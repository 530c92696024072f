"""Attention ops of the port and the hand-written CUDA kernels behind them.

Kernels are built from ``ops/csrc`` at first use (``ops/_build.py``);
importing this package builds nothing.
"""
