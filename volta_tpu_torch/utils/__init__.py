"""Profiling and debugging hooks (``profiling``)."""
