"""Decision probes of the port: the JAX package's matmul probes
(``tools/wgrad_probe.py``, ``tools/pallas_ffn_probe.py``) on the card, with
the hand-written CUDA kernels of ``ops/matmul.py`` in place of the Pallas
ones and cuBLAS as the yardstick."""
