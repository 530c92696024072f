"""Serving export helpers: counterpart of ``volta_tpu/export.py``.

Only ``quantize_residual_dtype`` (:55-59) for now, which the int8 serving
bundle of ``eval_retrieval --quantize int8`` uses. The exporter itself (a
``torch.export`` artifact of the eval forward, JAX's ``jax.export``) is
ROADMAP.md Queue 1 item 10's other half.
"""

from __future__ import annotations

import torch

from .config import VoltaConfig


def quantize_residual_dtype(cfg: VoltaConfig):
    """Shipping dtype for the non-quantized params of an int8 bundle:
    bf16 when that's the compute dtype, else None (left untouched)."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
