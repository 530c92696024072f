"""Fine-tuning losses. Counterpart of ``volta_tpu/losses.py``; only the
binary cross-entropy of the VQA path is ported so far."""

from __future__ import annotations

import torch


def binary_cross_entropy_with_logits(logits, targets, reduction="mean"):
    """Numerically stable BCE on logits, computed in float32
    (volta_tpu/losses.py:39-48)."""
    logits = logits.float()
    targets = targets.float()
    per = torch.clamp(logits, min=0) - logits * targets + \
        torch.log1p(torch.exp(-logits.abs()))
    if reduction == "mean":
        return per.mean()
    if reduction == "sum":
        return per.sum()
    return per
