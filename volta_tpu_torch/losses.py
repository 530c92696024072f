"""Fine-tuning losses. Counterpart of ``volta_tpu/losses.py``; only the
binary cross-entropy of the fine-tuning heads is ported so far (the cross
entropy of the VL-logit and tri-classifier heads is ``task_utils``'s, as
in the JAX package)."""

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
