"""Poolers and the classifier of the VQA and NLVR2 heads.

Counterpart of ``volta_tpu/models/heads.py`` (heads.py:27-67,118-171):
``TextPooler``, ``VLBertTextPooler``, ``ImagePooler``, ``fuse_pooled`` and
``SimpleClassifier``. The pretraining heads are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import VoltaConfig
from .embeddings import compute_dtype
from .layers import Dense, LayerNorm, gelu


class TextPooler(nn.Module):
    """CLS-token pooler: dense + ReLU (reference: volta/encoders.py:596-607)."""

    def __init__(self, cfg: VoltaConfig):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.pooler_size,
                           cfg.initializer_range, compute_dtype(cfg))

    def forward(self, hidden):
        return F.relu(self.dense(hidden[:, 0]))


class VLBertTextPooler(nn.Module):
    """VL-BERT VQA's pooler (``fusion_method: vl-bert_vqa``): the hidden
    state of the [MASK] slot at text_end - 2, clipped into the sequence,
    dense + ReLU (reference: volta/encoders.py:610-623)."""

    def __init__(self, cfg: VoltaConfig):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.pooler_size,
                           cfg.initializer_range, compute_dtype(cfg))

    def forward(self, hidden, text_end):
        """``text_end`` [B]: the count of non-pad text tokens."""
        idx = (text_end - 2).clamp(0, hidden.shape[1] - 1)
        rows = torch.arange(hidden.shape[0], device=hidden.device)
        return F.relu(self.dense(hidden[rows, idx]))


class ImagePooler(nn.Module):
    """First-region pooler (reference: volta/encoders.py:626-637)."""

    def __init__(self, cfg: VoltaConfig):
        super().__init__()
        self.dense = Dense(cfg.v_hidden_size, cfg.v_pooler_size,
                           cfg.initializer_range, compute_dtype(cfg))

    def forward(self, hidden):
        return F.relu(self.dense(hidden[:, 0]))


def fuse_pooled(cfg: VoltaConfig, pooled_t, pooled_v):
    """Cross-modal fusion of pooled outputs
    (reference: volta/encoders.py:767-778)."""
    if cfg.fusion_method == "sum":
        return pooled_t + pooled_v
    if cfg.fusion_method == "mul":
        return pooled_t * pooled_v
    if cfg.fusion_method in ("text", "vl-bert_vqa"):
        return pooled_t
    if cfg.fusion_method == "none":
        return None
    raise ValueError(f"Invalid fusion method: {cfg.fusion_method}")


class SimpleClassifier(nn.Module):
    """dense -> GeLU -> LN -> dense (reference: volta/encoders.py:787-814)."""

    def __init__(self, cfg: VoltaConfig, in_dim: int, hid_dim: int,
                 out_dim: int):
        super().__init__()
        std, dt = cfg.initializer_range, compute_dtype(cfg)
        self.dense1 = Dense(in_dim, hid_dim, std, dt)
        self.ln = LayerNorm(hid_dim, use_kernel=cfg.use_pallas_layernorm)
        self.dense2 = Dense(hid_dim, out_dim, std, dt)

    def forward(self, x):
        return self.dense2(self.ln(gelu(self.dense1(x))))
