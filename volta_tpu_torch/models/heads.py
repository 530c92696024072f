"""Poolers, pretraining heads and task classifiers.

Counterpart of ``volta_tpu/models/heads.py``: ``TextPooler``,
``VLBertTextPooler``, ``ImagePooler``, ``fuse_pooled`` and
``SimpleClassifier`` (heads.py:27-67,118-171), and the pretraining heads
``LMPredictionHead``, ``ImagePredictionHead`` and ``PreTrainingHeads``
(:70-153). The MLM decoder is tied: it reads the word-embedding table the
caller passes in at every call (the backbone's one parameter, cast to the
activations' dtype), and owns only ``decoder_bias``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import VoltaConfig
from .embeddings import XavierDense, compute_dtype
from .layers import ACT2FN, Dense, DropoutSeeds, LayerNorm, gelu, \
    hash_dropout, site_seed

# masked-region prediction target dims keyed by objective id
# (reference: volta/losses.py:129-137)
PRE_VIS_TARGETS = {
    "0": 1601, "1": 2048, "2": 2048, "3": 1600, "4": 400, "5": 2048, "6": 1601,
}


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


class LMPredictionHead(nn.Module):
    """MLM head: dense (xavier init) -> activation -> LayerNorm -> the tied
    decoder, logits = x · tableᵀ + decoder_bias in the compute dtype
    (volta_tpu/models/heads.py:70-91; reference: volta/encoders.py:643-697)."""

    RAW_PARAMS = ("decoder_bias",)

    def __init__(self, cfg: VoltaConfig):
        super().__init__()
        self.act = ACT2FN[cfg.hidden_act]
        self.transform_dense = XavierDense(cfg.hidden_size, cfg.hidden_size,
                                           compute_dtype(cfg))
        self.transform_ln = LayerNorm(cfg.hidden_size,
                                      use_kernel=cfg.use_pallas_layernorm)
        self.decoder_bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def reset_own_parameters(self, generator=None):
        with torch.no_grad():
            self.decoder_bias.zero_()

    def forward(self, hidden, word_table):
        x = self.transform_ln(self.act(self.transform_dense(hidden)))
        return F.linear(x, word_table.to(x.dtype),
                        self.decoder_bias.to(x.dtype))


class ImagePredictionHead(nn.Module):
    """Masked-region heads: dense (xavier) -> activation -> LayerNorm (with
    ``image_head_ln``) -> one xavier ``decoder_<ix>`` for each objective of
    ``visual_target_weights`` with a positive weight
    (volta_tpu/models/heads.py:94-117). Returns {ix: logits}."""

    def __init__(self, cfg: VoltaConfig):
        super().__init__()
        dt = compute_dtype(cfg)
        self.act = ACT2FN[cfg.hidden_act]
        self.transform_dense = XavierDense(cfg.v_hidden_size,
                                           cfg.v_hidden_size, dt)
        self.transform_ln = LayerNorm(
            cfg.v_hidden_size, use_kernel=cfg.use_pallas_layernorm) \
            if cfg.image_head_ln else None
        self.targets = [ix for ix in PRE_VIS_TARGETS
                        if cfg.visual_target_weights.get(ix, 0) > 0]
        for ix in self.targets:
            self.add_module(f"decoder_{ix}", XavierDense(
                cfg.v_hidden_size, PRE_VIS_TARGETS[ix], dt))

    def forward(self, hidden) -> Dict[str, torch.Tensor]:
        x = self.act(self.transform_dense(hidden))
        if self.transform_ln is not None:
            x = self.transform_ln(x)
        return {ix: getattr(self, f"decoder_{ix}")(x) for ix in self.targets}


class PreTrainingHeads(nn.Module):
    """MLM, masked-region and ITM heads (volta_tpu/models/heads.py:134-153;
    reference: volta/encoders.py:740-784). The fused pooled output takes
    the JAX module's fixed ``nn.Dropout(0.1)`` in training mode, as the
    port runs ``VoltaForVLTasks``' pooled dropout (``hash_dropout`` with
    the site's seed, drawn on every path); the ITM head
    (``bi_seq_relationship``) is absent under ``fusion_method`` ``none``
    and ``vl-bert_vqa``."""

    dropout_prob = 0.1

    def __init__(self, cfg: VoltaConfig):
        super().__init__()
        self.cfg = cfg
        self.predictions = LMPredictionHead(cfg)
        self.image_predictions = ImagePredictionHead(cfg)
        self.bi_seq_relationship = None \
            if cfg.fusion_method in ("none", "vl-bert_vqa") \
            else XavierDense(cfg.pooler_size, 2, compute_dtype(cfg))

    def forward(self, seq_t, seq_v, pooled_t, pooled_v, word_table,
                seeds: Optional[DropoutSeeds] = None):
        """(mlm logits, {ix: region logits}, itm logits or None, pooled)."""
        pooled = fuse_pooled(self.cfg, pooled_t, pooled_v)
        seed = site_seed(self, self.dropout_prob, seeds)
        if seed is not None and pooled is not None:
            pooled = hash_dropout(pooled, seed, self.dropout_prob)
        t_scores = self.predictions(seq_t, word_table)
        v_scores = self.image_predictions(seq_v)
        itm = None if self.bi_seq_relationship is None or pooled is None \
            else self.bi_seq_relationship(pooled)
        return t_scores, v_scores, itm, pooled


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
