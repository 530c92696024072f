"""Backbone and task wrapper.

Counterpart of ``volta_tpu/models/model.py``: ``VoltaModel`` (model.py:30-108)
with the shared-embedding branch, and ``VoltaForVLTasks`` (:156-246) with the
``VL-classifier`` / ``VL-classifier-GQA`` heads. ``module.training`` decides
whether dropout runs: in eval mode the forward is the JAX package's
``deterministic=True`` path; in training mode every dropout site of the JAX
train path runs, each with its own uint32 seed from ``DropoutSeeds`` over
the forward's ``dropout_seed``. Submodule names follow the Flax tree
(``bert.embeddings``, ``bert.encoder``, ``bert.t_pooler``, ``clf_TASK1``) so
that ``convert.state_dict_from_flax`` is a plain walk.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
from torch import nn

from volta_tpu.config import VoltaConfig

from ..ops.attention import additive_mask
from .embeddings import build_embeddings
from .encoder import GatedEncoder
from .heads import ImagePooler, SimpleClassifier, TextPooler, fuse_pooled
from .layers import DropoutSeeds, hash_dropout, site_seed


class VoltaModel(nn.Module):
    """Gated bimodal backbone (reference: volta/encoders.py:918-1017).
    Returns (seq_t, seq_v, pooled_t, pooled_v)."""

    def __init__(self, cfg: VoltaConfig):
        super().__init__()
        if cfg.visualization:
            raise NotImplementedError(
                "attention-map capture (visualization) is not ported yet")
        if cfg.fusion_method == "vl-bert_vqa":
            raise NotImplementedError(
                "the VL-BERT [MASK] pooler is not ported yet")
        self.cfg = cfg
        self.embeddings = build_embeddings(cfg)
        self.encoder = GatedEncoder(cfg)
        if cfg.fusion_method != "none":
            self.t_pooler = TextPooler(cfg)
        if cfg.fusion_method not in ("none", "text"):
            if cfg.pooler_size != cfg.v_pooler_size:
                raise ValueError("pooler_size != v_pooler_size")
            self.v_pooler = ImagePooler(cfg)

    def forward(self, input_ids, image_feat, image_loc, token_type_ids=None,
                attention_mask=None, image_attention_mask=None, seeds=None):
        fusion = self.cfg.fusion_method
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if image_attention_mask is None:
            image_attention_mask = torch.ones(
                image_feat.shape[:2], dtype=input_ids.dtype,
                device=input_ids.device)
        t_emb, v_emb = self.embeddings(input_ids, image_feat, image_loc,
                                       token_type_ids, seeds)
        seq_t, seq_v = self.encoder(t_emb, v_emb,
                                    additive_mask(attention_mask),
                                    additive_mask(image_attention_mask),
                                    seeds)
        pooled_t = None if fusion == "none" else self.t_pooler(seq_t)
        pooled_v = None if fusion in ("none", "text") \
            else self.v_pooler(seq_v)
        return seq_t, seq_v, pooled_t, pooled_v


class VoltaForVLTasks(nn.Module):
    """Task wrapper with one classifier per task
    (reference: volta/encoders.py:1117-1206). ``task_cfg`` maps task ids to
    dicts with ``type`` and ``num_labels``; ``task_ids`` are the tasks to
    build heads for. Returns the prediction logits. The pooled output gets
    dropout at ``dropout_prob`` (0.1, fixed as in the JAX module) in
    training mode."""

    def __init__(self, cfg: VoltaConfig, task_cfg: Dict[str, Any],
                 task_ids: Sequence[str], dropout_prob: float = 0.1):
        super().__init__()
        self.cfg = cfg
        self.task_cfg = task_cfg
        self.dropout_prob = dropout_prob
        self.bert = VoltaModel(cfg)
        for task_id in task_ids:
            tc = task_cfg[task_id]
            if tc["type"] not in ("VL-classifier", "VL-classifier-GQA"):
                raise NotImplementedError(
                    f"task type {tc['type']!r} is not ported yet (ROADMAP.md "
                    "Queue 1, eval path)")
            self.add_module(f"clf_{task_id}", SimpleClassifier(
                cfg, cfg.pooler_size, cfg.clf_hidden_size,
                tc["num_labels"]))

    def forward(self, input_ids, image_feat, image_loc, task_id: str,
                token_type_ids=None, attention_mask=None,
                image_attention_mask=None, dropout_seed: int = None):
        """``dropout_seed`` (a uint32, read in training mode only, where a
        dropout site needs it) seeds the forward's dropout sites."""
        seeds = DropoutSeeds(dropout_seed) \
            if self.training and dropout_seed is not None else None
        _, _, pooled_t, pooled_v = self.bert(
            input_ids, image_feat, image_loc, token_type_ids, attention_mask,
            image_attention_mask, seeds)
        pooled = fuse_pooled(self.cfg, pooled_t, pooled_v)
        seed = site_seed(self, self.dropout_prob, seeds)
        if seed is not None:
            pooled = hash_dropout(pooled, seed, self.dropout_prob)
        return getattr(self, f"clf_{task_id}")(pooled)
