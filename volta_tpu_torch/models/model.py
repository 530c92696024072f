"""Backbone and task wrapper.

Counterpart of ``volta_tpu/models/model.py``: ``VoltaModel`` (model.py:30-108)
with the shared and the dual-stream embeddings and every pooler (the
VL-BERT [MASK] pooler under ``fusion_method: vl-bert_vqa``), ``VLogitMLP``
(:140-151) and ``VoltaForVLTasks`` (:156-246) with every head type of the
JAX module: ``VL-classifier`` / ``VL-classifier-GQA`` and ``VL-binary-classifier``
(``SimpleClassifier``, the binary one over the two images' pooled outputs
side by side), ``VL-tri-classifier`` and ``VL-logit`` (one ``Dense``), and
``V-logit`` / ``V-logit-mc`` (a ``Dense`` or, with ``num_clf_layers: 2``,
``VLogitMLP``, over the region outputs, padding regions penalised by
-10000 in the logits' dtype). ``module.training`` decides
whether dropout runs: in eval mode the forward is the JAX package's
``deterministic=True`` path; in training mode every dropout site of the JAX
train path runs, each with its own uint32 seed from ``DropoutSeeds`` over
the forward's ``dropout_seed``, drawn in call order: the embeddings'
(text, then vision), the encoder's, the pooled output's, then the region
outputs' and ``VLogitMLP``'s. Submodule names follow the Flax tree
(``bert.embeddings``, ``bert.v_embeddings``, ``bert.encoder``,
``bert.t_pooler``, ``clf_TASK1``, ``clf_TASK10.dense1``) so that
``convert.state_dict_from_flax`` is a plain walk.

``VoltaForVLPreTraining`` (model.py:111-137) runs the same backbone under
the MLM, masked-region and ITM heads (``heads.PreTrainingHeads``).

Capture (model.py:61-108, 201-209): ``output_probs`` (and, on
``VoltaModel``, ``output_all_layers``) runs the encoder's general loop and
adds ``extras`` ``{all_t, all_v, probs}`` to the return value; the config's
``visualization`` implies ``output_probs`` on every forward, so such a
config trains and evaluates on the plain attention route, as JAX's does,
while a caller that asks for neither keyword gets today's return value.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
from torch import nn

from ..config import VoltaConfig
from ..ops.attention import additive_mask
from .embeddings import DUAL_EMBEDDINGS, SHARED_EMBEDDINGS, \
    TextEmbeddings, compute_dtype
from .encoder import GatedEncoder
from .heads import ImagePooler, PreTrainingHeads, SimpleClassifier, \
    TextPooler, VLBertTextPooler, fuse_pooled
from .layers import Dense, DropoutSeeds, gelu, hash_dropout, site_seed


class VoltaModel(nn.Module):
    """Gated bimodal backbone (reference: volta/encoders.py:918-1017).
    Returns (seq_t, seq_v, pooled_t, pooled_v). The single-stream families
    (``SHARED_EMBEDDINGS``) embed both modalities in one module named
    ``embeddings``; the dual-stream ones have ``embeddings`` (the text,
    ``TextEmbeddings``) and ``v_embeddings`` (``DUAL_EMBEDDINGS``), as the
    JAX module names them (model.py:40-50)."""

    def __init__(self, cfg: VoltaConfig):
        super().__init__()
        self.cfg = cfg
        self.is_shared = cfg.image_embeddings in SHARED_EMBEDDINGS
        if self.is_shared:
            self.embeddings = SHARED_EMBEDDINGS[cfg.image_embeddings](cfg)
        else:
            self.embeddings = TextEmbeddings(cfg)
            self.v_embeddings = DUAL_EMBEDDINGS[cfg.image_embeddings](cfg)
        self.encoder = GatedEncoder(cfg)
        if cfg.fusion_method == "vl-bert_vqa":
            self.t_pooler = VLBertTextPooler(cfg)
        elif cfg.fusion_method != "none":
            self.t_pooler = TextPooler(cfg)
        if cfg.fusion_method not in ("none", "text", "vl-bert_vqa"):
            if cfg.pooler_size != cfg.v_pooler_size:
                raise ValueError("pooler_size != v_pooler_size")
            self.v_pooler = ImagePooler(cfg)

    def forward(self, input_ids, image_feat, image_loc, token_type_ids=None,
                attention_mask=None, image_attention_mask=None, seeds=None,
                output_all_layers=False, output_probs=False):
        """(seq_t, seq_v, pooled_t, pooled_v), and ``extras`` after them
        when either keyword is true."""
        fusion = self.cfg.fusion_method
        capture = output_probs or self.cfg.visualization
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if image_attention_mask is None:
            image_attention_mask = torch.ones(
                image_feat.shape[:2], dtype=input_ids.dtype,
                device=input_ids.device)
        if self.is_shared:
            t_emb, v_emb = self.embeddings(input_ids, image_feat, image_loc,
                                           token_type_ids, seeds)
        else:
            t_emb = self.embeddings(input_ids, token_type_ids, seeds)
            v_emb = self.v_embeddings(image_feat, image_loc, seeds)
        seq_t, seq_v, *rest = self.encoder(
            t_emb, v_emb, additive_mask(attention_mask),
            additive_mask(image_attention_mask), seeds,
            output_all_layers=output_all_layers, output_probs=capture)
        if fusion == "vl-bert_vqa":
            pooled_t = self.t_pooler(seq_t, (input_ids != 0).sum(1))
        else:
            pooled_t = None if fusion == "none" else self.t_pooler(seq_t)
        pooled_v = None if fusion in ("none", "text", "vl-bert_vqa") \
            else self.v_pooler(seq_v)
        if not (output_all_layers or output_probs):
            return seq_t, seq_v, pooled_t, pooled_v
        all_t, all_v, probs = rest[0]
        return seq_t, seq_v, pooled_t, pooled_v, {
            "all_t": all_t, "all_v": all_v, "probs": probs}


class VoltaForVLPreTraining(nn.Module):
    """Pretraining wrapper: ``VoltaModel`` (``bert``) and
    ``PreTrainingHeads`` (``cls``) producing the MLM, masked-region and ITM
    logits (volta_tpu/models/model.py:111-137; reference:
    volta/encoders.py:1020-1114; the losses are ``losses
    .pretraining_losses``). The MLM decoder reads the backbone's word table,
    ``bert.embeddings.word_embeddings.weight``: one parameter, no copy.
    Returns {mlm_logits, mrm_logits (a dict by objective), itm_logits (None
    without an ITM head), pooled, extras}; ``extras`` holds ``word_table``
    and, with ``output_probs``, the capture's ``all_t``, ``all_v`` and
    ``probs``. In training mode the dropout sites draw their seeds from
    ``dropout_seed`` as ``VoltaForVLTasks``' do, the pooled output's last."""

    def __init__(self, cfg: VoltaConfig):
        super().__init__()
        self.cfg = cfg
        self.bert = VoltaModel(cfg)
        self.cls = PreTrainingHeads(cfg)

    def forward(self, input_ids, image_feat, image_loc, token_type_ids=None,
                attention_mask=None, image_attention_mask=None,
                dropout_seed: int = None, output_probs: bool = False):
        seeds = DropoutSeeds(dropout_seed) \
            if self.training and dropout_seed is not None else None
        seq_t, seq_v, pooled_t, pooled_v, *rest = self.bert(
            input_ids, image_feat, image_loc, token_type_ids, attention_mask,
            image_attention_mask, seeds, output_probs=output_probs)
        table = self.bert.embeddings.word_embeddings.weight
        t_scores, v_scores, itm, pooled = self.cls(
            seq_t, seq_v, pooled_t, pooled_v, table, seeds)
        extras = {"word_table": table, "all_t": None, "all_v": None,
                  "probs": None}
        if rest:
            extras.update(rest[0])
        return {"mlm_logits": t_scores, "mrm_logits": v_scores,
                "itm_logits": itm, "pooled": pooled, "extras": extras}


class VLogitMLP(nn.Module):
    """2-layer V-logit head: dense -> gelu -> dropout -> dense to one logit
    a region (reference: volta/encoders.py:1141-1147). Its dropout runs at
    ``v_attention_probs_dropout_prob`` in training mode."""

    def __init__(self, cfg: VoltaConfig):
        super().__init__()
        std, dt = cfg.initializer_range, compute_dtype(cfg)
        self.rate = cfg.v_attention_probs_dropout_prob
        self.dense1 = Dense(cfg.v_hidden_size, cfg.v_hidden_size, std, dt)
        self.dense2 = Dense(cfg.v_hidden_size, 1, std, dt)

    def forward(self, x, seeds=None):
        x = gelu(self.dense1(x))
        seed = site_seed(self, self.rate, seeds)
        if seed is not None:
            x = hash_dropout(x, seed, self.rate)
        return self.dense2(x)


def build_head(cfg: VoltaConfig, tc: Dict[str, Any]) -> nn.Module:
    """The classifier of one task config ``tc`` (volta_tpu/models/model.py
    :176-195); an unknown type raises ``ValueError``."""
    ttype, std, dt = tc["type"], cfg.initializer_range, compute_dtype(cfg)
    if ttype in ("VL-classifier", "VL-classifier-GQA"):
        return SimpleClassifier(cfg, cfg.pooler_size, cfg.clf_hidden_size,
                                tc["num_labels"])
    if ttype == "VL-binary-classifier":
        # the two images of a pair side by side
        return SimpleClassifier(cfg, 2 * cfg.pooler_size,
                                cfg.clf_hidden_size, 2)
    if ttype == "VL-tri-classifier":
        return Dense(cfg.pooler_size, 3, std, dt)
    if ttype == "VL-logit":
        return Dense(cfg.pooler_size, 1, std, dt)
    if ttype.startswith("V-logit"):
        if tc.get("num_clf_layers", 1) == 2:
            return VLogitMLP(cfg)
        return Dense(cfg.v_hidden_size, 1, std, dt)
    raise ValueError(f"Undefined task type: {ttype}")


class VoltaForVLTasks(nn.Module):
    """Task wrapper with one classifier per task
    (reference: volta/encoders.py:1117-1206). ``task_cfg`` maps task ids to
    dicts with ``type`` (and ``num_labels`` / ``num_clf_layers`` where they
    apply); ``task_ids`` are the tasks to build heads for. Returns the
    prediction logits. In training mode the pooled output, and for the
    V-logit heads the region outputs, get dropout at ``dropout_prob`` (0.1,
    fixed as in the JAX module)."""

    def __init__(self, cfg: VoltaConfig, task_cfg: Dict[str, Any],
                 task_ids: Sequence[str], dropout_prob: float = 0.1):
        super().__init__()
        self.cfg = cfg
        self.task_cfg = task_cfg
        self.dropout_prob = dropout_prob
        self.bert = VoltaModel(cfg)
        for task_id in task_ids:
            self.add_module(f"clf_{task_id}",
                            build_head(cfg, task_cfg[task_id]))

    def forward(self, input_ids, image_feat, image_loc, task_id: str,
                token_type_ids=None, attention_mask=None,
                image_attention_mask=None, dropout_seed: int = None,
                output_probs: bool = False):
        """``dropout_seed`` (a uint32, read in training mode only, where a
        dropout site needs it) seeds the forward's dropout sites. With
        ``output_probs`` the return is (logits, extras)."""
        seeds = DropoutSeeds(dropout_seed) \
            if self.training and dropout_seed is not None else None
        _, seq_v, pooled_t, pooled_v, *extras = self.bert(
            input_ids, image_feat, image_loc, token_type_ids, attention_mask,
            image_attention_mask, seeds, output_probs=output_probs)
        logits = self._head(task_id, seq_v, pooled_t, pooled_v, image_feat,
                            image_attention_mask, seeds)
        return (logits, extras[0]) if output_probs else logits

    def _head(self, task_id, seq_v, pooled_t, pooled_v, image_feat,
              image_attention_mask, seeds):
        ttype = self.task_cfg[task_id]["type"]
        clf = getattr(self, f"clf_{task_id}")
        # the pooled output's site draws its seed on every path, so the
        # sites after it keep theirs; a V-logit head does not read the
        # pooled output, so its dropout is not run (XLA drops it from the
        # JAX step as dead code)
        seed = site_seed(self, self.dropout_prob, seeds)
        if ttype.startswith("V-logit"):
            seed = site_seed(self, self.dropout_prob, seeds)
            if seed is not None:
                seq_v = hash_dropout(seq_v, seed, self.dropout_prob)
            logit = clf(seq_v, seeds) if isinstance(clf, VLogitMLP) \
                else clf(seq_v)
            if image_attention_mask is None:
                image_attention_mask = torch.ones(
                    image_feat.shape[:2], dtype=torch.float32,
                    device=logit.device)
            # in the logits' dtype, as the JAX module builds it: -10000 is
            # -9984 in bf16
            mask_pen = ((1.0 - image_attention_mask.to(logit.dtype))
                        * -10000.0)[..., None]
            return logit + mask_pen
        pooled = fuse_pooled(self.cfg, pooled_t, pooled_v)
        if seed is not None and pooled is not None:
            pooled = hash_dropout(pooled, seed, self.dropout_prob)
        if ttype == "VL-binary-classifier":
            # NLVR2: the two images of a pair are consecutive rows; fuse
            # their pooled outputs (reference: volta/encoders.py:1200-1202)
            pooled = pooled.reshape(-1, pooled.shape[-1] * 2)
        return clf(pooled)
