"""Joint text and vision embeddings.

Counterpart of ``volta_tpu/models/embeddings.py``. Only the UNITER scheme
(ctrl_uniter) is ported so far; the other four raise.
"""

from __future__ import annotations

import torch
from torch import nn

from volta_tpu.config import VoltaConfig

from .layers import Dense, Embed, LayerNorm, hash_dropout, site_seed


def compute_dtype(cfg: VoltaConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32


class UniterEmbeddings(nn.Module):
    """UNITER joint embeddings (reference: volta/embeddings.py:401-457):
    text LN'd separately; vision = LN(featW) + LN(locW) + type(1), own LN.

    Dtype flow, as in the JAX module: the text sum and its LN are float32,
    then cast; ``feat_dense``/``loc_dense`` and their LNs run in the compute
    dtype; adding the float32 type row promotes to float32 before
    ``v_layer_norm`` and the final cast. In training mode the text and the
    vision embeddings each get dropout at ``hidden_dropout_prob`` before
    the cast (embeddings.py:306,317), hash dropout here where the JAX
    module draws Flax ``nn.Dropout`` masks."""

    def __init__(self, cfg: VoltaConfig):
        super().__init__()
        self.dtype = compute_dtype(cfg)
        self.rate = cfg.hidden_dropout_prob
        std = cfg.initializer_range
        self.word_embeddings = Embed(cfg.vocab_size, cfg.hidden_size, std,
                                     zero_pad_row=True)
        self.position_embeddings = Embed(cfg.max_position_embeddings,
                                         cfg.hidden_size, std)
        self.token_type_embeddings = Embed(cfg.type_vocab_size,
                                           cfg.hidden_size, std)
        self.layer_norm = LayerNorm(cfg.hidden_size)
        self.feat_dense = Dense(cfg.v_feature_size, cfg.v_hidden_size, std,
                                self.dtype)
        self.feat_ln = LayerNorm(cfg.hidden_size)
        self.loc_dense = Dense(cfg.num_locs, cfg.v_hidden_size, std,
                               self.dtype)
        self.loc_ln = LayerNorm(cfg.hidden_size)
        self.v_layer_norm = LayerNorm(cfg.hidden_size)

    def forward(self, input_ids, feats, locs, token_type_ids, seeds=None):
        b, k = feats.shape[:2]
        seq = input_ids.shape[1]
        position_ids = torch.arange(seq, device=input_ids.device)
        t = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)[None]
             + self.token_type_embeddings(token_type_ids))
        t = self.layer_norm(t)
        seed = site_seed(self, self.rate, seeds)
        if seed is not None:
            t = hash_dropout(t, seed, self.rate)

        img = self.feat_ln(self.feat_dense(feats))
        loc = self.loc_ln(self.loc_dense(locs))
        typ = self.token_type_embeddings(
            torch.ones((b, k), dtype=torch.long, device=feats.device))
        v = self.v_layer_norm(img + loc + typ)
        seed = site_seed(self, self.rate, seeds)
        if seed is not None:
            v = hash_dropout(v, seed, self.rate)
        return t.to(self.dtype), v.to(self.dtype)


def build_embeddings(cfg: VoltaConfig) -> nn.Module:
    if cfg.image_embeddings == "uniter":
        return UniterEmbeddings(cfg)
    raise NotImplementedError(
        f"image_embeddings={cfg.image_embeddings!r} is not ported yet "
        "(ROADMAP.md Queue 1, dual-stream and the other families)")
