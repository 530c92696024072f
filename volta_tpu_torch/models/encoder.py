"""The gated encoder, single-stream path.

Counterpart of ``volta_tpu/models/encoder.py``. When every sublayer shares
its parameters across modalities and has one LayerNorm (UNITER, VisualBERT,
VL-BERT), the encoder is plain BERT over the concatenated [text ‖ vision]
sequence: ``GatedEncoder``'s fused loop (encoder.py:588-613) over
``GatedAttentionSublayer.fused`` (:140-187, deterministic branch) and
``GatedFeedForwardSublayer.fused`` (:373-379). That is the path ported here,
in both modes: in training mode each sublayer runs attention dropout inside
the attention kernel and hash dropout in its residual LayerNorm, one seed
per site from the forward's ``DropoutSeeds``; with the config's LayerNorm
flags the tails run the CUDA LayerNorm or fused residual kernels
(``_make_ln``). A dual-stream plan or ``use_scan`` raises at construction.
Submodules are named after the Flax tree (``attn_0``, ``ff_1``, ...).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..config import SublayerSpec, VoltaConfig
from ..ops.attention import fused_attention
from .embeddings import compute_dtype
from .layers import ACT2FN, Dense, LayerNorm, site_seed


def _make_ln(cfg: VoltaConfig, dim: int) -> LayerNorm:
    """A sublayer tail's LayerNorm with the JAX gates (encoder.py:31-39):
    the LayerNorm kernels with ``use_pallas_layernorm``, the fused
    dropout+residual+LN kernels with ``use_pallas`` and
    ``use_fused_residual_ln``. The Pallas keep-mask kernel and the non-hash
    dropout are not ported and raise."""
    if cfg.use_pallas and cfg.use_pallas_dropout_mask and not cfg.remat_ff:
        raise NotImplementedError(
            "use_pallas_dropout_mask is not ported yet (ROADMAP.md Queue 2 "
            "row 14, pallas_keep_mask)")
    if not cfg.use_hash_dropout:
        raise NotImplementedError(
            "use_hash_dropout=false (int_threshold_dropout) is not ported "
            "yet (ROADMAP.md Queue 1 item 2)")
    return LayerNorm(dim, use_kernel=cfg.use_pallas_layernorm,
                     fused_residual=cfg.use_pallas
                     and cfg.use_fused_residual_ln)


def _fully_fused(spec: SublayerSpec) -> bool:
    if spec.kind == "attn":
        return (spec.has_tt and spec.has_tv and spec.has_vt and spec.has_vv
                and spec.share_params and spec.single_ln)
    return (spec.has_t_ff and spec.has_v_ff and spec.share_params
            and spec.single_ln)


class GatedAttentionSublayer(nn.Module):
    """Self-attention over the joined sequence: Q/K/V dense -> attention on
    the natural [B, L, H·D] layout (dropout on the probabilities in
    training) -> out_dense -> LN(dropout(o) + x)."""

    def __init__(self, cfg: VoltaConfig, spec: SublayerSpec):
        super().__init__()
        std, dt = cfg.initializer_range, compute_dtype(cfg)
        self.num_heads = spec.num_heads
        self.head_dim = spec.attn_hidden_size // spec.num_heads
        self.attn_rate = cfg.attention_probs_dropout_prob
        self.hidden_rate = cfg.hidden_dropout_prob
        self.query = Dense(cfg.hidden_size, spec.attn_hidden_size, std, dt)
        self.key = Dense(cfg.hidden_size, spec.attn_hidden_size, std, dt)
        self.value = Dense(cfg.hidden_size, spec.attn_hidden_size, std, dt)
        self.out_dense = Dense(spec.attn_hidden_size, cfg.hidden_size, std,
                               dt)
        self.out_ln = _make_ln(cfg, cfg.hidden_size)

    def forward(self, x, bias, seeds=None):
        b, l, _ = x.shape
        h, d = self.num_heads, self.head_dim
        q = self.query(x).view(b, l, h, d)
        k = self.key(x).view(b, l, h, d)
        v = self.value(x).view(b, l, h, d)
        attn_seed = site_seed(self, self.attn_rate, seeds)
        ctx = fused_attention(q, k, v, bias, 1.0 / math.sqrt(d),
                              self.attn_rate if attn_seed is not None
                              else 0.0, attn_seed)
        return self.out_ln(self.out_dense(ctx.reshape(b, l, h * d)),
                           residual=x, drop_rate=self.hidden_rate,
                           seed=site_seed(self, self.hidden_rate, seeds))


class GatedFeedForwardSublayer(nn.Module):
    """FFN over the joined sequence:
    LN(dropout(out_dense(act(inter_dense(x)))) + x)."""

    def __init__(self, cfg: VoltaConfig, spec: SublayerSpec):
        super().__init__()
        std, dt = cfg.initializer_range, compute_dtype(cfg)
        self.act = ACT2FN[cfg.hidden_act]
        self.hidden_rate = cfg.hidden_dropout_prob
        self.inter_dense = Dense(cfg.hidden_size, spec.intermediate_size, std,
                                 dt)
        self.out_dense = Dense(spec.intermediate_size, cfg.hidden_size, std,
                               dt)
        self.out_ln = _make_ln(cfg, cfg.hidden_size)

    def forward(self, x, seeds=None):
        return self.out_ln(self.out_dense(self.act(self.inter_dense(x))),
                           residual=x, drop_rate=self.hidden_rate,
                           seed=site_seed(self, self.hidden_rate, seeds))


class GatedEncoder(nn.Module):
    """Depth-D stack over [text ‖ vision] per the static sublayer plan
    (reference: volta/encoders.py:820-888)."""

    def __init__(self, cfg: VoltaConfig):
        super().__init__()
        if cfg.use_scan:
            raise NotImplementedError(
                "use_scan is not ported: the port runs the stack as a loop")
        self.names = []
        for spec in cfg.sublayer_plan():
            if not _fully_fused(spec):
                raise NotImplementedError(
                    f"sublayer {spec.index} is dual-stream; only the single-"
                    "stream path is ported (ROADMAP.md Queue 1, dual-stream)")
            if spec.kind == "attn":
                name, layer = f"attn_{spec.index}", \
                    GatedAttentionSublayer(cfg, spec)
            else:
                name, layer = f"ff_{spec.index}", \
                    GatedFeedForwardSublayer(cfg, spec)
            self.add_module(name, layer)
            self.names.append(name)

    def forward(self, t, v, t_bias, v_bias, seeds=None):
        x = torch.cat([t, v], dim=1)
        bias = torch.cat([t_bias, v_bias], dim=-1)
        for name in self.names:
            layer = getattr(self, name)
            if isinstance(layer, GatedAttentionSublayer):
                x = layer(x, bias, seeds)
            else:
                x = layer(x, seeds)
        lt = t.shape[1]
        return x[:, :lt], x[:, lt:]
