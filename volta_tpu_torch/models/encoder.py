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
(``_make_ln``). ``attn_natural_layout`` picks the attention kernels as in
the JAX package (encoder.py:94-96, 113-116): the natural [B, L, H·D] ones
(Queue 2 rows 1-4) by default, the head-major [H, B, L, D] ones (rows 5-8)
with false. The hidden-dropout masks follow the JAX gates too: with
``fuse_hidden_dropout`` the training attention runs row 9, which draws the
keep masks of its own tail and of the next feed-forward's (encoder.py
:161-187, 595-612); with ``use_pallas_dropout_mask`` the other tails draw
theirs with row 14 (encoder.py:37-38). Every mask is ``hash_dropout``'s for
the seed its tail would draw, so the flags change no mask. With
``use_hash_dropout: false`` the tails draw ``int_threshold_dropout``
(layers.py) where no kernel flag takes them, as in JAX. With ``remat_ff``
each feed-forward sublayer runs under ``torch.utils.checkpoint`` and is
recomputed in the backward instead of keeping its activations
(encoder.py:556-608); attention sublayers never are. A dual-stream plan or
``use_scan`` raises at construction. Submodules are named after the Flax
tree (``attn_0``, ``ff_1``, ...).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import SublayerSpec, VoltaConfig
from ..ops.attention import dropout_attention_hidden_masks, \
    fused_attention
from .embeddings import compute_dtype
from .layers import ACT2FN, Dense, LayerNorm, site_seed


def _make_ln(cfg: VoltaConfig, dim: int) -> LayerNorm:
    """A sublayer tail's LayerNorm with the JAX gates (encoder.py:31-39):
    the LayerNorm kernels with ``use_pallas_layernorm``, the fused
    dropout+residual+LN kernels with ``use_pallas`` and
    ``use_fused_residual_ln``, the keep-mask kernel (row 14) with
    ``use_pallas`` and ``use_pallas_dropout_mask`` unless ``remat_ff``,
    the hash dropout unless ``use_hash_dropout`` is false."""
    return LayerNorm(dim, use_kernel=cfg.use_pallas_layernorm,
                     fused_residual=cfg.use_pallas
                     and cfg.use_fused_residual_ln,
                     pallas_mask=cfg.use_pallas
                     and cfg.use_pallas_dropout_mask and not cfg.remat_ff,
                     hash_mask=cfg.use_hash_dropout)


def _fully_fused(spec: SublayerSpec) -> bool:
    if spec.kind == "attn":
        return (spec.has_tt and spec.has_tv and spec.has_vt and spec.has_vv
                and spec.share_params and spec.single_ln)
    return (spec.has_t_ff and spec.has_v_ff and spec.share_params
            and spec.single_ln)


class GatedAttentionSublayer(nn.Module):
    """Self-attention over the joined sequence: Q/K/V dense -> attention on
    the natural [B, L, H·D] layout, or head-major with ``natural`` false
    (dropout on the probabilities in training) -> out_dense ->
    LN(dropout(o) + x). Returns the output and the next feed-forward's
    keep mask, which only ``fuse_hidden`` draws (else None)."""

    def __init__(self, cfg: VoltaConfig, spec: SublayerSpec):
        super().__init__()
        std, dt = cfg.initializer_range, compute_dtype(cfg)
        self.natural = cfg.attn_natural_layout
        # the static half of the JAX gate of row 9 (encoder.py:161-164)
        self.fuse_hidden = (cfg.use_pallas and cfg.fuse_hidden_dropout
                            and spec.attn_hidden_size == cfg.hidden_size)
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
        scale = 1.0 / math.sqrt(d)
        if (self.fuse_hidden and self.training and self.attn_rate > 0.0
                and self.hidden_rate > 0.0 and bias is not None and l >= 8):
            # row 9: the seeds of the attention, of this tail and of the
            # next feed-forward's tail, in the order the unfused path
            # draws them, so each mask is the one that path draws
            seeds3 = [site_seed(self, self.attn_rate, seeds)] + [
                site_seed(self, self.hidden_rate, seeds) for _ in range(2)]
            ctx, hm0, hm1 = dropout_attention_hidden_masks(
                q, k, v, bias, scale, self.attn_rate, self.hidden_rate,
                seeds3)
            return self.out_ln(self.out_dense(ctx.reshape(b, l, h * d)),
                               residual=x, drop_rate=self.hidden_rate,
                               keep_mask=hm0), hm1
        attn_seed = site_seed(self, self.attn_rate, seeds)
        ctx = fused_attention(q, k, v, bias, scale,
                              self.attn_rate if attn_seed is not None
                              else 0.0, attn_seed, natural=self.natural)
        return self.out_ln(self.out_dense(ctx.reshape(b, l, h * d)),
                           residual=x, drop_rate=self.hidden_rate,
                           seed=site_seed(self, self.hidden_rate,
                                          seeds)), None


class GatedFeedForwardSublayer(nn.Module):
    """FFN over the joined sequence:
    LN(dropout(out_dense(act(inter_dense(x)))) + x); with a ``keep_mask``
    from the attention before it, that mask and no seed of its own."""

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

    def forward(self, x, seeds=None, keep_mask=None):
        return self.body(x, self.draw_seed(seeds, keep_mask), keep_mask)

    def draw_seed(self, seeds, keep_mask):
        """The tail's seed: None with a ``keep_mask`` or without dropout,
        else the next of ``seeds``."""
        return None if keep_mask is not None else site_seed(
            self, self.hidden_rate, seeds)

    def body(self, x, seed, keep_mask):
        """The sublayer for a drawn ``seed``: it draws nothing itself, so
        a recomputation of the same call drops the same elements."""
        return self.out_ln(self.out_dense(self.act(self.inter_dense(x))),
                           residual=x, drop_rate=self.hidden_rate, seed=seed,
                           keep_mask=keep_mask)


class GatedEncoder(nn.Module):
    """Depth-D stack over [text ‖ vision] per the static sublayer plan
    (reference: volta/encoders.py:820-888). ``remat`` (the config's
    ``remat_ff``) recomputes each feed-forward sublayer in the backward."""

    def __init__(self, cfg: VoltaConfig):
        super().__init__()
        if cfg.use_scan:
            raise NotImplementedError(
                "use_scan is not ported: the port runs the stack as a loop")
        self.remat = cfg.remat_ff
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
        ffn_mask = None  # row 9's mask for the next feed-forward's tail
        for name in self.names:
            layer = getattr(self, name)
            if isinstance(layer, GatedAttentionSublayer):
                x, ffn_mask = layer(x, bias, seeds)
            elif self.remat and torch.is_grad_enabled():
                # the seed is drawn here, outside the recomputed call, and
                # row 9's mask is one of its inputs, so the backward's
                # recomputation drops what the forward dropped; no global
                # generator is read inside, so none is saved
                x = checkpoint(layer.body, x,
                               layer.draw_seed(seeds, ffn_mask), ffn_mask,
                               use_reentrant=False, preserve_rng_state=False)
                ffn_mask = None
            else:
                x = layer(x, seeds, keep_mask=ffn_mask)
                ffn_mask = None
        lt = t.shape[1]
        return x[:, :lt], x[:, lt:]
