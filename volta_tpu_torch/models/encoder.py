"""The gated encoder, single-stream path.

Counterpart of ``volta_tpu/models/encoder.py``. When every sublayer shares
its parameters across modalities and has one LayerNorm (UNITER, VisualBERT,
VL-BERT), the encoder is plain BERT over the concatenated [text ‖ vision]
sequence: ``GatedEncoder``'s fused loop (encoder.py:588-613) over
``GatedAttentionSublayer.fused`` (:140-187) and
``GatedFeedForwardSublayer.fused`` (:373-379). That is the route when no
capture is asked, in both modes: in training mode each sublayer runs
attention dropout inside the attention kernel and hash dropout in its
residual LayerNorm, one seed per site from the forward's
``DropoutSeeds``; with the config's LayerNorm flags the tails run the CUDA
LayerNorm or fused residual kernels (``_make_ln``). The attention takes
JAX's gate (``ops.attention.fused_attention``): with ``use_pallas``, a
bias and L >= 8 the kernels, else the plain composition, which drops the
probabilities by a Bernoulli draw from the site's seed.
``attn_natural_layout`` picks the attention kernels as in
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
(encoder.py:556-608); attention sublayers never are.

``output_all_layers`` or ``output_probs`` take the general loop instead
(encoder.py:615-631): each sublayer per stream (``streams``: the text and
the vision queries each attend over [text ‖ vision] keys, then one tail
over the concatenation, encoder.py:208-327 and 416-471), the hidden states
after every sublayer, and with ``output_probs`` each attention sublayer's
post-dropout probabilities, queries and keys (``_attn_data``, :329-358) on
the plain route, as JAX forms them. A dual-stream plan or ``use_scan``
raises at construction. Submodules are named after the Flax tree
(``attn_0``, ``ff_1``, ...).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import SublayerSpec, VoltaConfig
from ..ops.attention import dropout_attention_hidden_masks, \
    fused_attention, plain_attention
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
    LN(dropout(o) + x). ``forward`` returns the output and the next
    feed-forward's keep mask, which only ``fuse_hidden`` draws (else None);
    ``streams`` is the per-stream form of the same sublayer."""

    def __init__(self, cfg: VoltaConfig, spec: SublayerSpec):
        super().__init__()
        std, dt = cfg.initializer_range, compute_dtype(cfg)
        self.natural = cfg.attn_natural_layout
        self.use_pallas = cfg.use_pallas
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

    def _qkv(self, x):
        b, l, _ = x.shape
        h, d = self.num_heads, self.head_dim
        return (self.query(x).view(b, l, h, d), self.key(x).view(b, l, h, d),
                self.value(x).view(b, l, h, d))

    def _attend(self, q, k, v, bias, seeds, want_probs):
        """One query stream's attention with its site's seed (encoder.py
        :83-129): the probabilities after dropout with ``want_probs``,
        which take the plain route, else None."""
        seed = site_seed(self, self.attn_rate, seeds)
        rate = self.attn_rate if seed is not None else 0.0
        scale = 1.0 / math.sqrt(self.head_dim)
        if want_probs:
            return plain_attention(q, k, v, bias, scale, rate, seed)
        return fused_attention(q, k, v, bias, scale, rate, seed,
                               natural=self.natural,
                               use_pallas=self.use_pallas), None

    def forward(self, x, bias, seeds=None):
        b, l, _ = x.shape
        h, d = self.num_heads, self.head_dim
        q, k, v = self._qkv(x)
        if (self.fuse_hidden and self.training and self.attn_rate > 0.0
                and self.hidden_rate > 0.0 and bias is not None and l >= 8):
            # row 9: the seeds of the attention, of this tail and of the
            # next feed-forward's tail, in the order the unfused path
            # draws them, so each mask is the one that path draws
            seeds3 = [site_seed(self, self.attn_rate, seeds)] + [
                site_seed(self, self.hidden_rate, seeds) for _ in range(2)]
            ctx, hm0, hm1 = dropout_attention_hidden_masks(
                q, k, v, bias, 1.0 / math.sqrt(d), self.attn_rate,
                self.hidden_rate, seeds3)
            return self.out_ln(self.out_dense(ctx.reshape(b, l, h * d)),
                               residual=x, drop_rate=self.hidden_rate,
                               keep_mask=hm0), hm1
        ctx, _ = self._attend(q, k, v, bias, seeds, False)
        return self.out_ln(self.out_dense(ctx.reshape(b, l, h * d)),
                           residual=x, drop_rate=self.hidden_rate,
                           seed=site_seed(self, self.hidden_rate,
                                          seeds)), None

    def streams(self, t, v, t_bias, v_bias, seeds=None, output_probs=False):
        """The sublayer per stream (encoder.py:208-327 for a shared-
        parameter, single-LayerNorm spec): text queries, then vision
        queries, attend over [text ‖ vision] keys, each with its own seed;
        one tail over the concatenated outputs. Shared parameters have one
        hidden rate (encoder.py:275-276), so the tail is the equal-rate
        one (:304-308). Returns (t, v, (t_data, v_data) with
        ``output_probs`` else None)."""
        (b, lt, _), lv = t.shape, v.shape[1]
        qt, kt, vt = self._qkv(t)
        qv, kv, vv = self._qkv(v)
        k, vals = torch.cat([kt, kv], 1), torch.cat([vt, vv], 1)
        bias = torch.cat([t_bias, v_bias], -1)
        t_ctx, t_probs = self._attend(qt, k, vals, bias, seeds, output_probs)
        v_ctx, v_probs = self._attend(qv, k, vals, bias, seeds, output_probs)
        hd = self.num_heads * self.head_dim
        o = torch.cat([self.out_dense(t_ctx.reshape(b, lt, hd)),
                       self.out_dense(v_ctx.reshape(b, lv, hd))], 1)
        y = self.out_ln(o, residual=torch.cat([t, v], 1),
                        drop_rate=self.hidden_rate,
                        seed=site_seed(self, self.hidden_rate, seeds))
        data = None
        if output_probs:
            data = _attn_data(qt, kt, t_probs, qv, kv, v_probs, lt)
        return y[:, :lt], y[:, lt:], data


def _attn_data(qt, kt, t_probs, qv, kv, v_probs, lt):
    """The per-stream visualization dicts of encoder.py:329-358: each
    stream's probabilities [B, H, Lq, Lk] split at the text keys' end into
    intra- and inter-modal, queries and keys [B, H, L, D]."""
    bhld = lambda x: x.transpose(1, 2)  # noqa: E731
    t_data = {"intra_attn": t_probs[..., :lt], "inter_attn": t_probs[..., lt:],
              "queries": bhld(qt), "keys": bhld(kt)}
    v_data = {"intra_attn": v_probs[..., lt:], "inter_attn": v_probs[..., :lt],
              "queries": bhld(qv), "keys": bhld(kv)}
    return t_data, v_data


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

    def streams(self, t, v, seeds=None):
        """The sublayer per stream (encoder.py:416-471, shared parameters,
        one LayerNorm): each stream's FFN, one tail over the
        concatenation."""
        return self.streams_body(t, v, self.draw_seed(seeds, None))

    def streams_body(self, t, v, seed):
        ffn = lambda x: self.out_dense(self.act(self.inter_dense(x)))  # noqa: E731
        lt = t.shape[1]
        y = self.out_ln(torch.cat([ffn(t), ffn(v)], 1),
                        residual=torch.cat([t, v], 1),
                        drop_rate=self.hidden_rate, seed=seed)
        return y[:, :lt], y[:, lt:]


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

    def forward(self, t, v, t_bias, v_bias, seeds=None,
                output_all_layers=False, output_probs=False):
        """(t, v) after the stack; with ``output_all_layers`` or
        ``output_probs``, (t, v, (all_t, all_v, all_probs)) from the
        general loop, as the JAX module returns them."""
        if output_all_layers or output_probs:
            return self._general(t, v, t_bias, v_bias, seeds,
                                 output_all_layers, output_probs)
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

    def _general(self, t, v, t_bias, v_bias, seeds, output_all_layers,
                 output_probs):
        """encoder.py:615-631: every sublayer per stream; the streams after
        each sublayer, attention and feed-forward alike, and one
        (t_data, v_data) an attention sublayer."""
        all_t, all_v, all_probs = [], [], []
        for name in self.names:
            layer = getattr(self, name)
            if isinstance(layer, GatedAttentionSublayer):
                t, v, probs = layer.streams(t, v, t_bias, v_bias, seeds,
                                            output_probs)
                if output_probs:
                    all_probs.append(probs)
            elif self.remat and torch.is_grad_enabled():
                t, v = checkpoint(layer.streams_body, t, v,
                                  layer.draw_seed(seeds, None),
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                t, v = layer.streams(t, v, seeds)
            if output_all_layers:
                all_t.append(t)
                all_v.append(v)
        return t, v, (all_t, all_v, all_probs)
