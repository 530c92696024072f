"""The gated bimodal encoder, every VOLTA family.

Counterpart of ``volta_tpu/models/encoder.py``. Which of the tt/tv/vt/vv
attention flows and t/v feed-forwards a sublayer has, whether the two
streams share its parameters and whether one LayerNorm couples them come
from the static ``SublayerSpec`` plan, at construction. Submodules are
named after the Flax tree (``attn_0``, ``ff_1``, ..., ``v_query``,
``v_out_ln``, ...).

When every sublayer shares its parameters across modalities and has one
LayerNorm (UNITER, VisualBERT, VL-BERT), the encoder is plain BERT over the
concatenated [text ‖ vision] sequence: ``GatedEncoder``'s fused loop
(encoder.py:588-613) over ``GatedAttentionSublayer.forward`` (:140-187) and
``GatedFeedForwardSublayer.forward`` (:373-379). That is the route when no
capture is asked, in both modes: in training mode each sublayer runs
attention dropout inside the attention kernel and hash dropout in its
residual LayerNorm, one seed per site from the forward's ``DropoutSeeds``;
with the config's LayerNorm flags the tails run the CUDA LayerNorm or fused
residual kernels (``_make_ln``). The attention takes JAX's gate
(``ops.attention.fused_attention``): with ``use_pallas``, a bias and Lq >= 8
the kernels, else the plain composition, which drops the probabilities by a
Bernoulli draw from the site's seed. ``attn_natural_layout`` picks the
natural [B, L, H·D] kernels (Queue 2 rows 1-4) by default, the head-major
[H, B, L, D] ones (rows 5-8) with false (encoder.py:94-96, 113-116). The
hidden-dropout masks follow the JAX gates too: with ``fuse_hidden_dropout``
the fused loop's training attention runs row 9, which draws the keep masks
of its own tail and of the next feed-forward's (encoder.py:161-187,
595-612); with ``use_pallas_dropout_mask`` the tails draw theirs with row
14 (encoder.py:37-38). Every mask is ``hash_dropout``'s for the seed its
tail would draw, so the flags change no mask. With ``use_hash_dropout:
false`` the tails draw ``int_threshold_dropout`` where no kernel flag takes
them.

Any other plan (ViLBERT, LXMERT), and ``output_all_layers`` or
``output_probs``, take the general loop (encoder.py:615-631): each sublayer
per stream (``streams``). Each query stream attends over its own
concatenation of key sources in JAX's order, [text ‖ vision] (tt and tv for
the text queries, vt and vv for the vision queries), with the text or the
vision stream's heads, width and dropout rates; a stream without a flow
passes through. The tails take one of three forms (encoder.py:303-323,
451-471): one LayerNorm over the concatenation (``single_ln``), two
dropouts and a plain LayerNorm where a single LayerNorm meets distinct
rates, or a LayerNorm a stream; with ``fuse_dual_stream`` a two-stream
sublayer runs one dropout + residual + LayerNorm chain over the
concatenation (``residual_ln_seg``, or the shared LayerNorm), and a
parameter-shared one its projections over the concatenation too
(``fuse_dual_qkv``). Seeds are drawn in the JAX module's call order: text
attention, vision attention, text tail, vision tail. With ``output_probs``
each attention sublayer also returns its post-dropout probabilities,
queries and keys (``_attn_data``, encoder.py:329-358) from the plain route,
as JAX forms them. With ``remat_ff`` each feed-forward sublayer runs under
``torch.utils.checkpoint`` with its seeds drawn outside the recomputed call
(encoder.py:551-560, 602-608); attention sublayers never do. ``use_scan``
raises at construction.
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
from .layers import ACT2FN, Dense, LayerNorm, hash_dropout, \
    residual_ln_seg, site_seed


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


def _dual_fusable(cfg: VoltaConfig, spec: SublayerSpec) -> bool:
    """``fuse_dual_stream``'s gate for a sublayer when nothing is captured
    (encoder.py:189-206, 400-414): two streams with a LayerNorm each and
    equal widths; parameter-shared attention with equal attention widths;
    otherwise no LayerNorm or mask kernel flag and equal hidden rates."""
    if not (cfg.fuse_dual_stream and spec.has_text and spec.has_vision
            and not spec.single_ln):
        return False
    if cfg.hidden_size != cfg.v_hidden_size:
        return False
    if spec.share_params:
        return spec.kind == "ff" or \
            spec.attn_hidden_size == spec.v_attn_hidden_size
    if cfg.use_pallas_layernorm or cfg.use_fused_residual_ln \
            or cfg.use_pallas_dropout_mask:
        return False
    return cfg.hidden_dropout_prob == cfg.v_hidden_dropout_prob


def _vision(module, name):
    """The vision stream's submodule: the text one where shared."""
    return getattr(module, name if module.spec.share_params else "v_" + name)


def _heads(x, heads):
    b, l, hd = x.shape
    return x.contiguous().view(b, l, heads, hd // heads)


class _Tails:
    """The tail forms shared by both sublayer kinds (encoder.py:277-323,
    424-471). A subclass sets ``spec``, ``hidden_rate``, ``v_hidden_rate``,
    ``hash_mask``, ``fuse_dual`` and the ``out_ln`` (``v_out_ln``)
    modules."""

    def _one_tail(self, fuse):
        return fuse or (self.spec.single_ln
                        and self.hidden_rate == self.v_hidden_rate)

    def tail_seeds(self, seeds, fuse):
        """The tails' seeds (text, vision) in call order: one for a tail
        over the concatenation, else one a stream that has a tail."""
        if self._one_tail(fuse):
            return site_seed(self, self.hidden_rate, seeds), None
        spec = self.spec
        return (site_seed(self, self.hidden_rate, seeds)
                if spec.has_text else None,
                site_seed(self, self.v_hidden_rate, seeds)
                if spec.has_vision else None)

    def tails(self, t, v, outs, tail_seeds, fuse):
        """LN(dropout(o) + residual) in the sublayer's form; ``outs`` is
        the concatenated output where ``fuse``, else (t_o, v_o), None for
        a stream without this sublayer."""
        spec, lt = self.spec, t.shape[1]
        ts, vs = tail_seeds
        rate, v_rate = self.hidden_rate, self.v_hidden_rate
        if fuse and not spec.share_params:
            ln, v_ln = self.out_ln, self.v_out_ln
            y = residual_ln_seg(outs, torch.cat([t, v], 1), ln.weight,
                                ln.bias, v_ln.weight, v_ln.bias, lt, rate,
                                ts, self.hash_mask, ln.eps)
        elif self._one_tail(fuse):
            o = outs if fuse else torch.cat(outs, 1)
            y = self.out_ln(o, residual=torch.cat([t, v], 1),
                            drop_rate=rate, seed=ts)
        elif spec.single_ln:
            # distinct rates cannot share one mask draw (encoder.py
            # :309-312); a validated plan never gets here, since a single
            # LayerNorm needs shared parameters, whose rates are equal
            drop = lambda x, s, r: x if s is None \
                else hash_dropout(x, s, r)  # noqa: E731
            y = self.out_ln(torch.cat([drop(outs[0], ts, rate) + t,
                                       drop(outs[1], vs, v_rate) + v], 1))
        else:
            t_o, v_o = outs
            if t_o is not None:
                t = self.out_ln(t_o, residual=t, drop_rate=rate, seed=ts)
            if v_o is not None:
                v = _vision(self, "out_ln")(v_o, residual=v,
                                            drop_rate=v_rate, seed=vs)
            return t, v
        return y[:, :lt], y[:, lt:]


class GatedAttentionSublayer(_Tails, nn.Module):
    """Attention flows of one sublayer and their output block
    (reference: volta/encoders.py:163-449). ``forward`` is the fully fused
    form over the joined sequence: Q/K/V dense -> attention (dropout on
    the probabilities in training) -> out_dense -> LN(dropout(o) + x); it
    returns the output and the next feed-forward's keep mask, which only
    ``fuse_hidden`` draws (else None). ``streams`` is the per-stream form
    of any sublayer."""

    def __init__(self, cfg: VoltaConfig, spec: SublayerSpec):
        super().__init__()
        std, dt = cfg.initializer_range, compute_dtype(cfg)
        share = spec.share_params
        self.spec = spec
        self.natural = cfg.attn_natural_layout
        self.use_pallas = cfg.use_pallas
        self.hash_mask = cfg.use_hash_dropout
        # the static half of the JAX gate of row 9 (encoder.py:161-164)
        self.fuse_hidden = (cfg.use_pallas and cfg.fuse_hidden_dropout
                            and spec.attn_hidden_size == cfg.hidden_size)
        self.fuse_dual = _dual_fusable(cfg, spec)
        self.fuse_qkv = self.fuse_dual and share and cfg.fuse_dual_qkv
        self.num_heads = spec.num_heads
        self.head_dim = spec.attn_hidden_size // spec.num_heads
        self.v_num_heads = spec.v_num_heads
        self.v_head_dim = spec.v_attn_hidden_size // spec.v_num_heads
        self.attn_rate = cfg.attention_probs_dropout_prob
        self.v_attn_rate = self.attn_rate if share \
            else cfg.v_attention_probs_dropout_prob
        self.hidden_rate = cfg.hidden_dropout_prob
        self.v_hidden_rate = self.hidden_rate if share \
            else cfg.v_hidden_dropout_prob
        if spec.has_text:
            self.query = Dense(cfg.hidden_size, spec.attn_hidden_size, std,
                               dt)
            self.key = Dense(cfg.hidden_size, spec.attn_hidden_size, std, dt)
            self.value = Dense(cfg.hidden_size, spec.attn_hidden_size, std,
                               dt)
            self.out_dense = Dense(spec.attn_hidden_size, cfg.hidden_size,
                                   std, dt)
            self.out_ln = _make_ln(cfg, cfg.hidden_size)
        if spec.has_vision and not share:
            vw = spec.v_attn_hidden_size
            self.v_query = Dense(cfg.v_hidden_size, vw, std, dt)
            self.v_key = Dense(cfg.v_hidden_size, vw, std, dt)
            self.v_value = Dense(cfg.v_hidden_size, vw, std, dt)
            self.v_out_dense = Dense(vw, cfg.v_hidden_size, std, dt)
            self.v_out_ln = _make_ln(cfg, cfg.v_hidden_size)

    def _attend(self, q, sources, head_dim, rate, seeds, want_probs):
        """One query stream's attention over the concatenation of
        ``sources`` [(k, v, bias)], with its site's seed (encoder.py
        :83-129). Returns the context [B, Lq, H·D] and, with
        ``want_probs`` (the plain route), the probabilities after dropout,
        else None."""
        cat = lambda xs, dim: xs[0] if len(xs) == 1 \
            else torch.cat(xs, dim)  # noqa: E731
        k, v = cat([s[0] for s in sources], 1), cat([s[1] for s in sources],
                                                    1)
        bias = cat([s[2] for s in sources], -1)
        seed = site_seed(self, rate, seeds)
        rate = rate if seed is not None else 0.0
        scale = 1.0 / math.sqrt(head_dim)
        if want_probs:
            out, probs = plain_attention(q, k, v, bias, scale, rate, seed)
        else:
            out, probs = fused_attention(q, k, v, bias, scale, rate, seed,
                                         natural=self.natural,
                                         use_pallas=self.use_pallas), None
        return out.reshape(q.shape[0], q.shape[1], -1), probs

    def forward(self, x, bias, seeds=None):
        b, l, _ = x.shape
        h, d = self.num_heads, self.head_dim
        q, k, v = (_heads(m(x), h) for m in (self.query, self.key,
                                              self.value))
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
        ctx, _ = self._attend(q, [(k, v, bias)], d, self.attn_rate, seeds,
                              False)
        return self.out_ln(self.out_dense(ctx), residual=x,
                           drop_rate=self.hidden_rate,
                           seed=site_seed(self, self.hidden_rate,
                                          seeds)), None

    def streams(self, t, v, t_bias, v_bias, seeds=None, output_probs=False):
        """The sublayer per stream (encoder.py:208-327). Returns (t, v,
        (t_data, v_data) with ``output_probs`` else None)."""
        spec, lt = self.spec, t.shape[1]
        h, vh = self.num_heads, self.v_num_heads
        fuse = self.fuse_dual and not output_probs
        qt = kt = vt = qv = kv = vv = None
        if fuse and self.fuse_qkv:
            # shared weights: one projection over [text ‖ vision]
            # (encoder.py:216-227)
            joint = [m(torch.cat([t, v], 1)) for m in (self.query, self.key,
                                                       self.value)]
            qt, kt, vt = (_heads(y[:, :lt], h) for y in joint)
            qv, kv, vv = (_heads(y[:, lt:], vh) for y in joint)
        else:
            if spec.has_text:
                qt, kt, vt = (_heads(m(t), h) for m in (
                    self.query, self.key, self.value))
            if spec.has_vision:
                qv, kv, vv = (_heads(_vision(self, n)(v), vh)
                              for n in ("query", "key", "value"))
        text, vis = (kt, vt, t_bias), (kv, vv, v_bias)
        t_ctx = v_ctx = t_probs = v_probs = None
        if spec.has_text:
            t_ctx, t_probs = self._attend(
                qt, [text] * spec.has_tt + [vis] * spec.has_tv,
                self.head_dim, self.attn_rate, seeds, output_probs)
        if spec.has_vision:
            v_ctx, v_probs = self._attend(
                qv, [text] * spec.has_vt + [vis] * spec.has_vv,
                self.v_head_dim, self.v_attn_rate, seeds, output_probs)
        tail_seeds = self.tail_seeds(seeds, fuse)
        if fuse and spec.share_params:
            outs = self.out_dense(torch.cat([t_ctx, v_ctx], 1))
        else:
            outs = (None if t_ctx is None else self.out_dense(t_ctx),
                    None if v_ctx is None
                    else _vision(self, "out_dense")(v_ctx))
            if fuse:
                outs = torch.cat(outs, 1)
        t, v = self.tails(t, v, outs, tail_seeds, fuse)
        data = None
        if output_probs:
            data = _attn_data(spec, qt, kt, t_probs, qv, kv, v_probs, lt)
        return t, v, data


def _attn_data(spec, qt, kt, t_probs, qv, kv, v_probs, lt):
    """The per-stream visualization dicts of encoder.py:329-358: each
    stream's probabilities [B, H, Lq, Lk] split where its key sources meet
    ([text ‖ vision], so a vision stream with both flows splits as (vt,
    vv)) into intra- and inter-modal, None for an absent flow; queries and
    keys [B, H, L, D], None for an absent stream."""
    bhld = lambda x: None if x is None else x.transpose(1, 2)  # noqa: E731

    def split(probs, first, second):
        if probs is None:
            return None, None
        if first and second:
            return probs[..., :lt], probs[..., lt:]
        return (probs, None) if first else (None, probs)

    tt, tv = split(t_probs, spec.has_tt, spec.has_tv)
    vt, vv = split(v_probs, spec.has_vt, spec.has_vv)
    t_data = {"intra_attn": tt, "inter_attn": tv,
              "queries": bhld(qt), "keys": bhld(kt)}
    v_data = {"intra_attn": vv, "inter_attn": vt,
              "queries": bhld(qv), "keys": bhld(kv)}
    return t_data, v_data


class GatedFeedForwardSublayer(_Tails, nn.Module):
    """The feed-forwards of one sublayer (reference: volta/encoders.py
    :452-590). ``forward`` is the fully fused form over the joined
    sequence, LN(dropout(out_dense(act(inter_dense(x)))) + x); with a
    ``keep_mask`` from the attention before it, that mask and no seed of
    its own. ``streams`` is the per-stream form of any sublayer."""

    def __init__(self, cfg: VoltaConfig, spec: SublayerSpec):
        super().__init__()
        std, dt = cfg.initializer_range, compute_dtype(cfg)
        share = spec.share_params
        self.spec = spec
        self.act = ACT2FN[cfg.hidden_act]
        self.v_act = ACT2FN[cfg.hidden_act if share else cfg.v_hidden_act]
        self.hash_mask = cfg.use_hash_dropout
        self.fuse_dual = _dual_fusable(cfg, spec)
        self.hidden_rate = cfg.hidden_dropout_prob
        self.v_hidden_rate = self.hidden_rate if share \
            else cfg.v_hidden_dropout_prob
        if spec.has_t_ff:
            self.inter_dense = Dense(cfg.hidden_size, spec.intermediate_size,
                                     std, dt)
            self.out_dense = Dense(spec.intermediate_size, cfg.hidden_size,
                                   std, dt)
            self.out_ln = _make_ln(cfg, cfg.hidden_size)
        if spec.has_v_ff and not share:
            self.v_inter_dense = Dense(cfg.v_hidden_size,
                                       spec.v_intermediate_size, std, dt)
            self.v_out_dense = Dense(spec.v_intermediate_size,
                                     cfg.v_hidden_size, std, dt)
            self.v_out_ln = _make_ln(cfg, cfg.v_hidden_size)

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
        return self.out_ln(self._ffn(x, False), residual=x,
                           drop_rate=self.hidden_rate, seed=seed,
                           keep_mask=keep_mask)

    def _ffn(self, x, vision):
        if vision:
            return _vision(self, "out_dense")(self.v_act(
                _vision(self, "inter_dense")(x)))
        return self.out_dense(self.act(self.inter_dense(x)))

    def streams(self, t, v, seeds=None):
        """The sublayer per stream (encoder.py:416-471)."""
        return self.streams_body(t, v, *self.tail_seeds(seeds,
                                                        self.fuse_dual))

    def streams_body(self, t, v, t_seed, v_seed):
        """``streams`` for drawn tail seeds: it draws nothing itself."""
        spec, fuse = self.spec, self.fuse_dual
        if fuse and spec.share_params:
            # the whole shared sublayer over [text ‖ vision]
            outs = self._ffn(torch.cat([t, v], 1), False)
        else:
            outs = (self._ffn(t, False) if spec.has_t_ff else None,
                    self._ffn(v, True) if spec.has_v_ff else None)
            if fuse:
                outs = torch.cat(outs, 1)
        return self.tails(t, v, outs, (t_seed, v_seed), fuse)


class GatedEncoder(nn.Module):
    """Depth-D stack over the static sublayer plan
    (reference: volta/encoders.py:820-888). ``remat`` (the config's
    ``remat_ff``) recomputes each feed-forward sublayer in the backward."""

    def __init__(self, cfg: VoltaConfig):
        super().__init__()
        if cfg.use_scan:
            raise NotImplementedError(
                "use_scan is not ported: the port runs the stack as a loop")
        self.remat = cfg.remat_ff
        self.names = []
        plan = cfg.sublayer_plan()
        self.fused = all(_fully_fused(spec) for spec in plan)
        for spec in plan:
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
        if output_all_layers or output_probs or not self.fused:
            out = self._general(t, v, t_bias, v_bias, seeds,
                                output_all_layers, output_probs)
            return out if output_all_layers or output_probs else out[:2]
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
                                  *layer.tail_seeds(seeds, layer.fuse_dual),
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                t, v = layer.streams(t, v, seeds)
            if output_all_layers:
                all_t.append(t)
                all_v.append(v)
        return t, v, (all_t, all_v, all_probs)
