"""Bimodal joint attention: the plain composition and the dispatch point.

Counterpart of ``volta_tpu/ops/attention.py``. The reference's concat-
softmax-split over [text ‖ vision] keys is one attention over the
concatenated key axis, so each query stream runs one QKᵀ, one joint softmax
and one PV product.

Layout convention, as in the JAX package: q/k/v are [B, L, H, D]; the
additive bias is [B, 1, 1, Lk] (0 for live keys, -10000 for padding).
The plain functions compute in float32, or in float64 for float64 inputs.

``fused_attention`` keeps JAX's gate (volta_tpu/ops/attention.py:61): the
CUDA kernels run with ``use_pallas``, a bias and Lq >= 8; anything else
runs ``plain_attention``, the composition of the functions below on
whatever device the tensors are on, which is JAX's XLA path and not a
kernel's twin standing in for a kernel. That route drops the
probabilities as JAX's ``_attend`` does with ``nn.Dropout``
(volta_tpu/models/encoder.py:118-122): Bernoulli(1 - rate) keep bits,
here uint32 draws from the site's seed against the rate's threshold
(``probs_keep``), kept values divided by 1 - rate.
"""

from __future__ import annotations

import torch

from . import in_kernel_export
from .hash import dropout_threshold, seeded_bits


def acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype the plain functions accumulate in for operands like x."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def attention_scores(q, k, bias, scale):
    """Raw joint scores [B, H, Lq, Lk] in float32."""
    acc = acc_dtype(q)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    if bias is not None:
        scores = scores + bias.to(acc)
    return scores


def attention_probs(q, k, bias, scale):
    """Joint softmax over the concatenated key axis, float32."""
    return torch.softmax(attention_scores(q, k, bias, scale), dim=-1)


def attention_out(probs, v):
    """[B,H,Lq,Lk] x [B,Lk,H,D] -> [B,Lq,H,D] in v.dtype: probs rounded to
    v.dtype, product accumulated in float32."""
    acc = acc_dtype(v)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).to(acc),
                       v.to(acc))
    return out.to(v.dtype)


def _bias2(bias, b, lk):
    """An additive bias that broadcasts to [B, 1, 1, Lk] as the kernels'
    [B, Lk] float32."""
    return bias.to(torch.float32).expand(b, 1, 1, lk).reshape(b, lk)


def probs_keep(shape, rate: float, seed: int, device) -> torch.Tensor:
    """The plain route's keep bits for attention probabilities of
    ``shape``: the uint32 draws of the site's ``seed`` below the threshold
    of ``rate``, as ``int_threshold_dropout`` draws them."""
    return seeded_bits(shape, seed, device) < dropout_threshold(rate)


def plain_attention(q, k, v, bias, scale, dropout_rate: float = 0.0,
                    seed: int = None):
    """JAX's XLA attention (``_attend``'s plain branch, volta_tpu/models
    /encoder.py:118-122): the joint softmax, dropped with ``probs_keep``'s
    bits when ``dropout_rate > 0``, times v. Returns (out [B, Lq, H, D],
    the probabilities after dropout [B, H, Lq, Lk] float32). No kernel
    runs; the bias may be None."""
    # imported here: hash_dropout's module imports this one
    from .hash_dropout import apply_keep_mask

    probs = attention_probs(q, k, bias, scale)
    if dropout_rate > 0.0:
        if seed is None:
            raise ValueError("plain_attention: dropout needs a seed")
        probs = apply_keep_mask(
            probs, probs_keep(probs.shape, dropout_rate, seed, probs.device),
            dropout_rate)
    return attention_out(probs, v), probs


def fused_attention(q, k, v, bias, scale, dropout_rate: float = 0.0,
                    seed: int = None, natural: bool = True,
                    use_pallas: bool = True):
    """One-shot attention, [B,L,H,D] in and out, no probs for the caller.

    The single dispatch point. Outside JAX's gate of the kernels
    (volta_tpu/ops/attention.py:61, encoder.py:99-100: ``use_pallas``, a
    bias and Lq >= 8) it is ``plain_attention``. Inside, with
    ``dropout_rate > 0`` (training) the
    natural [B, L, H·D] views go to ``attention_dropout_cuda
    .DropoutAttention`` with the call's uint32 ``seed``; anything else goes
    to ``attention_cuda.FusedAttention``. With ``natural=False`` (the
    config's ``attn_natural_layout: false``) q, k and v are copied
    head-major, [H, B, L, D], for ``attention_head_major_cuda``'s
    ``HeadMajorDropoutAttention`` or ``HeadMajorAttention``, and the output
    is transposed back, as the TPU path does around its head-major kernels
    (pallas_attention.py:264-270, 979-981, 1011). All are autograd
    Functions whose forward and backward launch the CUDA kernels for CUDA
    tensors and run their plain twins for CPU tensors; there is no fallback
    on the card. While ``torch.export`` traces a kernel artifact
    (``in_kernel_export``) the no-dropout forwards are the registered ops
    ``volta::attention_fwd`` and ``volta::attention_head_major_fwd``
    (``ops.library``) instead.
    """
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("fused_attention: dropout needs a seed")
    if not (use_pallas and bias is not None and q.shape[1] >= 8):
        return plain_attention(q, k, v, bias, scale, dropout_rate, seed)[0]
    # imported here: the wrappers build their twins from the functions above
    from . import attention_cuda, attention_dropout_cuda, \
        attention_head_major_cuda

    b, lq, h, d = q.shape
    lk = k.shape[1]
    bias = _bias2(bias, b, lk)
    if not natural:
        qh, kh, vh = (x.permute(2, 0, 1, 3).contiguous() for x in (q, k, v))
        if dropout_rate > 0.0:
            out = attention_head_major_cuda.HeadMajorDropoutAttention.apply(
                qh, kh, vh, bias, scale, float(dropout_rate), int(seed))
        elif in_kernel_export():
            out = torch.ops.volta.attention_head_major_fwd(qh, kh, vh, bias,
                                                           scale)
        else:
            out = attention_head_major_cuda.HeadMajorAttention.apply(
                qh, kh, vh, bias, scale)
        return out.permute(1, 2, 0, 3)
    q3, k3, v3 = (q.reshape(b, lq, h * d), k.reshape(b, lk, h * d),
                  v.reshape(b, lk, h * d))
    if dropout_rate > 0.0:
        out = attention_dropout_cuda.DropoutAttention.apply(
            q3, k3, v3, bias, scale, h, float(dropout_rate), int(seed))
    elif in_kernel_export():
        out = torch.ops.volta.attention_fwd(q3, k3, v3, bias, scale, h)
    else:
        out = attention_cuda.FusedAttention.apply(q3, k3, v3, bias, scale, h)
    return out.view(b, lq, h, d)


def dropout_attention_head_major(qh, kh, vh, bias, scale, rate, seed):
    """Attention with dropout ``rate`` on operands already head-major,
    [H, B, L, D] in and out, with no layout copies: the port of
    ``dropout_attention_head_major`` (pallas_attention.py:316-358). The bias
    broadcasts to [B, 1, 1, Lk]; it gets no gradient."""
    from . import attention_head_major_cuda

    bias = _bias2(bias, qh.shape[1], kh.shape[2])
    return attention_head_major_cuda.HeadMajorDropoutAttention.apply(
        qh, kh, vh, bias, scale, float(rate), int(seed))


def dropout_attention_hidden_masks(q, k, v, bias, scale, rate, hidden_rate,
                                   seeds3):
    """Attention with dropout ``rate`` on the probabilities that also draws
    the keep masks of the two hidden dropouts after it: the port of
    ``pallas_dropout_attention_hm`` (pallas_attention.py:779-798). q, k, v
    are [B, L, H, D]; ``seeds3`` the uint32 seeds of the attention dropout,
    of the sublayer's tail and of the next feed-forward's tail. Always
    head-major, with the layout copies of ``fused_attention(natural=False)``,
    as the JAX entry is (:814). Returns (out [B, Lq, H, D], hm0, hm1), the
    masks uint8 0/1 [B, Lq, H·D] for ``hidden_rate``; the bias gets no
    gradient."""
    from . import attention_hidden_mask_cuda

    b, lq, h, d = q.shape
    bias = _bias2(bias, b, k.shape[1])
    qh, kh, vh = (x.permute(2, 0, 1, 3).contiguous() for x in (q, k, v))
    seed, hseed0, hseed1 = (int(s) for s in seeds3)
    out, hm0, hm1 = \
        attention_hidden_mask_cuda.HiddenMaskDropoutAttention.apply(
            qh, kh, vh, bias, scale, float(rate), seed, float(hidden_rate),
            hseed0, hseed1)
    return out.permute(1, 2, 0, 3), hm0, hm1


def additive_mask(mask, dtype=torch.float32):
    """[B, L] 1/0 mask -> [B, 1, 1, L] additive bias with -10000 on pads
    (reference: volta/encoders.py:974-991); -10000, not -inf."""
    m = mask.to(dtype)
    return ((1.0 - m) * -10000.0)[:, None, None, :]
