"""Bimodal joint attention: the plain composition and the dispatch point.

Counterpart of ``volta_tpu/ops/attention.py``. The reference's concat-
softmax-split over [text ‖ vision] keys is one attention over the
concatenated key axis, so each query stream runs one QKᵀ, one joint softmax
and one PV product.

Layout convention, as in the JAX package: q/k/v are [B, L, H, D]; the
additive bias is [B, 1, 1, Lk] (0 for live keys, -10000 for padding).
The plain functions compute in float32, or in float64 for float64 inputs.
"""

from __future__ import annotations

import torch


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


def fused_attention(q, k, v, bias, scale, dropout_rate: float = 0.0,
                    seed: int = None):
    """One-shot attention, [B,L,H,D] in and out, no probs for the caller.

    The single dispatch point. With ``dropout_rate > 0`` (training) the
    natural [B, L, H·D] views go to ``attention_dropout_cuda
    .DropoutAttention`` with the call's uint32 ``seed``; anything else goes
    to ``attention_cuda.FusedAttention``. Both are autograd Functions whose
    forward and backward launch the CUDA kernels for CUDA tensors and run
    their plain twins for CPU tensors; there is no fallback on the card.
    """
    # imported here: the wrappers build their twins from the functions above
    from . import attention_cuda, attention_dropout_cuda

    b, lq, h, d = q.shape
    lk = k.shape[1]
    bias = bias.to(torch.float32).expand(b, 1, 1, lk).reshape(b, lk)
    q3, k3, v3 = (q.reshape(b, lq, h * d), k.reshape(b, lk, h * d),
                  v.reshape(b, lk, h * d))
    if dropout_rate > 0.0:
        if seed is None:
            raise ValueError("fused_attention: dropout needs a seed")
        out = attention_dropout_cuda.DropoutAttention.apply(
            q3, k3, v3, bias, scale, h, float(dropout_rate), int(seed))
    else:
        out = attention_cuda.FusedAttention.apply(q3, k3, v3, bias, scale, h)
    return out.view(b, lq, h, d)


def additive_mask(mask, dtype=torch.float32):
    """[B, L] 1/0 mask -> [B, 1, 1, L] additive bias with -10000 on pads
    (reference: volta/encoders.py:974-991); -10000, not -inf."""
    m = mask.to(dtype)
    return ((1.0 - m) * -10000.0)[:, None, None, :]
