"""Bimodal joint attention: the plain composition and the dispatch point.

Counterpart of ``volta_tpu/ops/attention.py``. The reference's concat-
softmax-split over [text ‖ vision] keys is one attention over the
concatenated key axis, so each query stream runs one QKᵀ, one joint softmax
and one PV product.

Layout convention, as in the JAX package: q/k/v are [B, L, H, D]; the
additive bias is [B, 1, 1, Lk] (0 for live keys, -10000 for padding).
"""

from __future__ import annotations

import torch


def attention_scores(q, k, bias, scale):
    """Raw joint scores [B, H, Lq, Lk] in float32."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float()
    return scores


def attention_probs(q, k, bias, scale):
    """Joint softmax over the concatenated key axis, float32."""
    return torch.softmax(attention_scores(q, k, bias, scale), dim=-1)


def attention_out(probs, v):
    """[B,H,Lq,Lk] x [B,Lk,H,D] -> [B,Lq,H,D] in v.dtype: probs rounded to
    v.dtype, product accumulated in float32."""
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(v.dtype)


def fused_attention(q, k, v, bias, scale):
    """One-shot attention, [B,L,H,D] in and out, no probs for the caller.

    The single dispatch point: the natural [B, L, H·D] views go to
    ``attention_cuda.attention_fwd``, which launches the CUDA kernel for a
    CUDA tensor and runs its plain twin for a CPU tensor. Every shape the
    repo produces goes to the kernel; there is no fallback on the card.
    """
    # imported here: attention_cuda builds its twin from the functions above
    from . import attention_cuda

    b, lq, h, d = q.shape
    lk = k.shape[1]
    bias = bias.to(torch.float32).expand(b, 1, 1, lk).reshape(b, lk)
    out = attention_cuda.attention_fwd(
        q.reshape(b, lq, h * d), k.reshape(b, lk, h * d),
        v.reshape(b, lk, h * d), bias, scale, h)
    return out.view(b, lq, h, d)


def additive_mask(mask, dtype=torch.float32):
    """[B, L] 1/0 mask -> [B, 1, 1, L] additive bias with -10000 on pads
    (reference: volta/encoders.py:974-991); -10000, not -inf."""
    m = mask.to(dtype)
    return ((1.0 - m) * -10000.0)[:, None, None, :]
