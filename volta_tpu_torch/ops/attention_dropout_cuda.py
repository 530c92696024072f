"""The hand-written CUDA attention with dropout on the probabilities
(``csrc/attention_dropout.cu``), forward and backward, their wrappers,
their plain twins and the autograd Function over them.

Ports of the TPU kernels of the training path
``pallas_dropout_attention(natural=True)`` (volta_tpu/ops/pallas_attention.py
:213-227, 510-629): ``_attn_dropout_fwd_kernel_nat_bh`` and
``_attn_dropout_bwd_kernel_nat_bh``. The TPU saves the Mosaic PRNG's keep
mask for the backward; here the mask is the counter hash of
``hash_dropout`` over the [B, H, Lq, Lk] probabilities with a uint32 seed
per call, so the backward kernel replays it and no mask is saved. The twins
take the keep mask as an argument (``keep_mask`` builds the kernels' one),
so tests can feed them any mask, the Mosaic interpreter's all-keep mask
included. CUDA tensors take the kernels or raise; CPU tensors take the
twins.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from . import LAUNCHES, _build
from .attention import attention_out, attention_probs
from .attention_cuda import (DTYPE_CODE, _heads4, attention_bwd_math,
                             bwd_body, check, fwd_body, launch_error)
from .hash import dropout_threshold, fold_seed, hash_keep


def keep_scale(rate: float) -> float:
    """The factor of a kept probability, float32(1 / (1 - rate)), as the TPU
    kernels apply it (pallas_attention.py:96, 151)."""
    return float(np.float32(1.0 / (1.0 - rate)))


def keep_mask(seed: int, shape, rate: float, device=None) -> torch.Tensor:
    """The kernels' keep mask for ``seed``: bool [B, H, Lq, Lk], element n
    (linear index) kept iff fmix32(n * 0x9E3779B9 + seed) < threshold."""
    n = torch.arange(int(np.prod(shape)), dtype=torch.int64, device=device)
    return hash_keep(n.view(tuple(shape)), seed, rate)


def attention_dropout_fwd_ref(q, k, v, bias, scale, heads, rate, keep):
    """Plain twin of the forward: q [B,Lq,H·D], k/v [B,Lk,H·D], bias [B,Lk]
    float32, keep [B,H,Lq,Lk] 0/1 -> [B,Lq,H·D] in q.dtype. The keep factor
    is applied in float32 before the probabilities are rounded to v.dtype."""
    b, lq, hd = q.shape
    lk = k.shape[1]
    d = hd // heads
    probs = attention_probs(q.view(b, lq, heads, d), k.view(b, lk, heads, d),
                            bias.view(b, 1, 1, lk), scale)
    probs = probs * (keep.to(probs.dtype) * keep_scale(rate))
    out = attention_out(probs, v.view(b, lk, heads, d))
    return out.to(q.dtype).reshape(b, lq, hd)


def attention_dropout_bwd_ref(q, k, v, bias, g, scale, heads, rate, keep):
    """Plain twin of the backward (``_dropout_bwd_math``): dq, dk, dv in the
    operand dtype for the output cotangent g [B,Lq,H·D] and keep mask
    [B,H,Lq,Lk]."""
    dq, dk, dv, _ = attention_bwd_math(
        *(_heads4(x, heads) for x in (q, k, v)), bias, _heads4(g, heads),
        scale, keep, keep_scale(rate))
    flat = lambda x, like: x.to(like.dtype).reshape(like.shape)  # noqa: E731
    return flat(dq, q), flat(dk, k), flat(dv, v)


def _check_rate(rate, seed):
    if not 0.0 < rate < 1.0:
        raise ValueError(f"attention dropout rate must be in (0, 1), "
                         f"got {rate}")
    if not 0 <= seed < 2**32:
        raise ValueError(f"attention dropout seed must be a uint32, "
                         f"got {seed}")


@functools.cache
def _kernels():
    lib = _build.load()
    P, I, F, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_uint32
    fwd = lib.volta_attention_dropout_fwd
    fwd.argtypes = [P] * 6 + [I] * 5 + [F, U, U, F, I, I, P]
    fwd.restype = I
    bwd = lib.volta_attention_dropout_bwd
    bwd.argtypes = [P] * 8 + [I] * 5 + [F, U, U, F, I, I, P]
    bwd.restype = I
    lib.volta_cuda_error_string.argtypes = [I]
    lib.volta_cuda_error_string.restype = ctypes.c_char_p
    return fwd, bwd, lib.volta_cuda_error_string


def attention_dropout_fwd(q, k, v, bias, scale, heads, rate, seed,
                          return_mask=False):
    """dropout(softmax(q·kᵀ·scale + bias))·v per head on the natural layout,
    the mask drawn from the uint32 ``seed``: q [B,Lq,H·D], k/v [B,Lk,H·D]
    (bf16 or fp32), bias [B,Lk] float32 -> [B,Lq,H·D] in q.dtype; with
    ``return_mask`` also the bool keep mask [B,H,Lq,Lk] that was applied.
    bf16 runs the tensor-core body, fp32 the CUDA-core body (``fwd_body(
    dtype, dropout=True)``). CPU tensors take the plain twin with
    ``keep_mask(seed, ...)``."""
    _check_rate(rate, seed)
    b, lq, hd = q.shape
    lk = k.shape[1]
    shape = (b, heads, lq, lk)
    if q.device.type == "cpu":
        keep = keep_mask(seed, shape, rate)
        out = attention_dropout_fwd_ref(q, k, v, bias, scale, heads, rate,
                                        keep)
        return (out, keep) if return_mask else out
    _, rows, smem = fwd_body(q.dtype, dropout=True)
    check("attention_dropout_fwd", q, k, v, bias, heads, smem, rows=rows)
    fn, _, err_str = _kernels()
    out = torch.empty_like(q)
    mask = torch.empty(shape, dtype=torch.uint8, device=q.device) \
        if return_mask else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), mask.data_ptr() if return_mask else None, b, lq,
            lk, heads, hd // heads, float(scale), seed,
            dropout_threshold(rate), keep_scale(rate), DTYPE_CODE[q.dtype],
            q.device.index, stream)
    if rc != 0:
        raise launch_error("attention_dropout_fwd", rc, err_str)
    LAUNCHES["attention_dropout_fwd"] += 1
    return (out, mask.bool()) if return_mask else out


def attention_dropout_bwd(q, k, v, bias, g, scale, heads, rate, seed):
    """The backward of ``attention_dropout_fwd`` for the same ``seed`` and
    the output cotangent g [B,Lq,H·D]: dq, dk, dv in the operand dtype. The
    kernel replays the mask's hash; bf16 runs the tensor-core body, fp32
    the CUDA-core body (``bwd_body(dtype, dropout=True)``). CPU tensors take
    the plain twin."""
    _check_rate(rate, seed)
    b, lq, hd = q.shape
    lk = k.shape[1]
    if q.device.type == "cpu":
        keep = keep_mask(seed, (b, heads, lq, lk), rate)
        return attention_dropout_bwd_ref(q, k, v, bias, g, scale, heads,
                                         rate, keep)
    check("attention_dropout_bwd", q, k, v, bias, heads,
          bwd_body(q.dtype, dropout=True)[1], g=g)
    _, fn, err_str = _kernels()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, lq,
            lk, heads, hd // heads, float(scale), seed,
            dropout_threshold(rate), keep_scale(rate), DTYPE_CODE[q.dtype],
            q.device.index, stream)
    if rc != 0:
        raise launch_error("attention_dropout_bwd", rc, err_str)
    LAUNCHES["attention_dropout_bwd"] += 1
    return dq, dk, dv


class DropoutAttention(torch.autograd.Function):
    """Attention with dropout ``rate`` on the probabilities, mask from the
    uint32 ``seed``: forward ``attention_dropout_fwd``, backward
    ``attention_dropout_bwd`` (the kernels on the card, the twins on the
    CPU). Saves q, k, v and bias, no mask. The bias gets no gradient, as in
    the TPU rule (``_nat_bwd_rule`` returns zeros for it). The seed is
    folded for the rank's [B, H, Lq, Lk] (``hash.fold_seed``)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, heads, rate, seed):
        seed = fold_seed(seed, q.shape[0] * heads * q.shape[1] * k.shape[1])
        ctx.save_for_backward(q, k, v, bias)
        ctx.args = (scale, heads, rate, seed)
        return attention_dropout_fwd(q, k, v, bias, scale, heads, rate, seed)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv = attention_dropout_bwd(q, k, v, bias, g.contiguous(),
                                           *ctx.args)
        return dq, dk, dv, None, None, None, None, None
