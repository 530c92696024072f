"""The hand-written CUDA attention on head-major [H, B, L, D] operands
(``csrc/attention_head_major.cu``), with and without dropout on the
probabilities, forward and backward: their wrappers, their plain twins and
the autograd Functions over them.

Ports of the TPU kernels of the ``attn_natural_layout=false`` configuration
(volta_tpu/ops/pallas_attention.py), Queue 2 rows 5-8:

- row 7, ``_attn_kernel`` (:852, launched by ``_pallas_forward`` :970): the
  no-dropout forward, ``attention_head_major_fwd``;
- row 8, ``_attn_bwd_kernel`` (:907, launched by ``_attn_bwd_pallas``
  :917): its backward, the bias gradient as per-head partial sums
  [H, B, Lk] float32, ``attention_head_major_bwd``;
- row 5, ``_attn_dropout_fwd_kernel`` (:100, launched by
  ``_dropout_fwd_core`` :240): the dropout forward, which returns the 0/1
  keep mask [H, B, Lq, Lk] it applied, ``attention_dropout_head_major_fwd``;
- row 6, ``_attn_dropout_bwd_kernel`` (:169, launched by
  ``_dropout_bwd_core`` :278): its backward, which reads that mask back,
  ``attention_dropout_head_major_bwd``.

The keep bit of probability (b, h, i, j) is the counter hash of rows 3-4
(``attention_dropout_cuda.keep_mask``) over the natural [B, H, Lq, Lk]
index, stored head-major as uint8, so one seed drops the same probabilities
in both layouts. CUDA tensors take the kernels or raise; CPU tensors take
the twins. The dropout twins take the mask as an argument, in any 0/1 dtype
(the TPU kernel's bf16 included).
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from . import LAUNCHES, _build
from .attention import attention_out, attention_probs
from .attention_cuda import (DTYPE_CODE, attention_bwd_math, bwd_body,
                             check, fwd_body, launch_error)
from .attention_dropout_cuda import _check_rate, keep_mask, keep_scale
from .hash import dropout_threshold, fold_seed


def _natural(x):
    """[H, B, L, D] -> a [B, L, H, D] view, the layout of the plain
    functions of ``ops/attention.py``."""
    return x.permute(1, 2, 0, 3)


def _head_major(x, like):
    """[B, L, H, D] -> contiguous [H, B, L, D] in like's dtype."""
    return x.permute(2, 0, 1, 3).to(like.dtype).contiguous()


def keep_mask_head_major(seed: int, shape, rate: float, device=None):
    """The kernels' keep mask for ``seed``, uint8 0/1 of ``shape`` [H, B, Lq,
    Lk]: ``keep_mask`` over the natural [B, H, Lq, Lk] index, stored
    head-major."""
    h, b, lq, lk = shape
    return keep_mask(seed, (b, h, lq, lk), rate, device).transpose(
        0, 1).to(torch.uint8).contiguous()


def attention_head_major_fwd_ref(q, k, v, bias, scale):
    """Plain twin of row 7: q [H,B,Lq,D], k/v [H,B,Lk,D], bias [B,Lk]
    float32 -> [H,B,Lq,D] in q.dtype."""
    b, lk = bias.shape
    probs = attention_probs(_natural(q), _natural(k), bias.view(b, 1, 1, lk),
                            scale)
    return _head_major(attention_out(probs, _natural(v)), q)


def attention_head_major_bwd_ref(q, k, v, bias, g, scale, want_db=True):
    """Plain twin of row 8 for the output cotangent g [H,B,Lq,D]: dq, dk, dv
    in the operand dtype and, with ``want_db``, the per-head partial sums of
    the bias gradient [H,B,Lk] (dS summed over queries; float32, float64 for
    float64 operands), else None."""
    dq, dk, dv, ds = attention_bwd_math(*map(_natural, (q, k, v)), bias,
                                        _natural(g), scale)
    db_part = ds.sum(dim=2).transpose(0, 1).contiguous() if want_db else None
    return _head_major(dq, q), _head_major(dk, k), _head_major(dv, v), db_part


def attention_dropout_head_major_fwd_ref(q, k, v, bias, scale, rate, keep):
    """Plain twin of row 5 with the keep mask ``keep`` [H,B,Lq,Lk] 0/1:
    [H,B,Lq,D] in q.dtype. The keep factor is applied in float32 before the
    probabilities are rounded to v.dtype."""
    b, lk = bias.shape
    probs = attention_probs(_natural(q), _natural(k), bias.view(b, 1, 1, lk),
                            scale)
    probs = probs * (keep.transpose(0, 1).to(probs.dtype) * keep_scale(rate))
    return _head_major(attention_out(probs, _natural(v)), q)


def attention_dropout_head_major_bwd_ref(q, k, v, bias, g, keep, scale, rate):
    """Plain twin of row 6 (``_dropout_bwd_math``) with the forward's keep
    mask ``keep`` [H,B,Lq,Lk] 0/1: dq, dk, dv in the operand dtype."""
    dq, dk, dv, _ = attention_bwd_math(*map(_natural, (q, k, v)), bias,
                                       _natural(g), scale,
                                       keep.transpose(0, 1), keep_scale(rate))
    return _head_major(dq, q), _head_major(dk, k), _head_major(dv, v)


@functools.cache
def _kernels():
    lib = _build.load()
    P, I, F, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_uint32
    fwd = lib.volta_attention_head_major_fwd
    fwd.argtypes = [P] * 5 + [I] * 5 + [F, I, I, P]
    bwd = lib.volta_attention_head_major_bwd
    bwd.argtypes = [P] * 9 + [I] * 5 + [F, I, I, P]
    dfwd = lib.volta_attention_dropout_head_major_fwd
    dfwd.argtypes = [P] * 6 + [I] * 5 + [F, U, U, F, I, I, P]
    dbwd = lib.volta_attention_dropout_head_major_bwd
    dbwd.argtypes = [P] * 9 + [I] * 5 + [F, F, I, I, P]
    for fn in (fwd, bwd, dfwd, dbwd):
        fn.restype = I
    lib.volta_cuda_error_string.argtypes = [I]
    lib.volta_cuda_error_string.restype = ctypes.c_char_p
    return fwd, bwd, dfwd, dbwd, lib.volta_cuda_error_string


def _dims(q, k):
    """(H, B, Lq, Lk, D) of head-major operands."""
    h, b, lq, d = q.shape
    return h, b, lq, k.shape[2], d


def _launch(name, which, *args):
    fns = _kernels()
    rc = fns[which](*args)
    if rc != 0:
        raise launch_error(name, rc, fns[-1])
    LAUNCHES[name] += 1


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def attention_head_major_fwd(q, k, v, bias, scale):
    """softmax(q·kᵀ·scale + bias)·v per head: q [H,B,Lq,D], k/v [H,B,Lk,D]
    (bf16 or fp32), bias [B,Lk] float32 -> [H,B,Lq,D] in q.dtype. The body
    of row 1 by dtype (``fwd_body``: tensor cores for bf16, CUDA cores for
    fp32) with head-major addressing, so it computes row 1's bits. CPU
    tensors take the plain twin."""
    if q.device.type == "cpu":
        return attention_head_major_fwd_ref(q, k, v, bias, scale)
    _, rows, smem = fwd_body(q.dtype)
    check("attention_head_major_fwd", q, k, v, bias, None, smem,
          head_major=True, rows=rows)
    h, b, lq, lk, d = _dims(q, k)
    out = torch.empty_like(q)
    _launch("attention_head_major_fwd", 0, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), bias.data_ptr(), out.data_ptr(), b, lq, lk, h, d,
            float(scale), DTYPE_CODE[q.dtype], q.device.index, _stream(q))
    return out


def attention_head_major_bwd(q, k, v, bias, g, scale, want_db=False):
    """The backward of ``attention_head_major_fwd`` for its output
    cotangent g [H,B,Lq,D]: dq, dk, dv in the operand dtype and, with
    ``want_db``, the per-head partial sums of the bias gradient [H,B,Lk]
    float32 (else None). The body of row 2 by dtype (``bwd_body``: tensor
    cores for bf16, CUDA cores for fp32) with head-major addressing, so it
    computes row 2's bits. CPU tensors take the plain twin."""
    if q.device.type == "cpu":
        return attention_head_major_bwd_ref(q, k, v, bias, g, scale, want_db)
    check("attention_head_major_bwd", q, k, v, bias, None,
          bwd_body(q.dtype)[1], g=g, head_major=True)
    h, b, lq, lk, d = _dims(q, k)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    db_part = torch.empty((h, b, lk), dtype=torch.float32,
                          device=q.device) if want_db else None
    _launch("attention_head_major_bwd", 1, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), bias.data_ptr(), g.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            db_part.data_ptr() if want_db else None, b, lq, lk, h, d,
            float(scale), DTYPE_CODE[q.dtype], q.device.index, _stream(q))
    return dq, dk, dv, db_part


def attention_dropout_head_major_fwd(q, k, v, bias, scale, rate, seed):
    """dropout(softmax(q·kᵀ·scale + bias))·v per head on head-major
    operands, the mask drawn from the uint32 ``seed``: q [H,B,Lq,D], k/v
    [H,B,Lk,D], bias [B,Lk] float32 -> (out [H,B,Lq,D] in q.dtype, the keep
    mask [H,B,Lq,Lk] uint8 0/1 that was applied). The body of row 3 by
    dtype (``fwd_body(dtype, dropout=True)``: tensor cores for bf16, CUDA
    cores for fp32) with head-major addressing, so it computes row 3's and
    row 9's bits. CPU tensors take the plain twin with
    ``keep_mask_head_major(seed, ...)``."""
    _check_rate(rate, seed)
    h, b, lq, lk, d = _dims(q, k)
    if q.device.type == "cpu":
        keep = keep_mask_head_major(seed, (h, b, lq, lk), rate)
        return attention_dropout_head_major_fwd_ref(q, k, v, bias, scale,
                                                    rate, keep), keep
    _, rows, smem = fwd_body(q.dtype, dropout=True)
    check("attention_dropout_head_major_fwd", q, k, v, bias, None, smem,
          head_major=True, rows=rows)
    out = torch.empty_like(q)
    mask = torch.empty((h, b, lq, lk), dtype=torch.uint8, device=q.device)
    _launch("attention_dropout_head_major_fwd", 2, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
            mask.data_ptr(), b, lq, lk, h, d, float(scale), seed,
            dropout_threshold(rate), keep_scale(rate), DTYPE_CODE[q.dtype],
            q.device.index, _stream(q))
    return out, mask


def attention_dropout_head_major_bwd(q, k, v, bias, g, mask, scale, rate):
    """The backward of ``attention_dropout_head_major_fwd`` for the output
    cotangent g [H,B,Lq,D] and the forward's keep mask (uint8 [H,B,Lq,Lk]
    on the card): dq, dk, dv in the operand dtype. The body of row 4 by
    dtype (``bwd_body(dtype, dropout=True)``) with head-major addressing,
    the keep bits read from the mask, so it computes row 4's bits. CPU
    tensors take the plain twin."""
    _check_rate(rate, 0)
    if q.device.type == "cpu":
        return attention_dropout_head_major_bwd_ref(q, k, v, bias, g, mask,
                                                    scale, rate)
    name = "attention_dropout_head_major_bwd"
    check(name, q, k, v, bias, None, bwd_body(q.dtype, dropout=True)[1], g=g,
          head_major=True)
    h, b, lq, lk, d = _dims(q, k)
    if (mask.dtype != torch.uint8 or mask.device != q.device
            or mask.shape != (h, b, lq, lk) or not mask.is_contiguous()):
        raise ValueError(f"{name}: mask must be contiguous uint8 "
                         f"{(h, b, lq, lk)} on {q.device}, got {mask.dtype} "
                         f"{tuple(mask.shape)} on {mask.device}")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    _launch(name, 3, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr(), g.data_ptr(), mask.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, lq, lk, h, d, float(scale),
            keep_scale(rate), DTYPE_CODE[q.dtype], q.device.index,
            _stream(q))
    return dq, dk, dv


class HeadMajorAttention(torch.autograd.Function):
    """No-dropout attention on [H, B, L, D] operands, bias [B, Lk] float32:
    forward row 7, backward row 8 (the kernels on the card, the twins on the
    CPU). The bias gradient, the per-head partials summed over heads as the
    TPU rule sums them (pallas_attention.py:941), is computed only when the
    bias requires one."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        return attention_head_major_fwd(q, k, v, bias, scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv, db_part = attention_head_major_bwd(
            q, k, v, bias, g.contiguous(), ctx.scale,
            want_db=ctx.needs_input_grad[3])
        db = db_part.sum(dim=0) if db_part is not None else None
        return dq, dk, dv, db, None


class HeadMajorDropoutAttention(torch.autograd.Function):
    """Attention with dropout ``rate`` on the probabilities of [H, B, L, D]
    operands, mask from the uint32 ``seed``: forward row 5, whose keep mask
    is saved with q, k, v and bias; backward row 6, which reads it. The bias
    gets no gradient, as in the TPU rule (``_dropout_bwd_rule`` returns
    zeros for it). The seed is folded for the rank's natural [B, H, Lq,
    Lk], the index the mask hashes (``hash.fold_seed``)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, rate, seed):
        seed = fold_seed(seed, q.shape[1] * q.shape[0] * q.shape[2]
                         * k.shape[2])
        out, mask = attention_dropout_head_major_fwd(q, k, v, bias, scale,
                                                     rate, seed)
        ctx.save_for_backward(q, k, v, bias, mask)
        ctx.args = (scale, rate)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, bias, mask = ctx.saved_tensors
        dq, dk, dv = attention_dropout_head_major_bwd(
            q, k, v, bias, g.contiguous(), mask, *ctx.args)
        return dq, dk, dv, None, None, None, None
