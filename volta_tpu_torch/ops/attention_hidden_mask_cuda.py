"""The hand-written CUDA dropout attention that also draws the keep masks of
the two hidden dropouts after it (``csrc/attention_head_major.cu``), its
wrapper, its plain twin and the autograd Function over it.

Port of the TPU kernel of ``fuse_hidden_dropout``, Queue 2 row 9:
``_attn_dropout_fwd_hm_kernel`` (volta_tpu/ops/pallas_attention.py:125,
launched by ``_dropout_hm_fwd_impl`` :809 behind
``pallas_dropout_attention_hm`` :779). On head-major [H, B, L, D] operands
it computes row 5's function and probability keep mask on row 5's body (row
3's: tensor cores in bf16, CUDA cores in fp32), so its output and mask are
row 5's to the bit on the same operands, and writes two uint8 0/1 hidden
keep masks [B, Lq, H·D], in the layout of the out-dense output that they
mask: ``hm0`` for the attention sublayer's own tail, ``hm1`` for
the next feed-forward's. Mask m keeps element i (the linear index of
[B, Lq, H·D]) iff ``hash_keep(i, seed_m, hidden_rate)``, so a tail that
applies it drops what ``hash_dropout`` drops with the same seed; the TPU
draws both from its PRNG head-major and transposes them afterwards
(:796). The backward is row 6 (``_dropout_hm_bwd_rule`` :841 runs
``_dropout_bwd_rule``), which reads row 9's probability mask.

CUDA tensors take the kernel or raise; CPU tensors take the twin.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from . import LAUNCHES, _build
from . import attention_head_major_cuda as ahm
from . import dropout_mask as dm
from .attention_cuda import DTYPE_CODE, check, fwd_body, launch_error
from .attention_dropout_cuda import _check_rate, keep_scale
from .hash import dropout_threshold, fold_seed


def attention_dropout_hidden_masks_fwd_ref(q, k, v, bias, scale, rate, seed,
                                           hidden_rate, hseed0, hseed1):
    """Plain twin: row 5's twin with its head-major hash mask for ``seed``,
    and the hidden masks, row 14's twin over [B, Lq, H·D] for ``hseed0``
    and ``hseed1``. Returns (out [H,B,Lq,D], mask [H,B,Lq,Lk], hm0, hm1),
    the masks uint8 0/1."""
    h, b, lq, d = q.shape
    keep = ahm.keep_mask_head_major(seed, (h, b, lq, k.shape[2]), rate,
                                    device=q.device)
    out = ahm.attention_dropout_head_major_fwd_ref(q, k, v, bias, scale, rate,
                                                   keep)
    shape = (b, lq, h * d)
    return (out, keep,
            dm.keep_mask_ref(shape, hidden_rate, hseed0, q.device),
            dm.keep_mask_ref(shape, hidden_rate, hseed1, q.device))


@functools.cache
def _kernel():
    lib = _build.load()
    P, I, F, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_uint32
    fn = lib.volta_attention_dropout_hidden_masks_fwd
    fn.argtypes = [P] * 8 + [I] * 5 + [F, U, U, F, U, U, U, I, I, P]
    fn.restype = I
    lib.volta_cuda_error_string.argtypes = [I]
    lib.volta_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.volta_cuda_error_string


def attention_dropout_hidden_masks_fwd(q, k, v, bias, scale, rate, seed,
                                       hidden_rate, hseed0, hseed1):
    """Row 5 on head-major q [H,B,Lq,D], k/v [H,B,Lk,D] (bf16 or fp32),
    bias [B,Lk] float32, its mask from the uint32 ``seed``, plus the hidden
    keep masks at ``hidden_rate`` for the uint32 seeds ``hseed0`` and
    ``hseed1``: (out [H,B,Lq,D] in q.dtype, mask [H,B,Lq,Lk], hm0, hm1
    [B,Lq,H·D]), the masks uint8 0/1. bf16 runs row 3's tensor-core body,
    fp32 the CUDA-core body (``fwd_body(dtype, dropout=True)``). CPU
    tensors take the plain twin."""
    _check_rate(rate, seed)
    for s in (hseed0, hseed1):
        _check_rate(hidden_rate, s)
    if q.device.type == "cpu":
        return attention_dropout_hidden_masks_fwd_ref(
            q, k, v, bias, scale, rate, seed, hidden_rate, hseed0, hseed1)
    name = "attention_dropout_hidden_masks_fwd"
    _, rows, smem = fwd_body(q.dtype, dropout=True)
    check(name, q, k, v, bias, None, smem, head_major=True, rows=rows)
    h, b, lq, d = q.shape
    lk = k.shape[2]
    out = torch.empty_like(q)
    mask = torch.empty((h, b, lq, lk), dtype=torch.uint8, device=q.device)
    hm0, hm1 = (torch.empty((b, lq, h * d), dtype=torch.uint8,
                            device=q.device) for _ in range(2))
    fn, err_str = _kernel()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), mask.data_ptr(), hm0.data_ptr(), hm1.data_ptr(),
            b, lq, lk, h, d, float(scale), seed, dropout_threshold(rate),
            keep_scale(rate), hseed0, hseed1, dropout_threshold(hidden_rate),
            DTYPE_CODE[q.dtype], q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise launch_error(name, rc, err_str)
    LAUNCHES[name] += 1
    return out, mask, hm0, hm1


class HiddenMaskDropoutAttention(torch.autograd.Function):
    """Row 9 forward, row 6 backward, on [H, B, L, D] operands: returns
    (out, hm0, hm1). The probability mask is saved for row 6; the hidden
    masks are outputs without a gradient, and the bias gets none, as in the
    TPU rule. The seeds are folded for the rank's [B, H, Lq, Lk] and [B,
    Lq, H·D] (``hash.fold_seed``)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, rate, seed, hidden_rate, hseed0,
                hseed1):
        h, b, lq, _ = q.shape
        seed = fold_seed(seed, b * h * lq * k.shape[2])
        hseed0, hseed1 = (fold_seed(s, q.numel()) for s in (hseed0, hseed1))
        out, mask, hm0, hm1 = attention_dropout_hidden_masks_fwd(
            q, k, v, bias, scale, rate, seed, hidden_rate, hseed0, hseed1)
        ctx.save_for_backward(q, k, v, bias, mask)
        ctx.mark_non_differentiable(hm0, hm1)
        ctx.args = (scale, rate)
        return out, hm0, hm1

    @staticmethod
    @once_differentiable
    def backward(ctx, g, _g0, _g1):
        q, k, v, bias, mask = ctx.saved_tensors
        dq, dk, dv = ahm.attention_dropout_head_major_bwd(
            q, k, v, bias, g.contiguous(), mask, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None
