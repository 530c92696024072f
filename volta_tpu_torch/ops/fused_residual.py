"""The hand-written CUDA dropout + residual + LayerNorm
(``csrc/fused_residual.cu``), forward and backward, their wrappers, their
plain twins and the autograd Function over them.

Ports of the TPU kernels behind ``dropout_residual_ln``
(volta_tpu/ops/fused_residual.py:49-91, 113-202): ``_fwd_kernel`` computes
LN(dropout(o) + x) in one pass and ``_bwd_kernel`` its VJP. Numerics follow
those kernels, not the unfused composition: o is upcast to float32 and
dropped there (od = keep ? o·float32(1/(1 − rate)) : 0), s = od + x in
float32 gives the statistics, y is stored in o's dtype and od is saved
rounded to it; the backward recomputes s from the saved od.

The backward kernel walks bands of rows on a grid of one wave, as the
LayerNorm backward does (``layernorm.band_blocks``), and sums dscale and
dbias on the card in a fixed order into one workspace
(``layernorm.bwd_workspace``): no host-launched reduction follows it.

The TPU draws the mask from the Mosaic PRNG and saves it. Here it is the
counter hash of ``hash_dropout`` over o's linear index with the site's
uint32 seed, so the fused tail drops exactly the elements
``hash_dropout(o, seed, rate)`` drops, and the backward kernel replays it:
no mask is saved, and the keep bit never comes from ``od != 0``. The twins
take the keep mask as an argument (``attention_dropout_cuda.keep_mask``
builds the kernels' one), so tests can feed them any mask. CUDA tensors
take the kernels or raise; CPU tensors take the twins.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from . import LAUNCHES, _build
from .attention_cuda import DTYPE_CODE, launch_error
from .attention_dropout_cuda import keep_mask, keep_scale
from .hash import dropout_threshold, fold_seed
from .layernorm import (BAND_WARPS, LN_EPS, band_blocks, band_capacity,
                        bwd_workspace, check_rows, ln_rows, ln_rows_vjp)


def dropout_residual_ln_fwd_ref(o, x, weight, bias, keep, rate, eps):
    """Plain twin of the forward: o, x [n, d] (one dtype), weight and bias
    [d], keep [n, d] bool -> y and od [n, d] in o.dtype, mean and rstd [n]
    float32."""
    od = torch.where(keep, o.float() * keep_scale(rate), 0.0)
    y, mean, rstd = ln_rows(od + x.float(), weight, bias, eps)
    return y.to(o.dtype), od.to(o.dtype), mean, rstd


def dropout_residual_ln_bwd_ref(g, od, x, weight, mean, rstd, keep, rate):
    """Plain twin of the backward (``_bwd_xla``,
    volta_tpu/ops/fused_residual.py:139-165): for the output cotangent g
    [n, d], do and dx [n, d] in g.dtype and dscale, dbias [d] float32."""
    ds, dw, db = ln_rows_vjp(g, od.float() + x.float(), weight, mean, rstd)
    do = torch.where(keep, ds * keep_scale(rate), 0.0)
    return do.to(g.dtype), ds.to(g.dtype), dw, db


def tail_keep_mask(seed, shape, rate, device=None):
    """The kernels' keep mask of a [n, d] tail for ``seed`` (bool; every
    element kept at rate 0)."""
    if rate == 0.0:
        return torch.ones(shape, dtype=torch.bool, device=device)
    return keep_mask(seed, shape, rate, device=device)


def _check_rate(rate, seed):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_residual_ln: rate must be in [0, 1), "
                         f"got {rate}")
    if not 0 <= seed < 2**32:
        raise ValueError(f"dropout_residual_ln: seed must be a uint32, "
                         f"got {seed}")


def _dropout_args(seed, rate):
    """seed, threshold, keep scale and the drop flag of the C interface."""
    if rate == 0.0:
        return seed, 0, 1.0, 0
    return seed, dropout_threshold(rate), keep_scale(rate), 1


@functools.cache
def _kernels():
    lib = _build.load()
    P, I, F, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_uint32
    fwd = lib.volta_dropout_residual_ln_fwd
    fwd.argtypes = [P] * 8 + [I, I, F, U, U, F, I, I, I, I, P]
    fwd.restype = I
    bwd = lib.volta_dropout_residual_ln_bwd
    bwd.argtypes = [P] * 9 + [I, I, U, U, F, I, I, I, I, I, P]
    bwd.restype = I
    lib.volta_cuda_error_string.argtypes = [I]
    lib.volta_cuda_error_string.restype = ctypes.c_char_p
    return fwd, bwd, lib.volta_cuda_error_string


@functools.cache
def _per_card(device, d, code):
    """Blocks of the backward band kernel that CUDA device ``device`` holds
    at once for width d and dtype code, read once."""
    return band_capacity(
        _build.load().volta_dropout_residual_ln_blocks_per_sm, device, d,
        code)


def bwd_full_wave_rows(device, d, dtype):
    """The rows at which every warp of the backward's full band grid on
    CUDA device ``device`` (an index) walks exactly one row, for width d
    and dtype."""
    return _per_card(device, d, DTYPE_CODE[dtype]) * BAND_WARPS


def dropout_residual_ln_fwd(o, x, weight, bias, seed, rate, eps):
    """LN(dropout(o) + x) over rows: o, x [n, d] (one dtype, bf16 or fp32,
    d <= 4096), float32 weight and bias [d], the mask drawn from the uint32
    ``seed`` (none at rate 0) -> y and od [n, d] in o.dtype, the rows'
    float32 mean and rstd [n]. CPU tensors take the plain twin."""
    _check_rate(rate, seed)
    if o.device.type == "cpu":
        keep = tail_keep_mask(seed, o.shape, rate, o.device)
        return dropout_residual_ln_fwd_ref(o, x, weight, bias, keep, rate,
                                           eps)
    n, d, vec = check_rows("dropout_residual_ln_fwd", [("o", o), ("x", x)],
                           [("weight", weight), ("bias", bias)])
    fn, _, err_str = _kernels()
    y, od = torch.empty_like(o), torch.empty_like(o)
    mean = torch.empty(n, dtype=torch.float32, device=o.device)
    rstd = torch.empty_like(mean)
    stream = torch.cuda.current_stream(o.device).cuda_stream
    rc = fn(o.data_ptr(), x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            y.data_ptr(), od.data_ptr(), mean.data_ptr(), rstd.data_ptr(), n,
            d, float(eps), *_dropout_args(seed, rate), vec,
            DTYPE_CODE[o.dtype], o.device.index, stream)
    if rc != 0:
        raise launch_error("dropout_residual_ln_fwd", rc, err_str)
    LAUNCHES["dropout_residual_ln_fwd"] += 1
    return y, od, mean, rstd


def dropout_residual_ln_bwd(g, od, x, weight, mean, rstd, seed, rate):
    """The backward of ``dropout_residual_ln_fwd`` for the same ``seed``
    and the output cotangent g [n, d]: do and dx [n, d] in g.dtype, dscale
    and dbias [d] float32 (per-block partials summed over blocks in a fixed
    order, by a second kernel of the same launch). The kernel replays the
    mask's hash; CPU tensors take the plain twin."""
    _check_rate(rate, seed)
    if x.device.type == "cpu":
        return dropout_residual_ln_bwd_ref(
            g, od, x, weight, mean, rstd,
            tail_keep_mask(seed, x.shape, rate, x.device), rate)
    n, d, vec = check_rows("dropout_residual_ln_bwd",
                           [("g", g), ("od", od), ("x", x)],
                           [("weight", weight)],
                           [("mean", mean), ("rstd", rstd)])
    return _launch_bwd(g, od, x, weight, mean, rstd, seed, rate, n, d, vec)


def _launch_bwd(g, od, x, weight, mean, rstd, seed, rate, n, d, vec):
    """Row 13's launch on operands that ``check_rows`` took: the workspace
    for the grid's partials and the summed dscale and dbias is sized from
    the block count the launch is given."""
    _, fn, err_str = _kernels()
    dev, code = x.get_device(), DTYPE_CODE[x.dtype]
    blocks = band_blocks(n, _per_card(dev, d, code))
    do, dx = torch.empty_like(g), torch.empty_like(g)
    ws = torch.empty(bwd_workspace(d, blocks), dtype=torch.float32,
                     device=x.device)
    rc = fn(g.data_ptr(), od.data_ptr(), x.data_ptr(), weight.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), do.data_ptr(), dx.data_ptr(),
            ws.data_ptr(), n, d, *_dropout_args(seed, rate), vec, blocks,
            code, dev, torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise launch_error("dropout_residual_ln_bwd", rc, err_str)
    LAUNCHES["dropout_residual_ln_bwd"] += 1
    dw, db = ws[2 * blocks * d:].view(2, d)
    return do, dx, dw, db


class DropoutResidualLN(torch.autograd.Function):
    """LN(dropout(o) + x) over the last axis (any leading shape), mask from
    the uint32 ``seed``: forward ``dropout_residual_ln_fwd``, backward
    ``dropout_residual_ln_bwd`` (the kernels on the card, the twins on the
    CPU). Saves od, x, weight, mean and rstd, no mask. The seed is folded
    for the rank's rows · d (``hash.fold_seed``)."""

    @staticmethod
    def forward(ctx, o, x, weight, bias, seed, rate, eps):
        seed = fold_seed(seed, o.numel())
        shape = o.shape
        o2 = o.reshape(-1, shape[-1]).contiguous()
        x2 = x.reshape(o2.shape).contiguous()
        y, od, mean, rstd = dropout_residual_ln_fwd(o2, x2, weight, bias,
                                                    seed, rate, eps)
        ctx.save_for_backward(od, x2, weight, mean, rstd)
        ctx.seed, ctx.rate = seed, rate
        return y.view(shape)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        od, x2, weight, mean, rstd = ctx.saved_tensors
        do, dx, dw, db = dropout_residual_ln_bwd(
            g.reshape(x2.shape).contiguous(), od, x2, weight, mean, rstd,
            ctx.seed, ctx.rate)
        return (do.view(g.shape), dx.view(g.shape), dw, db, None, None,
                None)


def dropout_residual_ln(o, x, weight, bias, seed, rate, eps=LN_EPS):
    """LayerNorm(dropout(o) + x) through the fused CUDA kernels
    (``DropoutResidualLN``): ``o`` the sublayer's output, ``x`` the
    residual stream (same shape and dtype), ``seed`` the site's uint32
    dropout seed; output in o.dtype."""
    return DropoutResidualLN.apply(o, x, weight, bias, int(seed),
                                   float(rate), float(eps))
