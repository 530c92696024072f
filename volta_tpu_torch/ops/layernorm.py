"""The hand-written CUDA LayerNorm (``csrc/layernorm.cu``), forward and
backward, their wrappers, their plain twins and the autograd Function over
them.

Ports of the TPU kernels behind ``fused_layer_norm``
(volta_tpu/ops/layernorm.py:27-54, 63-120): ``_fwd_kernel``, TF-style
LayerNorm over the last axis with float32 statistics that also emits the
rows' mean and rstd, and ``_bwd_kernel``, its VJP with per-tile partial
dscale / dbias. ``layer_norm_fwd`` and ``layer_norm_bwd`` launch the
kernels for CUDA tensors and raise on anything they do not take; for CPU
tensors they run ``layer_norm_fwd_ref`` and ``layer_norm_bwd_ref``, the same
math in plain PyTorch. There is no fallback from the card to the twins.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from . import LAUNCHES, _build, in_kernel_export
from .attention_cuda import DTYPE_CODE, launch_error

LN_EPS = 1e-12  # TF-style epsilon, inside the square root
MAX_WIDTH = 4096  # the widest row of the kernels' instances (rownorm.cuh)
BAND_WARPS = 8  # kBandWarps in csrc/rowband.cuh: warps of a band block


def ln_rows(s, weight, bias, eps):
    """LayerNorm of float32 rows s [n, d] (``_ln_rows``,
    volta_tpu/ops/fused_residual.py:40-46): two-pass statistics, rstd =
    rsqrt(var + eps). Returns float32 y and mean, rstd [n]."""
    mean = s.mean(dim=-1, keepdim=True)
    sc = s - mean
    var = (sc * sc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = sc * rstd * weight.float() + bias.float()
    return y, mean[:, 0], rstd[:, 0]


def ln_rows_vjp(g, s, weight, mean, rstd):
    """The LayerNorm VJP of float32 rows s [n, d] for the cotangent g from
    the saved mean and rstd [n] (volta_tpu/ops/layernorm.py:40-54): float32
    ds [n, d] and the row sums dscale = Σ g·x̂, dbias = Σ g."""
    g = g.float()
    rstd = rstd[:, None]
    xhat = (s - mean[:, None]) * rstd
    gs = g * weight.float()
    m1 = gs.mean(dim=-1, keepdim=True)
    m2 = (gs * xhat).mean(dim=-1, keepdim=True)
    ds = rstd * (gs - m1 - xhat * m2)
    return ds, (g * xhat).sum(dim=0), g.sum(dim=0)


def layer_norm_fwd_ref(x, weight, bias, eps):
    """Plain twin of the forward: x [n, d] (bf16 or fp32), weight and bias
    [d] -> y [n, d] in x.dtype, mean and rstd [n] float32."""
    y, mean, rstd = ln_rows(x.float(), weight, bias, eps)
    return y.to(x.dtype), mean, rstd


def layer_norm_bwd_ref(g, x, weight, mean, rstd):
    """Plain twin of the backward: dx [n, d] in g.dtype, dscale and dbias
    [d] float32."""
    ds, dw, db = ln_rows_vjp(g, x.float(), weight, mean, rstd)
    return ds.to(g.dtype), dw, db


def check_rows(name, rows, vectors, stats=()):
    """Raise ValueError for anything the row kernels do not take: ``rows``
    (name, tensor) pairs must be [n, d] CUDA tensors of one bf16/fp32 dtype,
    ``vectors`` [d] float32 and ``stats`` [n] float32, all contiguous on one
    device, with 1 <= n < 2^31 and 1 <= d <= MAX_WIDTH. Returns (n, d, vec)
    where vec says whether 16-byte vector access applies (d a multiple of
    the vector and every row pointer 16-byte aligned). One pass over the
    operands; ``_refuse`` says what is wrong when it fails."""
    first = rows[0][1]
    dev, dtype, shape = first.get_device(), first.dtype, first.shape
    f32 = torch.float32
    ok = first.is_cuda and dtype in DTYPE_CODE and len(shape) == 2
    if ok:
        n, d = shape
        ok = 1 <= n < 2**31 and 1 <= d <= MAX_WIDTH and all(
            t.get_device() == dev and t.dtype == want and t.shape == like
            and t.is_contiguous()
            for group, want, like in ((rows, dtype, shape),
                                      (vectors, f32, (d,)),
                                      (stats, f32, (n,)))
            for _, t in group)
    if not ok:
        _refuse(name, rows, vectors, stats)
    vec = d % (16 // first.element_size()) == 0 and all(
        t.data_ptr() % 16 == 0 for _, t in rows)
    return n, d, int(vec)


def _refuse(name, rows, vectors, stats):
    """The ValueError for operands that ``check_rows`` refuses, naming the
    first fault in the order: device, dtype, rank, shapes, vectors and
    statistics, range, contiguity."""
    first = rows[0][1]
    every = list(rows) + list(vectors) + list(stats)
    if not (first.is_cuda and all(t.device == first.device
                                  for _, t in every)):
        raise ValueError(f"{name}: operands must lie on one CUDA device, got "
                         f"{[(n, str(t.device)) for n, t in every]}")
    if first.dtype not in DTYPE_CODE or any(t.dtype != first.dtype
                                            for _, t in rows):
        raise ValueError(f"{name}: {[n for n, _ in rows]} must share a dtype "
                         f"of bfloat16 or float32, got "
                         f"{[t.dtype for _, t in rows]}")
    if first.dim() != 2:
        raise ValueError(f"{name}: expected [n, d] rows, got "
                         f"{tuple(first.shape)}")
    n, d = first.shape
    for nm, t in rows:
        if t.shape != (n, d):
            raise ValueError(f"{name}: {nm} {tuple(t.shape)} is not "
                             f"{(n, d)}")
    for nm, t, want in [(nm, t, (d,)) for nm, t in vectors] + \
            [(nm, t, (n,)) for nm, t in stats]:
        if t.dtype != torch.float32 or tuple(t.shape) != want:
            raise ValueError(f"{name}: {nm} must be float32 {want}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if not 1 <= n < 2**31 or not 1 <= d <= MAX_WIDTH:
        raise ValueError(f"{name}: n={n}, d={d} is outside the kernels' "
                         f"range (1 <= n < 2^31, 1 <= d <= {MAX_WIDTH})")
    for nm, t in every:
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")
    raise ValueError(f"{name}: operands the kernels do not take")


def band_blocks(n, per_card):
    """Blocks of the band kernels (rows 10, 11 and 13, csrc/rowband.cuh)
    for n rows: as many as the card holds at once (``per_card``, the SM
    count times the blocks an SM holds), but no more than give each of a
    block's BAND_WARPS warps a row where there are more rows than one
    block's warps."""
    return max(1, min(per_card, n // BAND_WARPS))


def band_rows(n, blocks):
    """The band [r0, r1) of rows that each of the grid's blocks *
    BAND_WARPS warps walks (``band_range`` in csrc/rowband.cuh), in warp
    order."""
    warps = blocks * BAND_WARPS
    return [(w * n // warps, (w + 1) * n // warps) for w in range(warps)]


def full_wave_rows(device, d, dtype, backward=False):
    """The rows at which every warp of the full band grid on CUDA device
    ``device`` (an index) walks exactly one row, for width d and dtype."""
    return _per_card(device, d, DTYPE_CODE[dtype], backward) * BAND_WARPS


def bwd_workspace(d, blocks):
    """float32 elements of the backward's workspace: the blocks' partial
    dscale and dbias [2, blocks, d], then the summed dscale and dbias
    [2, d]."""
    return 2 * (blocks + 1) * d


@functools.cache
def _kernels():
    lib = _build.load()
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd = lib.volta_layer_norm_fwd
    fwd.argtypes = [P] * 6 + [I, I, F, I, I, I, I, P]
    fwd.restype = I
    bwd = lib.volta_layer_norm_bwd
    bwd.argtypes = [P] * 7 + [I] * 6 + [P]
    bwd.restype = I
    lib.volta_layer_norm_blocks_per_sm.argtypes = [I] * 4 + [
        ctypes.POINTER(I)]
    lib.volta_layer_norm_blocks_per_sm.restype = I
    lib.volta_cuda_error_string.argtypes = [I]
    lib.volta_cuda_error_string.restype = ctypes.c_char_p
    return fwd, bwd, lib.volta_cuda_error_string


def band_capacity(query, device, *args):
    """Blocks of a band kernel that CUDA device ``device`` holds at once:
    its SM count times the blocks an SM holds, as ``query`` (the library's
    occupancy export for that kernel, ``*_blocks_per_sm``) reports for
    ``args``."""
    per_sm = ctypes.c_int(0)
    rc = query(*args, device, ctypes.byref(per_sm))
    if rc != 0:
        raise launch_error(query.__name__, rc, _kernels()[2])
    if per_sm.value < 1:
        raise RuntimeError(f"{query.__name__}{args}: no block fits on an SM "
                           f"of CUDA device {device}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * per_sm.value


@functools.cache
def _per_card(device, d, code, backward):
    """Blocks of the forward or backward band kernel that CUDA device
    ``device`` holds at once for width d and dtype code, read once."""
    return band_capacity(_build.load().volta_layer_norm_blocks_per_sm,
                         device, d, code, int(backward))


def layer_norm_fwd(x, weight, bias, eps):
    """TF-style LayerNorm of the rows of x [n, d] (bf16 or fp32, d <=
    4096) with float32 weight and bias [d]: y [n, d] in x.dtype and the
    rows' float32 mean and rstd [n]. CPU tensors take the plain twin."""
    if x.device.type == "cpu":
        return layer_norm_fwd_ref(x, weight, bias, eps)
    n, d, vec = check_rows("layer_norm_fwd", (("x", x),),
                           (("weight", weight), ("bias", bias)))
    return _launch_fwd(x, weight, bias, eps, n, d, vec)


def _launch_fwd(x, weight, bias, eps, n, d, vec):
    """Row 10's launch on operands that ``check_rows`` took."""
    fn, _, err_str = _kernels()
    dev, code = x.get_device(), DTYPE_CODE[x.dtype]
    blocks = band_blocks(n, _per_card(dev, d, code, False))
    y = torch.empty_like(x)
    mean = torch.empty(n, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    rc = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), n, d, eps, vec, blocks, code,
            dev, torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise launch_error("layer_norm_fwd", rc, err_str)
    LAUNCHES["layer_norm_fwd"] += 1
    return y, mean, rstd


def layer_norm_bwd(g, x, weight, mean, rstd):
    """The backward of ``layer_norm_fwd`` for the output cotangent g [n, d]
    (x's dtype) from the saved mean and rstd: dx [n, d] in g.dtype, dscale
    and dbias [d] float32 (per-block partials summed over blocks in a fixed
    order, by a second kernel of the same launch). CPU tensors take the
    plain twin."""
    if x.device.type == "cpu":
        return layer_norm_bwd_ref(g, x, weight, mean, rstd)
    n, d, vec = check_rows("layer_norm_bwd", (("g", g), ("x", x)),
                           (("weight", weight),),
                           (("mean", mean), ("rstd", rstd)))
    return _launch_bwd(g, x, weight, mean, rstd, n, d, vec)


def _launch_bwd(g, x, weight, mean, rstd, n, d, vec):
    """Row 11's launch on operands that ``check_rows`` took: the workspace
    for the grid's partials is sized from the block count the launch is
    given."""
    _, fn, err_str = _kernels()
    dev, code = x.get_device(), DTYPE_CODE[x.dtype]
    blocks = band_blocks(n, _per_card(dev, d, code, True))
    dx = torch.empty_like(g)
    ws = torch.empty(bwd_workspace(d, blocks), dtype=torch.float32,
                     device=x.device)
    rc = fn(g.data_ptr(), x.data_ptr(), weight.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), dx.data_ptr(), ws.data_ptr(), n, d, vec,
            blocks, code, dev, torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise launch_error("layer_norm_bwd", rc, err_str)
    LAUNCHES["layer_norm_bwd"] += 1
    dw, db = ws[2 * blocks * d:].view(2, d)
    return dx, dw, db


class FusedLayerNorm(torch.autograd.Function):
    """LayerNorm over the last axis of x (any leading shape): forward
    ``layer_norm_fwd``, backward ``layer_norm_bwd`` (the kernels on the
    card, the twins on the CPU). Saves x, weight, mean and rstd."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1]).contiguous()
        y, mean, rstd = layer_norm_fwd(x2, weight, bias, eps)
        ctx.save_for_backward(x2, weight, mean, rstd)
        return y.view(shape)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x2, weight, mean, rstd = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(g.reshape(x2.shape).contiguous(), x2,
                                    weight, mean, rstd)
        return dx.view(g.shape), dw, db, None


def fused_layer_norm(x, weight, bias, eps):
    """TF-style LayerNorm of x over its last axis through the CUDA kernels
    (``FusedLayerNorm``); output in x.dtype. Where autograd is off (eval
    runs under ``torch.inference_mode``) the forward is called without the
    Function and its bookkeeping, host time that an eval forward pays once
    for each of its 29 LayerNorms. While ``torch.export`` traces a kernel
    artifact it is the registered op ``volta::layer_norm_fwd``."""
    if in_kernel_export():
        shape = x.shape
        return torch.ops.volta.layer_norm_fwd(
            x.reshape(-1, shape[-1]).contiguous(), weight, bias,
            float(eps))[0].view(shape)
    if torch.is_grad_enabled():
        return FusedLayerNorm.apply(x, weight, bias, float(eps))
    shape = x.shape
    y = layer_norm_fwd(x.reshape(-1, shape[-1]).contiguous(), weight, bias,
                       float(eps))[0]
    return y.view(shape)
