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

from . import LAUNCHES, _build
from .attention_cuda import DTYPE_CODE, launch_error

LN_EPS = 1e-12  # TF-style epsilon, inside the square root
MAX_WIDTH = 4096  # the widest row of the kernels' instances (rownorm.cuh)
BWD_ROWS = 64  # kBwdRows in csrc/rownorm.cuh: rows per backward block


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
    the vector and every row pointer 16-byte aligned)."""
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
    per_vec = 16 // first.element_size()
    vec = d % per_vec == 0 and all(t.data_ptr() % 16 == 0 for _, t in rows)
    return n, d, int(vec)


@functools.cache
def _kernels():
    lib = _build.load()
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd = lib.volta_layer_norm_fwd
    fwd.argtypes = [P] * 6 + [I, I, F, I, I, I, P]
    fwd.restype = I
    bwd = lib.volta_layer_norm_bwd
    bwd.argtypes = [P] * 8 + [I] * 5 + [P]
    bwd.restype = I
    lib.volta_cuda_error_string.argtypes = [I]
    lib.volta_cuda_error_string.restype = ctypes.c_char_p
    return fwd, bwd, lib.volta_cuda_error_string


def layer_norm_fwd(x, weight, bias, eps):
    """TF-style LayerNorm of the rows of x [n, d] (bf16 or fp32, d <=
    4096) with float32 weight and bias [d]: y [n, d] in x.dtype and the
    rows' float32 mean and rstd [n]. CPU tensors take the plain twin."""
    if x.device.type == "cpu":
        return layer_norm_fwd_ref(x, weight, bias, eps)
    n, d, vec = check_rows("layer_norm_fwd", [("x", x)],
                           [("weight", weight), ("bias", bias)])
    fn, _, err_str = _kernels()
    y = torch.empty_like(x)
    mean = torch.empty(n, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), n, d, float(eps), vec,
            DTYPE_CODE[x.dtype], x.device.index, stream)
    if rc != 0:
        raise launch_error("layer_norm_fwd", rc, err_str)
    LAUNCHES["layer_norm_fwd"] += 1
    return y, mean, rstd


def layer_norm_bwd(g, x, weight, mean, rstd):
    """The backward of ``layer_norm_fwd`` for the output cotangent g [n, d]
    (x's dtype) from the saved mean and rstd: dx [n, d] in g.dtype, dscale
    and dbias [d] float32 (per-block partials summed over blocks). CPU
    tensors take the plain twin."""
    if x.device.type == "cpu":
        return layer_norm_bwd_ref(g, x, weight, mean, rstd)
    n, d, vec = check_rows("layer_norm_bwd", [("g", g), ("x", x)],
                           [("weight", weight)],
                           [("mean", mean), ("rstd", rstd)])
    _, fn, err_str = _kernels()
    dx = torch.empty_like(g)
    parts = torch.empty((2, -(-n // BWD_ROWS), d), dtype=torch.float32,
                        device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(g.data_ptr(), x.data_ptr(), weight.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), dx.data_ptr(), parts[0].data_ptr(),
            parts[1].data_ptr(), n, d, vec, DTYPE_CODE[x.dtype],
            x.device.index, stream)
    if rc != 0:
        raise launch_error("layer_norm_bwd", rc, err_str)
    LAUNCHES["layer_norm_bwd"] += 1
    dw, db = parts.sum(dim=1)
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
    (``FusedLayerNorm``); output in x.dtype."""
    return FusedLayerNorm.apply(x, weight, bias, float(eps))
