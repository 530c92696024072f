"""K9: the int8 dense layer (``csrc/int8_dense.cu``): the per-token
quantize (K9a) and the int8 product with its dequantizing epilogue (K9b),
their wrappers and plain twins, and the serving transform around them.

Port of ``volta_tpu/ops/int8_dense.py``, which has no Pallas kernel (XLA
composes the abs-max, the divide, the round and an int8 ``dot_general``
there). Weights are quantized once, per output channel (symmetric, scale =
max|w| / 127 + 1e-12 over the input axis); activations per token at run
time (a = max|x| / 127 + 1e-12 over the row), or with one static scale
from ``calibrate_activation_scales``. The product accumulates in int32 and
is rescaled by a[m] * scale[n] and the bias added:

    y = fma(float(xq . qᵀ), a[m] * scale[n], bias[n])      (then the dtype)

Both the scales and this epilogue are computed as XLA compiles JAX's
jitted expressions on the CPU: max / 127 + 1e-12 becomes fma(max,
float32(1/127), 1e-12) (``absmax_scale``), and acc * (a * scale) + bias one
FMA after the rounded a * scale, so that the port equals the JAX CLI's
numbers to the bit (JAX's eager ops round each step instead, an ulp or so
apart). The twins compute the FMAs in float64 and round once to float32
(``fma32``).

The weight is kept as ``[out, in]`` int8, the port's ``Dense`` layout and
the K-major B operand of the int8 ``mma`` and ``wgmma``; JAX's ``[in, out]``
``q`` is its transpose. CUDA tensors take the kernels or raise; CPU tensors
take the twins, which sum the product in int64 (on the card the twin sums
in float64, exact below 2^53: 127² · K fits for any K < 5.5e8).

K9b has two bodies (``int8_body``): the Hopper body (TMA, a ring of
shared-memory stages, ``wgmma`` m64n256k32 s8, a persistent grid of
clusters of two) where TMA can read both operands, and the ``mma.sync``
body for the rest (K = 5, the location embedding; K not a multiple of 16;
misaligned or strided operands). A call runs the body the rule names, or
raises.
``torch._int_mm`` is no part of this: ``chip_smoke.py`` times it as the
library yardstick only.

The serving transform routes each ``Dense`` explicitly: ``quantize_model``
sets the module's ``int8`` entry from a bundle (``quantize_variables``,
keyed by the module's '/'-joined Flax path as JAX keys it), and
``Dense.forward`` then calls ``int8_dense_apply`` (models/layers.py).
Nothing is patched globally.
"""

from __future__ import annotations

import copy
import ctypes
import functools
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import LAUNCHES, _build, in_kernel_export
from .attention_cuda import DTYPE_CODE, launch_error
from .matmul import _raise as launch_failure

VEC_BYTES = 16


# float32(1 / 127) and float32(1e-12)
INV127 = float(np.float32(1 / 127))
EPS = float(np.float32(1e-12))
FMA_CHUNK = 1 << 22


def _fma32(x, y, z):
    p = x.double() * y
    c = z.double()
    r = p + c
    v = r - p
    e = (p - (r - v)) + (c - v)
    r32 = r.float()
    d = r - r32.double()
    inf = torch.full_like(r, float("inf"))
    other = torch.nextafter(r32, torch.where(d > 0, inf, -inf).float())
    tie = (d != 0) & (r == (r32.double() + other.double()) * 0.5) & (e != 0)
    r = torch.where(tie, torch.nextafter(r, torch.where(e > 0, inf, -inf)), r)
    return r.float()


def fma32(x: torch.Tensor, y, z) -> torch.Tensor:
    """fma(x, y, z) of float32 values (broadcast), rounded once to float32
    (as ``__fmaf_rn``). The product is exact in float64 and the sum r is
    not always: r rounded again to float32 would be off by one ulp where r
    is exactly halfway between two float32 values and the exact sum is not.
    There r moves one float64 ulp toward the exact sum (its TwoSum
    residual), which then rounds as the exact sum does. Computed
    ``FMA_CHUNK`` elements at a time, which bounds the float64
    temporaries; in one piece while ``torch.export`` traces it (a portable
    int8 artifact), whose batch may be a symbol."""
    x, y, z = torch.broadcast_tensors(*(
        torch.as_tensor(v, dtype=torch.float32, device=x.device)
        for v in (x, y, z)))
    if x.dim() == 0 or torch.compiler.is_exporting():
        return _fma32(x, y, z)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    rows = max(1, FMA_CHUNK // max(1, x[0].numel()))
    for i in range(0, x.shape[0], rows):
        j = slice(i, i + rows)
        out[j] = _fma32(x[j], y[j], z[j])
    return out


def absmax_scale(m: torch.Tensor) -> torch.Tensor:
    """max|x| / 127 + 1e-12 (float32) as XLA compiles JAX's expression:
    the division by the constant becomes a product with float32(1 / 127),
    fused with the addition into one FMA, fma(m, 1/127, 1e-12)
    (csrc/int8_dense.cu: __fmaf_rn)."""
    return fma32(m.float(), INV127, EPS)


def quantize_kernel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of a ``Dense``
    weight ``[out, in]`` (volta_tpu/ops/int8_dense.py:44-49, on the
    transpose): (q ``[out, in]`` int8, scale ``[out]`` float32)."""
    w = w.detach().float()
    scale = absmax_scale(w.abs().amax(dim=1))
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


# ------------------------------------------------------------------ twins
def quantize_ref(x: torch.Tensor, a_scale: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9a's plain twin: x ``[M, K]`` -> (xq ``[M, K]`` int8, a ``[M]``
    float32), a = max|x| / 127 + 1e-12 a row, or the 0-dim ``a_scale``."""
    xf = x.float()
    if a_scale is None:
        a = absmax_scale(xf.abs().amax(dim=1))
    else:
        a = a_scale.float().expand(xf.shape[0]).contiguous()
    xq = torch.clamp(torch.round(xf / a[:, None]), -127, 127)
    return xq.to(torch.int8), a


def int8_matmul_ref(xq: torch.Tensor, a: torch.Tensor, q: torch.Tensor,
                    scale: torch.Tensor, bias: Optional[torch.Tensor],
                    out_dtype) -> torch.Tensor:
    """K9b's plain twin: fma(float(xq . qᵀ), a[m] * scale[n], bias[n]) in
    float32, then ``out_dtype``. The int32 product is summed in int64 on
    the CPU and in float64 on the card, both exact."""
    wide = torch.int64 if xq.device.type == "cpu" else torch.float64
    acc = (xq.to(wide) @ q.to(wide).t()).to(torch.int32).float()
    s = a[:, None] * scale[None, :]
    if bias is None:
        return (acc * s).to(out_dtype)
    return fma32(acc, s, bias[None, :]).to(out_dtype)


# ----------------------------------------------------------------- kernels
def int8_body(xq: torch.Tensor, q: torch.Tensor) -> str:
    """The body that ``int8_matmul`` runs for xq ``[M, K]`` and q ``[N,
    K]``: "wgmma" where TMA can read both (non-empty contiguous int8
    matrices, each starting on a 16-byte boundary, K a multiple of 16: TMA's
    row stride is a multiple of 16 bytes), else "mma.sync"."""
    for t in (xq, q):
        if not (t.dtype == torch.int8 and t.dim() == 2 and t.numel() > 0
                and t.is_contiguous() and t.data_ptr() % VEC_BYTES == 0
                and t.shape[1] % VEC_BYTES == 0):
            return "mma.sync"
    return "wgmma"


@functools.cache
def _kernels():
    lib = _build.load()
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.volta_int8_quantize.argtypes = [P, P, P, P, LL, I, I, I, I, P]
    lib.volta_int8_quantize.restype = I
    lib.volta_int8_matmul.argtypes = [P] * 6 + [I] * 6 + [P]
    lib.volta_int8_matmul.restype = I
    lib.volta_int8_matmul_wgmma.argtypes = [P] * 6 + [I] * 6 + [P]
    lib.volta_int8_matmul_wgmma.restype = I
    lib.volta_int8_clusters.argtypes = [I, P]
    lib.volta_int8_clusters.restype = I
    lib.volta_cuda_error_string.argtypes = [I]
    lib.volta_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _clusters(index: int) -> int:
    """How many clusters of two blocks of K9b's Hopper body card ``index``
    runs at once: its persistent grid."""
    n = ctypes.c_int(0)
    rc = _kernels().volta_int8_clusters(index, ctypes.byref(n))
    if rc != 0 or n.value < 1:
        raise RuntimeError(f"int8_matmul's Hopper body does not fit on card "
                           f"{index} (cudaError {rc}, {n.value} clusters)")
    return n.value


def _stream(dev: int) -> int:
    return torch._C._cuda_getCurrentRawStream(dev)


def _cuda(name, *tensors):
    for t in tensors:
        if t is not None and t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must lie on a CUDA device or "
                             f"all on the CPU, got {t.device}")


def int8_quantize(x: torch.Tensor, a_scale: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9a on x ``[M, K]`` (bf16 or float32; made contiguous): (xq int8,
    a ``[M]`` float32), dynamic or with the 0-dim float32 ``a_scale`` on
    x's device. CPU tensors take the twin."""
    if x.device.type == "cpu":
        return quantize_ref(x, a_scale)
    _cuda("int8_quantize", x, a_scale)
    if x.dim() != 2 or x.dtype not in DTYPE_CODE:
        raise ValueError(f"int8_quantize: x must be 2-D bfloat16 or float32, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if a_scale is not None and (a_scale.numel() != 1
                                or a_scale.dtype != torch.float32):
        raise ValueError("int8_quantize: a_scale must be one float32")
    x = x.contiguous()
    m, k = x.shape
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    a = torch.empty((m,), dtype=torch.float32, device=x.device)
    if m == 0:
        return xq, a
    dev = x.get_device()
    vec = int(k * x.element_size() % VEC_BYTES == 0
              and x.data_ptr() % VEC_BYTES == 0)
    lib = _kernels()
    rc = lib.volta_int8_quantize(
        x.data_ptr(), None if a_scale is None else a_scale.data_ptr(),
        xq.data_ptr(), a.data_ptr(), m, k, DTYPE_CODE[x.dtype], vec, dev,
        _stream(dev))
    if rc != 0:
        raise launch_error("int8_quantize", rc, lib.volta_cuda_error_string)
    LAUNCHES["int8_quantize"] += 1
    return xq, a


def int8_matmul(xq: torch.Tensor, a: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor, bias: Optional[torch.Tensor],
                out_dtype) -> torch.Tensor:
    """K9b: y ``[M, N]`` of ``out_dtype`` (bf16 or float32) = fma(float(xq
    ``[M, K]`` . q ``[N, K]``ᵀ), a[m] * scale[n], bias[n]). CPU tensors
    take the twin."""
    if xq.device.type == "cpu":
        return int8_matmul_ref(xq, a, q, scale, bias, out_dtype)
    _cuda("int8_matmul", xq, a, q, scale, bias)
    m, k = xq.shape
    n = q.shape[0]
    if (xq.dtype, q.dtype) != (torch.int8, torch.int8) or q.shape[1] != k:
        raise ValueError(f"int8_matmul: xq [M, K] and q [N, K] must be int8, "
                         f"got {tuple(xq.shape)} {xq.dtype}, "
                         f"{tuple(q.shape)} {q.dtype}")
    f32 = [t for t in (a, scale, bias) if t is not None]
    if any(t.dtype != torch.float32 for t in f32) or a.shape != (m,) \
            or scale.shape != (n,) or (bias is not None
                                       and bias.shape != (n,)):
        raise ValueError("int8_matmul: a [M], scale [N] and bias [N] must "
                         "be float32")
    if out_dtype not in DTYPE_CODE:
        raise ValueError(f"int8_matmul: out_dtype must be bfloat16 or "
                         f"float32, got {out_dtype}")
    body = int8_body(xq, q)
    xq, q, a, scale = (t.contiguous() for t in (xq, q, a, scale))
    bias = None if bias is None else bias.contiguous()
    y = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    if m == 0 or n == 0:
        return y
    dev = xq.get_device()
    lib = _kernels()
    args = (xq.data_ptr(), a.data_ptr(), q.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(), m, n, k,
            DTYPE_CODE[out_dtype])
    if body == "wgmma":
        rc = lib.volta_int8_matmul_wgmma(*args, _clusters(dev), dev,
                                         _stream(dev))
    else:
        vec = int(k % VEC_BYTES == 0 and xq.data_ptr() % VEC_BYTES == 0
                  and q.data_ptr() % VEC_BYTES == 0)
        rc = lib.volta_int8_matmul(*args, vec, dev, _stream(dev))
    if rc != 0:
        raise launch_failure("int8_matmul", rc, lib.volta_cuda_error_string)
    LAUNCHES["int8_matmul"] += 1
    return y


def int8_dense_apply(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                     bias: Optional[torch.Tensor], out_dtype=torch.bfloat16,
                     a_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = dequant(int8(x) . qᵀ) + bias for x ``[..., in]`` and q ``[out,
    in]`` int8 (volta_tpu/ops/int8_dense.py:52-74): K9a (per-token scales,
    or the static ``a_scale``) then K9b; ``[..., out]`` of ``out_dtype``.
    While ``torch.export`` traces a kernel artifact both are the registered
    ops ``volta::int8_quantize`` and ``volta::int8_matmul``."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.dtype not in DTYPE_CODE:
        x2 = x2.float()
    if in_kernel_export():
        xq, a = torch.ops.volta.int8_quantize(x2, a_scale)
        y = torch.ops.volta.int8_matmul(xq, a, q, scale, bias, out_dtype)
    else:
        xq, a = int8_quantize(x2, a_scale)
        y = int8_matmul(xq, a, q, scale, bias, out_dtype)
    return y.reshape(*lead, q.shape[0])


# --------------------------------------------------------- the transform
def dense_modules(model: nn.Module) -> Dict[str, nn.Module]:
    """Every ``Dense`` of ``model`` by its '/'-joined Flax module path, the
    keys of JAX's bundle (every 2-D kernel, volta_tpu/ops/int8_dense.py
    :122-131)."""
    from ..models.layers import Dense

    return {name.replace(".", "/"): m for name, m in model.named_modules()
            if isinstance(m, Dense)}


def calibrate_activation_scales(model: nn.Module, batches: Iterable[tuple]
                                ) -> Dict[str, float]:
    """Per-``Dense`` static activation scales, max|x| / 127 + 1e-12 over
    every calibration batch (volta_tpu/ops/int8_dense.py:77-119): a forward
    pre-hook on each ``Dense`` records max|x| in float32 while
    ``model(*batch)`` runs; a ``Dense`` that no batch reaches has no
    entry."""
    records: Dict[str, torch.Tensor] = {}
    hooks = []

    def hook(key):
        def fn(module, args):
            m = args[0].float().abs().amax()
            records[key] = torch.maximum(records[key], m) \
                if key in records else m
        return fn

    for key, mod in dense_modules(model).items():
        hooks.append(mod.register_forward_pre_hook(hook(key)))
    out = None
    try:
        with torch.no_grad():
            for batch in batches:
                records.clear()
                model(*batch)
                r = {k: float(v) for k, v in records.items()}
                if out is None:
                    out = r
                else:
                    for k, v in r.items():
                        out[k] = max(out.get(k, 0.0), v)
    finally:
        for h in hooks:
            h.remove()
    if out is None:
        raise ValueError(
            "calibrate_activation_scales: empty `batches` iterable — at "
            "least one calibration batch is required")
    # in float64, as JAX's host arithmetic; the bundle rounds to float32
    return {k: v / 127.0 + 1e-12 for k, v in out.items()}


def quantize_variables(model: nn.Module, residual_dtype=None,
                       act_scales: Optional[Dict[str, float]] = None
                       ) -> Dict[str, Any]:
    """The int8 serving bundle of ``model``'s weights
    (volta_tpu/ops/int8_dense.py:131-176): ``bundle["int8"]`` maps each
    ``Dense``'s '/'-joined Flax path to {q ``[out, in]`` int8, scale,
    bias float32, a (a 0-dim float32 static scale, or None)};
    ``bundle["params"]`` holds every other parameter by its port name,
    cast to ``residual_dtype`` where that is given and the parameter is
    floating. Tensors on the model's device."""
    table = {}
    dense_params = set()  # ids of the Dense modules' weights and biases
    for key, mod in dense_modules(model).items():
        q, scale = quantize_kernel(mod.weight)
        a = None
        if act_scales is not None and key in act_scales:
            a = torch.tensor(act_scales[key], dtype=torch.float32,
                             device=q.device)
        table[key] = {"q": q, "scale": scale,
                      "bias": mod.bias.detach().float(), "a": a}
        dense_params.update((id(mod.weight), id(mod.bias)))
    params = {}
    for name, p in model.named_parameters():
        if id(p) in dense_params:
            continue
        v = p.detach()
        if residual_dtype is not None and v.is_floating_point():
            v = v.to(residual_dtype)
        params[name] = v
    return {"params": params, "int8": table}


def quantize_model(model: nn.Module, bundle: Dict[str, Any]) -> nn.Module:
    """Make ``model`` the served model of ``bundle``, in place: every
    ``Dense`` with an entry runs ``int8_dense_apply`` through it (its
    ``int8`` attribute) and drops its float weight and bias, so that the
    model holds the bundle and no second copy of the Dense weights; every
    other parameter takes the bundle's value (a residual cast to bf16 is
    rounded there). Returns ``model``."""
    for key, mod in dense_modules(model).items():
        mod.int8 = bundle["int8"].get(key)
        if mod.int8 is not None:
            mod.weight = None
            mod.bias = None
    own = dict(model.named_parameters())
    with torch.no_grad():
        for name, v in bundle["params"].items():
            own[name].copy_(v)
    return model


def apply_quantized(model: nn.Module, bundle: Dict[str, Any], *args,
                    **kwargs):
    """``model``'s forward with the int8 bundle (JAX's ``apply_quantized``,
    volta_tpu/ops/int8_dense.py:197-202), on a copy of ``model`` so that
    ``model`` itself stays as it is."""
    return quantize_model(copy.deepcopy(model), bundle)(*args, **kwargs)
