"""The hand-written CUDA matrix products of the tools' decision probes
(``csrc/matmul.cu``), their wrappers and their plain twins.

Ports of Queue 2 rows 15 and 16, the two TPU kernels that only the probes
launch:

- row 15, ``_wgrad_kernel`` (tools/wgrad_probe.py:36, launched by
  ``make_pallas_wgrad`` :50): ``wgrad(g, a)``, the weight gradient gᵀa of g
  [n, h] and a [n, f] bf16 over the token axis, accumulated and returned in
  float32 [h, f];
- row 16, ``_ffn1_kernel`` (tools/pallas_ffn_probe.py:46, launched by
  ``make_pallas_matmul`` :59): ``matmul_bias_act(x, w, b, act)``, x [n, k]
  · w [k, m] + b [1, m] in bf16 with float32 accumulation, the bias added
  and, with ``act``, the tanh gelu applied in float32 with the probe's
  constants (:38-43), stored bf16.

CUDA tensors take the kernels or raise; CPU tensors take the twins, which
multiply the bf16 operands exactly in float32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import LAUNCHES, _build
from .attention_cuda import launch_error


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The probe's tanh gelu (tools/pallas_ffn_probe.py:38-43) on float32."""
    c = 0.7978845608028654  # sqrt(2 / pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3)))


def wgrad_ref(g, a):
    """Plain twin of row 15: gᵀa in float32, [h, f]."""
    return g.float().t() @ a.float()


def matmul_bias_act_ref(x, w, b, act):
    """Plain twin of row 16: x·w + b in float32, tanh gelu with ``act``,
    rounded to x.dtype."""
    y = x.float() @ w.float() + b.float().reshape(1, -1)
    return (gelu_tanh(y) if act else y).to(x.dtype)


@functools.cache
def _kernels():
    lib = _build.load()
    P, I = ctypes.c_void_p, ctypes.c_int
    wg = lib.volta_wgrad
    wg.argtypes = [P] * 3 + [I] * 4 + [P]
    mm = lib.volta_matmul_bias_act
    mm.argtypes = [P] * 4 + [I] * 5 + [P]
    for fn in (wg, mm):
        fn.restype = I
    lib.volta_cuda_error_string.argtypes = [I]
    lib.volta_cuda_error_string.restype = ctypes.c_char_p
    return wg, mm, lib.volta_cuda_error_string


def _check(name, tensors):
    """Raise ValueError unless every operand is a contiguous bf16 matrix on
    one CUDA device with at most 2^31 - 1 elements."""
    dev = tensors[0][1].device
    for n, t in tensors:
        if not (t.is_cuda and t.device == dev):
            raise ValueError(f"{name}: {n} must lie on the CUDA device of "
                             f"the others, got {t.device}")
        if t.dtype != torch.bfloat16 or t.dim() != 2:
            raise ValueError(f"{name}: {n} must be a bf16 matrix, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.numel() >= 2**31:
            raise ValueError(f"{name}: {n} must be contiguous with fewer "
                             f"than 2^31 elements")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def wgrad(g, a):
    """gᵀa for g [n, h] and a [n, f] bf16: [h, f] float32 with float32
    accumulation. CPU tensors take the plain twin."""
    if g.device.type == "cpu":
        return wgrad_ref(g, a)
    _check("wgrad", [("g", g), ("a", a)])
    if g.shape[0] != a.shape[0]:
        raise ValueError(f"wgrad: g {tuple(g.shape)} and a "
                         f"{tuple(a.shape)} differ in tokens")
    n, h = g.shape
    f = a.shape[1]
    out = torch.empty((h, f), dtype=torch.float32, device=g.device)
    fn, _, err_str = _kernels()
    rc = fn(g.data_ptr(), a.data_ptr(), out.data_ptr(), n, h, f,
            g.device.index, _stream(g))
    if rc != 0:
        raise launch_error("wgrad", rc, err_str)
    LAUNCHES["wgrad"] += 1
    return out


def matmul_bias_act(x, w, b, act):
    """x [n, k] · w [k, m] + b [1, m] (or [m]), all bf16, with float32
    accumulation; tanh gelu in float32 with ``act``: [n, m] bf16. CPU tensors
    take the plain twin."""
    if x.device.type == "cpu":
        return matmul_bias_act_ref(x, w, b, act)
    b2 = b.reshape(1, -1)
    _check("matmul_bias_act", [("x", x), ("w", w), ("b", b2)])
    n, k = x.shape
    m = w.shape[1]
    if w.shape[0] != k or b2.shape[1] != m:
        raise ValueError(f"matmul_bias_act: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)} do not agree")
    out = torch.empty((n, m), dtype=torch.bfloat16, device=x.device)
    _, fn, err_str = _kernels()
    rc = fn(x.data_ptr(), w.data_ptr(), b2.data_ptr(), out.data_ptr(), n, k,
            m, int(bool(act)), x.device.index, _stream(x))
    if rc != 0:
        raise launch_error("matmul_bias_act", rc, err_str)
    LAUNCHES["matmul_bias_act"] += 1
    return out
