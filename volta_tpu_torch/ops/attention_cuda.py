"""The hand-written CUDA attention forward (``csrc/attention_fwd.cu``), its
wrapper and its plain twin.

Port of the TPU kernel ``_attn_kernel_nat_bh`` behind
``pallas_fused_attention_nat`` (volta_tpu/ops/pallas_attention.py:670-735):
no-dropout joint attention on the natural [B, L, H·D] layout, the one
kernel on the serving path. ``attention_fwd`` launches the kernel for a
CUDA tensor and raises on anything it does not take; for a CPU tensor it
runs ``attention_fwd_ref``, the same function in plain PyTorch. There is no
fallback from the card to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .attention import attention_out, attention_probs

# launches of the kernel since the counter was last set to 0
LAUNCHES = 0

HEAD_DIMS = (16, 32, 64, 128)
ROWS_PER_BLOCK = 16  # kRowsPerBlock in csrc/attention_fwd.cu
KEY_CHUNK = 32  # kKeyChunk in csrc/attention_fwd.cu
MAX_SMEM_BYTES = 232448  # a Hopper block's dynamic shared memory limit
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def attention_fwd_ref(q, k, v, bias, scale, heads):
    """Plain twin: q [B,Lq,H·D], k/v [B,Lk,H·D], bias [B,Lk] float32 ->
    [B,Lq,H·D] in q.dtype."""
    b, lq, hd = q.shape
    lk = k.shape[1]
    d = hd // heads
    probs = attention_probs(q.view(b, lq, heads, d),
                            k.view(b, lk, heads, d),
                            bias.view(b, 1, 1, lk), scale)
    out = attention_out(probs, v.view(b, lk, heads, d))
    return out.to(q.dtype).reshape(b, lq, hd)


def smem_bytes(lk: int, head_dim: int) -> int:
    """Dynamic shared memory of one block, all float32: its query rows, a
    chunk of K rows (stride D + 1) and its rows of Lk scores (padded to 4)."""
    return 4 * (ROWS_PER_BLOCK * (head_dim + (lk + 3) // 4 * 4)
                + KEY_CHUNK * (head_dim + 1))


def _check(q, k, v, bias, heads):
    if not (q.is_cuda and k.device == q.device and v.device == q.device
            and bias.device == q.device):
        raise ValueError("attention_fwd: q, k, v and bias must lie on one "
                         f"CUDA device, got {q.device}, {k.device}, "
                         f"{v.device}, {bias.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("attention_fwd: q, k, v must share a dtype of "
                         f"bfloat16 or float32, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if bias.dtype != torch.float32:
        raise ValueError(f"attention_fwd: bias must be float32, "
                         f"got {bias.dtype}")
    if q.dim() != 3 or k.dim() != 3 or bias.dim() != 2:
        raise ValueError("attention_fwd: expected q [B,Lq,H·D], k/v "
                         "[B,Lk,H·D], bias [B,Lk]")
    b, lq, hd = q.shape
    lk = k.shape[1]
    if (k.shape != (b, lk, hd) or v.shape != k.shape
            or bias.shape != (b, lk)):
        raise ValueError(f"attention_fwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"bias {tuple(bias.shape)} do not agree")
    if heads < 1 or hd % heads or hd // heads not in HEAD_DIMS:
        raise ValueError(f"attention_fwd: head dim {hd} / {heads} heads "
                         f"must be one of {HEAD_DIMS}")
    if min(b, lq, lk) < 1 or b * heads >= 2**31 \
            or -(-lq // ROWS_PER_BLOCK) > 65535:
        raise ValueError(f"attention_fwd: B={b}, Lq={lq}, Lk={lk}, "
                         f"H={heads} is outside the kernel's grid")
    if smem_bytes(lk, hd // heads) > MAX_SMEM_BYTES:
        raise ValueError(f"attention_fwd: Lk={lk} needs "
                         f"{smem_bytes(lk, hd // heads)} bytes of shared "
                         f"memory per block, over {MAX_SMEM_BYTES}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"attention_fwd: {name} must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"attention_fwd: {name} must be 16-byte "
                             "aligned")


@functools.cache
def _kernel():
    lib = _build.load()
    fn = lib.volta_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.volta_cuda_error_string.argtypes = [ctypes.c_int]
    lib.volta_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.volta_cuda_error_string


def attention_fwd(q, k, v, bias, scale, heads):
    """softmax(q·kᵀ·scale + bias)·v per head on the natural layout:
    q [B,Lq,H·D], k/v [B,Lk,H·D] (bf16 or fp32), bias [B,Lk] float32 ->
    [B,Lq,H·D] in q.dtype. CPU tensors take the plain twin."""
    global LAUNCHES
    if q.device.type == "cpu":
        return attention_fwd_ref(q, k, v, bias, scale, heads)
    _check(q, k, v, bias, heads)
    fn, err_str = _kernel()
    b, lq, hd = q.shape
    lk = k.shape[1]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, lq, lk, heads, hd // heads, float(scale),
            _DTYPE_CODE[q.dtype], q.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"attention_fwd kernel launch failed: "
                           f"{err_str(rc).decode()} (cudaError {rc})")
    LAUNCHES += 1
    return out
