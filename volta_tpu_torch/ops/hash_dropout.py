"""K10: the hand-written CUDA hash dropout (``csrc/hash_dropout.cu``),
forward and backward, its wrappers, its plain twin and the autograd
Function over them.

Port of the JAX package's ``hash_dropout`` (volta_tpu/models/layers.py
:226-255), which has no Pallas kernel (XLA fuses it there): element n of x
(its linear index modulo 2^32) is kept iff fmix32(n * 0x9E3779B9 + seed) <
threshold, and a kept value is divided by 1 - rate rounded to x's dtype,
a dropped one is 0. The backward replays the hash on the cotangent, dx =
where(keep, g / denom, 0), which is the gradient autograd takes through the
twin, so nothing is saved but the seed and the rate. CUDA tensors take the
kernel (bf16 or float32) or raise; CPU tensors take the twin.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from . import LAUNCHES, _build
from .attention_cuda import DTYPE_CODE, launch_error
from .hash import dropout_threshold, fold_seed, hash_keep

THREADS = 256  # kThreads in csrc/hash_dropout.cu
VEC_BYTES = 16  # each thread's load and store a step


@functools.cache
def dropout_denom(rate: float, dtype) -> float:
    """The divisor of a kept value: 1 - rate rounded to ``dtype``, as JAX
    rounds its weak-typed scalar (0.8984375 in bf16 at rate 0.1); cached,
    so that a launch builds no tensor on the host."""
    return float(torch.tensor(1.0 - rate, dtype=dtype))


def apply_keep_mask(x: torch.Tensor, keep: torch.Tensor,
                    rate: float) -> torch.Tensor:
    """Dropout with a given 0/1 (or bool) keep mask of x's shape: kept
    values divided by ``dropout_denom`` (volta_tpu/models/layers.py:139-145
    and :255), the others 0. The divisor is a 0-dim tensor on x's device:
    with a Python float CUDA's true division multiplies by its reciprocal
    instead, which can move the last bit."""
    denom = torch.full((), dropout_denom(rate, x.dtype), dtype=x.dtype,
                       device=x.device)
    return torch.where(keep.bool(), x / denom, x.new_zeros(()))


def hash_dropout_ref(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Plain twin: counter-hash dropout of x over its linear index with the
    uint32 ``seed``, bit-equal to volta_tpu.models.layers.hash_dropout for
    the seed that its key draws."""
    n = torch.arange(x.numel(), dtype=torch.int64, device=x.device)
    return apply_keep_mask(x, hash_keep(n.view(x.shape), seed, rate), rate)


def split(x_addr: int, out_addr: int, n: int, itemsize: int):
    """How the kernel covers n elements of x at byte address ``x_addr``
    written to ``out_addr``: (head, vectors, tail), the scalar elements
    before x's first 16-byte boundary, the whole 16-byte vectors after it
    and the scalar elements past them. Where x and out lie at different
    offsets modulo 16 bytes no vector serves both: all n are head."""
    if (x_addr - out_addr) % VEC_BYTES:
        return n, 0, 0
    head = min(n, (-x_addr % VEC_BYTES) // itemsize)
    nvec = (n - head) // (VEC_BYTES // itemsize)
    return head, nvec, n - head - nvec * (VEC_BYTES // itemsize)


def grid_blocks(n: int, itemsize: int, per_card: int) -> int:
    """Blocks of the launch for n elements: as many as the card holds at
    once (``per_card``), but no more than give each thread one vector."""
    return max(1, min(per_card, -(-n // (THREADS * VEC_BYTES // itemsize))))


def out_like(x: torch.Tensor) -> torch.Tensor:
    """An empty contiguous tensor of x's shape and dtype at x's offset
    modulo 16 bytes, so that one vector loop serves both (``split``). Not a
    view: a storage offset set on a fresh tensor, so that the autograd
    Function's output may be modified in place."""
    shift = x.data_ptr() % VEC_BYTES // x.element_size()
    if not shift:
        return torch.empty_like(x, memory_format=torch.contiguous_format)
    buf = torch.empty(x.numel() + shift, dtype=x.dtype, device=x.device)
    return torch.empty(0, dtype=x.dtype, device=x.device).set_(
        buf.untyped_storage(), shift, x.shape)


@functools.cache
def _kernels():
    lib = _build.load()
    P, I, LL, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_uint32
    fn = lib.volta_hash_dropout
    fn.argtypes = [P, P, LL, LL, U, U, ctypes.c_float, I, I, I, P]
    fn.restype = I
    lib.volta_hash_dropout_blocks_per_sm.argtypes = [I, I, ctypes.POINTER(I)]
    lib.volta_hash_dropout_blocks_per_sm.restype = I
    lib.volta_cuda_error_string.argtypes = [I]
    lib.volta_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.volta_cuda_error_string


@functools.cache
def _per_card(device: int, code: int) -> int:
    """Blocks of the kernel that CUDA device ``device`` holds at once for
    dtype code ``code``: its SM count times the blocks an SM holds (the
    occupancy API), read once."""
    lib = _build.load()
    per_sm = ctypes.c_int(0)
    rc = lib.volta_hash_dropout_blocks_per_sm(code, device,
                                              ctypes.byref(per_sm))
    if rc != 0 or per_sm.value < 1:
        raise launch_error("hash_dropout occupancy", rc, _kernels()[1])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * per_sm.value


def _check(name, x, seed, rate):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"{name}: rate must be in [0, 1), got {rate}")
    if not 0 <= seed < 2**32:
        raise ValueError(f"{name}: seed must be a uint32, got {seed}")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x must lie on a CUDA device or the CPU, "
                         f"got {x.device}")
    if x.dtype not in DTYPE_CODE:
        raise ValueError(f"{name}: dtype must be bfloat16 or float32, got "
                         f"{x.dtype}")


def _launch(name, x, seed, rate):
    """The kernel on x (made contiguous first), counted under ``name``."""
    _check(name, x, seed, rate)
    x = x.contiguous()
    out = out_like(x)
    n = x.numel()
    if n == 0:
        return out
    fn, err_str = _kernels()
    dev, size, code = x.get_device(), x.element_size(), DTYPE_CODE[x.dtype]
    head = split(x.data_ptr(), out.data_ptr(), n, size)[0]
    rc = fn(out.data_ptr(), x.data_ptr(), n, head, seed,
            dropout_threshold(rate), dropout_denom(rate, x.dtype),
            grid_blocks(n, size, _per_card(dev, code)), code, dev,
            torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise launch_error(name, rc, err_str)
    LAUNCHES[name] += 1
    return out


def hash_dropout_fwd(x: torch.Tensor, seed: int, rate: float):
    """Counter-hash dropout of x (bf16 or float32, any shape; a
    non-contiguous x is made contiguous first) with the uint32 ``seed``:
    a contiguous tensor of x's shape and dtype. CPU tensors take the plain
    twin."""
    if x.device.type == "cpu":
        return hash_dropout_ref(x, seed, rate)
    return _launch("hash_dropout_fwd", x, seed, rate)


def hash_dropout_bwd(g: torch.Tensor, seed: int, rate: float):
    """The backward of ``hash_dropout_fwd`` for the cotangent g (x's shape):
    where(keep, g / denom, 0), the same kernel with the hash replayed. CPU
    tensors take the plain twin."""
    if g.device.type == "cpu":
        return hash_dropout_ref(g, seed, rate)
    return _launch("hash_dropout_bwd", g, seed, rate)


class HashDropout(torch.autograd.Function):
    """Counter-hash dropout of x with the uint32 ``seed``: forward
    ``hash_dropout_fwd``, backward ``hash_dropout_bwd`` (the kernel on the
    card, the twin on the CPU), looked up at call time. Saves no tensor.
    The seed is folded for the rank's elements (``hash.fold_seed``)."""

    @staticmethod
    def forward(ctx, x, seed, rate):
        seed = fold_seed(seed, x.numel())
        ctx.seed, ctx.rate = seed, rate
        return hash_dropout_fwd(x, seed, rate)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return hash_dropout_bwd(g, ctx.seed, ctx.rate), None, None
