"""The hand-written CUDA keep mask of the hidden dropouts
(``csrc/dropout_mask.cu``), its wrapper and its plain twin.

Port of the TPU kernel of ``use_pallas_dropout_mask``, Queue 2 row 14:
``_mask_kernel`` (volta_tpu/ops/dropout_mask.py:28, launched by
``pallas_keep_mask`` :50), which draws a sublayer tail's 0/1 keep mask and
leaves the apply, the residual add and the LayerNorm to the caller
(volta_tpu/models/layers.py:126-145). The TPU draws from the Mosaic PRNG;
here element i of the mask (its linear index) is kept iff
fmix32(i * 0x9E3779B9 + seed) < threshold, ``hash_dropout``'s bit for the
same uint32 seed, stored as uint8 0/1. A tail that applies it drops exactly
what ``hash_dropout(x, seed, rate)`` drops. ``supported`` is the TPU
kernel's shape gate, kept so that the port takes the same branch.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import LAUNCHES, _build
from . import attention_dropout_cuda as adc
from .attention_cuda import launch_error
from .hash import dropout_threshold


def _row_tile(n: int, cap: int = 1024) -> int:
    rt = min(cap, n)
    while rt > 1 and n % rt:
        rt -= 1
    return rt


def supported(shape) -> bool:
    """The TPU kernel's gate (dropout_mask.py:42-47): at least 8 rows, a
    last dimension that is a multiple of 128, a row tile of at least 8."""
    n = math.prod(shape[:-1])
    return n >= 8 and shape[-1] % 128 == 0 and _row_tile(n) >= 8


def _check(rate, seed):
    if not 0.0 < rate < 1.0:
        raise ValueError(f"keep_mask: rate must be in (0, 1), got {rate}")
    if not 0 <= seed < 2**32:
        raise ValueError(f"keep_mask: seed must be a uint32, got {seed}")


def keep_mask_ref(shape, rate: float, seed: int, device=None):
    """Plain twin: the uint8 0/1 keep mask of ``shape``, element i (linear
    index) kept iff ``hash_keep(i, seed, rate)`` (the attention kernels'
    ``keep_mask`` over this shape)."""
    return adc.keep_mask(seed, shape, rate, device).to(torch.uint8)


@functools.cache
def _kernel():
    lib = _build.load()
    fn = lib.volta_keep_mask
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32,
                   ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.volta_cuda_error_string.argtypes = [ctypes.c_int]
    lib.volta_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.volta_cuda_error_string


def keep_mask(shape, rate: float, seed: int, device) -> torch.Tensor:
    """The uint8 0/1 keep mask of ``shape`` for the dropout ``rate`` and the
    uint32 ``seed`` on ``device``: the kernel on a CUDA device, the plain
    twin on the CPU."""
    _check(rate, seed)
    device = torch.device(device)
    if device.type == "cpu":
        return keep_mask_ref(shape, rate, seed, device)
    if device.type != "cuda":
        raise ValueError(f"keep_mask: device must be cuda or cpu, got "
                         f"{device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    fn, err_str = _kernel()
    mask = torch.empty(tuple(shape), dtype=torch.uint8, device=device)
    rc = fn(mask.data_ptr(), mask.numel(), seed, dropout_threshold(rate),
            device.index, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise launch_error("keep_mask", rc, err_str)
    LAUNCHES["keep_mask"] += 1
    return mask
