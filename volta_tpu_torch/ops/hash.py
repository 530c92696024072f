"""The counter hash behind every dropout mask of the port.

The keep bit of element n (a linear index) for a uint32 seed is
fmix32(n * 0x9E3779B9 + seed) < threshold, all modulo 2^32, with the
threshold uint32((1 - rate) * (2^32 - 1)): the JAX package's
``hash_dropout`` (volta_tpu/models/layers.py:_fmix32). ``hash_dropout`` in
``models.layers``, the dropout-attention twins and the fused residual twins
take their masks from here; the CUDA kernels hold the same hash in
``csrc/common.cuh``.

Under data parallelism (``parallel.data_parallel``) rank r of W holds rows
r·B to (r+1)·B of the global batch, and every hashed index space has the
batch as its slowest axis, so rank r's element n is the global element
n + r·(its local element count). ``fold_seed`` moves that shift into the
seed, which the kernels take as it is; ``seeded_bits`` draws the global
shape and keeps the rank's rows.
"""

from __future__ import annotations

import torch

from ..parallel.tp import current_group

_M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def _mul32(a, c: int):
    """(a * c) mod 2^32 for a in [0, 2^32) (an int64 tensor or an int) and a
    constant c < 2^32, without overflowing int64: a * c splits into
    a * (c mod 2^16) + ((a * (c >> 16)) mod 2^16) * 2^16."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def fmix32(h):
    """murmur3 finalizer on uint32 values held in int64 tensors or ints
    (volta_tpu/models/layers.py:_fmix32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def dropout_threshold(rate: float) -> int:
    """The keep threshold of ``rate`` as the JAX package computes it:
    uint32((1 - rate) * (2^32 - 1)) in double precision, truncated."""
    return int((1.0 - rate) * 4294967295.0)


def hash_bits(index: torch.Tensor, seed: int) -> torch.Tensor:
    """The uint32 draws (held in int64) of the elements at linear ``index``
    (int64): fmix32(index * 0x9E3779B9 + seed), all modulo 2^32."""
    return fmix32((_mul32(index & _M32, GOLDEN) + (int(seed) & _M32)) & _M32)


def fold_seed(seed: int, local_numel: int) -> int:
    """The seed that gives this rank's hashed elements the global batch's
    bits: with rank r of the installed group and base = r · ``local_numel``
    (the hashed tensor's elements on this rank), (n + base)·G + seed =
    n·G + (base·G + seed), all modulo 2^32 as JAX's uint32 iota wraps. The
    seed itself outside a group and on rank 0."""
    g = current_group()
    if g is None or g.rank == 0:
        return int(seed)
    base = (g.rank * int(local_numel)) & _M32
    return (int(seed) + _mul32(base, GOLDEN)) & _M32


def seeded_bits(shape, seed: int, device) -> torch.Tensor:
    """Raw uint32 draws (held in int64) of ``shape`` from a
    ``torch.Generator`` on ``device`` seeded with the uint32 ``seed``: the
    draws of ``int_threshold_dropout`` and of the plain attention route's
    dropout. The generator is made here, so a seed always gives the same
    draws and the global generator is neither read nor moved. Inside a
    group of W ranks it draws the global shape [W·B, ...] (``shape`` [B,
    ...], the batch leading) and returns the rank's rows, W times the
    draws, as JAX draws the global shape under a mesh."""
    gen = torch.Generator(device=device).manual_seed(int(seed) & _M32)
    shape = tuple(shape)
    g = current_group()
    if g is None or g.world == 1:
        return torch.randint(0, 2**32, shape, generator=gen,
                             dtype=torch.int64, device=device)
    b = shape[0]
    bits = torch.randint(0, 2**32, (g.world * b,) + shape[1:],
                         generator=gen, dtype=torch.int64, device=device)
    return bits[g.rank * b:(g.rank + 1) * b]


def hash_keep(index: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Keep bits of the elements at linear ``index`` (int64): their draw
    ``hash_bits(index, seed)`` < threshold."""
    return hash_bits(index, seed) < dropout_threshold(rate)
