"""The data-parallel context of a step: which rank of how many runs it.

The data half of ``volta_tpu/parallel/tp.py``: the JAX step installs its
mesh for the trace (``mesh_context``) and its call sites consult it; the
port's steps install ``data_parallel(rank, world)`` around the forward and
the backward (``mesh.step_context``), and the call sites that must see the
global batch read ``current_group()``:

  * every hash mask folds its seed for the rank's rows
    (``ops.hash.fold_seed``) and every generator draw takes the global
    shape and keeps the rank's rows (``ops.hash.seeded_bits``);
  * the losses divide by global counts, and NCE draws its negatives from
    the global batch (``losses``);
  * rows 9 and 14 do not run when the world is above 1, as JAX's gates
    close them under a mesh (volta_tpu/models/layers.py:133,
    encoder.py:168).

The context is the process's, not a thread's: autograd runs the backward
of CUDA tensors, and a checkpointed block's recomputation within it, on
threads of its own. The ``model`` half (tensor parallelism over heads)
is ROADMAP.md Queue 1 item 9b.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """Rank ``rank`` of ``world`` ranks, each holding ``1/world`` of the
    global batch: rank r the rows r·B to (r+1)·B of it."""
    rank: int
    world: int


_GROUP = [None]


@contextlib.contextmanager
def data_parallel(rank: int, world: int):
    """Install ``DataGroup(rank, world)`` for the block."""
    if not 0 <= rank < world:
        raise ValueError(f"data_parallel: rank {rank} of {world}")
    prev = _GROUP[0]
    _GROUP[0] = DataGroup(int(rank), int(world))
    try:
        yield _GROUP[0]
    finally:
        _GROUP[0] = prev


def current_group() -> Optional[DataGroup]:
    """The installed group, or None outside ``data_parallel``."""
    return _GROUP[0]


def split_world() -> bool:
    """Whether the installed group has more than one rank: the gates of
    rows 9 and 14 close then, as JAX's do under a mesh of more than one
    device (``mesh_context`` treats a one-device mesh as none)."""
    g = _GROUP[0]
    return g is not None and g.world > 1
