"""Data parallelism as PyTorch runs it: one process a GPU, started by
``torchrun`` and joined by ``torch.distributed``.

Counterpart of the ``data`` axis of ``volta_tpu/parallel/mesh.py``
(:25-46, :117-141), where one jitted step spans the mesh and XLA sums the
gradient over it. Here each rank feeds its own 1/W of the global batch
(``per_rank_batch``, ``shard_args``), runs the one-GPU step inside
``step_context``, and sums the gradients that exist across the ranks
before the clip and the optimizer (``all_reduce_grads``); every rank then
takes the same update. NCCL joins the ranks on the card and gloo on the
CPU; gloo's collectives take host tensors, so a CUDA tensor goes through
a host copy there (``_on_backend``), while the compute stays on the card.

Every collective is an ``all_reduce`` or a ``broadcast``: an all-gather is
an all-reduce of a zero buffer in which each rank fills its own rows, with
the bytes summed as integers, so every bit pattern arrives as it left.
Without a process group (a one-GPU run) each is the identity and runs
nothing.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterable, List

import torch
import torch.distributed as dist

from .tp import current_group, data_parallel

# flat buffers of at most this many bytes a collective
BUCKET_BYTES = 256 * 2**20


def active() -> bool:
    """Whether this process is in a process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def is_rank0() -> bool:
    return rank() == 0


def init_distributed(device) -> torch.device:
    """Join the process group that ``torchrun`` describes in the
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, and the
    rendezvous in ``MASTER_ADDR`` / ``MASTER_PORT``): NCCL for a CUDA
    ``device``, whose rank then runs on ``cuda:<LOCAL_RANK>`` (made the
    current device), gloo for the CPU. Returns the rank's device."""
    device = torch.device(device)
    missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                           "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise SystemExit(
            f"--distributed needs torchrun's environment ({', '.join(missing)}"
            " unset): torchrun --standalone --nproc_per_node N -m "
            "volta_tpu_torch.train_task --distributed ...")
    backend = "gloo"
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
        backend = "nccl"
    if not active():
        dist.init_process_group(backend)
    return device


def step_context():
    """``data_parallel(rank(), world_size())`` inside a process group,
    else nothing: the context a step installs around its forward and
    backward."""
    if not active():
        return contextlib.nullcontext()
    return data_parallel(rank(), world_size())


def per_rank_batch(batch_size: int, grad_acc_steps: int = 1) -> int:
    """A rank's micro-batch: the global batch over the accumulation steps
    and the ranks, as JAX's per-host batch (volta_tpu/task_utils.py:111,
    train_concap.py:160)."""
    b = batch_size // grad_acc_steps // world_size()
    if b < 1:
        raise ValueError(f"batch {batch_size} over {grad_acc_steps} "
                         f"accumulation steps and {world_size()} ranks "
                         "leaves no rows a rank")
    return b


def shard_args() -> Dict[str, int]:
    """The loader's shard of this rank: ``num_shards`` W, ``shard_index``
    r (``data.loader.DataLoader``)."""
    return {"num_shards": world_size(), "shard_index": rank()}


def _backend_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _on_backend(flat: torch.Tensor, collective):
    """Run ``collective`` on ``flat`` where the backend takes it: a copy
    on the backend's device (the host for gloo, the card for NCCL) where
    ``flat`` lies elsewhere, copied back after."""
    dev = _backend_device()
    work = flat if flat.device == dev else flat.to(dev)
    collective(work)
    if work is not flat:
        flat.copy_(work)


def _buckets(tensors: List[torch.Tensor]) -> Iterable[List[torch.Tensor]]:
    """``tensors`` in order, in runs of one dtype and device of at most
    ``BUCKET_BYTES`` each (a larger tensor alone)."""
    run, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if run and (t.dtype != run[0].dtype or t.device != run[0].device
                    or size + nbytes > BUCKET_BYTES):
            yield run
            run, size = [], 0
        run.append(t)
        size += nbytes
    if run:
        yield run


def _flat_collective(tensors: List[torch.Tensor], collective):
    """``collective`` over ``tensors`` in place, through flat buffers."""
    for run in _buckets([t for t in tensors if t.numel()]):
        flat = torch.cat([t.reshape(-1) for t in run])
        _on_backend(flat, collective)
        torch._foreach_copy_(run, [part.view(t.shape) for t, part in zip(
            run, flat.split([t.numel() for t in run]))])


def all_reduce_(tensors: List[torch.Tensor]) -> None:
    """Sum each of ``tensors`` over the ranks, in place, where a group is
    installed."""
    if current_group() is not None:
        _flat_collective(list(tensors), dist.all_reduce)


def all_reduce_grads(params: Iterable[torch.Tensor]) -> None:
    """Sum the gradients that exist over the ranks, in place. A parameter
    without a gradient keeps none, so the set of parameters with one is
    the one-GPU step's (the optimizer reads a missing gradient as zero;
    ``skip_disconnected`` reads an all-zero one), and the state dict's
    keys stay the model's."""
    all_reduce_([p.grad for p in params if p.grad is not None])


def sum_across(x: torch.Tensor) -> torch.Tensor:
    """x summed over the installed group's ranks (x itself outside one):
    a new tensor, outside autograd."""
    if current_group() is None:
        return x
    y = x.detach().clone()
    all_reduce_([y])
    return y


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """[W·B, ...]: every rank's x [B, ...] (the same shape on each) in rank
    order, where a group is installed (x itself outside one). The bytes of
    a zero buffer in which this rank fills its own rows are summed as
    integers over the ranks: every bit pattern, -0 and NaN among them,
    arrives as it left. Outside autograd."""
    g = current_group()
    if g is None:
        return x
    b = x.shape[0]
    out = x.new_zeros((g.world * b,) + tuple(x.shape[1:]))
    out[g.rank * b:(g.rank + 1) * b] = x.detach()
    _flat_collective([out.view(torch.uint8)], dist.all_reduce)
    return out


def min_across(n: int) -> int:
    """The least of the ranks' ``n`` (n itself without a process group):
    the batches every rank has, so that the ranks' steps pair up."""
    if not active():
        return int(n)
    t = torch.tensor([int(n)], dtype=torch.int64)
    _on_backend(t, lambda w: dist.all_reduce(w, op=dist.ReduceOp.MIN))
    return int(t.item())


def _tensors(obj) -> List[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    return []


def broadcast_state(state) -> None:
    """Rank 0's train state (``train_step.TrainState``) on every rank, in
    place: the model's parameters and buffers, the optimizer's tensors
    (the moments, and the running mean under accumulation) and counts,
    the step and the dropout-seed generator. Run after the weights are
    loaded or a run resumed, so that the ranks start equal to the bit."""
    if not active():
        return
    opt = state.optimizer
    with torch.no_grad():
        tensors = (list(state.model.parameters())
                   + list(state.model.buffers())
                   + _tensors(opt.state_dict()))
        _flat_collective(tensors, lambda w: dist.broadcast(w, 0))
    counts = torch.tensor([state.step, opt.count, opt.adam_count,
                           opt.mini_step], dtype=torch.int64)
    _on_backend(counts, lambda w: dist.broadcast(w, 0))
    state.step, opt.count, opt.adam_count, opt.mini_step = \
        (int(v) for v in counts.tolist())
    gen = state.generator.get_state()
    _on_backend(gen, lambda w: dist.broadcast(w, 0))
    state.generator.set_state(gen)
