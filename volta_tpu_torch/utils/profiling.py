"""Profiling and debugging hooks: counterpart of
``volta_tpu/utils/profiling.py``.

``trace`` records a ``torch.profiler`` session (CPU, and CUDA where a card
is present) on rank 0 and writes it as a Chrome trace into its log
directory; the encoder names each sublayer's range there (``attn_<i>``,
``ff_<i>``, as the JAX encoder's ``jax.named_scope``), and the train CLIs
each traced step's (``step_<n>``, n the steps done before it), both
through ``named_range``, which enters a range only while a profiler
records, so an untraced step pays one check a range. ``enable_nan_debugging`` is ``jax_debug_nans``: every
op's floating output, forward or backward, is checked for NaNs and the
first holding one raises ``FloatingPointError`` naming the op (slow; for
debugging only).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..parallel import is_rank0

logger = logging.getLogger(__name__)


def recording() -> bool:
    """Whether a profiler records on this thread."""
    return torch._C._autograd._profiler_enabled()


def named_range(name: str):
    """A profiler range named ``name`` while a profiler records, else a
    context that does nothing."""
    if recording():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


class Trace:
    """A ``torch.profiler`` session into ``logdir``: ``start()``, then
    ``stop()`` writes ``<logdir>/trace_<time>.json`` (Chrome trace format)
    and returns its path. On a rank other than 0 both do nothing."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.path = None
        self._prof = None
        self._scheduled = False

    def start(self, warmup: int = 0, active: int = 0):
        """Record from now on or, after ``warmup`` steps (``step()`` after
        each), for ``active`` steps."""
        if not is_rank0():
            return self
        os.makedirs(self.logdir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            # the work before the trace finishes outside it
            torch.cuda.synchronize()
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        kw = {}
        if warmup:
            kw = dict(schedule=torch.profiler.schedule(
                wait=0, warmup=warmup, active=active, repeat=1),
                on_trace_ready=self._write)
        self._prof = torch.profiler.profile(activities=acts, **kw)
        self._prof.__enter__()
        self._scheduled = bool(warmup)
        return self

    def step(self):
        """A step boundary of a scheduled session; the device finishes the
        steps before it first, so none of their work is recorded after."""
        if self._prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.step()

    def _write(self, prof):
        self.path = os.path.join(
            self.logdir, f"trace_{time.strftime('%Y_%m_%d_%H_%M_%S')}_"
            f"{os.getpid()}.json")
        prof.export_chrome_trace(self.path)
        logger.info("profiler trace written to %s", self.path)

    def stop(self):
        if self._prof is None:
            return None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        if not self._scheduled:
            self._write(self._prof)
        self._prof = None
        return self.path


@contextlib.contextmanager
def trace(logdir: str, enabled: bool = True):
    """Capture a profiler trace around the enclosed steps; yields the
    ``Trace`` (its ``path`` set on exit), or None when not enabled."""
    if not enabled:
        yield None
        return
    t = Trace(logdir).start()
    try:
        yield t
    finally:
        t.stop()


class ProfileSteps:
    """The train CLIs' ``--profile_steps N`` (train_task.py:266-280): a
    ``Trace`` into ``logdir`` of global steps ``START`` to ``START`` + N,
    stopped after a sync on the last step's loss; each traced step in its
    range, ``step_<n>``. The profiler runs one step ahead as its warm-up,
    recording nothing of it: a session's first launches can be missing
    from its records. ``close`` stops a trace that the run's end cut
    short."""

    START = 20

    def __init__(self, steps: int, logdir: str):
        self.steps = steps
        self.trace = Trace(logdir) if steps else None
        self.path = None

    def step(self, done: int):
        """The context of the step after ``done`` steps."""
        if self.trace is not None:
            if done == self.START - 1:
                self.trace.start(warmup=1, active=self.steps)
            elif self.START <= done < self.START + self.steps:
                self.trace.step()
        return named_range(f"step_{done}")

    def done(self, done: int, loss):
        """After a step, ``done`` steps now done."""
        if self.trace is not None and done == self.START + self.steps:
            float(loss)
            self.trace.step()
            self.close()

    def close(self):
        if self.trace is not None:
            self.path = self.trace.stop() or self.path
            self.trace = None


# creation ops return uninitialised memory, which the kernels' wrappers
# fill outside the dispatcher; their outputs are checked where an op reads
# them
_UNCHECKED = ("empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided")


class NanCheck(TorchDispatchMode):
    """Raise ``FloatingPointError`` at the first op whose floating output
    holds a NaN (the autograd engine's threads run under the mode too)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNCHECKED:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.is_floating_point() \
                        and bool(torch.isnan(t).any()):
                    raise FloatingPointError(
                        f"invalid value (nan) encountered in {func}")
        return out


def enable_nan_debugging() -> NanCheck:
    """Check every op's output for NaNs from here on, in this thread and
    the autograd engine's (``NanCheck``); returns the mode, whose
    ``__exit__(None, None, None)`` ends the checks."""
    mode = NanCheck()
    mode.__enter__()
    return mode


class StepTimer:
    """Lightweight wall-clock step timing with a sync point per window."""

    def __init__(self, window: int = 50):
        self.window = window
        self._time = time.perf_counter
        self._t0 = None
        self._count = 0

    def tick(self, sync_value=None) -> float | None:
        """Returns steps/sec once per window (forces sync via the value,
        a tensor through ``.item()``)."""
        self._count += 1
        if self._count % self.window:
            return None
        if sync_value is not None:
            sync_value.item() if isinstance(sync_value, torch.Tensor) \
                else float(sync_value)
        now = self._time()
        rate = None
        if self._t0 is not None:
            rate = self.window / (now - self._t0)
        self._t0 = now
        return rate
