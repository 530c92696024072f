"""The port's profiling hooks (``volta_tpu_torch.utils.profiling``) against
``volta_tpu/utils/profiling.py`` and the JAX CLIs' ``--profile_steps``, on
the CPU.

- ``trace`` writes a Chrome trace only when enabled and on rank 0, with
  the encoder's sublayer ranges under the JAX module's names
  (``attn_<i>``, ``ff_<i>``) when a forward runs inside it, and none
  outside a trace.
- ``--profile_steps 2`` on tiny ``train_task`` and ``train_concap`` runs
  (24 steps) traces global steps 20 and 21 and no other (JAX starts its
  trace before the step at global step 20 and stops after step 20 + N,
  train_task.py:266-280), each with the four sublayers' ranges.
- ``StepTimer``: None inside a window, a rate at its end, a tensor synced.
- ``enable_nan_debugging``: on a batch with a NaN feature the port raises
  ``FloatingPointError`` where JAX under ``jax.debug_nans`` (scoped by its
  config context) raises, and neither raises on the clean batch; a NaN
  that only the backward makes raises too; ``--debug_nans`` is that mode.
"""

import contextlib
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_concap import cli  # noqa: F401 (a fixture)
from test_torch_port_model import TASK_CFG, flax_params, make_batch, \
    small_cfg  # noqa: F401 (a fixture)
from test_torch_port_train_cli import workdir  # noqa: F401 (a fixture)
from volta_tpu.models import VoltaForVLTasks as JaxVLTasks
from volta_tpu_torch import VoltaForVLTasks, train_concap, train_task
from volta_tpu_torch.config import VoltaConfig
from volta_tpu_torch.convert import load_flax_params
from volta_tpu_torch.utils import profiling

SUBLAYERS = ["attn_0", "ff_1", "attn_2", "ff_3"]
KEYS = ("question", "features", "spatials")
REST = ("segment_ids", "input_mask", "image_mask")


def events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def ranges(path):
    """The user ranges' names of a trace, in order of start."""
    evs = sorted((e for e in events(path)
                  if e.get("cat") == "user_annotation"),
                 key=lambda e: e["ts"])
    return [e["name"] for e in evs]


def port_model(params, **kw):
    cfg = VoltaConfig.from_dict(dict(small_cfg("float32", True).to_dict(),
                                     **kw))
    return load_flax_params(VoltaForVLTasks(cfg, TASK_CFG, ("TASK1",)),
                            params).eval()


def port_forward(model, batch):
    with torch.no_grad():
        return model(*[torch.from_numpy(batch[k]) for k in KEYS], "TASK1",
                     *[torch.from_numpy(batch[k]) for k in REST])


def test_trace_writes_only_when_enabled_on_rank_0(flax_params, tmp_path,
                                                  monkeypatch):
    model, batch = port_model(flax_params), make_batch(1)
    with profiling.trace(str(tmp_path / "off"), enabled=False) as t:
        port_forward(model, batch)
    assert t is None and not (tmp_path / "off").exists()

    with profiling.trace(str(tmp_path / "on")) as t:
        assert profiling.recording()
        port_forward(model, batch)
    assert not profiling.recording()
    assert os.path.dirname(t.path) == str(tmp_path / "on")
    assert ranges(t.path) == SUBLAYERS
    # outside a trace no range is entered
    assert isinstance(profiling.named_range("attn_0"),
                      contextlib.nullcontext)

    # the general loop names its sublayers too
    with profiling.trace(str(tmp_path / "general")) as t:
        with torch.no_grad():
            model.bert(*[torch.from_numpy(batch[k]) for k in KEYS],
                       *[torch.from_numpy(batch[k]) for k in REST],
                       output_all_layers=True)
    assert ranges(t.path) == SUBLAYERS

    monkeypatch.setattr(torch.distributed, "is_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    with profiling.trace(str(tmp_path / "rank1")) as t:
        port_forward(model, batch)
    assert t.path is None and not (tmp_path / "rank1").exists()


def _traced_steps(path):
    names = ranges(path)
    steps = [n for n in names if n.startswith("step_")]
    # each traced step's forward runs the four sublayers' ranges
    assert [n for n in names if n in SUBLAYERS] == SUBLAYERS * len(steps)
    return steps


def test_profile_steps_train_task(workdir):  # noqa: F811
    log = os.path.join(workdir["tmp"], "profiled_logs")
    out = train_task.main(workdir["base"] + [
        "--output_dir", os.path.join(workdir["tmp"], "profiled"),
        "--logdir", log, "--num_train_epochs", "6", "--eval_period", "9",
        "--profile_steps", "2"])
    assert out["steps"] == 24
    assert os.path.dirname(out["profile_trace"]) == out["log_dir"]
    assert out["log_dir"].startswith(log)
    assert glob.glob(os.path.join(out["log_dir"], "trace_*.json")) == [
        out["profile_trace"]]
    assert _traced_steps(out["profile_trace"]) == ["step_20", "step_21"]


def test_profile_steps_train_concap(cli, tmp_path):  # noqa: F811
    out = train_concap.main(cli["base"] + [
        "--output_dir", str(tmp_path / "save"), "--logdir",
        str(tmp_path / "logs"), "--num_train_epochs", "6",
        "--profile_steps", "2"])
    assert out["steps"] == 24
    assert os.path.dirname(out["profile_trace"]) == out["log_dir"]
    assert _traced_steps(out["profile_trace"]) == ["step_20", "step_21"]


def test_step_timer():
    timer = profiling.StepTimer(window=3)
    seen = []

    class Synced(torch.Tensor):
        def item(self):
            seen.append(1)
            return super().item()

    sync = torch.tensor(1.0).as_subclass(Synced)
    assert [timer.tick(sync) for _ in range(2)] == [None, None]
    assert timer.tick(sync) is None and seen == [1]  # the first window
    for _ in range(2):
        assert timer.tick() is None
    rate = timer.tick(2.0)
    assert rate is not None and rate > 0


def test_nan_debugging_raises_where_jax_does(flax_params):
    batch = make_batch(4)
    bad = dict(batch, features=batch["features"].copy())
    bad["features"][1, 2, 3] = np.nan
    jmodel = JaxVLTasks(small_cfg("float32", False), TASK_CFG, ("TASK1",))

    def jax_forward(b):
        return jmodel.apply({"params": flax_params},
                            *[jnp.asarray(b[k]) for k in KEYS], "TASK1",
                            *[jnp.asarray(b[k]) for k in REST])[0]

    model = port_model(flax_params, use_pallas=False)
    with jax.debug_nans(True):
        assert np.isfinite(np.asarray(jax_forward(batch))).all()
        with pytest.raises(FloatingPointError):
            jax_forward(bad)
    mode = profiling.enable_nan_debugging()
    try:
        assert torch.isfinite(port_forward(model, batch)).all()
        with pytest.raises(FloatingPointError, match="nan"):
            port_forward(model, bad)
        # a NaN that only the backward makes: the norm's gradient at 0
        x = torch.zeros(3, requires_grad=True)
        y = torch.linalg.vector_norm(x)
        with pytest.raises(FloatingPointError):
            y.backward()
    finally:
        mode.__exit__(None, None, None)
    # off again: the NaN batch runs
    assert torch.isnan(port_forward(model, bad)).any()

    with train_task.debug_nans(True):
        with pytest.raises(FloatingPointError):
            port_forward(model, bad)
    with train_task.debug_nans(False):
        port_forward(model, bad)
