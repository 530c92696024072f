"""Resuming the port's fine-tuning, on the CPU.

- **From the reference's tar.** The test writes a
  ``pytorch_ckpt_latest.tar`` as the reference's trainer does
  (volta/train_utils.py:305-317): weights from JAX's
  ``export_torch_state_dict`` of random Flax params, AdamW moments under
  torch's optimizer-state indices in both grouping schemes (one parameter a
  group, train_task.py:208-218; decay then no-decay, train_concap.py
  :204-210), a moments ``step`` (7) that differs from ``global_step`` (5),
  and an object whose class does not import (the reference's
  ``tbLogger``). JAX's ``resume_from_torch_tar`` and the port's
  ``resume_from_reference_tar`` resume from it, with and without bias
  correction, and three fp32 steps on each agree within
  tests/test_torch_port_train.py's tolerances.
- **Native.** 2k steps with dropout equal k steps, ``save_train_state``,
  fresh objects, ``restore_train_state`` and k more, bit for bit: losses,
  parameters, moments, counts, generator. A reference tar written from the
  port's state (``save_reference_tar``) resumes to the same bits, given
  the same generator (the tar holds none).
- **The CLIs.** The train CLI resumes from its own ``ckpt/`` at the next
  epoch, bit-equal to the run that was not interrupted, and from
  ``--resume_file`` (a train state directory, or a tar at its
  ``epoch_id`` + 1 or ``global_step`` over the epoch's steps); the eval
  CLI scores a reference ``.bin`` as it scores the train state it came
  from.
"""

import os
import shutil
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_model import TASK_CFG, make_batch, small_cfg
from test_torch_port_train import BETAS, CLIP, EPS, LR, WARMUP, WD, \
    _flax_init
from test_torch_port_train_cli import workdir  # noqa: F401 (fixture)
from volta_tpu import checkpoint as jck
from volta_tpu.optimization import build_optimizer as jax_build_optimizer
from volta_tpu.optimization import warmup_linear_schedule as jax_warmup
from volta_tpu.parallel.train_step import create_train_state as jax_state
from volta_tpu.task_utils import process_batch as jax_process_batch
from volta_tpu.task_utils import task_loss_and_score as jax_loss_and_score
from volta_tpu_torch import VoltaForVLTasks
from volta_tpu_torch import checkpoint as ck
from volta_tpu_torch import eval_task as port_eval
from volta_tpu_torch import train_task as port_train
from volta_tpu_torch.config import VoltaConfig
from volta_tpu_torch.convert import state_dict_from_flax
from volta_tpu_torch.models.layers import init_weights
from volta_tpu_torch.optimization import build_optimizer, \
    warmup_linear_schedule
from volta_tpu_torch.task_utils import load_task_config
from volta_tpu_torch.train_step import create_train_state, \
    make_task_train_step

TOTAL, GLOBAL_STEP, MOMENT_STEP, AFTER = 20, 5, 7, 3


class _TbLogger:
    """Stands for the reference's tbLogger: pickled from a module that the
    loader cannot import."""

    def __init__(self):
        self.txt = "log"


def _unimportable_object():
    mod = types.ModuleType("reference_tb_logger_gone")
    cls = type("TbLogger", (_TbLogger,), {"__module__": mod.__name__})
    mod.TbLogger = cls
    sys.modules[mod.__name__] = mod
    return cls(), mod.__name__


def write_reference_tar(path, jcfg, params, grouping, correct_bias):
    msd = jck.export_torch_state_dict(jcfg, params)[0]
    named = [k for k in msd if k not in jck._alias_key_set(jcfg, msd)]
    nd = lambda k: any(s in k for s in jck._NO_DECAY_REF)  # noqa: E731
    if grouping == "one_per_group":
        order = named
    else:
        order = [k for k in named if not nd(k)] + [k for k in named if nd(k)]
    rng = np.random.RandomState(11)
    states = {i: {"step": MOMENT_STEP,
                  "exp_avg": torch.from_numpy(
                      1e-3 * rng.randn(*msd[k].shape).astype(np.float32)),
                  "exp_avg_sq": torch.from_numpy(
                      1e-6 * rng.rand(*msd[k].shape).astype(np.float32))}
              for i, k in enumerate(order)}
    hyper = {"lr": LR, "betas": BETAS, "eps": EPS,
             "correct_bias": correct_bias}
    if grouping == "one_per_group":
        groups = [dict(hyper, weight_decay=0.0 if nd(k) else WD, params=[i])
                  for i, k in enumerate(order)]
    else:
        n_decay = sum(not nd(k) for k in named)
        groups = [dict(hyper, weight_decay=WD, params=list(range(n_decay))),
                  dict(hyper, weight_decay=0.0,
                       params=list(range(n_decay, len(order))))]
    logger, modname = _unimportable_object()
    torch.save({"model_state_dict": {k: torch.from_numpy(
                    np.ascontiguousarray(v)) for k, v in msd.items()},
                "optimizer_state_dict": {"state": states,
                                         "param_groups": groups},
                "scheduler_state_dict": {"last_epoch": GLOBAL_STEP},
                "global_step": GLOBAL_STEP, "epoch_id": 1, "score": 0.25,
                "tbLogger": logger}, path)
    del sys.modules[modname]


def _jax_continue(jcfg, params, path, correct_bias, batch):
    from volta_tpu.models import VoltaForVLTasks as JaxVLTasks

    model = JaxVLTasks(jcfg, TASK_CFG, ("TASK1",))
    tx = jax_build_optimizer("adamw", jax_warmup(LR, WARMUP, TOTAL),
                             params, weight_decay=WD, clip_norm=CLIP,
                             betas=BETAS, eps=EPS, correct_bias=correct_bias)
    init = jax.tree.map(lambda p: jnp.zeros_like(jnp.asarray(p)), params)
    state = jax_state(jax.random.PRNGKey(0), init, tx)
    state, info = jck.resume_from_torch_tar(jcfg, state, path)
    tc = TASK_CFG["TASK1"]
    jb = jax.tree.map(jnp.asarray, batch)

    def loss_fn(p):
        inputs, binfo = jax_process_batch(tc, jb)
        pred, _ = model.apply(
            {"params": p}, inputs["input_ids"], inputs["image_feat"],
            inputs["image_loc"], "TASK1", inputs["token_type_ids"],
            inputs["attention_mask"], inputs["image_attention_mask"],
            deterministic=True)
        return jax_loss_and_score(tc["type"], pred, jb, binfo)[0]

    p, opt_state, losses = state.params, state.opt_state, []
    for _ in range(AFTER):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        upd, opt_state = tx.update(grads, opt_state, p)
        p = optax.apply_updates(p, upd)
        losses.append(float(loss))
    return info, losses, p


@pytest.mark.parametrize("correct_bias", [False, True])
@pytest.mark.parametrize("grouping", ["one_per_group", "decay_then_not"])
def test_reference_tar_resumes_as_in_jax(grouping, correct_bias, tmp_path):
    jcfg = small_cfg()
    batch = make_batch(4)
    params = _flax_init(jcfg, batch)[1]
    path = str(tmp_path / "pytorch_ckpt_latest.tar")
    write_reference_tar(path, jcfg, params, grouping, correct_bias)
    jinfo, jlosses, jparams = _jax_continue(jcfg, params, path,
                                            correct_bias, batch)

    pcfg = VoltaConfig.from_dict(jcfg.to_dict())
    model = VoltaForVLTasks(pcfg, TASK_CFG, ("TASK1",))
    init_weights(model, torch.Generator().manual_seed(3))
    opt = build_optimizer("adamw", warmup_linear_schedule(LR, WARMUP, TOTAL),
                          model, weight_decay=WD, clip_norm=CLIP,
                          betas=BETAS, eps=EPS, correct_bias=correct_bias)
    state = create_train_state(model.eval(), opt, seed=0)
    info = ck.resume_from_reference_tar(pcfg, state, path)
    assert info == jinfo
    assert info["global_step"] == state.step == opt.count == GLOBAL_STEP
    assert opt.adam_count == MOMENT_STEP
    assert info["hyperparams"]["correct_bias"] == correct_bias
    step = make_task_train_step(model, opt, TASK_CFG, "TASK1")
    losses = [float(step(state, batch)["loss"]) for _ in range(AFTER)]
    np.testing.assert_allclose(losses, jlosses, rtol=2e-4)
    ref = state_dict_from_flax(jax.tree.map(np.asarray, jparams))
    got = model.state_dict()
    for name, want in ref.items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


def test_tar_without_moments_or_model_state(tmp_path):
    pcfg = VoltaConfig.from_dict(small_cfg().to_dict())
    model = VoltaForVLTasks(pcfg, TASK_CFG, ("TASK1",))
    state = create_train_state(model, build_optimizer("adamw", 1e-3, model),
                               0)
    torch.save({"global_step": 3}, tmp_path / "bad.tar")
    with pytest.raises(ValueError, match="no model_state_dict"):
        ck.resume_from_reference_tar(pcfg, state, str(tmp_path / "bad.tar"))
    sd = ck.export_reference_state_dict(pcfg, model)[0]
    torch.save({"model_state_dict": sd, "global_step": 3},
               tmp_path / "weights.tar")
    info = ck.resume_from_reference_tar(pcfg, state,
                                        str(tmp_path / "weights.tar"))
    assert info["global_step"] == state.step == state.optimizer.count == 3
    assert state.optimizer.adam_count == 0 and info["hyperparams"] == {}


# ------------------------------------------------------------------ native
def _native_setup(init_seed, gen_seed):
    pcfg = VoltaConfig.from_dict(small_cfg().to_dict())
    model = VoltaForVLTasks(pcfg, TASK_CFG, ("TASK1",))
    init_weights(model, torch.Generator().manual_seed(init_seed))
    opt = build_optimizer("adamw", warmup_linear_schedule(1e-3, 2, 20),
                          model, clip_norm=1.0, correct_bias=True)
    state = create_train_state(model.train(), opt, seed=gen_seed)
    return pcfg, state, make_task_train_step(model, opt, TASK_CFG, "TASK1")


def _run(state, step, batches):
    return [step(state, b)["loss"] for b in batches]


def _snapshot(state, losses):
    opt = state.optimizer.state_dict()
    return (torch.stack(losses), state.step, opt["count"],
            opt["adam_count"], state.model.state_dict(), opt["mu"],
            opt["nu"], state.generator.get_state())


def assert_same_run(a, b):
    la, sa, ca, aa, pa, ma, na, ga = a
    lb, sb, cb, ab, pb, mb, nb, gb = b
    assert torch.equal(la, lb) and (sa, ca, aa) == (sb, cb, ab)
    assert torch.equal(ga, gb)
    for x, y in ((pa, pb), (ma, mb), (na, nb)):
        assert set(x) == set(y)
        for k in x:
            assert torch.equal(x[k], y[k]), k


K = 2


def test_native_and_tar_resume_are_bit_equal(tmp_path):
    batches = [make_batch(s) for s in range(2 * K)]
    _, state, step = _native_setup(1, 3)
    whole = _snapshot(state, _run(state, step, batches))

    pcfg, state, step = _native_setup(1, 3)
    first = _run(state, step, batches[:K])
    ck.save_train_state(str(tmp_path / "ckpt"), state, 0, 0.5)
    ck.save_reference_tar(str(tmp_path / "latest.tar"), pcfg, state,
                          epoch_id=0)
    saved_gen = state.generator.get_state()

    _, fresh, fstep = _native_setup(7, 9)  # other weights, other generator
    info = ck.restore_train_state(str(tmp_path / "ckpt"), fresh)
    assert info == {"step": K, "epoch": 0, "best_score": 0.5}
    native = _snapshot(fresh, first + _run(fresh, fstep, batches[K:]))
    assert_same_run(native, whole)

    _, fresh, fstep = _native_setup(7, 9)
    tinfo = ck.resume_from_reference_tar(pcfg, fresh,
                                         str(tmp_path / "latest.tar"))
    assert tinfo["global_step"] == K and tinfo["epoch_id"] == 0
    fresh.generator.set_state(saved_gen)  # the tar carries no generator
    assert_same_run(_snapshot(fresh, first + _run(fresh, fstep, batches[K:])),
                    whole)


# -------------------------------------------------------------------- CLIs
def _train(workdir, out, epochs, *extra):  # noqa: F811
    return port_train.main(workdir["base"] + [
        "--output_dir", os.path.join(workdir["tmp"], out),
        "--logdir", os.path.join(workdir["tmp"], "logs_" + out),
        "--num_train_epochs", str(epochs), "--clip_grad_norm", "1.0",
        "--lr_scheduler", "warmup_constant", "--warmup_steps", "2",
        *extra])


def _val_epochs(out):
    with open(os.path.join(out["log_dir"], "out.txt")) as f:
        return [int(l.split(" VAL epoch ")[1].split()[0]) for l in f
                if " VAL epoch " in l]


def _ckpt(out):
    return torch.load(os.path.join(out["run_dir"], "ckpt", "train_state.pt"),
                      weights_only=True)


def _assert_same_ckpt(a, b):
    assert a["step"] == b["step"] and torch.equal(a["generator"],
                                                  b["generator"])
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for m in ("mu", "nu"):
        for k in a["optimizer"][m]:
            assert torch.equal(a["optimizer"][m][k], b["optimizer"][m][k])


def test_train_cli_resumes(workdir, tmp_path):  # noqa: F811
    whole = _train(workdir, "whole", 3)
    assert whole["steps"] == 12 and _val_epochs(whole) == [0, 1, 2]

    part = _train(workdir, "part", 2)
    assert part["steps"] == 8
    saved = str(tmp_path / "after_two")
    shutil.copytree(os.path.join(part["run_dir"], "ckpt"), saved)
    # the same run again with one epoch more: it resumes from its ckpt/
    resumed = _train(workdir, "part", 3)
    assert resumed["steps"] == 12 and len(resumed["train_losses"]) == 4
    assert _val_epochs(resumed) == [0, 1, 2]  # one more VAL line
    assert resumed["val_scores"] == whole["val_scores"][2:]
    _assert_same_ckpt(_ckpt(resumed), _ckpt(whole))

    # --resume_file: a train state directory, into another run
    other = _train(workdir, "other", 3, "--resume_file", saved)
    assert other["steps"] == 12 and _val_epochs(other) == [2]
    _assert_same_ckpt(_ckpt(other), _ckpt(whole))

    # --resume_file: a reference tar, at epoch_id + 1, or by global_step
    cfg = VoltaConfig.from_json_file(workdir["base"][1])
    cfg.compute_dtype = "float32"
    task_cfg = load_task_config(workdir["base"][3])
    model = VoltaForVLTasks(cfg, task_cfg, ("TASK1",))
    state = create_train_state(model, build_optimizer("adamw", 1e-3, model),
                               0)
    ck.restore_train_state(saved, state)
    for epoch_id, start in ((0, 1), (-1, 2)):
        tar = str(tmp_path / f"ckpt_{epoch_id}.tar")
        ck.save_reference_tar(tar, cfg, state, epoch_id=epoch_id)
        run = _train(workdir, f"tar{epoch_id}", 3, "--resume_file", tar)
        assert _val_epochs(run) == list(range(start, 3))
        assert run["steps"] == 8 + 4 * (3 - start)


def test_eval_cli_reads_a_reference_bin(workdir, tmp_path):  # noqa: F811
    out = _train(workdir, "for_eval", 1)
    best = os.path.join(out["run_dir"], "best")
    args = workdir["base"] + ["--output_dir", str(tmp_path / "results")]
    from_state = port_eval.main(args + ["--from_pretrained", best])

    cfg = VoltaConfig.from_json_file(workdir["base"][1])
    cfg.compute_dtype = "float32"
    task_cfg = load_task_config(workdir["base"][3])
    model = VoltaForVLTasks(cfg, task_cfg, ("TASK1",))
    ck.from_pretrained(cfg, model, best)
    path = ck.save_reference_checkpoint(str(tmp_path / "pytorch_model.bin"),
                                        cfg, model)
    from_bin = port_eval.main(args + ["--from_pretrained", path])
    assert from_bin["n"] == from_state["n"] == 16
    assert from_bin["score"] == from_state["score"]
    assert from_bin["loss"] == from_state["loss"]
