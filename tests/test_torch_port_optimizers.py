"""The port's other optimizers against ``volta_tpu.optimization`` (optax)
on the CPU, inputs from numpy seeds: RAdam and PlainRAdam across the
rho >= 5 switch (step 6 at b2 = 0.999), AdamW's bf16 moments in both of
JAX's semantics, ``skip_disconnected`` with a parameter that no gradient
reaches (with and without ``apply_freeze``), the lr scales of a reference
``.bin``'s report, the whole ``build_optimizer`` chain under the clip and
K = 2 accumulation, and RAdam's reference-tar and ``train_state.pt``
resumes. Parameters rtol 1e-6; bf16 moments bit-equal to optax's stored
state."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from test_torch_port_model import TASK_CFG, make_batch, small_cfg
from test_torch_port_resume import MOMENT_STEP, TOTAL, _snapshot, \
    assert_same_run, write_reference_tar
from test_torch_port_train import BETAS, CLIP, EPS, LR, WARMUP, WD, \
    _flax_init
from volta_tpu import checkpoint as jck
from volta_tpu.optimization import SCHEDULES as JAX_SCHEDULES
from volta_tpu.optimization import build_optimizer as jax_build_optimizer
from volta_tpu.optimization import lr_scales_from_loaded as jax_lr_scales
from volta_tpu.optimization import radam as jax_radam
from volta_tpu.parallel.train_step import create_train_state as jax_state
from volta_tpu.train_utils import apply_freeze as jax_apply_freeze
from volta_tpu_torch import VoltaForVLPreTraining, VoltaForVLTasks
from volta_tpu_torch import checkpoint as ck
from volta_tpu_torch import optimization as topt
from volta_tpu_torch.config import VoltaConfig
from volta_tpu_torch.models.layers import Dense, LayerNorm, init_weights
from volta_tpu_torch.train_step import create_train_state, \
    make_task_train_step
from volta_tpu_torch.train_utils import apply_freeze

TOL = dict(rtol=1e-6, atol=1e-7)


class _Toy(nn.Module):
    """Three modules; ``tail`` plays a sublayer that feeds no loss."""

    def __init__(self):
        super().__init__()
        self.dense = Dense(6, 5, 0.5)
        self.out_ln = LayerNorm(5)
        self.tail = Dense(5, 4, 0.5)


def _init(seed=0):
    rng = np.random.RandomState(seed)
    r = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return {"dense": {"kernel": r(6, 5), "bias": r(5)},
            "out_ln": {"scale": r(5), "bias": r(5)},
            "tail": {"kernel": r(5, 4), "bias": r(4)}}


def _to_port(tree):
    """{port name: tensor} of a Flax-shaped numpy tree."""
    out = {}
    for mod, leaves in tree.items():
        for leaf, v in leaves.items():
            name = "bias" if leaf == "bias" else "weight"
            out[f"{mod}.{name}"] = torch.from_numpy(
                np.array(v.T if leaf == "kernel" else v))
    return out


def _toy(init):
    toy = _Toy()
    with torch.no_grad():
        for n, p in toy.named_parameters():
            p.copy_(_to_port(init)[n])
    return toy


def _grads(rng, init, zero=("tail",), scale=3.0):
    return {m: {k: (np.zeros_like(v) if m in zero else
                    rng.randn(*v.shape).astype(np.float32) * scale)
                for k, v in leaves.items()} for m, leaves in init.items()}


def _run_both(tx, opt, toy, init, steps, seed=1, zero=("tail",)):
    """``steps`` micro-steps of the optax chain ``tx`` and the port's
    ``opt`` on the same numpy gradients; returns JAX's params and state."""
    rng = np.random.RandomState(seed)
    params = jax.tree.map(jnp.asarray, init)
    state = tx.init(params)
    update = jax.jit(tx.update)
    for _ in range(steps):
        g = _grads(rng, init, zero)
        upd, state = update(jax.tree.map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, upd)
        for n, p in toy.named_parameters():
            p.grad = _to_port(g)[n].clone()
        opt.step()
        opt.zero_grad()
    return jax.tree.map(np.asarray, params), state


def _assert_params(toy, params, **tol):
    got = {n: p.detach().numpy() for n, p in toy.named_parameters()}
    for n, want in _to_port(params).items():
        np.testing.assert_allclose(got[n], want.numpy(), err_msg=n,
                                   **(tol or TOL))


def _moments(state, field):
    """The first optax state node holding ``field`` (mu or nu)."""
    nodes = jax.tree_util.tree_leaves(
        state, is_leaf=lambda x: hasattr(x, field))
    return getattr(next(s for s in nodes if hasattr(s, field)), field)


@pytest.mark.parametrize("name", ["radam", "plain_radam"])
def test_radam_matches_optax(name):
    """Eight updates with warmup: the fallback at steps 1-5, the adaptive
    branch from step 6, decay in both; parameters and moments."""
    init = _init()
    kw = dict(weight_decay=0.5, eps=1e-6)
    sched = (1e-2, 2, 8)
    tx = jax_build_optimizer(name, JAX_SCHEDULES["warmup_linear"](*sched),
                             jax.tree.map(jnp.asarray, init), **kw)
    toy = _toy(init)
    opt = topt.build_optimizer(name, topt.SCHEDULES["warmup_linear"](*sched),
                               toy, **kw)
    assert isinstance(opt, topt.RAdam)
    params, state = _run_both(tx, opt, toy, init, 8, zero=())
    assert opt.count == opt.adam_count == 8
    _assert_params(toy, params)
    sd = opt.state_dict()
    for field in ("mu", "nu"):
        ref = _to_port(jax.tree.map(np.asarray, _moments(state, field)))
        for n, want in ref.items():
            np.testing.assert_allclose(sd[field][n].numpy(), want.numpy(),
                                       err_msg=n, **TOL)


def test_radam_step_sizes_switch_at_step_6():
    """The fallback through step 5 and the adaptive branch from step 6
    (rho >= 5, not rho > 4), the step sizes equal to JAX's float32 ones."""
    toy = _Toy()
    opt = topt.build_optimizer("radam", 1.0, toy)
    tx = jax_radam(1.0, weight_decay=0.0)
    p = {"w": jnp.zeros(())}
    state = tx.init(p)
    for t in range(1, 13):
        adaptive, adapt, sgd = opt.step_sizes(t)
        assert adaptive == (t >= 6), t
        # JAX's update of a unit gradient on zero moments at count t - 1
        st = jax.tree.map(lambda x: x, state)
        st = (st[0]._replace(count=jnp.int32(t - 1)),) + tuple(st[1:])
        upd, _ = tx.update({"w": jnp.float32(1.0)}, st, p)
        m = np.float32(1.0 - 0.9)
        want = -(np.float32(adapt) * m / (np.sqrt(np.float32(1 - 0.999))
                                          + np.float32(1e-8))
                 if adaptive else np.float32(sgd) * m)
        assert float(upd["w"]) == pytest.approx(float(want), rel=1e-6), t


@pytest.mark.parametrize("correct_bias", [False, True])
def test_bf16_moments_match_optax(correct_bias):
    """AdamW with bf16 moments over six updates: without bias correction
    both moments stored rounded and read as stored; with it optax's
    ``mu_dtype`` (mu alone, cast after the update). The stored moments
    bit-equal to optax's, the parameters within rtol 1e-6."""
    init = _init()
    kw = dict(weight_decay=0.5, clip_norm=1.0, betas=(0.9, 0.98), eps=1e-6,
              correct_bias=correct_bias)
    sched = (1e-2, 2, 6)
    tx = jax_build_optimizer("adamw", JAX_SCHEDULES["warmup_linear"](*sched),
                             jax.tree.map(jnp.asarray, init),
                             state_dtype=jnp.bfloat16, **kw)
    toy = _toy(init)
    opt = topt.build_optimizer("adamw",
                               topt.SCHEDULES["warmup_linear"](*sched), toy,
                               state_dtype=torch.bfloat16, **kw)
    params, state = _run_both(tx, opt, toy, init, 6, zero=())
    _assert_params(toy, params)
    sd = opt.state_dict()
    for field in ("mu", "nu"):
        ref = jax.tree.map(np.asarray, _moments(state, field))
        want_dtype = torch.float32 if correct_bias and field == "nu" \
            else torch.bfloat16
        for n, want in _to_port(jax.tree.map(
                lambda x: x.astype(np.float32), ref)).items():
            got = sd[field][n]
            assert got.dtype == want_dtype, (field, n)
            if got.dtype == torch.bfloat16:
                assert torch.equal(got.float(), want), (field, n)
            else:
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           err_msg=n, **TOL)


@pytest.mark.parametrize("frozen", [False, True])
def test_skip_disconnected_matches_optax(frozen):
    """``tail`` never gets a gradient: with ``skip_disconnected`` it takes
    no update at all (no decay), unlike the chain without it; a frozen
    ``out_ln`` (``apply_freeze``) then takes no decay either, while its
    moments and every other parameter update as in JAX."""
    init = _init()
    kw = dict(weight_decay=0.5, clip_norm=1.0, eps=1e-6)
    fixed = ["out_ln"] if frozen else []
    tx = jax_apply_freeze(jax_build_optimizer(
        "adamw", 1e-2, jax.tree.map(jnp.asarray, init),
        skip_disconnected_params=True, **kw), init, fixed)
    toy = _toy(init)
    opt = apply_freeze(topt.build_optimizer(
        "adamw", 1e-2, toy, skip_disconnected_params=True, **kw), toy, fixed)
    params, _ = _run_both(tx, opt, toy, init, 4)
    _assert_params(toy, params)
    frozen_mods = ("tail",) + (("out_ln",) if frozen else ())
    for n, p in toy.named_parameters():
        if n.split(".")[0] in frozen_mods:
            assert torch.equal(p.detach(), _to_port(init)[n]), n
        else:
            assert not torch.equal(p.detach(), _to_port(init)[n]), n
    # without the flag the disconnected tail decays
    toy2 = _toy(init)
    opt2 = topt.build_optimizer("adamw", 1e-2, toy2, **kw)
    _run_both(jax_build_optimizer("adamw", 1e-2,
                                  jax.tree.map(jnp.asarray, init), **kw),
              opt2, toy2, init, 1)
    assert not torch.equal(toy2.tail.weight.detach(),
                           _to_port(init)["tail.weight"])


def _tiny_pretrain():
    jcfg = small_cfg()
    return jcfg, VoltaConfig.from_dict(jcfg.to_dict())


def test_lr_scales_from_a_reference_bin_match_jax(tmp_path):
    """A reference ``.bin`` of a task model's weights read into the
    pretraining model: the trunk loaded, the heads not. The scaled names
    are JAX's leaf for leaf, and equal to the loaded ones."""
    from volta_tpu.models import VoltaForVLPreTraining as JaxPre

    jcfg, pcfg = _tiny_pretrain()
    task = VoltaForVLTasks(pcfg, TASK_CFG, ("TASK1",))
    init_weights(task, torch.Generator().manual_seed(1))
    path = str(tmp_path / "task.bin")
    ck.save_reference_checkpoint(path, pcfg, task)

    pre = VoltaForVLPreTraining(pcfg)
    init_weights(pre, torch.Generator().manual_seed(2))
    report = ck.from_pretrained(pcfg, pre, path)
    scales = topt.lr_scales_from_loaded(pre, report["loaded"], 0.1)

    batch = make_batch(0)
    jmodel = JaxPre(jcfg)
    shapes = jax.eval_shape(lambda r: jmodel.init(
        r, jnp.asarray(batch["question"]), jnp.asarray(batch["features"]),
        jnp.asarray(batch["spatials"]), jnp.asarray(batch["segment_ids"]),
        jnp.asarray(batch["input_mask"]), jnp.asarray(batch["image_mask"])),
        jax.random.PRNGKey(0))["params"]
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    _, jreport = jck.from_pretrained(jcfg, {"params": zeros}, path)
    assert report["loaded"] == jreport["loaded"]
    jscales = {".".join(p.key for p in path): v for path, v in
               jax.tree_util.tree_flatten_with_path(
                   jax_lr_scales(zeros, jreport["loaded"], 0.1))[0]}
    paths = topt.flax_paths(pre)
    got = {".".join(paths[n]): s for n, s in scales.items()}
    assert got == jscales
    scaled = {k for k, v in got.items() if v == 0.1}
    assert scaled == set(report["loaded"]) and scaled
    assert any(k.startswith("cls.") for k, v in got.items() if v == 1.0)


@pytest.mark.parametrize("name,dtype", [("adamw", "bfloat16"),
                                        ("radam", None)])
def test_whole_chain_matches_optax(name, dtype):
    """clip -> skip_disconnected(optimizer -> decay -> lr -> lr scales)
    inside MultiSteps with K = 2 and ``apply_freeze`` outermost: twelve
    micro-steps, six updates, the RAdam switch among them."""
    init = _init()
    fixed = ["dense.bias"]
    jscales = {"dense": {"kernel": 0.1, "bias": 1.0},
               "out_ln": {"scale": 1.0, "bias": 0.1},
               "tail": {"kernel": 1.0, "bias": 1.0}}
    kw = dict(weight_decay=0.5, clip_norm=1.0, grad_accum_steps=2,
              eps=1e-6, skip_disconnected_params=True)
    sched = (1e-2, 2, 6)
    tx = jax_apply_freeze(jax_build_optimizer(
        name, JAX_SCHEDULES["warmup_linear"](*sched),
        jax.tree.map(jnp.asarray, init), lr_scales=jscales,
        state_dtype=jnp.bfloat16 if dtype else None, **kw), init, fixed)
    toy = _toy(init)
    opt = apply_freeze(topt.build_optimizer(
        name, topt.SCHEDULES["warmup_linear"](*sched), toy,
        lr_scales={"dense.weight": 0.1, "out_ln.bias": 0.1},
        state_dtype=torch.bfloat16 if dtype else None, **kw), toy, fixed)
    params, _ = _run_both(tx, opt, toy, init, 12)
    assert opt.count == 6 and opt.mini_step == 0
    _assert_params(toy, params)
    assert torch.equal(toy.tail.weight.detach(),
                       _to_port(init)["tail.weight"])


# ------------------------------------------------------------------ resumes
def _port_radam(pcfg, seed=3):
    model = VoltaForVLTasks(pcfg, TASK_CFG, ("TASK1",))
    init_weights(model, torch.Generator().manual_seed(seed))
    opt = topt.build_optimizer(
        "radam", topt.warmup_linear_schedule(LR, WARMUP, TOTAL), model,
        weight_decay=WD, clip_norm=CLIP, betas=BETAS, eps=EPS)
    return model, opt


def test_radam_reference_tar_resumes_as_in_jax(tmp_path):
    """The reference tar's moments into RAdam, as JAX's
    ``resume_from_torch_tar`` puts them into its ``_RAdamState``: the same
    info, the moments tensor for tensor, RAdam's count from their ``step``
    (7) and the schedule's from ``global_step`` (5); then a port step."""
    from volta_tpu.optimization import _RAdamState
    from volta_tpu_torch.convert import state_dict_from_flax

    jcfg = small_cfg()
    batch = make_batch(4)
    params = _flax_init(jcfg, batch)[1]
    path = str(tmp_path / "pytorch_ckpt_latest.tar")
    write_reference_tar(path, jcfg, params, "one_per_group", False)
    tx = jax_build_optimizer(
        "radam", JAX_SCHEDULES["warmup_linear"](LR, WARMUP, TOTAL), params,
        weight_decay=WD, clip_norm=CLIP, betas=BETAS, eps=EPS)
    init = jax.tree.map(lambda p: jnp.zeros_like(jnp.asarray(p)), params)
    jstate, jinfo = jck.resume_from_torch_tar(
        jcfg, jax_state(jax.random.PRNGKey(0), init, tx), path)
    (radam_state,) = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda x: isinstance(x, _RAdamState))
        if isinstance(s, _RAdamState)]

    pcfg = VoltaConfig.from_dict(small_cfg(use_pallas=True).to_dict())
    model, opt = _port_radam(pcfg)
    state = create_train_state(model.eval(), opt, seed=0)
    info = ck.resume_from_reference_tar(pcfg, state, path)
    assert info == jinfo
    assert opt.adam_count == int(radam_state.count) == MOMENT_STEP
    assert opt.count == state.step == int(jstate.step) == 5
    sd = opt.state_dict()
    for key in ("mu", "nu"):
        want = state_dict_from_flax(jax.tree.map(
            np.asarray, getattr(radam_state, key)))
        assert set(want) == set(sd[key])
        for name, w in want.items():
            assert torch.equal(sd[key][name], w), (key, name)
    want = state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    for name, w in want.items():
        assert torch.equal(model.state_dict()[name], w), name
    step = make_task_train_step(model, opt, TASK_CFG, "TASK1")
    assert np.isfinite(float(step(state, batch)["loss"]))
    assert opt.adam_count == MOMENT_STEP + 1


def test_radam_train_state_and_tar_resume_bit_equal(tmp_path):
    """Four RAdam steps (the count past the fallback once resumed with a
    moments step of 4 + 2) equal two, a ``train_state.pt`` and two more,
    bit for bit; so does a reference tar written from the port's state,
    given the same generator. bf16 AdamW moments resume bit for bit too."""
    pcfg = VoltaConfig.from_dict(small_cfg(use_pallas=True).to_dict())
    batches = [make_batch(s) for s in range(4)]

    def setup(seed, gen, kind):
        model = VoltaForVLTasks(pcfg, TASK_CFG, ("TASK1",))
        init_weights(model, torch.Generator().manual_seed(seed))
        opt = topt.build_optimizer(
            kind, topt.warmup_linear_schedule(1e-3, 1, 20), model,
            clip_norm=1.0, state_dtype=torch.bfloat16)
        state = create_train_state(model.train(), opt, seed=gen)
        return state, make_task_train_step(model, opt, TASK_CFG, "TASK1")

    for kind in ("radam", "adamw"):
        state, step = setup(1, 3, kind)
        whole = _snapshot(state, [step(state, b)["loss"] for b in batches])
        state, step = setup(1, 3, kind)
        first = [step(state, b)["loss"] for b in batches[:2]]
        ck.save_train_state(str(tmp_path / kind), state, 0, 0.5)
        tar = str(tmp_path / f"{kind}.tar")
        ck.save_reference_tar(tar, pcfg, state, epoch_id=0)
        saved_gen = state.generator.get_state()
        fresh, fstep = setup(7, 9, kind)
        ck.restore_train_state(str(tmp_path / kind), fresh)
        assert_same_run(_snapshot(fresh, first + [fstep(fresh, b)["loss"]
                                                  for b in batches[2:]]),
                        whole)
        if kind == "radam":
            assert fresh.optimizer.state_dict()["mu"][
                "clf_TASK1.dense2.weight"].dtype == torch.float32
            fresh, fstep = setup(7, 9, kind)
            ck.resume_from_reference_tar(pcfg, fresh, tar)
            fresh.generator.set_state(saved_gen)
            assert_same_run(
                _snapshot(fresh, first + [fstep(fresh, b)["loss"]
                                          for b in batches[2:]]), whole)
        else:
            assert fresh.optimizer.state_dict()["nu"][
                "clf_TASK1.dense2.weight"].dtype == torch.bfloat16
