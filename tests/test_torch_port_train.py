"""The port's fine-tuning step against the JAX package's on the CPU.

Dropout off: a small ctrl_uniter (two attention + feed-forward pairs, hidden
64, 4 heads of 16; 8 text tokens + 6 regions, L = 14 >= 8 so the JAX kernel
gates open) takes six fp32 steps on both sides from the same Flax init and
the same batch. JAX: ``deterministic=True``, ``jax.value_and_grad`` and
``build_optimizer("adamw", warmup_linear_schedule(...), clip_norm=...)``
under ``interpret_mode()`` so its Pallas attention kernels (forward and
backward, Queue 2 rows 1-2) run. Port: the model in eval mode (dropout is
the only difference between the modes, as tests/test_train_parity.py:17-22
uses it) through ``make_task_train_step``. Warmup 2 of 6 (so step 0 has lr
0), the clip active, weight decay 10 so a wrong decay mask would move LN
and bias parameters far past the tolerance, eps 1e-3 for the reason at
tests/test_train_parity.py:64-68. The loss trajectory and the final
parameters (through ``state_dict_from_flax``) agree within rtol 2e-4 /
atol 2e-5, ten times tighter than test_train_parity.py:216-217.

Dropout on (rates 0.1, training mode): losses are finite, the same
generator state gives the same step bit for bit, another seed another, and
the loss falls over twenty steps on one batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from volta_tpu.models import VoltaForVLTasks as JaxVLTasks
from volta_tpu.ops import pallas_attention as pa
from volta_tpu.optimization import build_optimizer as jax_build_optimizer
from volta_tpu.optimization import warmup_linear_schedule as jax_warmup
from volta_tpu.task_utils import process_batch as jax_process_batch
from volta_tpu.task_utils import task_loss_and_score as jax_loss_and_score
from volta_tpu_torch import VoltaForVLTasks
from volta_tpu_torch.convert import load_flax_params, state_dict_from_flax
from volta_tpu_torch.ops import LAUNCHES
from volta_tpu_torch.optimization import build_optimizer, \
    warmup_linear_schedule
from volta_tpu_torch.train_step import create_train_state, \
    make_task_train_step

from test_torch_port_model import TASK_CFG, make_batch, small_cfg

LR, WD, CLIP, EPS, BETAS = 1e-4, 10.0, 1.0, 1e-3, (0.9, 0.999)
STEPS, WARMUP = 6, 2


def _flax_init(cfg, batch):
    model = JaxVLTasks(cfg, TASK_CFG, ("TASK1",))
    variables = jax.jit(lambda r: model.init(
        r, jnp.asarray(batch["question"]), jnp.asarray(batch["features"]),
        jnp.asarray(batch["spatials"]), "TASK1",
        jnp.asarray(batch["segment_ids"]), jnp.asarray(batch["input_mask"]),
        jnp.asarray(batch["image_mask"])))(jax.random.PRNGKey(0))
    return model, jax.tree.map(np.asarray, variables["params"])


def _jax_steps(model, params, batch):
    tc = TASK_CFG["TASK1"]
    tx = jax_build_optimizer("adamw", jax_warmup(LR, WARMUP, STEPS),
                             params, weight_decay=WD, clip_norm=CLIP,
                             betas=BETAS, eps=EPS)
    jb = jax.tree.map(jnp.asarray, batch)

    def loss_fn(p):
        inputs, info = jax_process_batch(tc, jb)
        pred, _ = model.apply(
            {"params": p}, inputs["input_ids"], inputs["image_feat"],
            inputs["image_loc"], "TASK1", inputs["token_type_ids"],
            inputs["attention_mask"], inputs["image_attention_mask"],
            deterministic=True)
        loss, _ = jax_loss_and_score(tc["type"], pred, jb, info)
        return loss

    params = jax.tree.map(jnp.asarray, params)
    state = tx.init(params)
    losses, norms = [], []
    with pa.interpret_mode():
        traced = pa.TRACE_COUNT[0]
        for _ in range(STEPS):
            loss, grads = jax.value_and_grad(loss_fn)(params)
            norms.append(float(optax.global_norm(grads)))
            upd, state = tx.update(grads, state, params)
            params = optax.apply_updates(params, upd)
            losses.append(float(loss))
        assert pa.TRACE_COUNT[0] > traced  # the Pallas kernels ran
    return losses, norms, params


def test_train_step_matches_jax_without_dropout():
    batch = make_batch(4)
    model, params = _flax_init(small_cfg(use_pallas=True), batch)
    jax_losses, norms, jax_params = _jax_steps(model, params, batch)
    assert norms[0] > CLIP  # the clip is active

    tmodel = load_flax_params(
        VoltaForVLTasks(small_cfg(), TASK_CFG, ("TASK1",)), params).eval()
    opt = build_optimizer("adamw", warmup_linear_schedule(LR, WARMUP, STEPS),
                          tmodel, weight_decay=WD, clip_norm=CLIP,
                          betas=BETAS, eps=EPS)
    state = create_train_state(tmodel, opt, seed=0)
    step = make_task_train_step(tmodel, opt, TASK_CFG, "TASK1")
    before = dict(LAUNCHES)
    losses = [float(step(state, batch)["loss"]) for _ in range(STEPS)]
    assert LAUNCHES == before and state.step == STEPS == opt.count
    np.testing.assert_allclose(losses, jax_losses, rtol=2e-4)
    assert losses[-1] < losses[0]

    ref = state_dict_from_flax(jax.tree.map(np.asarray, jax_params))
    got = tmodel.state_dict()
    assert set(got) == set(ref)
    start = state_dict_from_flax(params)
    moved = 0
    for name, want in ref.items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=name)
        moved += not torch.equal(want, start[name])
    assert moved == len(ref)  # every parameter trained (or decayed)


def _train_setup(seed=0, lr=1e-3):
    torch.manual_seed(0)
    model = VoltaForVLTasks(small_cfg(), TASK_CFG, ("TASK1",))
    from volta_tpu_torch.models.layers import init_weights

    init_weights(model, torch.Generator().manual_seed(1))
    opt = build_optimizer("adamw", lr, model, clip_norm=1.0)
    return (model.train(), create_train_state(model, opt, seed),
            make_task_train_step(model, opt, TASK_CFG, "TASK1"))


def test_train_step_with_dropout():
    cfg = small_cfg()
    assert cfg.attention_probs_dropout_prob == cfg.hidden_dropout_prob == 0.1
    batch = make_batch(5)
    runs = []
    for seed in (3, 3, 4):
        model, state, step = _train_setup(seed)
        out = [step(state, batch) for _ in range(2)]
        runs.append(([float(o["loss"]) for o in out],
                     {k: v.clone() for k, v in model.state_dict().items()}))
    (la, pa_), (lb, pb), (lc, _) = runs
    assert all(np.isfinite(la))
    assert la == lb and all(torch.equal(pa_[k], pb[k]) for k in pa_)
    assert la[0] != lc[0]  # another generator state, other dropout masks

    # dropout changes the loss: the same weights in eval mode give another
    model, state, step = _train_setup(3)
    with torch.no_grad():
        model.eval()
        from volta_tpu_torch.eval_step import make_task_eval_step

        ev = make_task_eval_step(model, TASK_CFG, "TASK1")(batch)
        assert float(ev["loss"]) != la[0]
        # a training-mode forward draws no seed of its own: it needs one
        model.train()
        with pytest.raises(ValueError, match="dropout seed"):
            make_task_eval_step(model, TASK_CFG, "TASK1")(batch)


def test_loss_falls_in_training_mode():
    batch = make_batch(6)
    _, state, step = _train_setup(9, lr=3e-3)
    losses = [float(step(state, batch)["loss"]) for _ in range(20)]
    assert all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < 0.5 * losses[0], losses
