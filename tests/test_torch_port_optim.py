"""The port's optimizer against ``volta_tpu.optimization`` (optax) on the
CPU: the schedules, the no-decay mask over every parameter of
ctrl_uniter_base, and clip + AdamW(correct_bias=False) for several steps,
fp32, rtol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from volta_tpu import zoo
from volta_tpu.models import VoltaForVLTasks as JaxVLTasks
from volta_tpu.optimization import SCHEDULES as JAX_SCHEDULES
from volta_tpu.optimization import build_optimizer as jax_build_optimizer
from volta_tpu.optimization import no_decay_mask as jax_no_decay_mask
from volta_tpu_torch import VoltaForVLTasks
from volta_tpu_torch import optimization as topt
from volta_tpu_torch.models.layers import Dense, LayerNorm

TASK_CFG = {"TASK1": {"type": "VL-classifier", "num_labels": 3129,
                      "process": "normal"}}


@pytest.mark.parametrize("name", ["warmup_linear", "warmup_constant",
                                  "constant"])
def test_schedules_match(name):
    for lr, warmup, total in ((1e-4, 3, 10), (4e-5, 0, 7), (2e-3, 5, 5)):
        ref = JAX_SCHEDULES[name](lr, warmup, total)
        got = topt.SCHEDULES[name](lr, warmup, total)
        for step in range(total + 2):
            assert got(step) == float(ref(step)), (name, step)
    # with warmup the first update's lr is 0
    assert topt.warmup_linear_schedule(1e-4, 2, 10)(0) == 0.0


def test_no_decay_mask_matches_on_ctrl_uniter_base():
    """Every parameter of ctrl_uniter_base (VQA head): the JAX mask on the
    Flax tree (shapes only) against the port's on its parameter names,
    joined through convert's leaf names; the reference's blind spots are
    decayed on both sides."""
    cfg = zoo.build("ctrl_uniter_base")
    model = JaxVLTasks(cfg, TASK_CFG, ("TASK1",))
    b, lt, lv = 2, 4, 5
    shapes = jax.eval_shape(lambda r: model.init(
        r, jnp.zeros((b, lt), jnp.int32),
        jnp.zeros((b, lv, cfg.v_feature_size)), jnp.zeros((b, lv, 5)),
        "TASK1", jnp.zeros((b, lt), jnp.int32), jnp.ones((b, lt), jnp.int32),
        jnp.ones((b, lv), jnp.int32)), jax.random.PRNGKey(0))["params"]
    leaf = {"kernel": "weight", "scale": "weight", "embedding": "weight",
            "bias": "bias"}
    ref = {}
    for path, val in jax.tree_util.tree_flatten_with_path(
            jax_no_decay_mask(shapes))[0]:
        names = [p.key for p in path]
        ref[".".join(names[:-1] + [leaf[names[-1]]])] = bool(val)
    with torch.device("meta"):
        tmodel = VoltaForVLTasks(cfg, TASK_CFG, ("TASK1",))
    got = topt.no_decay_mask(tmodel)
    assert got == ref
    assert len(got) == len(list(tmodel.parameters())) > 200
    for name, want in (("bert.embeddings.feat_ln.weight", True),
                       ("bert.embeddings.loc_ln.weight", True),
                       ("clf_TASK1.ln.weight", True),
                       ("bert.embeddings.layer_norm.weight", False),
                       ("bert.encoder.attn_0.out_ln.weight", False),
                       ("bert.encoder.ff_1.out_dense.bias", False),
                       ("bert.encoder.ff_1.out_dense.weight", True),
                       ("bert.embeddings.word_embeddings.weight", True)):
        assert got[name] is want, name


class _Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = Dense(6, 5, 0.5)
        self.out_ln = LayerNorm(5)


@pytest.mark.parametrize("correct_bias", [False, True])
def test_clip_adamw_match_optax(correct_bias):
    """Six updates with warmup, the clip active on every step, a weight
    decay large enough that a wrong mask shows; parameters and moments
    compared with the optax chain's."""
    rng = np.random.RandomState(0)
    toy = _Toy()
    init = {"dense": {"kernel": rng.randn(6, 5).astype(np.float32),
                      "bias": rng.randn(5).astype(np.float32)},
            "out_ln": {"scale": rng.randn(5).astype(np.float32),
                       "bias": rng.randn(5).astype(np.float32)}}
    with torch.no_grad():
        toy.dense.weight.copy_(torch.from_numpy(init["dense"]["kernel"].T))
        toy.dense.bias.copy_(torch.from_numpy(init["dense"]["bias"]))
        toy.out_ln.weight.copy_(torch.from_numpy(init["out_ln"]["scale"]))
        toy.out_ln.bias.copy_(torch.from_numpy(init["out_ln"]["bias"]))
    kw = dict(weight_decay=0.5, clip_norm=1.0, betas=(0.9, 0.98), eps=1e-6,
              correct_bias=correct_bias)
    tx = jax_build_optimizer("adamw", JAX_SCHEDULES["warmup_linear"](
        1e-2, 2, 6), jax.tree.map(jnp.asarray, init), **kw)
    opt = topt.build_optimizer("adamw", topt.SCHEDULES["warmup_linear"](
        1e-2, 2, 6), toy, **kw)
    params = jax.tree.map(jnp.asarray, init)
    state = tx.init(params)
    for _ in range(6):
        grads = jax.tree.map(
            lambda p: rng.randn(*p.shape).astype(np.float32) * 3, init)
        assert float(optax.global_norm(grads)) > 1.0  # the clip engages
        upd, state = tx.update(jax.tree.map(jnp.asarray, grads), state,
                               params)
        params = optax.apply_updates(params, upd)
        toy.dense.weight.grad = torch.from_numpy(grads["dense"]["kernel"].T
                                                 .copy())
        toy.dense.bias.grad = torch.from_numpy(grads["dense"]["bias"])
        toy.out_ln.weight.grad = torch.from_numpy(grads["out_ln"]["scale"])
        toy.out_ln.bias.grad = torch.from_numpy(grads["out_ln"]["bias"])
        opt.step()
        opt.zero_grad()
    assert opt.count == 6
    tol = dict(rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(toy.dense.weight.detach().numpy(),
                               np.asarray(params["dense"]["kernel"]).T, **tol)
    np.testing.assert_allclose(toy.dense.bias.detach().numpy(),
                               np.asarray(params["dense"]["bias"]), **tol)
    np.testing.assert_allclose(toy.out_ln.weight.detach().numpy(),
                               np.asarray(params["out_ln"]["scale"]), **tol)
    np.testing.assert_allclose(toy.out_ln.bias.detach().numpy(),
                               np.asarray(params["out_ln"]["bias"]), **tol)
    # the moments: optax's adam state sits first in the chain after clip
    mu = jax.tree_util.tree_leaves(state)
    sd = opt.state_dict()
    ref_mu = next(s for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")).mu
    np.testing.assert_allclose(sd["mu"]["dense.weight"].numpy(),
                               np.asarray(ref_mu["dense"]["kernel"]).T, **tol)
    assert mu  # the optax state is not empty


def test_decay_uses_the_pre_update_parameter():
    """One update at lr 1 with zero gradients: u = 0 + wd * p, so
    p' = p - wd * p exactly (optax.add_decayed_weights before
    scale_by_learning_rate), not p - wd * (p - lr * u)."""
    toy = _Toy()
    before = toy.dense.weight.detach().clone()
    opt = topt.build_optimizer("adamw", 1.0, toy, weight_decay=0.25)
    opt.step()
    assert torch.equal(toy.dense.weight.detach(), before - 0.25 * before)
    assert torch.equal(toy.dense.bias.detach(), torch.zeros(5))  # undecayed


def test_unported_optimizer_options_raise():
    """The options of ROADMAP.md Queue 1 item 8, once refused, build their
    optimizers and take a step: RAdam, bf16 moments, skip_disconnected;
    an unknown name raises as in JAX."""
    toy = _Toy()
    for p in toy.parameters():
        p.grad = torch.ones_like(p)
    radam = topt.build_optimizer("radam", 1e-3, toy)
    assert type(radam) is topt.RAdam and radam.eps == 1e-8
    bf16 = topt.build_optimizer("adamw", 1e-3, toy,
                                state_dtype=torch.bfloat16)
    skip = topt.build_optimizer("adamw", 1e-3, toy,
                                skip_disconnected_params=True)
    for opt in (radam, bf16, skip):
        opt.step()
        assert opt.count == 1
    assert {m.dtype for m in bf16.mu + bf16.nu} == {torch.bfloat16}
    assert skip.skip_disconnected
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.build_optimizer("sgd", 1e-3, toy)
