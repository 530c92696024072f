"""``remat_ff`` in the port: each feed-forward sublayer runs under
``torch.utils.checkpoint`` and is recomputed in the backward
(volta_tpu/models/encoder.py:556-608), on the CPU.

- A 2-layer model with ``remat_ff`` gives the loss and every gradient of
  the same model without it, bit for bit, in fp32 and bf16, with the hash
  dropout, with ``fuse_hidden_dropout`` (row 9's mask for the feed-forward
  tail an input of the recomputed call), with ``use_hash_dropout: false``
  (the int-threshold draws made again from the same seed) and with the
  LayerNorm flags (rows 10-13's twins); two AdamW steps end at the same
  parameters.
- The forward draws as many seeds with ``remat_ff`` as without and the
  backward none: each feed-forward's seed is drawn outside the recomputed
  call.
- The JAX ``remat_ff`` model's steps at dropout 0 match the port's
  (tests/test_torch_port_train.py's tolerances).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_port_model import TASK_CFG, make_batch, small_cfg
from test_torch_port_train import BETAS, CLIP, EPS, LR, STEPS, WARMUP, WD, \
    _flax_init, _jax_steps
from volta_tpu_torch import VoltaForVLTasks
from volta_tpu_torch.config import VoltaConfig
from volta_tpu_torch.convert import load_flax_params, state_dict_from_flax
from volta_tpu_torch.models import model as port_model
from volta_tpu_torch.models.encoder import GatedFeedForwardSublayer
from volta_tpu_torch.models.layers import DropoutSeeds, init_weights
from volta_tpu_torch.optimization import build_optimizer, \
    warmup_linear_schedule
from volta_tpu_torch.task_utils import process_batch, task_loss_and_score
from volta_tpu_torch.train_step import create_train_state, \
    make_task_train_step

MODES = {
    "hash": {},
    "fuse_hidden_dropout": {"use_pallas": True, "fuse_hidden_dropout": True},
    "int_threshold": {"use_hash_dropout": False},
    "ln_flags": {"use_pallas": True, "use_pallas_layernorm": True,
                 "use_fused_residual_ln": True},
}


def port_cfg(dtype="float32", **fields):
    # the attention kernels' route (their twins here), as the default
    # config takes it
    cfg = VoltaConfig.from_dict(small_cfg(dtype, use_pallas=True).to_dict())
    return dataclasses.replace(cfg, **fields)


def build(cfg):
    model = VoltaForVLTasks(cfg, TASK_CFG, ("TASK1",))
    init_weights(model, torch.Generator().manual_seed(1))
    return model.train()


def loss_and_grads(model, batch, seed):
    tc = TASK_CFG["TASK1"]
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    inputs, info = process_batch(tc, batch)
    pred = model(inputs["input_ids"], inputs["image_feat"],
                 inputs["image_loc"], "TASK1", inputs["token_type_ids"],
                 inputs["attention_mask"], inputs["image_attention_mask"],
                 dropout_seed=seed)
    loss, _ = task_loss_and_score(tc["type"], pred, batch, info,
                                  tc["loss"])
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", list(MODES))
def test_remat_is_bit_equal_to_the_plain_step(dtype, mode):
    batch = make_batch(7)
    runs = {}
    for remat in (False, True):
        cfg = port_cfg(dtype, remat_ff=remat, **MODES[mode])
        model = build(cfg)
        assert model.bert.encoder.remat == remat
        loss, grads = loss_and_grads(model, batch, seed=12345)
        opt = build_optimizer("adamw", 1e-3, model, clip_norm=1.0)
        state = create_train_state(model, opt, seed=3)
        step = make_task_train_step(model, opt, TASK_CFG, "TASK1")
        losses = [step(state, batch)["loss"] for _ in range(2)]
        runs[remat] = (loss, grads, losses, model.state_dict())
    (l0, g0, s0, p0), (l1, g1, s1, p1) = runs[False], runs[True]
    assert torch.isfinite(l0) and torch.equal(l0, l1)
    assert set(g0) == set(g1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n


def test_remat_draws_no_seed_in_the_backward(monkeypatch):
    """The backward recomputes each feed-forward (its body runs twice a
    step) and draws no seed."""
    seen, bodies = [], []
    body = GatedFeedForwardSublayer.body

    def counted_body(self, *a):
        bodies.append(torch.is_grad_enabled())
        return body(self, *a)

    monkeypatch.setattr(GatedFeedForwardSublayer, "body", counted_body)

    class Counted(DropoutSeeds):
        def __init__(self, step_seed):
            super().__init__(step_seed)
            seen.append(self)

    monkeypatch.setattr(port_model, "DropoutSeeds", Counted)
    batch = make_batch(2)
    counts = []
    for fields in ({}, {"remat_ff": True},
                   {"remat_ff": True, **MODES["fuse_hidden_dropout"]},
                   MODES["fuse_hidden_dropout"]):
        model = build(port_cfg(**fields))
        seen.clear()
        bodies.clear()
        tc = TASK_CFG["TASK1"]
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        inputs, info = process_batch(tc, tb)
        pred = model(inputs["input_ids"], inputs["image_feat"],
                     inputs["image_loc"], "TASK1", inputs["token_type_ids"],
                     inputs["attention_mask"],
                     inputs["image_attention_mask"], dropout_seed=9)
        (seeds,) = seen
        after_forward = seeds.count
        task_loss_and_score(tc["type"], pred, tb, info,
                            tc["loss"])[0].backward()
        assert seeds.count == after_forward  # the recomputation drew none
        counts.append((after_forward, len(bodies)))
    # 2 embeddings + 2 x (attention probs + its tail + the FF tail) +
    # pooled; 2 feed-forwards, each run again in the backward under remat
    assert counts == [(9, 2), (9, 4), (9, 4), (9, 2)]


def test_remat_in_eval_and_without_grad_is_the_plain_forward():
    batch = make_batch(1)
    outs = []
    for remat in (False, True):
        model = build(port_cfg(remat_ff=remat)).eval()
        tc = TASK_CFG["TASK1"]
        inputs, _ = process_batch(tc, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
        args = (inputs["input_ids"], inputs["image_feat"],
                inputs["image_loc"], "TASK1", inputs["token_type_ids"],
                inputs["attention_mask"], inputs["image_attention_mask"])
        with torch.no_grad():
            outs.append(model(*args))
        outs.append(model(*args).detach())
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_remat_model_trains_as_jax():
    """The JAX ``remat_ff`` model (its FF sublayers under ``nn.remat``) at
    dropout 0 against the port's, six fp32 steps."""
    batch = make_batch(4)
    jcfg = dataclasses.replace(small_cfg(use_pallas=True), remat_ff=True,
                               attention_probs_dropout_prob=0.0,
                               hidden_dropout_prob=0.0)
    model, params = _flax_init(jcfg, batch)
    jax_losses, _, jax_params = _jax_steps(model, params, batch)

    pcfg = VoltaConfig.from_dict(jcfg.to_dict())
    tmodel = load_flax_params(VoltaForVLTasks(pcfg, TASK_CFG, ("TASK1",)),
                              params).eval()
    assert tmodel.bert.encoder.remat
    opt = build_optimizer("adamw", warmup_linear_schedule(LR, WARMUP, STEPS),
                          tmodel, weight_decay=WD, clip_norm=CLIP,
                          betas=BETAS, eps=EPS)
    state = create_train_state(tmodel, opt, seed=0)
    step = make_task_train_step(tmodel, opt, TASK_CFG, "TASK1")
    losses = [float(step(state, batch)["loss"]) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, jax_losses, rtol=2e-4)
    ref = state_dict_from_flax(jax.tree.map(np.asarray, jax_params))
    got = tmodel.state_dict()
    for name, want in ref.items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=name)
