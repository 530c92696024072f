"""The port's ctrl_uniter with the LayerNorm flags on
(``use_pallas_layernorm`` and ``use_fused_residual_ln``) against the JAX
package's, on the CPU.

A narrow ctrl_uniter (two attention + feed-forward pairs, hidden 128, 4
heads of 32; 8 text tokens + 6 regions) is initialised in Flax and bridged
into the port with ``convert.load_flax_params``. On the CPU the JAX model's
flagged path is its own fallback: ``hash_dropout`` + ``layer_norm_ref`` in
the tails (volta_tpu/models/layers.py:146-172) and ``layer_norm_ref`` for
the other LayerNorms, while the port runs its LayerNorm and fused residual
twins (rows 10-13 on the CPU). So the port's fused tail is held to the JAX
main path's numbers.

- Eval: the logits agree (fp32 rtol/atol 1e-4, as
  tests/test_torch_port_model.py) and the port's LayerNorms went through
  the row-10 wrapper 4 + 4 + 1 times.
- One fp32 train step with dropout in the sublayer tails (hidden rate 0.1;
  attention dropout 0 and the pooled dropout 0, whose JAX masks come from
  other generators): both sides draw the hash masks with the same uint32
  seeds. The JAX side's ``hash_dropout`` and Flax ``Dropout`` are replaced
  in this test by the same counter hash fed from the port's
  ``DropoutSeeds`` of the step, in call order (the two embedding sites,
  then the four tails). Loss and every parameter after one AdamW step
  agree within rtol 2e-4 / atol 2e-5 (PR 2's tolerance,
  tests/test_torch_port_train.py). The port's step went through the
  fused-tail wrappers 4 + 4 times and the LayerNorm wrappers 5 + 5 times.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_model import TASK_CFG, make_batch
from volta_tpu import zoo
from volta_tpu.models import VoltaForVLTasks as JaxVLTasks
from volta_tpu.models import layers as jl
from volta_tpu.optimization import build_optimizer as jax_build_optimizer
from volta_tpu.task_utils import process_batch as jax_process_batch
from volta_tpu.task_utils import task_loss_and_score as jax_loss_and_score
from volta_tpu_torch import VoltaForVLTasks
from volta_tpu_torch.config import VoltaConfig
from volta_tpu_torch.convert import load_flax_params, state_dict_from_flax
from volta_tpu_torch.models.layers import DropoutSeeds
from volta_tpu_torch.ops import fused_residual as port_fr
from volta_tpu_torch.ops import layernorm as port_ln
from volta_tpu_torch.optimization import build_optimizer
from volta_tpu_torch.train_step import create_train_state, \
    make_task_train_step

LR, WD, CLIP, EPS, BETAS = 1e-4, 10.0, 1.0, 1e-3, (0.9, 0.999)


def flagged_cfg(attn_rate=0.1):
    return zoo.single_stream(
        "uniter", depth=2, hidden_size=128, num_attention_heads=4,
        intermediate_size=256, pooler_size=128, v_pooler_size=128,
        vocab_size=50, max_position_embeddings=32, v_feature_size=32,
        v_hidden_size=128, v_num_attention_heads=4, v_intermediate_size=256,
        clf_hidden_size=96, use_pallas_layernorm=True,
        use_fused_residual_ln=True, attention_probs_dropout_prob=attn_rate)


def port_cfg(cfg):
    return VoltaConfig.from_dict(cfg.to_dict())


@pytest.fixture(scope="module")
def flax_params():
    batch = make_batch(0)
    model = JaxVLTasks(flagged_cfg(), TASK_CFG, ("TASK1",))
    variables = jax.jit(lambda r: model.init(
        r, jnp.asarray(batch["question"]), jnp.asarray(batch["features"]),
        jnp.asarray(batch["spatials"]), "TASK1",
        jnp.asarray(batch["segment_ids"]), jnp.asarray(batch["input_mask"]),
        jnp.asarray(batch["image_mask"])))(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, variables["params"])


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Counts of the calls of the four kernel wrappers (on the CPU they run
    the twins and count no launch)."""
    calls = {}
    for mod, name in ((port_ln, "layer_norm_fwd"), (port_ln, "layer_norm_bwd"),
                      (port_fr, "dropout_residual_ln_fwd"),
                      (port_fr, "dropout_residual_ln_bwd")):
        fn = getattr(mod, name)
        calls[name] = 0

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(mod, name, counted)
    return calls


def _model_inputs(batch, conv):
    return [conv(batch[k]) for k in ("question", "features", "spatials")] \
        + ["TASK1"] + [conv(batch[k]) for k in
                       ("segment_ids", "input_mask", "image_mask")]


def test_flagged_eval_logits_match_jax(flax_params, wrapper_calls):
    batch = make_batch(3)
    ref, _ = JaxVLTasks(flagged_cfg(), TASK_CFG, ("TASK1",)).apply(
        {"params": flax_params}, *_model_inputs(batch, jnp.asarray))
    model = load_flax_params(VoltaForVLTasks(port_cfg(flagged_cfg()),
                                             TASK_CFG, ("TASK1",)),
                             flax_params).eval()
    assert model.bert.encoder.attn_0.out_ln.fused_residual
    assert model.clf_TASK1.ln.use_kernel
    with torch.no_grad():
        got = model(*_model_inputs(batch, torch.from_numpy))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    assert wrapper_calls == {"layer_norm_fwd": 9, "layer_norm_bwd": 0,
                             "dropout_residual_ln_fwd": 0,
                             "dropout_residual_ln_bwd": 0}


def _seeded_hash_dropout(x, seed, rate):
    """volta_tpu.models.layers.hash_dropout with its uint32 seed given
    instead of drawn from a key (layers.py:246-255)."""
    lin = jnp.zeros(x.shape, jnp.uint32)
    mult = 1
    for axis in range(x.ndim - 1, -1, -1):
        lin = lin + jax.lax.broadcasted_iota(
            jnp.uint32, x.shape, axis) * jnp.uint32(mult)
        mult *= x.shape[axis]
    h = jl._fmix32(lin * jnp.uint32(0x9E3779B9) + jnp.uint32(seed))
    keep = h < jnp.uint32((1.0 - rate) * 4294967295.0)
    return jnp.where(keep, x / (1.0 - rate), jnp.zeros((), x.dtype))


def test_flagged_train_step_matches_jax(flax_params, wrapper_calls,
                                        monkeypatch):
    cfg = flagged_cfg(attn_rate=0.0)
    assert cfg.hidden_dropout_prob == 0.1
    batch = make_batch(4)
    state_seed = 5
    step_seed = int(torch.randint(
        0, 2**32, (), generator=torch.Generator().manual_seed(state_seed),
        dtype=torch.int64))

    # the JAX side: every dropout site hashes with the port's site seeds
    seeds = DropoutSeeds(step_seed)
    drawn = []

    def next_seed():
        drawn.append(seeds.next())
        return drawn[-1]

    class SeededDropout(fnn.Module):
        rate: float

        @fnn.compact
        def __call__(self, x, deterministic=True):
            if deterministic or self.rate == 0.0:
                return x
            return _seeded_hash_dropout(x, next_seed(), self.rate)

    monkeypatch.setattr(fnn, "Dropout", SeededDropout)
    monkeypatch.setattr(jl, "hash_dropout", lambda x, key, rate:
                        _seeded_hash_dropout(x, next_seed(), rate))
    tc = TASK_CFG["TASK1"]
    jmodel = JaxVLTasks(cfg, TASK_CFG, ("TASK1",), dropout_prob=0.0)
    jb = jax.tree.map(jnp.asarray, batch)

    def loss_fn(p):
        inputs, info = jax_process_batch(tc, jb)
        pred, _ = jmodel.apply(
            {"params": p}, inputs["input_ids"], inputs["image_feat"],
            inputs["image_loc"], "TASK1", inputs["token_type_ids"],
            inputs["attention_mask"], inputs["image_attention_mask"],
            deterministic=False, rngs={"dropout": jax.random.PRNGKey(1)})
        return jax_loss_and_score(tc["type"], pred, jb, info)[0]

    params = jax.tree.map(jnp.asarray, flax_params)
    jax_loss, grads = jax.value_and_grad(loss_fn)(params)
    assert len(drawn) == 6  # 2 embedding sites + 4 tails
    tx = jax_build_optimizer("adamw", LR, params, weight_decay=WD,
                             clip_norm=CLIP, betas=BETAS, eps=EPS)
    upd, _ = tx.update(grads, tx.init(params), params)
    jax_params = optax.apply_updates(params, upd)

    # the port: its own train step with the same step seed
    model = load_flax_params(VoltaForVLTasks(port_cfg(cfg), TASK_CFG,
                                             ("TASK1",), dropout_prob=0.0),
                             flax_params).train()
    opt = build_optimizer("adamw", LR, model, weight_decay=WD,
                          clip_norm=CLIP, betas=BETAS, eps=EPS)
    state = create_train_state(model, opt, seed=state_seed)
    loss = float(make_task_train_step(model, opt, TASK_CFG, "TASK1")(
        state, batch)["loss"])
    assert wrapper_calls == {"layer_norm_fwd": 5, "layer_norm_bwd": 5,
                             "dropout_residual_ln_fwd": 4,
                             "dropout_residual_ln_bwd": 4}
    np.testing.assert_allclose(loss, float(jax_loss), rtol=2e-4)

    ref = state_dict_from_flax(jax.tree.map(np.asarray, jax_params))
    got = model.state_dict()
    start = state_dict_from_flax(flax_params)
    assert set(got) == set(ref)
    for name, want in ref.items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=name)
        assert not torch.equal(want, start[name]), name  # every one moved

    # the dropout mattered: the same step in eval mode gives another loss
    model.load_state_dict(start)
    model.eval()
    state = create_train_state(model, opt, seed=state_seed)
    eval_loss = float(make_task_train_step(model, opt, TASK_CFG, "TASK1")(
        state, batch)["loss"])
    assert abs(eval_loss - loss) > 1e-3 * abs(loss)


def test_unported_dropout_flags_raise():
    for flag, value, item in (("use_pallas_dropout_mask", True, "row 14"),
                              ("use_hash_dropout", False, "item 2")):
        cfg = dataclasses.replace(port_cfg(flagged_cfg()), **{flag: value})
        with pytest.raises(NotImplementedError, match=item):
            VoltaForVLTasks(cfg, TASK_CFG, ("TASK1",))
