"""The port's ``int_threshold_dropout`` (``use_hash_dropout: false``)
against the JAX package's, on the CPU.

JAX draws the uint32 bits of ``int_threshold_dropout`` from a Flax key by
threefry (volta_tpu/models/layers.py:206-213); the port draws them from a
``torch.Generator`` seeded with the site's seed, which cannot give the same
bits. So parity is held with the bits fed in: ``jax.random.bits(key,
shape, uint32)``, the draw the JAX function makes, go into the port's
``int_threshold_keep`` and ``apply_keep_mask``, whose output and gradient
are bit-equal to the JAX function's and its ``jax.vjp``'s in bf16 and
fp32 at three rates and three shapes. The sublayer tail's branch order is
the JAX module's for every combination of the flags and ``keep_mask``,
and a tail with the JAX bits fed in agrees with the JAX ``LayerNorm``
with ``hash_mask=False``. A 2-layer model with ``use_hash_dropout: false`` at
dropout 0 trains as the JAX one does (tests/test_torch_port_train.py's
tolerances).
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_model import TASK_CFG, make_batch, small_cfg
from test_torch_port_train import STEPS, _flax_init, _jax_steps
from volta_tpu.models import layers as jl
from volta_tpu_torch import VoltaForVLTasks
from volta_tpu_torch.config import VoltaConfig
from volta_tpu_torch.convert import load_flax_params, state_dict_from_flax
from volta_tpu_torch.models import layers as pl
from volta_tpu_torch.ops.hash import dropout_threshold
from volta_tpu_torch.ops.hash_dropout import apply_keep_mask

RATES = (0.1, 0.5, 1 / 3)
SHAPES = ((7, 5), (4, 14, 64), (3, 2, 33, 17))
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float32": (jnp.float32, torch.float32)}


def _bits(key, shape):
    return np.array(jax.random.bits(key, shape, jnp.uint32))


def _as_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("shape", SHAPES)
def test_keep_and_apply_match_jax_with_fed_bits(dtype, rate, shape):
    jdt, tdt = DTYPES[dtype]
    key = jax.random.PRNGKey(10 * SHAPES.index(shape) + RATES.index(rate))
    rng = np.random.RandomState(len(shape))
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    xj = jnp.asarray(x, jdt)
    want, vjp = jax.vjp(lambda v: jl.int_threshold_dropout(v, key, rate), xj)
    (want_dx,) = vjp(jnp.asarray(g, jdt))

    bits = _bits(key, shape).copy()
    keep = pl.int_threshold_keep(torch.from_numpy(bits.astype(np.int64)),
                                 rate)
    # an int32 view of the same 32 bits gives the same keep bits
    assert torch.equal(keep, pl.int_threshold_keep(
        torch.from_numpy(bits.view(np.int32)), rate))
    np.testing.assert_array_equal(
        keep.numpy(), bits < np.uint32((1.0 - rate) * 4294967295.0))
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    got = apply_keep_mask(xt, keep, rate)
    got.backward(torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.detach().float().numpy(), _as_np(want))
    np.testing.assert_array_equal(xt.grad.float().numpy(), _as_np(want_dx))


def test_threshold_truncates_as_jax():
    for rate in RATES + (0.0, 0.9, 1e-9):
        assert dropout_threshold(rate) == int(
            np.uint32((1.0 - rate) * 4294967295.0))


def test_int_threshold_dropout_draws_from_its_seed():
    x = torch.ones(64, 257)
    a = pl.int_threshold_dropout(x, 123, 0.1)
    assert torch.equal(a, pl.int_threshold_dropout(x, 123, 0.1))
    assert not torch.equal(a, pl.int_threshold_dropout(x, 124, 0.1))
    # the draws are the generator's for that seed, compared by the keep rule
    gen = torch.Generator().manual_seed(123)
    bits = torch.randint(0, 2**32, x.shape, generator=gen, dtype=torch.int64)
    assert torch.equal(a, apply_keep_mask(
        x, pl.int_threshold_keep(bits, 0.1), 0.1))
    keep = float((a != 0).float().mean())
    assert abs(keep - 0.9) < 0.01, keep
    # the global generator is neither read nor moved
    before = torch.random.get_rng_state()
    pl.int_threshold_dropout(x, 5, 0.1)
    assert torch.equal(before, torch.random.get_rng_state())


def _route_spy(monkeypatch):
    """Replace each of the tail's dropout routes by a recording wrapper."""
    calls = []
    real = {"pallas_mask": pl.dropout_mask.keep_mask,
            "fused": pl.dropout_residual_ln, "hash": pl.hash_dropout,
            "int": pl.int_threshold_dropout, "apply": pl.apply_keep_mask}

    def spy(name):
        def f(*a, **k):
            calls.append(name)
            return real[name](*a, **k)
        return f

    monkeypatch.setattr(pl.dropout_mask, "keep_mask", spy("pallas_mask"))
    for name, attr in (("fused", "dropout_residual_ln"),
                       ("hash", "hash_dropout"),
                       ("int", "int_threshold_dropout"),
                       ("apply", "apply_keep_mask")):
        monkeypatch.setattr(pl, attr, spy(name))
    return calls


@pytest.mark.parametrize("pallas_mask,fused,hash_mask,given", list(
    itertools.product((False, True), repeat=4)))
def test_tail_branch_precedence(monkeypatch, pallas_mask, fused, hash_mask,
                                given):
    """JAX's order (volta_tpu/models/layers.py:119-167): keep_mask, then
    pallas_mask (row 14), then fused_residual (row 12), then the hash,
    then the int threshold."""
    calls = _route_spy(monkeypatch)
    rng = np.random.RandomState(0)
    o = torch.from_numpy(rng.randn(2, 16, 128).astype(np.float32))
    x = torch.from_numpy(rng.randn(2, 16, 128).astype(np.float32))
    ln = pl.LayerNorm(128, fused_residual=fused, pallas_mask=pallas_mask,
                      hash_mask=hash_mask)
    keep = torch.from_numpy((rng.rand(2, 16, 128) > 0.1).astype(np.uint8))
    y = ln(o, residual=x, drop_rate=0.1, seed=77,
           keep_mask=keep if given else None)
    if given:
        want = ["apply"]
    elif pallas_mask:
        want = ["pallas_mask", "apply"]
    elif fused:
        want = ["fused"]
    elif hash_mask:
        want = ["hash"]
    else:
        want = ["int", "apply"]
    assert calls == want
    assert torch.isfinite(y).all()
    # eval (no seed, no mask) and rate 0 draw nothing
    calls.clear()
    ln(o, residual=x, drop_rate=0.1)
    ln(o, residual=x, drop_rate=0.0, seed=77)
    assert calls == []


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_tail_matches_jax_layernorm_with_fed_bits(monkeypatch, dtype):
    """LN(int_threshold_dropout(o) + x) of the port's tail with the JAX
    module's bits fed in agrees with JAX ``LayerNorm(hash_mask=False)``."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(3)
    o, x = (rng.randn(3, 14, 64).astype(np.float32) for _ in range(2))
    fed = {}
    real = jl.int_threshold_dropout

    def capture(v, key, rate):
        fed["bits"] = _bits(key, v.shape)
        return real(v, key, rate)

    monkeypatch.setattr(jl, "int_threshold_dropout", capture)
    jln = jl.LayerNorm(64, hash_mask=False)
    variables = jln.init(jax.random.PRNGKey(0), jnp.asarray(o, jdt))
    want = jln.apply(variables, jnp.asarray(o, jdt), jnp.asarray(x, jdt),
                     drop_rate=0.1, deterministic=False,
                     rngs={"dropout": jax.random.PRNGKey(9)})
    monkeypatch.setattr(pl, "int_threshold_dropout", lambda v, s, r: (
        apply_keep_mask(v, pl.int_threshold_keep(
            torch.from_numpy(fed["bits"].astype(np.int64)), r), r)))
    ln = pl.LayerNorm(64, hash_mask=False)
    got = ln(torch.from_numpy(o).to(tdt), residual=torch.from_numpy(x).to(
        tdt), drop_rate=0.1, seed=1)
    # the LayerNorm sums in another order than layer_norm_ref: held as
    # tests/test_torch_port_layers.py holds it
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=0, atol=3e-2)
    np.testing.assert_allclose(got.detach().float().numpy(), _as_np(want),
                               **tol)


def test_model_without_hash_dropout_trains_as_jax():
    """use_hash_dropout: false builds, and at dropout 0 its fp32 steps
    follow JAX's (tests/test_torch_port_train.py's tolerances)."""
    batch = make_batch(4)
    jcfg = dataclasses.replace(small_cfg(use_pallas=True),
                               use_hash_dropout=False,
                               attention_probs_dropout_prob=0.0,
                               hidden_dropout_prob=0.0)
    model, params = _flax_init(jcfg, batch)
    jax_losses, _, jax_params = _jax_steps(model, params, batch)

    from volta_tpu_torch.optimization import build_optimizer, \
        warmup_linear_schedule
    from volta_tpu_torch.train_step import create_train_state, \
        make_task_train_step
    from test_torch_port_train import BETAS, CLIP, EPS, LR, WARMUP, WD

    pcfg = VoltaConfig.from_dict(jcfg.to_dict())
    assert not pcfg.use_hash_dropout
    tmodel = load_flax_params(VoltaForVLTasks(pcfg, TASK_CFG, ("TASK1",)),
                              params).eval()
    tails = [m for n, m in tmodel.named_modules()
             if n.endswith("out_ln") and "encoder" in n]
    assert len(tails) == 4 and not any(m.hash_mask for m in tails)
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
