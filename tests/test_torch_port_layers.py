"""volta_tpu_torch.models.layers against volta_tpu.models.layers on the CPU:
TF-style LayerNorm, dtype-dependent gelu, Dense and Embed. Inputs come from
numpy with a seed and go through both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volta_tpu.models import layers as jl
from volta_tpu_torch.models import layers as tl

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(0)
    # a low-variance row (var ~ 2.5e-5) makes the eps placement visible
    x = rng.randn(4, 7, 48).astype(np.float32) * 3.0 + 1.5
    x[0, 0] = rng.randn(48).astype(np.float32) * 5e-3
    scale = rng.randn(48).astype(np.float32)
    bias = rng.randn(48).astype(np.float32)
    ref = jl.layer_norm_ref(jnp.asarray(x, jdt), jnp.asarray(scale),
                            jnp.asarray(bias))
    ln = tl.LayerNorm(48)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
    got = ln(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=0, atol=3e-2)  # one bf16 ulp at |y| ~ 4
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), **tol)
    # torch's own LayerNorm (eps 1e-5) would be visibly wrong on row 0
    if dtype == "float32":
        wrong = torch.nn.functional.layer_norm(
            torch.from_numpy(x), (48,), ln.weight, ln.bias)
        assert np.abs(_np(wrong)[0, 0] - np.asarray(ref)[0, 0]).max() > 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_and_activations_match(dtype):
    jdt, tdt = DTYPES[dtype]
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    # bf16: JAX rounds every intermediate of the tanh form to bf16, torch
    # rounds once, so the two differ by up to one bf16 ulp (|y| * 2^-7)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else \
        dict(rtol=2 ** -7, atol=2 ** -8)
    for name in ("gelu", "gelu_tanh", "relu", "swish"):
        ref = jl.ACT2FN[name](jnp.asarray(x, jdt))
        got = tl.ACT2FN[name](torch.from_numpy(x).to(tdt))
        assert got.dtype == tdt, name
        np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32),
                                   err_msg=name, **tol)
    # fp32 gelu is the exact erf form, bf16 the tanh form
    t = torch.tensor([2.7])
    erf = t * 0.5 * (1 + torch.erf(t / 2 ** 0.5))
    assert float(tl.gelu(t)) == float(erf)
    assert float(tl.gelu(t.bfloat16())) == float(
        torch.nn.functional.gelu(t.bfloat16(), approximate="tanh"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_matches_flax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(1)
    x = rng.randn(3, 5, 24).astype(np.float32)
    mod = jl.dense(40, 0.5, jdt, "d")
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = {"kernel": params["kernel"],
              "bias": jnp.asarray(rng.randn(40).astype(np.float32))}
    ref = mod.apply({"params": params}, jnp.asarray(x))
    dense = tl.Dense(24, 40, 0.5, tdt)
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(np.array(params["kernel"]).T))
        dense.bias.copy_(torch.from_numpy(np.array(params["bias"])))
    got = dense(torch.from_numpy(x))
    assert got.dtype == tdt and dense.weight.dtype == torch.float32
    assert ref.dtype == jdt
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=0, atol=6e-2)  # one bf16 ulp at |y| ~ 8
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), **tol)


def test_dense_and_embed_init():
    dense = tl.Dense(64, 512, 0.02)
    emb = tl.Embed(300, 64, 0.02, zero_pad_row=True)
    tl.init_weights(torch.nn.ModuleList([dense, emb]),
                    torch.Generator().manual_seed(0))
    w, b, e = (t.detach() for t in (dense.weight, dense.bias, emb.weight))
    assert abs(float(w.std()) - 0.02) < 1e-3
    assert float(b.abs().max()) == 0.0
    assert float(e[0].abs().max()) == 0.0
    assert abs(float(e[1:].std()) - 0.02) < 1e-3
    # the same seed draws the same weights
    dense2 = tl.Dense(64, 512, 0.02)
    tl.init_weights(torch.nn.ModuleList(
        [dense2, tl.Embed(300, 64, 0.02, zero_pad_row=True)]),
        torch.Generator().manual_seed(0))
    assert torch.equal(w, dense2.weight.detach())


def test_embed_matches_flax():
    rng = np.random.RandomState(2)
    mod = jl.embed(30, 16, 0.02, "e", zero_pad_row=True)
    ids = rng.randint(0, 30, (4, 9)).astype(np.int32)
    params = mod.init(jax.random.PRNGKey(1), jnp.asarray(ids))["params"]
    table = np.array(params["embedding"])
    assert np.all(table[0] == 0)
    ref = mod.apply({"params": params}, jnp.asarray(ids))
    emb = tl.Embed(30, 16, 0.02, zero_pad_row=True)
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(table))
    got = emb(torch.from_numpy(ids))
    np.testing.assert_array_equal(_np(got), np.asarray(ref))
