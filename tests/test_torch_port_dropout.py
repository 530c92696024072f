"""The port's hash dropout and its seeding against the JAX package's
``hash_dropout`` on the CPU.

For the uint32 seed that a JAX key draws (``jax.random.bits(key, (),
uint32)``, what ``hash_dropout`` itself draws), the port's ``hash_dropout``
is bit-equal to the JAX one, in float32 and bfloat16. The keep fraction over
a b256-sized activation is 0.9 within 0.005 at rate 0.1, and the sites of
one forward draw different masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volta_tpu.models import layers as jl
from volta_tpu_torch.models import layers as tl

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _seed(key):
    return int(jax.random.bits(key, (), jnp.uint32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.25])
def test_hash_dropout_is_bit_equal_to_jax(dtype, rate):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 23, 96) * 3).astype(np.float32)
    for k in range(3):
        key = jax.random.PRNGKey(100 + k)
        ref = np.asarray(jl.hash_dropout(jnp.asarray(x, jdt), key, rate),
                         np.float32)
        got = tl.hash_dropout(torch.from_numpy(x).to(tdt), _seed(key), rate)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), ref)
        assert 0 < (ref == 0).mean() < 2 * rate


def test_fmix32_and_threshold_match_jax():
    rng = np.random.RandomState(1)
    h = rng.randint(0, 2**32, size=1000, dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(jl._fmix32(jnp.asarray(h)))
    got = tl.fmix32(torch.from_numpy(h.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    assert tl.fmix32(int(h[7])) == int(ref[7])  # ints take the same path
    for rate in (0.1, 0.25, 0.5):
        assert tl.dropout_threshold(rate) == int(
            np.uint32((1.0 - rate) * 4294967295.0))


def test_keep_fraction_at_b256():
    """A b256 hidden activation of the VQA step, [256, 60, 768]."""
    x = torch.ones(256, 60, 768)
    seeds = tl.DropoutSeeds(12345)
    for _ in range(2):
        frac = float((tl.hash_dropout(x, seeds.next(), 0.1) != 0)
                     .float().mean())
        assert abs(frac - 0.9) <= 0.005, frac


def test_sites_of_one_step_draw_different_masks():
    x = torch.ones(8, 60, 64)
    seeds = tl.DropoutSeeds(7)
    drawn = [seeds.next() for _ in range(50)]
    assert len(set(drawn)) == 50 and all(0 <= s < 2**32 for s in drawn)
    a = tl.hash_dropout(x, drawn[0], 0.1) != 0
    b = tl.hash_dropout(x, drawn[1], 0.1) != 0
    agree = float((a == b).float().mean())
    # independent Bernoulli(0.9) masks agree on 0.82 of the elements
    assert abs(agree - 0.82) < 0.01, agree
    # the same step seed gives the same seeds, another step seed others
    again = tl.DropoutSeeds(7)
    assert [again.next() for _ in range(50)] == drawn
    other = tl.DropoutSeeds(8)
    assert not set(other.next() for _ in range(50)) & set(drawn)


def test_residual_layer_norm_drops_before_the_add():
    rng = np.random.RandomState(2)
    o = torch.from_numpy(rng.randn(3, 5, 16).astype(np.float32))
    x = torch.from_numpy(rng.randn(3, 5, 16).astype(np.float32))
    ln = tl.LayerNorm(16)
    key = jax.random.PRNGKey(3)
    ref = jl.layer_norm_ref(
        jl.hash_dropout(jnp.asarray(o.numpy()), key, 0.1)
        + jnp.asarray(x.numpy()), jnp.ones(16), jnp.zeros(16))
    got = ln(o, residual=x, drop_rate=0.1, seed=_seed(key))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    # without a seed (eval) the residual mode is LN(o + x)
    np.testing.assert_array_equal(ln(o, residual=x).detach().numpy(),
                                  ln(o + x).detach().numpy())
