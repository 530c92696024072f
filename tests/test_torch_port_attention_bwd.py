"""The port's attention backward and dropout attention against the JAX
package's Pallas kernels on the CPU.

The JAX kernels run as the JAX tests run them: in the Mosaic interpreter
(``pallas_attention.interpret_mode()``), whose PRNG gives all-zero bits, so
its dropout keeps everything at scale 1/(1 - rate); the port's twins are fed
that all-keep mask. At a real hash mask the port's backward twin is held
against ``_dropout_bwd_math``, the JAX kernels' math, with the same mask.
The CUDA kernels themselves are held against these twins on the card by
``test_torch_port_cuda.py``. Tolerances: fp32 rtol 1e-4 / atol 1e-5 for the
gradients (sums in another order; the JAX package's own kernel-vs-XLA
gradient tolerance, tests/test_attention_math.py:278), rtol 1e-5 / atol
1e-6 for forward outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volta_tpu.ops import pallas_attention as pa
from volta_tpu.ops.attention import additive_mask as jax_mask
from volta_tpu_torch.ops import LAUNCHES
from volta_tpu_torch.ops import attention_cuda as ac
from volta_tpu_torch.ops import attention_dropout_cuda as adc
from volta_tpu_torch.ops.attention import fused_attention

# (B, Lq, Lk, H, D): square and cross lengths, an odd key count, Lq < 8
SHAPES = [(2, 8, 8, 2, 16), (4, 16, 24, 3, 32), (3, 5, 37, 2, 64),
          (2, 12, 9, 1, 128)]
RATE = 0.1
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
ids = lambda s: "x".join(map(str, s))  # noqa: E731


def _inputs(b, lq, lk, h, d, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, lq, h, d).astype(np.float32)
    k = rng.randn(b, lk, h, d).astype(np.float32)
    v = rng.randn(b, lk, h, d).astype(np.float32)
    g = rng.randn(b, lq, h, d).astype(np.float32)
    mask = (rng.rand(b, lk) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    return q, k, v, g, mask


def _flat(x):
    return torch.from_numpy(x).reshape(x.shape[0], x.shape[1], -1)


def _bias2(mask):
    return torch.from_numpy(np.array(jax_mask(jnp.asarray(mask)))
                            ).reshape(mask.shape)


@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_no_dropout_backward_matches_pallas(shape):
    """Row 2: jax.vjp of pallas_fused_attention_nat (its bwd rule runs the
    Pallas backward kernel for Lq >= 8, the XLA recipe below) against the
    port's FusedAttention backward: dq, dk, dv and the bias gradient."""
    b, lq, lk, h, d = shape
    q, k, v, g, mask = _inputs(*shape)
    scale = 1.0 / np.sqrt(d)
    jb = jax_mask(jnp.asarray(mask))
    with pa.interpret_mode():
        out, vjp = jax.vjp(
            lambda q, k, v, bias: pa.pallas_fused_attention_nat(
                q, k, v, bias, scale), *map(jnp.asarray, (q, k, v)), jb)
        jdq, jdk, jdv, jdb = vjp(jnp.asarray(g))

    tq, tk, tv = (_flat(x).requires_grad_() for x in (q, k, v))
    tb = _bias2(mask).requires_grad_()
    before = dict(LAUNCHES)
    got = ac.FusedAttention.apply(tq, tk, tv, tb, scale, h)
    got.backward(_flat(g))
    assert LAUNCHES == before  # CPU tensors take the twins
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(out).reshape(got.shape),
                               rtol=1e-5, atol=1e-6)
    for name, t, ref in (("dq", tq, jdq), ("dk", tk, jdk), ("dv", tv, jdv)):
        np.testing.assert_allclose(t.grad.numpy(),
                                   np.asarray(ref).reshape(t.shape),
                                   err_msg=name, **GRAD_TOL)
    np.testing.assert_allclose(tb.grad.numpy(),
                               np.asarray(jdb).reshape(b, lk), **GRAD_TOL)
    # no bias gradient is computed where the bias needs none
    dq, dk, dv, db = ac.attention_bwd(
        _flat(q), _flat(k), _flat(v), _bias2(mask), _flat(g), scale, h)
    assert db is None
    np.testing.assert_array_equal(dq.numpy(), tq.grad.numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_dropout_attention_matches_pallas_interpreter(shape):
    """Rows 3-4: pallas_dropout_attention(natural=True) in the Mosaic
    interpreter (all-keep mask at scale 1/(1 - rate)) against the port's
    twins fed the all-keep mask: forward and vjp."""
    b, lq, lk, h, d = shape
    q, k, v, g, mask = _inputs(*shape, seed=1)
    scale = 1.0 / np.sqrt(d)
    jb = jax_mask(jnp.asarray(mask))
    with pa.interpret_mode():
        out, vjp = jax.vjp(
            lambda q, k, v: pa.pallas_dropout_attention(
                q, k, v, jb, scale, RATE, 1234, natural=True),
            *map(jnp.asarray, (q, k, v)))
        jgrads = vjp(jnp.asarray(g))

    keep = torch.ones((b, h, lq, lk), dtype=torch.bool)
    args = (_flat(q), _flat(k), _flat(v), _bias2(mask))
    got = adc.attention_dropout_fwd_ref(*args, scale, h, RATE, keep)
    np.testing.assert_allclose(got.numpy(), np.asarray(out).reshape(got.shape),
                               rtol=1e-5, atol=1e-6)
    grads = adc.attention_dropout_bwd_ref(*args, _flat(g), scale, h, RATE,
                                          keep)
    for name, t, ref in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(ref).reshape(t.shape),
                                   err_msg=name, **GRAD_TOL)


def _head_batch(x, heads):
    """[B, L, H·D] -> [B·H, L, D], the JAX kernels' batched-head layout."""
    b, l, hd = x.shape
    return jnp.asarray(x.reshape(b, l, heads, hd // heads).transpose(
        0, 2, 1, 3).reshape(b * heads, l, hd // heads))


@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_dropout_backward_matches_jax_math_at_a_real_mask(shape):
    """Rows 3-4 at a real mask: the port's keep_mask (the kernels' hash)
    passed as numpy to both JAX ``_dropout_bwd_math`` and the port's twin;
    and the forward against the JAX kernel body's recipe on that mask."""
    b, lq, lk, h, d = shape
    q, k, v, g, mask = _inputs(*shape, seed=2)
    scale = 1.0 / np.sqrt(d)
    keep = adc.keep_mask(0xDEADBEEF, (b, h, lq, lk), RATE)
    kept = float(keep.float().mean())
    assert 0.7 < kept < 1.0  # a real mask: some probabilities dropped
    fq, fk, fv, fg = (_flat(x).numpy() for x in (q, k, v, g))
    bias = _bias2(mask).numpy()
    jbias = jnp.asarray(np.repeat(bias[:, None], h, axis=1).reshape(
        b * h, 1, lk))
    m01 = jnp.asarray(keep.numpy().reshape(b * h, lq, lk), jnp.bfloat16)
    jdq, jdk, jdv = pa._dropout_bwd_math(
        _head_batch(fq, h), _head_batch(fk, h), _head_batch(fv, h), jbias,
        _head_batch(fg, h), m01, scale, RATE)
    back = lambda x, l: np.asarray(x).reshape(b, h, l, d).transpose(  # noqa
        0, 2, 1, 3).reshape(b, l, h * d)
    args = (_flat(q), _flat(k), _flat(v), _bias2(mask))
    grads = adc.attention_dropout_bwd_ref(*args, _flat(g), scale, h, RATE,
                                          keep)
    for name, t, ref, l in zip(("dq", "dk", "dv"), grads, (jdq, jdk, jdv),
                               (lq, lk, lk)):
        np.testing.assert_allclose(t.numpy(), back(ref, l), err_msg=name,
                                   **GRAD_TOL)

    # forward: the kernel body's recipe (pallas_attention.py:517-522)
    probs = pa._probs_arr(_head_batch(fq, h), _head_batch(fk, h), jbias,
                          scale)
    probs = probs * jnp.where(m01 > 0, 1.0 / (1.0 - RATE), 0.0).astype(
        jnp.float32)
    jout = jax.lax.dot_general(probs, _head_batch(fv, h),
                               (((2,), (1,)), ((0,), (0,))),
                               preferred_element_type=jnp.float32)
    got = adc.attention_dropout_fwd_ref(*args, scale, h, RATE, keep)
    np.testing.assert_allclose(got.numpy(), back(jout, lq), rtol=1e-5,
                               atol=1e-6)


def test_dropout_function_gradcheck_float64():
    """The dropout Function's twin path (forward and backward with the mask
    replayed from the seed) passes torch.autograd.gradcheck in float64; so
    does the no-dropout Function, bias gradient included."""
    b, lq, lk, h, d = 2, 3, 5, 2, 4
    rng = np.random.RandomState(3)
    mk = lambda *s: torch.from_numpy(rng.randn(*s)).requires_grad_()  # noqa
    q, k, v = mk(b, lq, h * d), mk(b, lk, h * d), mk(b, lk, h * d)
    bias = torch.zeros(b, lk, dtype=torch.float64)
    bias[1, 3] = -2.0
    seed = 77
    keep = adc.keep_mask(seed, (b, h, lq, lk), 0.3)
    assert 0 < int(keep.sum()) < keep.numel()  # the mask drops something
    assert torch.autograd.gradcheck(
        lambda q, k, v: adc.DropoutAttention.apply(q, k, v, bias, 0.5, h,
                                                   0.3, seed), (q, k, v))
    assert torch.autograd.gradcheck(
        lambda q, k, v, bias: ac.FusedAttention.apply(q, k, v, bias, 0.5, h),
        (q, k, v, bias.clone().requires_grad_()))


def test_dispatch_routes_by_rate_and_replays_the_mask():
    """fused_attention sends rate > 0 to the dropout Function (the CPU twin
    with keep_mask(seed)), rate 0 to the no-dropout one; the same seed gives
    the same output, another seed another, and the wrappers refuse a
    tensor on neither the CPU nor a card."""
    # 9 queries: JAX's gate sends fewer than 8 to the plain route
    b, lq, lk, h, d = 3, 9, 37, 2, 64
    q, k, v, _, mask = _inputs(b, lq, lk, h, d, seed=4)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    bias4 = _bias2(mask).view(b, 1, 1, lk)
    out = fused_attention(tq, tk, tv, bias4, 0.125, RATE, 5)
    keep = adc.keep_mask(5, (b, h, lq, lk), RATE)
    ref = adc.attention_dropout_fwd_ref(
        _flat(q), _flat(k), _flat(v), _bias2(mask), 0.125, h, RATE, keep)
    assert torch.equal(out.reshape(ref.shape), ref)
    assert torch.equal(fused_attention(tq, tk, tv, bias4, 0.125, RATE, 5),
                       out)
    assert not torch.equal(fused_attention(tq, tk, tv, bias4, 0.125, RATE,
                                           6), out)
    plain = fused_attention(tq, tk, tv, bias4, 0.125)
    assert torch.equal(plain.reshape(ref.shape), ac.attention_fwd_ref(
        _flat(q), _flat(k), _flat(v), _bias2(mask), 0.125, h))
    with pytest.raises(ValueError, match="seed"):
        fused_attention(tq, tk, tv, bias4, 0.125, RATE)
    meta = lambda x: _flat(x).to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="CUDA device"):
        adc.attention_dropout_fwd(meta(q), meta(k), meta(v),
                                  _bias2(mask).to("meta"), 0.125, h, RATE, 5)
    with pytest.raises(ValueError, match="CUDA device"):
        ac.attention_bwd(meta(q), meta(k), meta(v), _bias2(mask).to("meta"),
                         meta(q), 0.125, h)


def test_keep_mask_is_jax_hash_dropout_over_the_probabilities():
    """keep_mask(seed) is the keep pattern of the JAX package's
    hash_dropout over a [B, H, Lq, Lk] tensor for the key whose bits are
    seed; the threshold is computed on the host in double precision."""
    from volta_tpu.models.layers import hash_dropout as jax_hash_dropout

    shape = (2, 3, 7, 11)
    key = jax.random.PRNGKey(17)
    seed = int(jax.random.bits(key, (), jnp.uint32))
    jkeep = np.asarray(jax_hash_dropout(jnp.ones(shape, jnp.float32), key,
                                        RATE)) != 0
    np.testing.assert_array_equal(adc.keep_mask(seed, shape, RATE).numpy(),
                                  jkeep)
    assert adc.dropout_threshold(RATE) == int(
        np.uint32((1.0 - RATE) * 4294967295.0))
    assert adc.keep_scale(RATE) == float(np.float32(1 / 0.9))
