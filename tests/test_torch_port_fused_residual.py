"""The port's fused dropout + residual + LayerNorm twins (Queue 2 rows
12-13) against the JAX package's Pallas kernels on the CPU, following
tests/test_fused_residual.py.

- rate 0: forward and gradients of the port's ``dropout_residual_ln`` (the
  twins behind the autograd Function) vs ``fr.dropout_residual_ln(...,
  interpret=True)``;
- rate > 0: in the Mosaic interpreter (``interpret=pltpu.InterpretParams()``)
  the TPU PRNG keeps every element, so the port's twins get the all-keep
  mask and must give the same forward and gradients;
- the backward twin on a fabricated mask and saved residuals vs the Pallas
  backward kernel (``fr._bwd_call(..., "pallas", ...)``) and the XLA one;
- a kept element that is exactly 0 still gets its gradient;
- the port's mask is ``hash_dropout``'s: the zero pattern of the saved od
  is bit-equal to ``volta_tpu.models.layers.hash_dropout``'s for the uint32
  seed that its key draws.

Tolerances: both sides compute the same float32 formula with sums in
another order: fp32 within 1e-5 of max(1, the largest |ref|); bf16 within
two bf16 ulps of the largest |ref| (2^-6 · max|ref|); the row sums dscale
and dbias are float32 in both dtypes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from volta_tpu.models import layers as jl
from volta_tpu.ops import fused_residual as jfr
from volta_tpu_torch.ops import fused_residual as fr

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
EPS = 1e-12


def _inputs(n, d, seed):
    rng = np.random.RandomState(seed)
    o, x, g = (rng.randn(n, d).astype(np.float32) for _ in range(3))
    w = (1 + 0.1 * rng.randn(d)).astype(np.float32)
    b = (0.1 * rng.randn(d)).astype(np.float32)
    return o, x, g, w, b


def _close(got, ref, dtype, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    top = float(np.abs(ref).max())
    tol = 2 ** -6 * top if dtype == "bfloat16" else 1e-5 * max(1.0, top)
    err = float(np.abs(got - ref).max())
    assert err <= tol, (what, err, tol)


def _jax_fwd_vjp(o, x, w, b, g, rate, dtype, interpret):
    jdt = DTYPES[dtype][0]
    y, vjp = jax.vjp(
        lambda o_, x_, w_, b_: jfr.dropout_residual_ln(
            o_, x_, w_, b_, 0, rate, interpret=interpret),
        jnp.asarray(o, jdt), jnp.asarray(x, jdt), jnp.asarray(w),
        jnp.asarray(b))
    return y, vjp(jnp.asarray(g, jdt))


def _torch_leaves(o, x, w, b, dtype):
    tdt = DTYPES[dtype][1]
    return (torch.from_numpy(o).to(tdt).requires_grad_(),
            torch.from_numpy(x).to(tdt).requires_grad_(),
            torch.from_numpy(w).requires_grad_(),
            torch.from_numpy(b).requires_grad_())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rate0_matches_the_pallas_kernels(dtype):
    o, x, g, w, b = _inputs(64, 128, seed=0)
    jy, jgrads = _jax_fwd_vjp(o, x, w, b, g, 0.0, dtype, True)
    leaves = _torch_leaves(o, x, w, b, dtype)
    y = fr.dropout_residual_ln(*leaves, seed=0, rate=0.0, eps=EPS)
    y.backward(torch.from_numpy(g).to(DTYPES[dtype][1]))
    _close(y, jy, dtype, "y")
    for t, r, name in zip(leaves, jgrads, ("do", "dx", "dscale", "dbias")):
        _close(t.grad, r, dtype if name in ("do", "dx") else "float32", name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.25])
def test_all_keep_mask_matches_the_mosaic_interpreter(dtype, rate):
    o, x, g, w, b = _inputs(32, 256, seed=1)
    jy, (jdo, jdx, jdw, jdb) = _jax_fwd_vjp(o, x, w, b, g, rate, dtype,
                                            pltpu.InterpretParams())
    tdt = DTYPES[dtype][1]
    to, tx, tg = (torch.from_numpy(a).to(tdt) for a in (o, x, g))
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    keep = torch.ones(o.shape, dtype=torch.bool)
    y, od, mean, rstd = fr.dropout_residual_ln_fwd_ref(to, tx, tw, tb, keep,
                                                       rate, EPS)
    _close(y, jy, dtype, "y")
    do, dx, dw, db = fr.dropout_residual_ln_bwd_ref(tg, od, tx, tw, mean,
                                                    rstd, keep, rate)
    _close(do, jdo, dtype, "do")
    _close(dx, jdx, dtype, "dx")
    _close(dw, jdw, "float32", "dscale")
    _close(db, jdb, "float32", "dbias")


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_backward_twin_matches_the_backward_kernel(impl):
    """The saved residuals of a fabricated mask (od in bf16, as
    tests/test_fused_residual.py:53-87 builds them) through the port's
    backward twin and through ``fr._bwd_call``."""
    rng = np.random.RandomState(2)
    n, d, rate = 32, 128, 0.25
    o, x, g, w, b = _inputs(n, d, seed=2)
    mask = rng.rand(n, d) > rate
    od = jnp.where(mask, jnp.asarray(o) / (1.0 - rate), 0.0).astype(
        jnp.bfloat16)
    s = od.astype(jnp.float32) + jnp.asarray(x)
    mean = jnp.mean(s, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(s - mean), axis=-1, keepdims=True)
    rstd = jax.lax.rsqrt(var + EPS)
    res = (od, jnp.asarray(mask).astype(od.dtype), jnp.asarray(x),
           jnp.asarray(w), mean, rstd, (n, d))
    jdo, jdx, jdw, jdb, _ = jfr._bwd_call(rate, EPS, True, impl, res,
                                          jnp.asarray(g))
    tod = torch.tensor(np.asarray(od.astype(jnp.float32))).bfloat16()
    do, dx, dw, db = fr.dropout_residual_ln_bwd_ref(
        torch.from_numpy(g), tod, torch.from_numpy(x), torch.from_numpy(w),
        torch.from_numpy(np.asarray(mean)[:, 0]),
        torch.from_numpy(np.asarray(rstd)[:, 0]), torch.from_numpy(mask),
        rate)
    _close(do, jdo, "float32", "do")
    _close(dx, jdx, "float32", "dx")
    _close(dw, jdw, "float32", "dscale")
    _close(db, jdb, "float32", "dbias")


def test_kept_zero_activation_keeps_its_gradient():
    """tests/test_fused_residual.py:147-181 for the port: an element that is
    exactly 0 before the dropout but kept must get its gradient. Against the
    Mosaic interpreter's all-keep run, and with the port's own hash mask."""
    n, d, rate = 16, 128, 0.25
    o, x, g, w, b = _inputs(n, d, seed=3)
    o[0, :8] = 0.0
    _, (jdo, _, _, _) = _jax_fwd_vjp(o, x, w, b, g, rate, "float32",
                                     pltpu.InterpretParams())
    t = dict(zip("oxgwb", (torch.from_numpy(a) for a in (o, x, g, w, b))))
    keep = torch.ones(n, d, dtype=torch.bool)
    _, od, mean, rstd = fr.dropout_residual_ln_fwd_ref(
        t["o"], t["x"], t["w"], t["b"], keep, rate, EPS)
    do = fr.dropout_residual_ln_bwd_ref(t["g"], od, t["x"], t["w"], mean,
                                        rstd, keep, rate)[0]
    _close(do, jdo, "float32", "do")
    assert float(do[0, :8].abs().min()) > 0.0

    # the hash mask through the autograd Function: every kept zero of o gets
    # ds / (1 - rate), every dropped element 0
    seed = 12345
    leaves = _torch_leaves(o, x, w, b, "float32")
    y = fr.dropout_residual_ln(*leaves, seed=seed, rate=rate, eps=EPS)
    y.backward(t["g"])
    kept = fr.keep_mask(seed, (n, d), rate)
    zero_kept = kept & (t["o"] == 0)
    assert int(zero_kept.sum()) >= 4
    grad_o, grad_x = leaves[0].grad, leaves[1].grad
    assert bool((grad_o[zero_kept] != 0).all())
    torch.testing.assert_close(grad_o, torch.where(
        kept, grad_x * fr.keep_scale(rate), 0.0), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.25])
def test_mask_is_hash_dropouts(dtype, rate):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(4)
    o = (rng.rand(4, 23, 96) + 0.5).astype(np.float32)  # no zeros
    x = rng.randn(4, 23, 96).astype(np.float32)
    w, b = np.ones(96, np.float32), np.zeros(96, np.float32)
    for k in range(3):
        key = jax.random.PRNGKey(200 + k)
        seed = int(jax.random.bits(key, (), jnp.uint32))
        ref = np.asarray(jl.hash_dropout(jnp.asarray(o, jdt), key, rate),
                         np.float32)
        _, od, _, _ = fr.dropout_residual_ln_fwd(
            torch.from_numpy(o).to(tdt).reshape(-1, 96),
            torch.from_numpy(x).to(tdt).reshape(-1, 96), torch.from_numpy(w),
            torch.from_numpy(b), seed, rate, EPS)
        np.testing.assert_array_equal((od == 0).reshape(o.shape).numpy(),
                                      ref == 0)
        assert 0 < (ref == 0).mean() < 2 * rate
        # and od is the kept o times float32(1 / (1 - rate)), in o's dtype
        want = torch.where(torch.from_numpy(ref != 0).reshape(-1, 96),
                           torch.from_numpy(o).to(tdt).float().reshape(-1, 96)
                           * fr.keep_scale(rate), 0.0).to(tdt)
        assert torch.equal(od, want)


def test_module_takes_the_fused_path():
    """LayerNorm(fused_residual=True) in a dropping residual call equals
    the twin of rows 12-13 with the hash mask; without a seed (eval) it is
    LN(o + x)."""
    from volta_tpu_torch.models.layers import LayerNorm

    o, x, g, w, b = _inputs(12, 64, seed=5)
    m = LayerNorm(64, use_kernel=True, fused_residual=True)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(w))
        m.bias.copy_(torch.from_numpy(b))
    to, tx = torch.from_numpy(o), torch.from_numpy(x)
    y = m(to, residual=tx, drop_rate=0.1, seed=77)
    keep = fr.keep_mask(77, (12, 64), 0.1)
    ref = fr.dropout_residual_ln_fwd_ref(to, tx, m.weight, m.bias, keep, 0.1,
                                         EPS)[0]
    assert torch.equal(y, ref)
    _close(m(to, residual=tx), m(to + tx).detach().numpy(), "float32",
           "eval residual mode")
