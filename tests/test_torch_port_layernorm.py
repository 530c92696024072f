"""The port's LayerNorm twins (Queue 2 rows 10-11) against the JAX
package's Pallas LayerNorm kernels on the CPU.

The JAX side runs ``_pallas_layer_norm`` (forward ``_fwd_kernel``, backward
``_bwd_kernel`` through its custom VJP) under
``pltpu.force_tpu_interpret_mode()``; the port runs ``layer_norm_fwd`` /
``layer_norm_bwd`` and the ``fused_layer_norm`` autograd Function on CPU
tensors, which take the plain twins. Inputs come from numpy with a seed, in
fp32 and bf16, d in {128, 768}, n a multiple of the JAX kernel's 256-row
tile. A ragged n is held against the JAX package's CPU path
(``fused_layer_norm`` -> ``layer_norm_ref``).

Tolerances: both sides compute the same float32 formula, with sums over a
row or over the rows in another order. fp32 values within 1e-5 of max(1,
the largest |ref|); bf16 outputs within two bf16 ulps of the largest |ref|
(2^-6 · max|ref|), since one rounding of a float32 that differs in its last
bits can land one bf16 ulp away.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from volta_tpu.ops import layernorm as jln
from volta_tpu_torch.models.layers import LayerNorm
from volta_tpu_torch.ops import layernorm as ln

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
EPS = 1e-12


def _inputs(n, d, seed, lead=()):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*lead, n, d) * 2 + 0.5).astype(np.float32)
    g = rng.randn(*lead, n, d).astype(np.float32)
    w = (1 + 0.1 * rng.randn(d)).astype(np.float32)
    b = (0.1 * rng.randn(d)).astype(np.float32)
    return x, g, w, b


def _close(got, ref, dtype, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    top = float(np.abs(ref).max())
    tol = 2 ** -6 * top if dtype == "bfloat16" else 1e-5 * max(1.0, top)
    err = float(np.abs(got - ref).max())
    assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(256, 128), (512, 768)])
def test_twins_match_the_pallas_kernels(dtype, n, d):
    jdt, tdt = DTYPES[dtype]
    x, g, w, b = _inputs(n, d, seed=n + d)
    jx, jg = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    jw, jb = jnp.asarray(w), jnp.asarray(b)
    with pltpu.force_tpu_interpret_mode():
        jy, res = jln._fwd_call(jx, jw, jb, EPS)
        y_ref, vjp = jax.vjp(
            lambda x_, w_, b_: jln._pallas_layer_norm(x_, w_, b_, EPS),
            jx, jw, jb)
        jdx, jdw, jdb = vjp(jg)
    np.testing.assert_array_equal(np.asarray(jy, np.float32),
                                  np.asarray(y_ref, np.float32))
    tx, tg = torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt)
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)

    # the wrappers on CPU tensors are the twins
    y, mean, rstd = ln.layer_norm_fwd(tx, tw, tb, EPS)
    assert y.dtype == tdt and mean.dtype == rstd.dtype == torch.float32
    _close(y, jy, dtype, "y")
    _close(mean, res[2][:, 0], "float32", "mean")
    _close(rstd, res[3][:, 0], "float32", "rstd")
    dx, dw, db = ln.layer_norm_bwd(tg, tx, tw, mean, rstd)
    assert dx.dtype == tdt and dw.dtype == db.dtype == torch.float32
    _close(dx, jdx, dtype, "dx")
    _close(dw, jdw, "float32", "dscale")
    _close(db, jdb, "float32", "dbias")

    # the autograd Function over them, on a [2, n/2, d] input
    xr = tx.view(2, n // 2, d).clone().requires_grad_()
    wr, br = tw.clone().requires_grad_(), tb.clone().requires_grad_()
    yr = ln.fused_layer_norm(xr, wr, br, EPS)
    yr.backward(tg.view(2, n // 2, d))
    _close(yr.view(n, d), jy, dtype, "Function y")
    _close(xr.grad.view(n, d), jdx, dtype, "Function dx")
    _close(wr.grad, jdw, "float32", "Function dscale")
    _close(br.grad, jdb, "float32", "Function dbias")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_rows_match_the_jax_cpu_path(dtype):
    jdt, tdt = DTYPES[dtype]
    x, g, w, b = _inputs(37, 96, seed=3, lead=(3,))
    jx = jnp.asarray(x, jdt)
    ref, vjp = jax.vjp(lambda x_, w_, b_: jln.fused_layer_norm(x_, w_, b_),
                       jx, jnp.asarray(w), jnp.asarray(b))
    jdx, jdw, jdb = vjp(jnp.asarray(g, jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    y = ln.fused_layer_norm(tx, tw, tb, EPS)
    y.backward(torch.from_numpy(g).to(tdt))
    _close(y, ref, dtype, "y")
    _close(tx.grad, jdx, dtype, "dx")
    _close(tw.grad, jdw, "float32", "dscale")
    _close(tb.grad, jdb, "float32", "dbias")


def test_module_kernel_path_matches_the_plain_path():
    """LayerNorm(use_kernel=True) and the plain torch LayerNorm agree, in
    both modes and in residual mode, and the kernel path runs the wrappers
    (on the CPU: the twins, so no launch is counted)."""
    from volta_tpu_torch.ops import LAUNCHES

    x, g, w, b = _inputs(20, 64, seed=4, lead=(2,))
    o = _inputs(20, 64, seed=5, lead=(2,))[0]
    outs = []
    for use_kernel in (True, False):
        m = LayerNorm(64, use_kernel=use_kernel)
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(w))
            m.bias.copy_(torch.from_numpy(b))
        tx = torch.from_numpy(x).requires_grad_()
        before = dict(LAUNCHES)
        y = m(torch.from_numpy(o), residual=tx) + m(tx)
        y.backward(torch.from_numpy(g))
        assert LAUNCHES == before
        outs.append([y, tx.grad, m.weight.grad, m.bias.grad])
    for a, r, name in zip(*outs, ("y", "dx", "dscale", "dbias")):
        _close(a, r.detach().numpy(), "float32", name)
