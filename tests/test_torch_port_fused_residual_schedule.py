"""The band schedule of the port's fused dropout + residual + LayerNorm
backward (Queue 2 row 13, ``csrc/fused_residual.cu`` on
``csrc/rowband.cuh``) on the CPU.

What the CUDA kernel does with rows and sums is decided by Python that the
CPU reaches: ``layernorm.band_blocks`` sizes the grid from the card's
capacity (``fused_residual._per_card``), ``layernorm.band_rows`` gives each
warp its band (the kernel's ``band_range``), and
``layernorm.bwd_workspace`` sizes the partial sums and the summed dscale
and dbias. These tests hold:

- the bands cover every row exactly once, in order, balanced to one row,
  for the train shape's rows and the edges of a block's 8 warps, on cards
  of 132 and 114 SMs holding 1 to 3 blocks each;
- the backward's wrapper sizes its workspace for the block count it
  passes to the launch, and reads dscale and dbias where the C interface
  writes them (a recording stand-in for the kernel);
- the backward's reduction recipe in plain PyTorch (each warp adds its
  band's rows in order, a tree over a block's 8 warps, the blocks'
  partials in 32 strands of block order and a tree over the strands:
  ``bwd_sums_recipe`` of the LayerNorm schedule's tests, on s = od + x)
  against the JAX package's ``_bwd_kernel`` (``_bwd_call(..., "pallas",
  ...)`` under ``pltpu.force_tpu_interpret_mode()``), its ``_bwd_xla`` and
  the twin ``dropout_residual_ln_bwd_ref``, with the port's hash mask.

Inputs come from numpy with a seed. Tolerance: float32 sums over rows in
another order, within 1e-5 of max(1, the largest |ref|); do and dx, which
both sides compute by the same float32 formula, within two bf16 ulps of
the largest |ref| in bf16 (2^-6 · max|ref|) and 1e-5 of max(1, |ref|) in
float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_port_layernorm_schedule import _close, bwd_sums_recipe

from volta_tpu.ops import fused_residual as jfr
from volta_tpu_torch.ops import LAUNCHES
from volta_tpu_torch.ops import fused_residual as fr
from volta_tpu_torch.ops import layernorm as ln

EPS = 1e-12
ROWS = [1, 7, 63, 64, 65, 15360, 15361]
# blocks the card holds: 132 SMs (an H100) and 114 SMs (an H100 PCIe), 1-3
# blocks an SM
CARDS = [sms * k for sms in (132, 114) for k in (1, 2, 3)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("per_card", CARDS)
@pytest.mark.parametrize("n", ROWS)
def test_bands_cover_every_row_once(n, per_card):
    blocks = ln.band_blocks(n, per_card)
    assert 1 <= blocks <= per_card
    bands = ln.band_rows(n, blocks)
    assert len(bands) == blocks * ln.BAND_WARPS
    assert [r for r0, r1 in bands for r in range(r0, r1)] == list(range(n))
    sizes = [r1 - r0 for r0, r1 in bands]
    assert max(sizes) - min(sizes) <= 1
    # a block is launched only where its warps get a row each, or where one
    # block is all there is
    assert blocks == 1 or min(sizes) >= 1
    assert ln.bwd_workspace(768, blocks) == 2 * (blocks + 1) * 768


class _RecordingKernel:
    """Stands in for the ctypes backward: records what the launch is told
    and writes dscale and dbias where the C interface puts them (after the
    [2, blocks, d] partials of the workspace)."""

    def __init__(self, buffers):
        self.buffers, self.calls = buffers, []

    def __call__(self, g, od, x, w, mean, rstd, do, dx, ws, n, d, seed,
                 threshold, scale, drop, vec, blocks, code, dev, stream):
        self.calls.append((n, d, seed, drop, vec, blocks))
        buf = self.buffers[ws]
        assert buf.numel() == ln.bwd_workspace(d, blocks), (buf.numel(),
                                                            blocks, d)
        buf[2 * blocks * d:].copy_(torch.arange(2 * d, dtype=torch.float32))
        return 0


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("per_card", [264, 3])
@pytest.mark.parametrize("n", [1, 7, 15361])
def test_launch_is_told_the_blocks_its_workspace_is_sized_for(
        monkeypatch, n, per_card, rate):
    d = 96
    g, od, x = (torch.zeros(n, d) for _ in range(3))
    w, mean, rstd = torch.ones(d), torch.zeros(n), torch.ones(n)
    buffers = {}
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        buffers[t.data_ptr()] = t
        return t

    rec = _RecordingKernel(buffers)
    monkeypatch.setattr(fr, "_kernels", lambda: (None, rec,
                                                 lambda rc: b"error"))
    monkeypatch.setattr(fr, "_per_card", lambda *a: per_card)
    monkeypatch.setattr(fr.torch, "empty", empty)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 0,
                        raising=False)
    monkeypatch.setitem(LAUNCHES, "dropout_residual_ln_bwd", 0)

    do, dx, dw, db = fr._launch_bwd(g, od, x, w, mean, rstd, 1234, rate, n,
                                    d, 1)
    blocks = ln.band_blocks(n, per_card)
    assert rec.calls == [(n, d, 1234, int(rate > 0), 1, blocks)]
    assert do.shape == dx.shape == (n, d)
    np.testing.assert_array_equal(dw.numpy(), np.arange(d))
    np.testing.assert_array_equal(db.numpy(), np.arange(d, 2 * d))
    assert LAUNCHES["dropout_residual_ln_bwd"] == 1


def _inputs(n, d, seed):
    rng = np.random.RandomState(seed)
    o, x, g = (rng.randn(n, d).astype(np.float32) for _ in range(3))
    w = (1 + 0.1 * rng.randn(d)).astype(np.float32)
    b = (0.1 * rng.randn(d)).astype(np.float32)
    return o, x, g, w, b


def _close_rows(got, ref, dtype, what):
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    top = float(np.abs(ref).max())
    tol = 2 ** -6 * top if dtype == "bfloat16" else 1e-5 * max(1.0, top)
    err = float(np.abs(got - ref).max())
    assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("per_card", [264, 5, 1])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(256, 128), (768, 768)])
def test_bwd_recipe_matches_the_pallas_kernel_and_the_twin(n, d, dtype, rate,
                                                           per_card):
    jdt, tdt = DTYPES[dtype]
    o, x, g, w, b = _inputs(n, d, seed=n + d)
    seed = 0xBEEF + n
    to, tx, tg = (torch.from_numpy(a).to(tdt) for a in (o, x, g))
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    keep = fr.tail_keep_mask(seed, (n, d), rate)
    _, od, mean, rstd = fr.dropout_residual_ln_fwd_ref(to, tx, tw, tb, keep,
                                                       rate, EPS)
    # the JAX package's saved residuals for the same od and mask
    res = (jnp.asarray(od.float().numpy(), jdt),
           jnp.asarray(keep.numpy(), jdt), jnp.asarray(x, jdt),
           jnp.asarray(w), jnp.asarray(mean.numpy()[:, None]),
           jnp.asarray(rstd.numpy()[:, None]), (n, d))
    jg = jnp.asarray(g, jdt)
    with pltpu.force_tpu_interpret_mode():
        kdo, kdx, kdw, kdb, _ = jfr._bwd_call(rate, EPS, False, "pallas",
                                              res, jg)
    xdo, xdx, xdw, xdb, _ = jfr._bwd_xla(rate, res, jg)
    do, dx, rdw, rdb = fr.dropout_residual_ln_bwd_ref(tg, od, tx, tw, mean,
                                                      rstd, keep, rate)
    dw, db = bwd_sums_recipe(tg.float(), od.float() + tx.float(), mean, rstd,
                             ln.band_blocks(n, per_card))
    for ref_w, ref_b, name in ((kdw, kdb, "_bwd_kernel"),
                               (xdw, xdb, "_bwd_xla"),
                               (rdw.numpy(), rdb.numpy(), "twin")):
        _close(dw, ref_w, f"dscale vs {name}")
        _close(db, ref_b, f"dbias vs {name}")
    for ref_do, ref_dx, name in ((kdo, kdx, "_bwd_kernel"),
                                 (xdo, xdx, "_bwd_xla")):
        _close_rows(do, ref_do, dtype, f"twin do vs {name}")
        _close_rows(dx, ref_dx, dtype, f"twin dx vs {name}")


@pytest.mark.parametrize("n,d,per_card", [(33, 100, 264), (1000, 768, 7),
                                          (15361, 64, 264)])
def test_bwd_recipe_matches_the_twin_at_ragged_rows(n, d, per_card):
    o, x, g, w, b = _inputs(n, d, seed=n)
    to, tx, tg, tw, tb = (torch.from_numpy(a) for a in (o, x, g, w, b))
    keep = fr.tail_keep_mask(7, (n, d), 0.1)
    _, od, mean, rstd = fr.dropout_residual_ln_fwd_ref(to, tx, tw, tb, keep,
                                                       0.1, EPS)
    dw, db = bwd_sums_recipe(tg, od + tx, mean, rstd,
                             ln.band_blocks(n, per_card))
    _, _, rdw, rdb = fr.dropout_residual_ln_bwd_ref(tg, od, tx, tw, mean,
                                                    rstd, keep, 0.1)
    _close(dw, rdw.numpy(), "dscale")
    _close(db, rdb.numpy(), "dbias")
