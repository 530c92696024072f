"""The band schedule of the port's LayerNorm kernels (Queue 2 rows 10-11,
``csrc/rowband.cuh``, ``csrc/layernorm.cu``) on the CPU.

What the CUDA kernels do with rows and sums is decided by Python that the
CPU reaches: ``band_blocks`` sizes the grid from the card's capacity,
``band_rows`` gives each warp its band (the kernels' ``band_range``), and
``bwd_workspace`` sizes the backward's partial sums. These tests hold:

- the bands cover every row exactly once, in order, balanced to one row,
  for every n and card size, and the backward's wrapper sizes its
  workspace for the block count it passes to the launch (a recording
  stand-in for the kernel, which writes the sums where the C interface
  says they go);
- the backward's reduction recipe in plain PyTorch: each warp adds its
  band's rows in order, the block's 8 warps are summed as a tree, and the
  blocks' partials in 32 strands of block order and a tree over the strands
  (``band_sum_kernel``, rowband.cuh). It is held against the JAX package's
  ``_bwd_kernel`` (through ``_pallas_layer_norm``'s VJP under
  ``pltpu.force_tpu_interpret_mode()``) and against the twin
  ``layer_norm_bwd_ref``.

Inputs come from numpy with a seed. Tolerance: float32 sums over rows in
another order, within 1e-5 of max(1, the largest |ref|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from volta_tpu.ops import layernorm as jln
from volta_tpu_torch.ops import LAUNCHES
from volta_tpu_torch.ops import layernorm as ln

EPS = 1e-12
SUM_STRANDS = 32  # kSumWarps in csrc/layernorm.cu
ROWS = [1, 7, 33, 255, 256, 15360, 15361, 61440]
# blocks the card holds: 132 SMs x 2 (an H100), 114 x 2, and small cards
CARDS = [264, 228, 16, 1]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("per_card", CARDS)
@pytest.mark.parametrize("n", ROWS)
def test_bands_cover_every_row_once(n, per_card):
    blocks = ln.band_blocks(n, per_card)
    assert 1 <= blocks <= per_card
    bands = ln.band_rows(n, blocks)
    assert len(bands) == blocks * ln.BAND_WARPS
    covered = [r for r0, r1 in bands for r in range(r0, r1)]
    assert covered == list(range(n))
    sizes = [r1 - r0 for r0, r1 in bands]
    assert max(sizes) - min(sizes) <= 1
    # a block is launched only where its warps get a row each, or where one
    # block is all there is
    assert blocks == 1 or min(sizes) >= 1
    d = 768
    assert ln.bwd_workspace(d, blocks) == 2 * blocks * d + 2 * d


class _RecordingKernels:
    """Stands in for the ctypes functions: records what each launch is told
    and writes dscale and dbias where the C interface puts them (after the
    [2, blocks, d] partials of the workspace)."""

    def __init__(self, buffers):
        self.buffers, self.calls = buffers, []

    def fwd(self, *args):
        self.calls.append(("fwd", args))
        return 0

    def bwd(self, g, x, w, mean, rstd, dx, ws, n, d, vec, blocks, code, dev,
            stream):
        self.calls.append(("bwd", (n, d, vec, blocks)))
        buf = self.buffers[ws]
        # the C side's layout: out = part + 2 * blocks * d, dscale then dbias
        out = buf[2 * blocks * d:]
        assert out.numel() == 2 * d, (buf.numel(), blocks, d)
        out.copy_(torch.arange(2 * d, dtype=torch.float32))
        return 0


@pytest.mark.parametrize("per_card", [264, 3])
@pytest.mark.parametrize("n", [1, 7, 15361])
def test_launches_are_told_the_blocks_their_buffers_are_sized_for(
        monkeypatch, n, per_card):
    d = 96
    x, g = torch.zeros(n, d), torch.zeros(n, d)
    w, b = torch.ones(d), torch.zeros(d)
    mean, rstd = torch.zeros(n), torch.ones(n)
    buffers = {}
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        buffers[t.data_ptr()] = t
        return t

    rec = _RecordingKernels(buffers)
    monkeypatch.setattr(ln, "_kernels", lambda: (rec.fwd, rec.bwd,
                                                 lambda rc: b"error"))
    monkeypatch.setattr(ln, "_per_card", lambda *a: per_card)
    monkeypatch.setattr(ln.torch, "empty", empty)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 0,
                        raising=False)
    for name in ("layer_norm_fwd", "layer_norm_bwd"):
        monkeypatch.setitem(LAUNCHES, name, 0)

    ln._launch_fwd(x, w, b, EPS, n, d, 1)
    dx, dw, db = ln._launch_bwd(g, x, w, mean, rstd, n, d, 1)
    blocks = ln.band_blocks(n, per_card)
    (kind_f, args_f), (kind_b, args_b) = rec.calls
    assert kind_f == "fwd" and args_f[10] == blocks
    assert kind_b == "bwd" and args_b == (n, d, 1, blocks)
    assert dx.shape == (n, d)
    np.testing.assert_array_equal(dw.numpy(), np.arange(d))
    np.testing.assert_array_equal(db.numpy(), np.arange(d, 2 * d))
    assert LAUNCHES["layer_norm_fwd"] == LAUNCHES["layer_norm_bwd"] == 1


def _tree(t, dim):
    """Sum over dim (a power-of-2 length) as the kernels' tree_sum: strides
    K/2, K/4, ..., 1."""
    while t.shape[dim] > 1:
        half = t.shape[dim] // 2
        t = t.narrow(dim, 0, half) + t.narrow(dim, half, half)
    return t.squeeze(dim)


def bwd_sums_recipe(g, x, mean, rstd, blocks):
    """dscale and dbias of rows 10-11's backward for float32 rows g, x [n,
    d], in the kernels' order: each warp's band in row order, a tree over a
    block's BAND_WARPS warps, then the blocks in SUM_STRANDS strands
    (blocks k, k + SUM_STRANDS, ... in order) and a tree over the
    strands."""
    n, d = x.shape
    xhat = (x - mean[:, None]) * rstd[:, None]
    contrib = torch.stack([g * xhat, g])  # [2, n, d]
    bands = ln.band_rows(n, blocks)
    warps = len(bands)
    acc = torch.zeros(2, warps, d)
    starts = torch.tensor([r0 for r0, _ in bands])
    lens = torch.tensor([r1 - r0 for r0, r1 in bands])
    for k in range(int(lens.max())):
        live = lens > k
        acc[:, live] += contrib[:, starts[live] + k]
    part = _tree(acc.view(2, blocks, ln.BAND_WARPS, d), 2)  # [2, blocks, d]
    strands = torch.zeros(2, SUM_STRANDS, d)
    for blk in range(blocks):
        strands[:, blk % SUM_STRANDS] += part[:, blk]
    dw, db = _tree(strands, 1)
    return dw, db


def _close(got, ref, what):
    ref = np.asarray(ref, np.float32)
    got = got.numpy()
    tol = 1e-5 * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol, (what, err, tol)


def _inputs(n, d, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, d) * 2 + 0.5).astype(np.float32)
    g = rng.randn(n, d).astype(np.float32)
    w = (1 + 0.1 * rng.randn(d)).astype(np.float32)
    b = (0.1 * rng.randn(d)).astype(np.float32)
    return x, g, w, b


@pytest.mark.parametrize("per_card", [264, 5, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(256, 128), (768, 768)])
def test_bwd_recipe_matches_the_pallas_kernel_and_the_twin(n, d, dtype,
                                                           per_card):
    jdt, tdt = DTYPES[dtype]
    x, g, w, b = _inputs(n, d, seed=n + d)
    jx, jg = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(
            lambda x_, w_, b_: jln._pallas_layer_norm(x_, w_, b_, EPS),
            jx, jnp.asarray(w), jnp.asarray(b))
        _, jdw, jdb = vjp(jg)
    tx, tg = torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt)
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    _, mean, rstd = ln.layer_norm_fwd_ref(tx, tw, tb, EPS)
    blocks = ln.band_blocks(n, per_card)
    dw, db = bwd_sums_recipe(tg.float(), tx.float(), mean, rstd, blocks)
    _close(dw, jdw, "dscale vs _bwd_kernel")
    _close(db, jdb, "dbias vs _bwd_kernel")
    _, rdw, rdb = ln.layer_norm_bwd_ref(tg, tx, tw, mean, rstd)
    _close(dw, rdw.numpy(), "dscale vs twin")
    _close(db, rdb.numpy(), "dbias vs twin")


@pytest.mark.parametrize("n,d,per_card", [(33, 100, 264), (1000, 768, 7)])
def test_bwd_recipe_matches_the_twin_at_ragged_rows(n, d, per_card):
    x, g, w, b = _inputs(n, d, seed=n)
    tx, tg, tw, tb = (torch.from_numpy(a) for a in (x, g, w, b))
    _, mean, rstd = ln.layer_norm_fwd_ref(tx, tw, tb, EPS)
    dw, db = bwd_sums_recipe(tg, tx, mean, rstd,
                             ln.band_blocks(n, per_card))
    _, rdw, rdb = ln.layer_norm_bwd_ref(tg, tx, tw, mean, rstd)
    _close(dw, rdw.numpy(), "dscale")
    _close(db, rdb.numpy(), "dbias")
