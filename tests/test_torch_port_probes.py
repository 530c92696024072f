"""The port's matmul kernels of the tools' decision probes (Queue 2 rows 15
and 16) and the ported probes, on the CPU.

The JAX kernels run in the Mosaic TPU interpreter
(``pltpu.force_tpu_interpret_mode()``), called through the tools' own
``make_pallas_wgrad`` and ``make_pallas_matmul``, whose files are imported
by path and left as they are. The port's twins get the same bf16 operands,
made with numpy from a seed:

- row 15 (gᵀa, float32 accumulation and output): within 1e-5 of the largest
  |value|, the same exact bf16 products summed in another order;
- row 16 (x·w + b, tanh gelu or none, stored bf16): within one bf16 ulp of
  each element, the float32 results rounding apart at most once; with the
  gelu, plus four float32 ulps of the pre-activation, where 1 + tanh
  cancels and the two tanh implementations differ.

The probe CLIs run with ``--device cpu`` at tiny sizes and print one JSON
line a variant and a verdict.

The Hopper body of both rows (``csrc/matmul_wgmma.cuh``) runs only on the
card; here its routing rule (``matmul_body``) on CPU-made tensors, its work
plan (``wgmma_plan``: every (tile, k block) once, row 15's token ranges
partitioning each tile's reduction in slot order, equal shares) and row
15's partial tiles and their ordered sum replayed in float64 against gᵀa.
"""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from volta_tpu_torch.ops import LAUNCHES
from volta_tpu_torch.ops import matmul as mm
from volta_tpu_torch.tools import ffn_probe, wgrad_probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16(rng, *shape, scale=1.0):
    """numpy float32 values rounded to bf16, as (jax array, torch tensor)."""
    x = jnp.asarray(rng.randn(*shape).astype(np.float32) * scale,
                    jnp.bfloat16)
    return x, torch.from_numpy(np.asarray(x, np.float32)).bfloat16()


@pytest.mark.parametrize("n,h,f,bk", [(256, 128, 256, 64), (96, 8, 24, 32)])
def test_row_15_twin_matches_pallas(n, h, f, bk):
    rng = np.random.RandomState(30)
    jg, g = _bf16(rng, n, h)
    ja, a = _bf16(rng, n, f)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(_tool("wgrad_probe").make_pallas_wgrad(n, h, f, bk)(
            jg, ja))
    before = dict(LAUNCHES)
    got = mm.wgrad(g, a)
    assert LAUNCHES == before  # the CPU runs the twin
    assert got.dtype == torch.float32 and got.shape == (h, f)
    top = np.abs(ref).max()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * top)


def _bf16_ulp(x):
    """One bf16 ulp of each element of float32 x (which holds bf16 values):
    2^(exponent - 7), the smallest normal's for 0."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("act", [True, False], ids=["gelu", "bias_only"])
@pytest.mark.parametrize("n,k,m,bm,bn", [(64, 128, 256, 32, 128),
                                         (48, 64, 32, 16, 32)])
def test_row_16_twin_matches_pallas(n, k, m, bm, bn, act):
    rng = np.random.RandomState(31)
    jx, x = _bf16(rng, n, k)
    jw, w = _bf16(rng, k, m, scale=0.2)
    jb, b = _bf16(rng, 1, m)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(_tool("pallas_ffn_probe").make_pallas_matmul(
            n, k, m, bm, bn, act)(jx, jw, jb), np.float32)
    got = mm.matmul_bias_act(x, w, b, act)
    assert got.dtype == torch.bfloat16 and got.shape == (n, m)
    diff = np.abs(got.float().numpy() - ref)
    # where the gelu cancels (1 + tanh near 0, large negative inputs) the
    # result is far below its input, and the two tanh implementations'
    # float32 ulps show: allow four of them, of the pre-activation
    pre = (x.double() @ w.double() + b.double()).numpy()
    tol = _bf16_ulp(ref) + (4 * 2.0 ** -24 * np.abs(pre) if act else 0.0)
    assert (diff <= tol).all(), (diff - tol).max()
    if act:  # the gelu ran: large negative inputs went to ~0
        assert (ref > -0.2).all()


def test_matmul_wrappers_refuse_what_the_kernels_do_not_take():
    meta = torch.zeros(8, 8, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        mm.wgrad(meta, meta)
    with pytest.raises(ValueError, match="CUDA device"):
        mm.matmul_bias_act(meta, meta, meta[0], True)


@pytest.mark.parametrize("rc,message", [
    (mm.NO_ENCODE, "cuTensorMapEncodeTiled failed (no driver entry point)"),
    (-1, "cuTensorMapEncodeTiled failed (CUresult 1)"),
    (1, "kernel launch failed: bad (cudaError 1)")])
def test_matmul_launch_codes_become_errors(rc, message):
    """The Hopper body's host side returns a negated CUresult where a
    tensor map does not encode, and the launch's cudaError_t otherwise; the
    wrappers raise on either."""
    err = mm._raise("wgrad", rc, lambda code: b"bad")
    assert isinstance(err, RuntimeError) and message in str(err)


def _lines(capsys):
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]


def test_wgrad_probe_runs_on_the_cpu(capsys, monkeypatch):
    calls = []
    monkeypatch.setattr(wgrad_probe, "wgrad",
                        lambda g, a: (calls.append(1), mm.wgrad(g, a))[1])
    results, verdict = wgrad_probe.main(
        ["--device", "cpu", "--tokens", "64", "--hidden", "16", "--ffn",
         "32", "--layers", "2", "--iters", "2"])
    lines = _lines(capsys)
    assert [line["variant"] for line in lines[:-1]] == [
        "torch_T", "torch_dg", "torch_dg_f32", "cuda_k"]
    for line in lines[:-1]:
        assert line["ms"] > 0 and line["tensor_pct"] is None
        assert line["card"] == "cpu"
    assert lines[-1] == verdict and verdict["verdict"] in results
    assert "gain_vs_torch_T_pct" in verdict
    assert len(calls) == 2 * 3  # two layers, a warm call and two timed


def test_ffn_probe_runs_on_the_cpu(capsys, monkeypatch):
    calls = []
    monkeypatch.setattr(ffn_probe, "matmul_bias_act",
                        lambda *a: (calls.append(1),
                                    mm.matmul_bias_act(*a))[1])
    results, verdict = ffn_probe.main(
        ["--device", "cpu", "--tokens", "32", "--hidden", "16", "--ffn",
         "32", "--calls", "2", "--iters", "1"])
    lines = _lines(capsys)
    assert [line["variant"] for line in lines[:-1]] == [
        "torch", "cuda1", "cuda2"]
    assert all(line["card"] == "cpu" for line in lines[:-1])
    assert lines[-1] == verdict and "gain_vs_torch_pct" in verdict
    # 2 calls a chain, a warm chain and a timed one: cuda1 one kernel a
    # call, cuda2 two
    assert len(calls) == 2 * 2 * (1 + 2)


def test_probes_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wgrad_probe.main(["--tokens", "8", "--hidden", "4", "--ffn", "4"])


# ------------------------ the Hopper body: which operands take it, its plan
def _zeros(*shape, dtype=torch.bfloat16):
    return torch.zeros(*shape, dtype=dtype)


@pytest.mark.parametrize("shapes,body", [
    ([(15360, 768), (15360, 3072)], "wgmma"),  # row 15 at the probes' shape
    ([(1000, 104), (1000, 296)], "wgmma"),  # ragged against the tiles
    ([(64, 128), (64, 256)], "wgmma"),
    ([(1000, 100), (1000, 300)], "mma.sync"),  # 200-byte rows of g
    ([(17, 5), (17, 9)], "mma.sync"),
    ([(15360, 768), (768, 3072), (1, 3072)], "wgmma"),  # row 16, leg 1
    ([(15360, 3072), (3072, 768), (1, 768)], "wgmma"),  # leg 2
    ([(1000, 40), (40, 200), (1, 200)], "wgmma"),
    ([(1000, 100), (100, 300), (1, 300)], "mma.sync"),  # 200-byte rows of x
    ([(17, 40), (40, 9), (1, 9)], "mma.sync"),  # 18-byte rows of w
])
def test_matmul_body_by_shape(shapes, body):
    assert mm.matmul_body(*[_zeros(*s) for s in shapes]) == body


def test_matmul_body_by_layout():
    ok = _zeros(64, 64)
    assert mm.matmul_body(ok) == "wgmma"
    assert mm.matmul_body(ok.float()) == "mma.sync"
    assert mm.matmul_body(ok.t()) == "mma.sync"  # not contiguous
    flat = _zeros(64 * 64 + 8)
    assert flat.data_ptr() % 16 == 0
    assert mm.matmul_body(flat[8:].view(64, 64)) == "wgmma"  # 16 bytes on
    assert mm.matmul_body(flat[1:4097].view(64, 64)) == "mma.sync"  # 2 on
    assert mm.matmul_body(_zeros(0, 64)) == "mma.sync"  # empty
    assert mm.matmul_body(ok, _zeros(64, 4)) == "mma.sync"  # 8-byte rows


# (m, n, k, split): rows 15 (split) and 16 at the probes' shapes and at
# shapes ragged against the 256 x 256 tiles and 64-deep k blocks
PLAN_SHAPES = [(768, 3072, 15360, True), (104, 296, 1000, True),
               (264, 520, 200, True), (128, 256, 64, True),
               (15360, 3072, 768, False), (15360, 768, 3072, False),
               (1000, 200, 40, False), (264, 520, 200, False)]


@pytest.mark.parametrize("clusters", [66, 5])
@pytest.mark.parametrize("m,n,k,split", PLAN_SHAPES)
def test_wgmma_plan_covers_every_tile_and_k_block_once(m, n, k, split,
                                                       clusters):
    units, first, tile_slots = mm.wgmma_plan(m, n, k, clusters, split)
    tiles = -(-m // mm.TILE_M) * -(-n // mm.TILE_N)
    kb = -(-k // mm.TILE_K)
    grid = len(first) - 1
    assert grid == min(clusters, tiles * kb if split else tiles)
    assert first[0] == 0 and first[-1] == len(units)
    assert all(first[c] < first[c + 1] for c in range(grid))
    steps = sorted((t, b) for t, b0, b1, _ in units for b in range(b0, b1))
    assert steps == [(t, b) for t in range(tiles) for b in range(kb)]
    work = [sum(b1 - b0 for _, b0, b1, _ in units[first[c]:first[c + 1]])
            for c in range(grid)]
    if split:  # stream-K: equal shares, each a run of the (tile, k) order
        assert max(work) - min(work) <= 1
        assert [u[3] for u in units] == list(range(len(units)))
        order = [(t, b0, b1) for t, b0, b1, _ in units]
        assert order == sorted(order)
        assert len(tile_slots) == 2 * tiles
        for t in range(tiles):  # each tile's token ranges partition [0, kb)
            s0, s1 = tile_slots[2 * t], tile_slots[2 * t + 1]
            assert all(units[s][0] == t for s in range(s0, s1))
            bounds = [0] + [units[s][2] for s in range(s0, s1)]
            assert [units[s][1] for s in range(s0, s1)] == bounds[:-1]
            assert bounds[-1] == kb
    else:  # whole tiles, dealt round robin
        assert all(u[1:] == (0, kb, -1) for u in units) and not tile_slots
        assert max(work) - min(work) <= kb


@pytest.mark.parametrize("n,h,f,clusters", [(200, 264, 520, 5),
                                            (1000, 104, 296, 66),
                                            (130, 128, 256, 3)])
def test_wgrad_partials_sum_to_the_product(n, h, f, clusters):
    """Row 15's Hopper body replayed in float64: each unit's partial tiles
    (block r of the cluster on rows [128 r, 128 r + 128) of its pair tile,
    zeros past the edges) into workspace slot 2 s + r, then the second
    kernel's sum of each tile's slots in order, against gᵀa."""
    rng = np.random.RandomState(32)
    g = torch.from_numpy(rng.randn(n, h))
    a = torch.from_numpy(rng.randn(n, f))
    units, _, tile_slots = mm.wgmma_plan(h, f, n, clusters, True)
    tiles_n = -(-f // 256)
    kb = -(-n // 64)
    rows = -(-h // 256) * 256
    gp = torch.zeros(kb * 64, rows, dtype=torch.float64)
    ap = torch.zeros(kb * 64, tiles_n * 256, dtype=torch.float64)
    gp[:n, :h], ap[:n, :f] = g, a
    ws = torch.full((2 * len(units), 128, 256), float("nan"),
                    dtype=torch.float64)
    for t, b0, b1, s in units:
        n0 = t % tiles_n * 256
        for r in (0, 1):
            m0 = (2 * (t // tiles_n) + r) * 128
            ws[2 * s + r] = (gp[b0 * 64:b1 * 64, m0:m0 + 128].t()
                             @ ap[b0 * 64:b1 * 64, n0:n0 + 256])
    out = torch.full((rows, tiles_n * 256), float("nan"),
                     dtype=torch.float64)
    for p in range(len(tile_slots) // 2):
        m0, n0 = p // tiles_n * 256, p % tiles_n * 256
        for r in (0, 1):
            slots = range(tile_slots[2 * p], tile_slots[2 * p + 1])
            acc = ws[2 * slots[0] + r].clone()
            for s in slots[1:]:
                acc += ws[2 * s + r]
            out[m0 + 128 * r:m0 + 128 * r + 128, n0:n0 + 256] = acc
    np.testing.assert_allclose(out[:h, :f].numpy(), (g.t() @ a).numpy(),
                               rtol=1e-12, atol=1e-10)
