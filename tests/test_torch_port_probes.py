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
