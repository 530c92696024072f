"""The hand-written CUDA kernels against their plain twins, on the card.

Marked ``cuda``: each test skips on a host without one. The file imports no
JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest

Tolerances: the no-dropout forward output bf16 2e-2 (two bf16 ulps at
|x| ~ 2; fp32 1e-5). The backward sums run in another order than the twin's
einsums, then both round: bf16 within two bf16 ulps of the tensor's largest
magnitude (2^-6 * max|ref|), fp32 within 1e-5 * max(1, max|ref|). The
dropout mask is compared bit for bit.
"""

import numpy as np
import pytest
import torch

from volta_tpu_torch.ops import LAUNCHES, attention_cuda
from volta_tpu_torch.ops import attention_dropout_cuda as adc

SERVING = (256, 60, 60, 12, 64)
# (B, Lq, Lk, H, D): Lq != Lk, Lq < 8, D = 16 and 128
ODD = [(2, 9, 33, 4, 16), (3, 5, 37, 2, 64), (2, 17, 70, 2, 128),
       (1, 1, 1, 3, 32)]
RATE = 0.1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed=0):
    b, lq, lk, h, d = shape
    rng = np.random.RandomState(seed)
    dt = getattr(torch, dtype)
    mk = lambda l: torch.from_numpy(  # noqa: E731
        rng.randn(b, l, h * d).astype(np.float32)).to(device, dt)
    q, k, v, g = mk(lq), mk(lk), mk(lk), mk(lq)
    mask = (rng.rand(b, lk) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    bias = torch.from_numpy((1.0 - mask) * -10000.0).to(device)
    return q, k, v, bias, g


def _assert_close(got, ref, dtype, what):
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    assert bool(torch.isfinite(got).all()), what
    top = float(ref.float().abs().max())
    tol = 2 ** -6 * top if dtype == "bfloat16" else 1e-5 * max(1.0, top)
    err = float((got.float() - ref.float()).abs().max())
    assert err <= tol, (what, err, tol)


def _max_lk(smem, lq, d):
    lk = 4
    while smem(lq, lk + 4, d) <= attention_cuda.MAX_SMEM_BYTES:
        lk += 4
    return lk


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,tol", [
    ("bfloat16", (256, 60, 60, 12, 64), 2e-2),
    ("float32", (256, 60, 60, 12, 64), 1e-5),
    ("bfloat16", (3, 5, 563, 12, 64), 2e-2),
    ("float32", (2, 9, 33, 4, 16), 1e-5),
    ("bfloat16", (2, 17, 70, 2, 128), 2e-2),
    ("float32", (1, 1, 1, 3, 32), 1e-5),
    ("bfloat16", (2, 563, 563, 12, 64), 2e-2),
    ("float32", (2, 20, 1000, 2, 128), 1e-5),
])
def test_cuda_kernel_matches_twin(cuda_device, dtype, shape, tol):
    b, lq, lk, h, d = shape
    q, k, v, bias, _ = _inputs(shape, dtype, cuda_device)
    before = LAUNCHES["attention_fwd"]
    out = attention_cuda.attention_fwd(q, k, v, bias, d ** -0.5, h)
    torch.cuda.synchronize()
    assert LAUNCHES["attention_fwd"] == before + 1
    ref = attention_cuda.attention_fwd_ref(q, k, v, bias, d ** -0.5, h)
    assert out.dtype == getattr(torch, dtype) and out.shape == q.shape
    assert float((out.float() - ref.float()).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [SERVING] + ODD,
                         ids=lambda s: "x".join(map(str, s)))
def test_bwd_kernel_matches_twin(cuda_device, dtype, shape):
    b, lq, lk, h, d = shape
    q, k, v, bias, g = _inputs(shape, dtype, cuda_device, seed=1)
    before = LAUNCHES["attention_bwd"]
    got = attention_cuda.attention_bwd(q, k, v, bias, g, d ** -0.5, h,
                                       want_db=True)
    torch.cuda.synchronize()
    assert LAUNCHES["attention_bwd"] == before + 1
    ref = attention_cuda.attention_bwd_ref(q, k, v, bias, g, d ** -0.5, h)
    for name, a, r in zip(("dq", "dk", "dv"), got[:3], ref[:3]):
        _assert_close(a, r, dtype, name)
    # db is float32 in both; its sums follow the operands' rounding
    _assert_close(got[3], ref[3], "float32" if dtype == "float32"
                  else "bfloat16", "db")
    assert attention_cuda.attention_bwd(q, k, v, bias, g, d ** -0.5, h)[3] \
        is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [SERVING] + ODD,
                         ids=lambda s: "x".join(map(str, s)))
def test_dropout_kernels_match_twins(cuda_device, dtype, shape):
    b, lq, lk, h, d = shape
    q, k, v, bias, g = _inputs(shape, dtype, cuda_device, seed=2)
    seed = 0xC0FFEE + lq
    before = (LAUNCHES["attention_dropout_fwd"],
              LAUNCHES["attention_dropout_bwd"])
    out, mask = adc.attention_dropout_fwd(q, k, v, bias, d ** -0.5, h, RATE,
                                          seed, return_mask=True)
    grads = adc.attention_dropout_bwd(q, k, v, bias, g, d ** -0.5, h, RATE,
                                      seed)
    torch.cuda.synchronize()
    assert (LAUNCHES["attention_dropout_fwd"],
            LAUNCHES["attention_dropout_bwd"]) == (before[0] + 1,
                                                   before[1] + 1)
    keep = adc.keep_mask(seed, (b, h, lq, lk), RATE, device=cuda_device)
    assert torch.equal(mask, keep)  # the mask the kernel applied, bit for bit
    ref = adc.attention_dropout_fwd_ref(q, k, v, bias, d ** -0.5, h, RATE,
                                        keep)
    _assert_close(out, ref, dtype, "out")
    ref_grads = adc.attention_dropout_bwd_ref(q, k, v, bias, g, d ** -0.5, h,
                                              RATE, keep)
    for name, a, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        _assert_close(a, r, dtype, name)
    if shape == SERVING:
        frac = float(mask.float().mean())
        assert abs(frac - (1 - RATE)) <= 0.005, frac


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 128])
def test_largest_lengths_run_and_the_next_raise(cuda_device, d):
    # forward kernels: the largest Lk at Lq = 5
    lk = _max_lk(lambda lq, lk, d: attention_cuda.smem_bytes(lk, d), 5, d)
    q, k, v, bias, g = _inputs((1, 5, lk, 2, d), "bfloat16", cuda_device)
    ref = attention_cuda.attention_fwd_ref(q, k, v, bias, d ** -0.5, 2)
    assert float((attention_cuda.attention_fwd(q, k, v, bias, d ** -0.5, 2)
                  .float() - ref.float()).abs().max()) <= 2e-2
    out, mask = adc.attention_dropout_fwd(q, k, v, bias, d ** -0.5, 2, RATE,
                                          7, return_mask=True)
    _assert_close(out, adc.attention_dropout_fwd_ref(
        q, k, v, bias, d ** -0.5, 2, RATE, mask), "bfloat16", "dropout fwd")
    _, k2, v2, bias2, _ = _inputs((1, 5, lk + 1, 2, d), "bfloat16",
                                  cuda_device)
    for fn in (lambda: attention_cuda.attention_fwd(q, k2, v2, bias2, 0.1, 2),
               lambda: adc.attention_dropout_fwd(q, k2, v2, bias2, 0.1, 2,
                                                 RATE, 7)):
        with pytest.raises(ValueError, match="shared memory"):
            fn()
    # backward kernels: the largest Lk at Lq = 128 (at least 128 for every D)
    lk = _max_lk(attention_cuda.bwd_smem_bytes, 128, d)
    assert lk >= 128
    q, k, v, bias, g = _inputs((1, 128, lk, 2, d), "float32", cuda_device)
    got = attention_cuda.attention_bwd(q, k, v, bias, g, d ** -0.5, 2)
    ref = attention_cuda.attention_bwd_ref(q, k, v, bias, g, d ** -0.5, 2)
    for a, r in zip(got[:3], ref[:3]):
        _assert_close(a, r, "float32", "bwd at the largest Lk")
    got = adc.attention_dropout_bwd(q, k, v, bias, g, d ** -0.5, 2, RATE, 7)
    keep = adc.keep_mask(7, (1, 2, 128, lk), RATE, device=cuda_device)
    ref = adc.attention_dropout_bwd_ref(q, k, v, bias, g, d ** -0.5, 2, RATE,
                                        keep)
    for a, r in zip(got, ref):
        _assert_close(a, r, "float32", "dropout bwd at the largest Lk")
    _, k2, v2, bias2, _ = _inputs((1, 128, lk + 1, 2, d), "float32",
                                  cuda_device)
    for fn in (lambda: attention_cuda.attention_bwd(q, k2, v2, bias2, g, 0.1,
                                                    2),
               lambda: adc.attention_dropout_bwd(q, k2, v2, bias2, g, 0.1, 2,
                                                 RATE, 7)):
        with pytest.raises(ValueError, match="shared memory"):
            fn()


@pytest.mark.cuda
def test_functions_take_the_kernels(cuda_device):
    """The autograd Functions of the dispatch launch one forward and one
    backward kernel each, and agree with their CPU twin paths."""
    from volta_tpu_torch.ops.attention import fused_attention

    b, l, h, d = 4, 60, 12, 64
    rng = np.random.RandomState(3)
    qkv = [torch.from_numpy(rng.randn(b, l, h, d).astype(np.float32))
           for _ in range(3)]
    bias = torch.zeros(b, 1, 1, l)
    for rate, fwd, bwd in ((0.0, "attention_fwd", "attention_bwd"),
                           (RATE, "attention_dropout_fwd",
                            "attention_dropout_bwd")):
        outs, grads = [], []
        for dev in ("cpu", "cuda"):
            x = [t.to(dev).detach().requires_grad_() for t in qkv]
            before = (LAUNCHES[fwd], LAUNCHES[bwd])
            out = fused_attention(*x, bias.to(dev), d ** -0.5, rate, 99)
            out.square().sum().backward()
            launched = (LAUNCHES[fwd] - before[0], LAUNCHES[bwd] - before[1])
            assert launched == ((0, 0) if dev == "cpu" else (1, 1)), launched
            outs.append(out.detach().cpu())
            grads.append([t.grad.cpu() for t in x])
        _assert_close(outs[1], outs[0], "float32", f"out at rate {rate}")
        for a, r in zip(grads[1], grads[0]):
            _assert_close(a, r, "float32", f"grad at rate {rate}")


# ----------------------------------------------- LayerNorm kernels (10-13)
# (n, d): the b256 train shape (256 x 60 rows of 768), 7 rows, 1000 rows,
# the classifier width, an odd width (element-wise access) and the widest
LN_SHAPES = [(15360, 768), (7, 768), (1000, 768), (256, 1536), (33, 100),
             (5, 4096)]


def _ln_inputs(n, d, dtype, device, seed):
    rng = np.random.RandomState(seed)
    dt = getattr(torch, dtype)
    mk = lambda: torch.from_numpy(  # noqa: E731
        (rng.randn(n, d) * 2 + 0.5).astype(np.float32)).to(device, dt)
    vec = lambda: torch.from_numpy(  # noqa: E731
        (1 + 0.1 * rng.randn(d)).astype(np.float32)).to(device)
    return mk(), mk(), mk(), vec(), vec()


def _assert_sums_close(got, ref, what):
    """dscale / dbias: float32 sums over the rows in another order than the
    twin's, within 1e-5 of the largest |ref|."""
    assert got.dtype == ref.dtype == torch.float32 and got.shape == ref.shape
    tol = 1e-5 * max(1.0, float(ref.abs().max()))
    err = float((got - ref).abs().max())
    assert err <= tol, (what, err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", LN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_layer_norm_kernels_match_twins(cuda_device, dtype, shape):
    from volta_tpu_torch.ops import layernorm as ln

    n, d = shape
    x, g, _, w, b = _ln_inputs(n, d, dtype, cuda_device, seed=n + d)
    before = (LAUNCHES["layer_norm_fwd"], LAUNCHES["layer_norm_bwd"])
    y, mean, rstd = ln.layer_norm_fwd(x, w, b, 1e-12)
    dx, dw, db = ln.layer_norm_bwd(g, x, w, mean, rstd)
    torch.cuda.synchronize()
    assert (LAUNCHES["layer_norm_fwd"], LAUNCHES["layer_norm_bwd"]) == \
        (before[0] + 1, before[1] + 1)
    ry, rmean, rrstd = ln.layer_norm_fwd_ref(x, w, b, 1e-12)
    _assert_close(y, ry, dtype, "y")
    _assert_close(mean, rmean, "float32", "mean")
    _assert_close(rstd, rrstd, "float32", "rstd")
    rdx, rdw, rdb = ln.layer_norm_bwd_ref(g, x, w, mean, rstd)
    _assert_close(dx, rdx, dtype, "dx")
    _assert_sums_close(dw, rdw, "dscale")
    _assert_sums_close(db, rdb, "dbias")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", LN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_fused_residual_kernels_match_twins(cuda_device, dtype, shape):
    from volta_tpu_torch.models.layers import hash_dropout
    from volta_tpu_torch.ops import fused_residual as fr

    n, d = shape
    o, x, g, w, b = _ln_inputs(n, d, dtype, cuda_device, seed=2 * n + d)
    seed = 0xBEEF + n
    names = ("dropout_residual_ln_fwd", "dropout_residual_ln_bwd")
    before = tuple(LAUNCHES[k] for k in names)
    y, od, mean, rstd = fr.dropout_residual_ln_fwd(o, x, w, b, seed, RATE,
                                                   1e-12)
    do, dx, dw, db = fr.dropout_residual_ln_bwd(g, od, x, w, mean, rstd, seed,
                                                RATE)
    torch.cuda.synchronize()
    assert tuple(LAUNCHES[k] for k in names) == (before[0] + 1, before[1] + 1)
    keep = adc.keep_mask(seed, (n, d), RATE, device=cuda_device)
    # the kernel dropped exactly what hash_dropout drops, and od is exact
    assert torch.equal(od != 0, hash_dropout(o, seed, RATE) != 0)
    assert torch.equal(od != 0, keep)
    ry, rod, rmean, rrstd = fr.dropout_residual_ln_fwd_ref(o, x, w, b, keep,
                                                          RATE, 1e-12)
    assert torch.equal(od, rod)
    _assert_close(y, ry, dtype, "y")
    _assert_close(mean, rmean, "float32", "mean")
    _assert_close(rstd, rrstd, "float32", "rstd")
    rdo, rdx, rdw, rdb = fr.dropout_residual_ln_bwd_ref(g, od, x, w, mean,
                                                        rstd, keep, RATE)
    _assert_close(do, rdo, dtype, "do")
    _assert_close(dx, rdx, dtype, "dx")
    _assert_sums_close(dw, rdw, "dscale")
    _assert_sums_close(db, rdb, "dbias")
    if n * d >= 10**6:
        frac = float(keep.float().mean())
        assert abs(frac - (1 - RATE)) <= 0.005, frac
    # rate 0 keeps every element: od is o, the gradients of o and x agree
    y0, od0, _, _ = fr.dropout_residual_ln_fwd(o, x, w, b, seed, 0.0, 1e-12)
    assert torch.equal(od0, o)
    _assert_close(y0, ln_ref_of_sum(o, x, w, b), dtype, "y at rate 0")


def ln_ref_of_sum(o, x, w, b):
    from volta_tpu_torch.ops import layernorm as ln

    return ln.ln_rows(o.float() + x.float(), w, b, 1e-12)[0].to(o.dtype)


@pytest.mark.cuda
def test_layer_norm_kernels_raise_past_their_range(cuda_device):
    from volta_tpu_torch.ops import fused_residual as fr
    from volta_tpu_torch.ops import layernorm as ln

    x, g, _, w, b = _ln_inputs(3, 4097, "float32", cuda_device, 0)
    with pytest.raises(ValueError, match="4096"):
        ln.layer_norm_fwd(x, w, b, 1e-12)
    with pytest.raises(ValueError, match="4096"):
        fr.dropout_residual_ln_fwd(x, g, w, b, 1, RATE, 1e-12)
    x, g, _, w, b = _ln_inputs(3, 64, "bfloat16", cuda_device, 0)
    with pytest.raises(ValueError, match="dtype"):
        fr.dropout_residual_ln_fwd(x, g.float(), w, b, 1, RATE, 1e-12)
    with pytest.raises(ValueError, match="float32"):
        ln.layer_norm_fwd(x, w.bfloat16(), b, 1e-12)
    with pytest.raises(ValueError, match="contiguous"):
        ln.layer_norm_fwd(x.t().contiguous().t(), w, b, 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["ln", "fused"])
def test_layer_norm_module_takes_the_kernels(cuda_device, fused):
    """The LayerNorm module with the kernels launches one forward and one
    backward kernel per call and agrees with its CPU twin path."""
    from volta_tpu_torch.models.layers import LayerNorm

    rng = np.random.RandomState(4)
    o, x = (torch.from_numpy(rng.randn(4, 60, 768).astype(np.float32))
            for _ in range(2))
    names = ("dropout_residual_ln_fwd", "dropout_residual_ln_bwd") if fused \
        else ("layer_norm_fwd", "layer_norm_bwd")
    outs, grads = [], []
    for dev in ("cpu", "cuda"):
        ln = LayerNorm(768, use_kernel=True, fused_residual=fused).to(dev)
        a, r = (t.to(dev).detach().requires_grad_() for t in (o, x))
        before = tuple(LAUNCHES[k] for k in names)
        y = ln(a, residual=r, drop_rate=RATE, seed=77)
        y.square().sum().backward()
        launched = tuple(LAUNCHES[k] - c for k, c in zip(names, before))
        assert launched == ((0, 0) if dev == "cpu" else (1, 1)), launched
        outs.append(y.detach().cpu())
        grads.append([t.grad.cpu() for t in (a, r, ln.weight, ln.bias)])
    _assert_close(outs[1], outs[0], "float32", "out")
    for name, a, r in zip(("do", "dx", "dscale", "dbias"), *grads):
        _assert_close(a, r, "float32", name)
