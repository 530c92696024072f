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
