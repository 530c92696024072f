"""The hand-written CUDA kernels against their plain twins, on the card.

Marked ``cuda``: each test skips on a host without one. The file imports no
JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from volta_tpu_torch.ops import attention_cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


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
    rng = np.random.RandomState(0)
    dt = getattr(torch, dtype)
    mk = lambda l: torch.from_numpy(
        rng.randn(b, l, h * d).astype(np.float32)).to(cuda_device, dt)
    q, k, v = mk(lq), mk(lk), mk(lk)
    mask = torch.from_numpy((rng.rand(b, lk) > 0.3).astype(np.float32))
    bias = ((1.0 - mask) * -10000.0).to(cuda_device)
    before = attention_cuda.LAUNCHES
    out = attention_cuda.attention_fwd(q, k, v, bias, d ** -0.5, h)
    torch.cuda.synchronize()
    assert attention_cuda.LAUNCHES == before + 1
    ref = attention_cuda.attention_fwd_ref(q, k, v, bias, d ** -0.5, h)
    assert out.dtype == dt and out.shape == q.shape
    assert float((out.float() - ref.float()).abs().max()) <= tol
