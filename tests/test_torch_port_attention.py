"""volta_tpu_torch.ops attention against volta_tpu.ops on the CPU.

The port's plain attention (what ``fused_attention`` runs for CPU tensors,
the kernel's twin ``attention_fwd_ref``) is held against the TPU kernel
``pallas_fused_attention_nat`` run in the Mosaic interpreter and against
the JAX plain composition, on the same numpy inputs with a padding mask.
The CUDA kernel itself is held against its twin on the card by
``test_torch_port_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volta_tpu.ops import attention as jattn
from volta_tpu.ops import pallas_attention as pa
from volta_tpu_torch.ops import LAUNCHES
from volta_tpu_torch.ops import attention as tattn
from volta_tpu_torch.ops import attention_cuda

# (B, Lq, Lk, H, D): square and cross lengths, an odd key count, Lq < 8
SHAPES = [(2, 8, 8, 2, 16), (4, 16, 24, 3, 32), (3, 5, 37, 2, 64),
          (2, 12, 9, 1, 128)]


def _inputs(b, lq, lk, h, d, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, lq, h, d).astype(np.float32)
    k = rng.randn(b, lk, h, d).astype(np.float32)
    v = rng.randn(b, lk, h, d).astype(np.float32)
    mask = (rng.rand(b, lk) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    return q, k, v, mask


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_attention_matches_pallas_and_xla(shape):
    b, lq, lk, h, d = shape
    q, k, v, mask = _inputs(*shape)
    scale = 1.0 / np.sqrt(d)
    jbias = jattn.additive_mask(jnp.asarray(mask))
    tbias = tattn.additive_mask(torch.from_numpy(mask))
    np.testing.assert_array_equal(tbias.numpy(), np.asarray(jbias))

    with pa.interpret_mode():
        kern = np.asarray(pa.pallas_fused_attention_nat(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jbias, scale))
    xla = np.asarray(jattn._xla_fused_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jbias, scale))
    got = tattn.fused_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), tbias, scale)
    assert got.shape == (b, lq, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), kern, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), xla, rtol=1e-5, atol=1e-6)

    # the plain pieces match one by one
    tp = tattn.attention_probs(torch.from_numpy(q), torch.from_numpy(k),
                               tbias, scale)
    jp = jattn.attention_probs(jnp.asarray(q), jnp.asarray(k), jbias, scale)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        tattn.attention_out(tp, torch.from_numpy(v)).numpy(),
        np.asarray(jattn.attention_out(jp, jnp.asarray(v))), rtol=1e-5,
        atol=1e-6)


def test_plain_attention_bf16_matches_pallas():
    """bf16 operands: probs rounded to bf16, PV accumulated in fp32, output
    bf16, as the TPU kernel does. The two sums run in different orders, so
    outputs may differ by a bf16 ulp at |out| < 2: atol 2e-2."""
    b, lq, lk, h, d = 4, 16, 24, 3, 32
    q, k, v, mask = _inputs(b, lq, lk, h, d, seed=3)
    scale = 1.0 / np.sqrt(d)
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)
    tb = lambda x: torch.from_numpy(x).to(torch.bfloat16)
    with pa.interpret_mode():
        kern = pa.pallas_fused_attention_nat(
            bf(q), bf(k), bf(v), jattn.additive_mask(jnp.asarray(mask)),
            scale)
    got = tattn.fused_attention(tb(q), tb(k), tb(v),
                                tattn.additive_mask(torch.from_numpy(mask)),
                                scale)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - np.asarray(kern, np.float32)).max()
    assert diff <= 2e-2, diff


def test_wrapper_takes_twin_on_cpu_only():
    b, lq, lk, h, d = 3, 5, 37, 2, 64
    q, k, v, mask = _inputs(b, lq, lk, h, d, seed=1)
    flat = lambda x: torch.from_numpy(x).reshape(x.shape[0], x.shape[1], -1)
    bias = tattn.additive_mask(torch.from_numpy(mask)).reshape(b, lk)
    before = dict(LAUNCHES)
    out = attention_cuda.attention_fwd(flat(q), flat(k), flat(v), bias,
                                       0.125, h)
    ref = attention_cuda.attention_fwd_ref(flat(q), flat(k), flat(v), bias,
                                           0.125, h)
    assert torch.equal(out, ref)
    assert LAUNCHES == before  # the twin is no launch
    # a tensor on neither the CPU nor a card is refused, not computed
    meta = lambda x: flat(x).to("meta")
    with pytest.raises(ValueError, match="CUDA device"):
        attention_cuda.attention_fwd(meta(q), meta(k), meta(v),
                                     bias.to("meta"), 0.125, h)


def test_shared_memory_bound():
    # the CUDA-core body (fp32 forward, every dropout forward): the longest
    # task sequence (GuessWhatPointing, 256 + 306 + 1 keys) fits with room
    # to spare; the limit is ~3.2k keys at D = 128
    assert attention_cuda.smem_bytes(60, 64) < 48 * 1024
    assert attention_cuda.smem_bytes(563, 128) <= \
        attention_cuda.MAX_SMEM_BYTES
    assert attention_cuda.smem_bytes(3200, 128) <= \
        attention_cuda.MAX_SMEM_BYTES
    assert attention_cuda.smem_bytes(3300, 128) > \
        attention_cuda.MAX_SMEM_BYTES
    # the tensor-core body (bf16 forward of rows 1 and 7) streams the keys
    # in tiles: the same bytes at every Lk, within the limit at D = 128
    _, _, tc = attention_cuda.fwd_body(torch.bfloat16)
    assert tc(60, 60, 64) < 48 * 1024
    assert tc(5, 563, 128) == tc(5, 10**6, 128) <= \
        attention_cuda.MAX_SMEM_BYTES
