"""The bf16 tensor-core forward of rows 1 and 7 (csrc/attention_fwd_tc.cuh)
on the CPU: its tile recipe against the JAX package, and its wrappers'
routing and limits.

The kernel cannot run here, so its recipe is written out below in plain
PyTorch (``tile_recipe``, used by nothing in the package): 64-key tiles;
pass 1 keeps each row's running max and sum, rescaling only the sum when
the max grows; pass 2 forms p = exp(s - m) / sum in float32, rounds it to
v's dtype and accumulates P V in float32. It is held against the TPU
kernels ``pallas_fused_attention_nat`` (row 1) and ``pallas_fused_attention``
(row 7) in the Mosaic interpreter, as tests/test_torch_port_attention.py
runs them, and against the port's twin ``attention_fwd_ref``, at tile edges
and across them, with padding masks and one batch row whose keys are all
padded but one. Tolerances: bf16 2e-2 (two bf16 ulps at |x| ~ 2, as
chip_smoke.py phase 3), fp32 1e-5 (sums in another order). The kernel is
held to its twin on the card by tests/test_torch_port_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volta_tpu.ops import attention as jattn
from volta_tpu.ops import pallas_attention as pa
from volta_tpu_torch.ops import attention_cuda as ac
from volta_tpu_torch.ops import attention_head_major_cuda as ahm

TOL = {"bfloat16": 2e-2, "float32": 1e-5}
# (B, Lq, Lk, H, D): Lq and Lk in {1, 16, 60, 63, 64, 65, 128, 563}, square
# and cross, one key tile, its edges and several tiles, D in {16, 64, 128}
SHAPES = [(2, 1, 1, 2, 16), (2, 16, 60, 2, 64), (2, 60, 60, 2, 64),
          (2, 63, 65, 2, 128), (2, 64, 64, 1, 16), (2, 65, 128, 2, 64),
          (2, 128, 63, 1, 128), (2, 5, 563, 2, 64), (2, 60, 1, 2, 16),
          (1, 563, 563, 1, 16)]


def ids(s):
    return "x".join(map(str, s))


def tile_recipe(q, k, v, bias, scale, tile=ac.TC_KEYS):
    """The tensor-core body's arithmetic: q [B,H,Lq,D], k/v [B,H,Lk,D] in
    bf16 or fp32, bias [B,Lk] float32 -> [B,H,Lq,D] in q.dtype."""
    qf, kf, vf = q.float(), k.float(), v.float()
    lk = k.shape[2]

    def scores(j0):  # keys past Lk are absent: their exp is 0
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, j0:j0 + tile])
        return s * scale + bias[:, None, None, j0:j0 + tile]

    m = torch.full(q.shape[:3], -torch.inf)
    l = torch.zeros(q.shape[:3])
    for j0 in range(0, lk, tile):
        s = scores(j0)
        mn = torch.maximum(m, s.amax(-1))
        l = l * torch.exp(m - mn) + torch.exp(s - mn[..., None]).sum(-1)
        m = mn
    o = torch.zeros(q.shape[:3] + v.shape[3:])
    for j0 in range(0, lk, tile):
        p = torch.exp(scores(j0) - m[..., None]) / l[..., None]
        o += p.to(v.dtype).float() @ vf[:, :, j0:j0 + tile]
    return o.to(q.dtype)


def _inputs(b, lq, lk, h, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, lq, h, d).astype(np.float32)
    k = rng.randn(b, lk, h, d).astype(np.float32)
    v = rng.randn(b, lk, h, d).astype(np.float32)
    mask = (rng.rand(b, lk) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    mask[0, 1:] = 0  # every key of batch row 0 padded but one
    return q, k, v, mask


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_tile_recipe_matches_pallas_and_twin(shape, dtype):
    b, lq, lk, h, d = shape
    q, k, v, mask = _inputs(*shape, seed=lq + lk + d)
    scale = 1.0 / np.sqrt(d)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    bias = (1.0 - torch.from_numpy(mask).float()) * -10000.0
    got = tile_recipe(*(x.transpose(1, 2) for x in (tq, tk, tv)), bias,
                      scale).transpose(1, 2)
    assert got.dtype == tdt and got.shape == (b, lq, h, d)

    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    jb = jattn.additive_mask(jnp.asarray(mask))
    with pa.interpret_mode():
        row1 = pa.pallas_fused_attention_nat(jq, jk, jv, jb, scale)
        row7 = pa.pallas_fused_attention(jq, jk, jv, jb, scale)
    flat = lambda x: x.reshape(b, x.shape[1], h * d)  # noqa: E731
    twin = ac.attention_fwd_ref(flat(tq), flat(tk), flat(tv), bias, scale, h)
    for name, ref in (("row 1", np.asarray(row1, np.float32)),
                      ("row 7", np.asarray(row7, np.float32)),
                      ("twin", twin.float().view(b, lq, h, d).numpy())):
        err = np.abs(got.float().numpy() - ref).max()
        assert err <= TOL[dtype], (name, err)


def test_tile_recipe_keeps_the_exact_softmax():
    """One key tile: the recipe's probabilities are exp(s - max) / sum
    computed at once, and over several tiles the running sum equals the
    sum at the final max within float32 rounding."""
    q, k, v, mask = _inputs(1, 7, 200, 1, 16, seed=4)
    bias = (1.0 - torch.from_numpy(mask).float()) * -10000.0
    tq, tk = (torch.from_numpy(x).transpose(1, 2) for x in (q, k))
    eye = torch.eye(200).view(1, 1, 200, 200)  # v = I: out = the probs
    for lk in (40, 200):
        probs = tile_recipe(tq, tk[:, :, :lk], eye[:, :, :lk, :lk],
                            bias[:, :lk], 0.25)
        s = torch.einsum("bhqd,bhkd->bhqk", tq, tk[:, :, :lk]) * 0.25 \
            + bias[:, None, None, :lk]
        np.testing.assert_allclose(probs.numpy(),
                                   torch.softmax(s, -1).numpy(),
                                   rtol=1e-6, atol=1e-7)


# ------------------------------------------------- routing and limits
def test_bf16_routes_to_the_tensor_core_body():
    name, rows, smem = ac.fwd_body(torch.bfloat16)
    assert (name, rows) == ("tensor-core", ac.TC_ROWS_PER_BLOCK) \
        and rows == 64
    for d in ac.HEAD_DIMS:
        assert smem(1, 1, d) == smem(60, 10**7, d) == ac.tc_smem_bytes(d)
    name, rows, smem = ac.fwd_body(torch.float32)
    assert (name, rows) == ("CUDA-core", ac.ROWS_PER_BLOCK) and rows == 16
    assert smem(5, 563, 128) == ac.smem_bytes(563, 128)
    # the head-major row 7 takes the same routing, and so does its dropout
    # row 5 (fwd_body(dtype, dropout=True), as rows 3 and 9)
    assert ahm.fwd_body is ac.fwd_body
    assert not hasattr(ahm, "_dropout_fwd_smem")


@pytest.mark.parametrize("d", ac.HEAD_DIMS)
def test_tensor_core_shared_memory(d):
    """A Q tile and K and V key tiles of bf16 rows padded by 16 bytes, and
    a key tile's float32 bias: within the default 48 KB up to D = 64, and
    at D = 128 (52,480 bytes) within the card's limit, which the launcher
    raises."""
    want = 2 * (64 + 2 * 64) * (d + 8) + 4 * 64
    assert ac.tc_smem_bytes(d) == want <= ac.MAX_SMEM_BYTES
    assert (want <= 48 * 1024) == (d <= 64)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_each_body_has_its_own_grid(dtype):
    _, rows, smem = ac.fwd_body(dtype)
    ac.check_extent("fwd", 1, 65535 * rows, 3, 1, 16, smem, rows)
    with pytest.raises(ValueError, match="grid"):
        ac.check_extent("fwd", 1, 65535 * rows + 1, 3, 1, 16, smem, rows)
    with pytest.raises(ValueError, match="grid"):
        ac.check_extent("fwd", 2**30, 60, 60, 2, 64, smem, rows)


@pytest.mark.parametrize("d", ac.HEAD_DIMS)
def test_every_bf16_shape_that_ran_still_runs(d):
    """Every (Lq, Lk) the CUDA-core body's grid and shared memory took in
    bf16 before rows 1 and 7 moved to the tensor cores is taken by the
    tensor-core body, which also takes Lk past that limit."""
    core_rows, core = ac.ROWS_PER_BLOCK, \
        (lambda lq, lk, d: ac.smem_bytes(lk, d))
    _, rows, tc = ac.fwd_body(torch.bfloat16)
    max_lk = max(lk for lk in range(1, 4000)
                 if core(1, lk, d) <= ac.MAX_SMEM_BYTES)
    lqs = (1, 5, 16, 60, 63, 64, 65, 128, 563, 65535 * core_rows)
    lks = sorted({1, 60, 63, 64, 65, 563, max_lk // 2, max_lk})
    for lq in lqs:
        for lk in lks:
            ac.check_extent("old", 4, lq, lk, 12, d, core, core_rows)
            ac.check_extent("new", 4, lq, lk, 12, d, tc, rows)
    with pytest.raises(ValueError, match="shared memory"):
        ac.check_extent("old", 4, 60, max_lk + 1, 12, d, core, core_rows)
    ac.check_extent("new", 4, 60, 100 * max_lk, 12, d, tc, rows)
