"""The bf16 dropout forward of rows 3, 5 and 9 on the tensor-core forward body
(csrc/attention_fwd_tc.cuh with kDropout) on the CPU: its tile recipe
against the JAX package, the keep-mask bytes and the hidden masks by the
body's own index arithmetic, and its wrappers' routing and limits.

The kernel cannot run here, so its recipe is written out below in plain
PyTorch (``dropout_tile_recipe``, used by nothing in the package): the
tile recipe of tests/test_torch_port_attention_tc.py, with the keep factor
(keep * float32(1 / (1 - rate))) multiplying p in float32 between the
division and the rounding to v's dtype. With a real hash mask
(``keep_mask``) it is held against the JAX package's math
(``volta_tpu.ops.attention.attention_probs`` times the mask, rounded to v's
dtype, times v in float32: the body of ``_attn_dropout_fwd_kernel_nat_bh``
with the mask given) and against the port's twins of rows 3 and 9; with
the all-keep mask, the one the Mosaic interpreter's PRNG draws, against the
TPU kernels ``_nat_fwd_core`` (row 3) and ``pallas_dropout_attention_hm``
(row 9) in the interpreter. Shapes: the forward's tile edges, Lq and Lk up
to 563, with one batch row whose keys are all padded but one. Tolerances:
bf16 2e-2 (two bf16 ulps at |x| ~ 2, as chip_smoke.py phase 3), fp32 1e-5
(sums in another order). The kernels are held to their twins on the card
by tests/test_torch_port_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_attention_tc import SHAPES, _inputs, ids
from volta_tpu.ops import attention as jattn
from volta_tpu.ops import pallas_attention as pa
from volta_tpu_torch.ops import attention_cuda as ac
from volta_tpu_torch.ops import attention_dropout_cuda as adc
from volta_tpu_torch.ops import attention_head_major_cuda as ahm
from volta_tpu_torch.ops import attention_hidden_mask_cuda as ahc
from volta_tpu_torch.ops import dropout_mask as dm
from volta_tpu_torch.ops.hash import hash_keep

TOL = {"bfloat16": 2e-2, "float32": 1e-5}
RATE = 0.1


def dropout_tile_recipe(q, k, v, bias, scale, keep, keep_scale,
                        tile=ac.TC_KEYS):
    """The tensor-core body's dropout arithmetic: q [B,H,Lq,D], k/v
    [B,H,Lk,D] in bf16 or fp32, bias [B,Lk] float32, keep [B,H,Lq,Lk] 0/1
    -> [B,H,Lq,D] in q.dtype. Pass 1 keeps each row's running max and sum
    over 64-key tiles; pass 2 forms p = exp(s - m) / sum, multiplies it by
    keep * keep_scale in float32, rounds it to v's dtype and accumulates
    P V in float32."""
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
        p = p * (keep[..., j0:j0 + tile].float() * keep_scale)
        o += p.to(v.dtype).float() @ vf[:, :, j0:j0 + tile]
    return o.to(q.dtype)


def _operands(shape, dtype, seed):
    """numpy q, k, v [B, L, H, D] and padding mask [B, Lk] (batch row 0
    all padded but key 0), their torch tensors in ``dtype`` and the bias
    [B, Lk]."""
    q, k, v, mask = _inputs(*shape, seed=seed)
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype))
                  for x in (q, k, v))
    bias = (1.0 - torch.from_numpy(mask).float()) * -10000.0
    return (q, k, v, mask), (tq, tk, tv), bias


def _recipe(tq, tk, tv, bias, scale, keep):
    heads = lambda x: x.transpose(1, 2)  # noqa: E731
    return heads(dropout_tile_recipe(*map(heads, (tq, tk, tv)), bias, scale,
                                     keep, adc.keep_scale(RATE)))


def _assert_close(got, ref, dtype, what):
    if isinstance(ref, torch.Tensor):
        ref = ref.float().numpy()
    err = np.abs(got.float().numpy() - np.asarray(ref, np.float32)).max()
    assert err <= TOL[dtype], (what, err)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_dropout_tile_recipe_matches_jax_math_and_twins(shape, dtype):
    """With a real hash mask: the recipe against the JAX package's math of
    ``_attn_dropout_fwd_kernel_nat_bh`` with that mask (attention_probs
    times keep * float32(1 / (1 - rate)), rounded to v's dtype, times v in
    float32), against row 3's twin ``attention_dropout_fwd_ref`` and
    against row 9's twin ``attention_dropout_hidden_masks_fwd_ref``, which
    draws the same mask from the same seed."""
    b, lq, lk, h, d = shape
    (q, k, v, mask), (tq, tk, tv), bias = _operands(shape, dtype,
                                                    lq + 2 * lk + d)
    scale = 1.0 / np.sqrt(d)
    seed = 0xD0 + lq + 3 * lk
    keep = adc.keep_mask(seed, (b, h, lq, lk), RATE)
    if lq * lk > 16:
        assert 0.7 < float(keep.float().mean()) < 1.0  # some dropped
    got = _recipe(tq, tk, tv, bias, scale, keep)
    assert got.dtype == tq.dtype and got.shape == (b, lq, h, d)

    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    probs = jattn.attention_probs(jq, jk, jattn.additive_mask(
        jnp.asarray(mask)), scale)
    factor = jnp.asarray(keep.numpy(), jnp.float32) * jnp.float32(
        adc.keep_scale(RATE))
    _assert_close(got, jattn.attention_out(probs * factor, jv), dtype,
                  "JAX math")
    flat = lambda x: x.reshape(b, x.shape[1], h * d)  # noqa: E731
    twin3 = adc.attention_dropout_fwd_ref(*map(flat, (tq, tk, tv)), bias,
                                          scale, h, RATE, keep)
    _assert_close(got, twin3.view(b, lq, h, d), dtype, "row 3 twin")
    hm = lambda x: x.permute(2, 0, 1, 3).contiguous()  # noqa: E731
    twin9, mask9, _, _ = ahc.attention_dropout_hidden_masks_fwd_ref(
        *map(hm, (tq, tk, tv)), bias, scale, RATE, seed, RATE, 1, 2)
    assert torch.equal(mask9.transpose(0, 1).bool(), keep)
    _assert_close(got, twin9.permute(1, 2, 0, 3), dtype, "row 9 twin")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_dropout_tile_recipe_matches_pallas_interpreter(shape, dtype):
    """With the all-keep mask the interpreter's PRNG draws: the recipe
    against ``_nat_fwd_core`` (row 3, whose mask is checked to keep
    everything) and ``pallas_dropout_attention_hm`` (row 9) in the Mosaic
    interpreter: every kept probability scaled by 1 / (1 - rate)."""
    b, lq, lk, h, d = shape
    (q, k, v, mask), (tq, tk, tv), bias = _operands(shape, dtype,
                                                    2 * lq + lk + d)
    scale = 1.0 / np.sqrt(d)
    got = _recipe(tq, tk, tv, bias, scale,
                  torch.ones((b, h, lq, lk), dtype=torch.bool))

    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    jb = jattn.additive_mask(jnp.asarray(mask))
    with pa.interpret_mode():
        row3, jmask = pa._nat_fwd_core(
            jq, jk, jv, pa._bias_bcast(jb, b, lk),
            jnp.asarray(7, jnp.int32).reshape(1), scale, RATE, 16)
        row9, _, _ = pa.pallas_dropout_attention_hm(jq, jk, jv, jb, scale,
                                                    RATE, RATE, 7)
    assert bool(jnp.all(jmask == 1))
    _assert_close(got, row3, dtype, "row 3")
    _assert_close(got, row9, dtype, "row 9")


# ------------------------------------- the mask bytes and hidden masks
def _mask_writes(b_n, h_n, lq, lk, seed, head_major):
    """The keep bytes the body writes, by its own index arithmetic, over
    every block (b·H + h, query tile of 64), active warp, lane and key
    tile: each lane's keys j, j + 1 (j = j0 + 16 kk + 8 half + 2 t) of its
    rows g and g + 8 (tc_pv), kept where i < Lq, j < Lk and the hash of the
    natural index prob_index says so, stored by tc_put_mask at the pair's
    offset (HeadLayout::pair) + i·Lk + j: two bytes at even Lk, a byte
    each (inside Lk) at odd. Returns the bytes and the times each was
    written, over a tensor of B·H·Lq·Lk bytes plus 64 past its end."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    size = b_n * h_n * lq * lk
    offs, idxs, valid = [], [], []
    for b in range(b_n):
        for h in range(h_n):
            pair = h * b_n + b if head_major else b * h_n + h
            for i0 in range(0, lq, ac.TC_ROWS_PER_BLOCK):
                for warp in range(4):
                    if i0 + 16 * warp >= lq:
                        continue  # the warp has no rows: it writes nothing
                    for j0 in range(0, lk, ac.TC_KEYS):
                        for kk in range(4):
                            for half in range(2):
                                j = j0 + 16 * kk + 8 * half + 2 * t
                                for r in range(2):
                                    i = i0 + 16 * warp + g + 8 * r
                                    at = pair * lq * lk + i * lk + j
                                    for e in range(2):
                                        stored = (i < lq) & (j < lk)
                                        if lk % 2:
                                            stored &= j + e < lk
                                        offs.append(at[stored] + e)
                                        idxs.append(((b * h_n + h) * lq
                                                     + i[stored]) * lk
                                                    + j[stored] + e)
                                        valid.append(j[stored] + e < lk)
    offs, idxs, valid = map(np.concatenate, (offs, idxs, valid))
    keep = hash_keep(torch.from_numpy(idxs % 2**32), seed, RATE).numpy()
    keep &= valid
    out = np.zeros(size + 64, np.uint8)
    count = np.zeros(size + 64, np.int64)
    assert offs.min() >= 0
    np.add.at(count, offs, 1)
    out[offs] = keep
    return out, count


@pytest.mark.parametrize("head_major", [False, True],
                         ids=["row_3", "row_9"])
@pytest.mark.parametrize("b,h,lq,lk", [
    (2, 3, 1, 1), (2, 3, 60, 60), (2, 3, 63, 65), (1, 2, 64, 64),
    (1, 2, 65, 128), (1, 2, 128, 63), (2, 2, 17, 70), (1, 1, 5, 563),
    (1, 1, 130, 563)], ids=lambda x: str(x))
def test_mask_bytes_by_the_body_index_arithmetic(b, h, lq, lk, head_major):
    """Every (i < Lq, j < Lk) of every pair is written once, with the
    hash's keep bit of its natural index, in the layout of its row
    ([B, H, Lq, Lk] for row 3, [H, B, Lq, Lk] for row 9), and nothing past
    the tensor is written: rows past Lq and keys past Lk are left out, and
    at odd Lk no 2-byte store crosses into the next row."""
    seed = 99 + lq * lk
    got, count = _mask_writes(b, h, lq, lk, seed, head_major)
    size = b * h * lq * lk
    assert (count[:size] == 1).all() and (count[size:] == 0).all()
    want = (ahm.keep_mask_head_major(seed, (h, b, lq, lk), RATE)
            if head_major else adc.keep_mask(seed, (b, h, lq, lk), RATE))
    assert np.array_equal(got[:size], want.to(torch.uint8).numpy().ravel())


def _hidden_mask_writes(b_n, h_n, lq, d, rows, seeds):
    """hidden_masks_block's writes by its own index arithmetic over the
    grid (B·H, query tiles of ``rows``): block (b·H + h, y) takes i0 = y ·
    rows and min(rows, Lq - i0) rows, its 128 threads word idx, idx + 128,
    ... of rows·D/4, each 4 bytes at ((b·Lq + i)·H + h)·D + 4 (idx mod
    D/4), each byte the keep bit of its offset. Returns the two masks and
    the times each byte was written."""
    size = b_n * lq * h_n * d
    masks = [np.zeros(size, np.uint8) for _ in seeds]
    count = np.zeros(size, np.int64)
    words = d // 4
    for bx in range(b_n * h_n):
        b, h = bx // h_n, bx % h_n
        for y in range(-(-lq // rows)):
            i0 = y * rows
            n = min(rows, lq - i0)
            for tid in range(128):
                for idx in range(tid, n * words, 128):
                    i = i0 + idx // words
                    off = ((b * lq + i) * h_n + h) * d + (idx % words) * 4
                    at = torch.arange(off, off + 4)
                    count[off:off + 4] += 1
                    for m, s in zip(masks, seeds):
                        m[off:off + 4] = hash_keep(at, s, RATE).numpy()
    return masks, count


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("lq", [1, 60, 63, 64, 65, 128])
def test_hidden_masks_cover_their_rows_once(lq, dtype):
    """Row 9's hidden masks under the tile of the body it runs beside (64
    rows in bf16, 16 in fp32, ``fwd_body(dtype, dropout=True)``): the
    blocks' words cover [B, Lq, H·D] once each, and the bytes are the
    twin's hash masks."""
    rows = ac.fwd_body(dtype, dropout=True)[1]
    assert rows == (64 if dtype == torch.bfloat16 else 16)
    b, h, d, seeds = 2, 3, 16, (5, 6)
    masks, count = _hidden_mask_writes(b, h, lq, d, rows, seeds)
    assert (count == 1).all()
    for m, s in zip(masks, seeds):
        want = dm.keep_mask_ref((b, lq, h * d), RATE, s)
        assert np.array_equal(m, want.numpy().ravel())


# ------------------------------------------------- routing and limits
def test_dropout_forward_routes_to_the_tensor_core_body_in_bf16():
    """``fwd_body(dtype, dropout=True)``: bf16 to the tensor-core body (64
    query rows, shared memory that does not grow with Lk), fp32 to the
    CUDA-core body (16 rows, score rows of Lk); the dropout flavour takes
    the tile and shared memory of the no-dropout body."""
    name, rows, smem = ac.fwd_body(torch.bfloat16, dropout=True)
    assert (name, rows) == ("tensor-core", ac.TC_ROWS_PER_BLOCK) == \
        ac.fwd_body(torch.bfloat16)[:2]
    for d in ac.HEAD_DIMS:
        assert smem(1, 1, d) == smem(60, 10**7, d) == ac.tc_smem_bytes(d)
    name, rows, smem = ac.fwd_body(torch.float32, dropout=True)
    assert (name, rows) == ("CUDA-core", ac.ROWS_PER_BLOCK)
    assert smem(5, 563, 128) == ac.smem_bytes(563, 128)


class _Checked(Exception):
    pass


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dropout_forward_wrappers_check_with_their_body(dtype, monkeypatch):
    """Rows 3, 5 and 9 check a card's operands against the grid and shared
    memory of the body their dtype routes to (``fwd_body(dtype,
    dropout=True)``), seen through a stand-in for ``check`` on tensors of
    no device (meta), which do not take the CPU twins."""
    seen = {}

    def check(name, *args, rows=ac.ROWS_PER_BLOCK, **kwargs):
        seen[name] = (rows, [args[5](lq, lk, d) for lq, lk, d in
                             ((1, 1, 16), (60, 60, 64), (5, 563, 128))])
        raise _Checked

    for mod in (adc, ahc, ahm):
        monkeypatch.setattr(mod, "check", check)
    x = torch.empty((2, 60, 128), dtype=dtype, device="meta")
    xh = torch.empty((2, 2, 60, 64), dtype=dtype, device="meta")
    bias = torch.empty((2, 60), device="meta")
    with pytest.raises(_Checked):
        adc.attention_dropout_fwd(x, x, x, bias, 0.125, 2, RATE, 5)
    with pytest.raises(_Checked):
        ahc.attention_dropout_hidden_masks_fwd(xh, xh, xh, bias, 0.125, RATE,
                                               5, RATE, 6, 7)
    with pytest.raises(_Checked):
        ahm.attention_dropout_head_major_fwd(xh, xh, xh, bias, 0.125, RATE,
                                             5)
    _, rows, smem = ac.fwd_body(dtype, dropout=True)
    want = (rows, [smem(1, 1, 16), smem(60, 60, 64), smem(5, 563, 128)])
    assert seen == {"attention_dropout_fwd": want,
                    "attention_dropout_hidden_masks_fwd": want,
                    "attention_dropout_head_major_fwd": want}


@pytest.mark.parametrize("d", ac.HEAD_DIMS)
def test_every_bf16_dropout_forward_shape_that_ran_still_runs(d):
    """Every (Lq, Lk) the CUDA-core body's grid and shared memory took in
    bf16 before rows 3 and 9 moved to the tensor cores is taken by the
    tensor-core body, which also takes Lk past that limit."""
    core_rows, core = ac.ROWS_PER_BLOCK, \
        (lambda lq, lk, d: ac.smem_bytes(lk, d))
    _, rows, tc = ac.fwd_body(torch.bfloat16, dropout=True)
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
