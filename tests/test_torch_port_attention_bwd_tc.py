"""The bf16 tensor-core backward of rows 2 and 8 and of the dropout rows 4
and 6 (csrc/attention_bwd_tc.cuh) on the CPU: its tile recipe against the
JAX package, the dropout flavour's keep bits, and its wrappers' routing and
limits.

The kernel cannot run here, so its recipe is written out below in plain
PyTorch (``bwd_tile_recipe``, used by nothing in the package): products of
the operands accumulated in float32; per 64-row query tile the rows'
softmax max and sum over 64-key tiles (the forward's exact softmax, p =
e / l), delta = rowsum(dP * P), dS = P * (dP - delta) and dq = dS K, then
per 64-key tile P and dS again from the rows' saved max, sum and delta, dv
= Pᵀ G and dk = dSᵀ Q; P and dS enter their products as hi + lo halves in
the operand dtype (hi = x rounded, lo = x - hi rounded: bf16 halves for
bf16, x itself for float32). It is held against the TPU kernels'
backward, the vjps of ``pallas_fused_attention_nat`` (row 2) and
``pallas_fused_attention`` (row 8) in the Mosaic interpreter, and against
the port's twin ``attention_bwd_ref``, at tile edges and across them, with
padding masks and one batch row whose keys are all padded but one. With a
keep mask (the hash mask of ``keep_mask``) the recipe is the dropout
flavour's, held against the TPU kernels of rows 4 (``_nat_bwd_core``) and
6 (``_dropout_bwd_core``) in the interpreter, fed that mask as bf16 0/1,
and against the port's two dropout twins.
Tolerances: bf16 2^-6 * max|ref| (two bf16 ulps of the largest value, as
``close`` in chip_smoke.py), float32 1e-5 * max(1, max|ref|) (sums in
another order). The kernel is held to its twin on the card by
tests/test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volta_tpu.ops import attention as jattn
from volta_tpu.ops import pallas_attention as pa
from volta_tpu_torch.ops import attention_cuda as ac
from volta_tpu_torch.ops import attention_dropout_cuda as adc
from volta_tpu_torch.ops import attention_head_major_cuda as ahm

# (B, Lq, Lk, H, D): Lq and Lk in {1, 16, 60, 63, 64, 65, 128}, square and
# cross, one tile, its edges and two tiles either way, D in {16, 64, 128}
SHAPES = [(2, 1, 1, 2, 16), (2, 16, 60, 2, 64), (2, 60, 60, 2, 64),
          (2, 63, 65, 2, 128), (2, 64, 64, 1, 16), (2, 65, 128, 2, 64),
          (2, 128, 63, 1, 128), (2, 60, 1, 2, 16), (2, 128, 128, 1, 16)]
RATE = 0.1


def ids(s):
    return "x".join(map(str, s))


def _split(x, dtype):
    """float32 x as hi + lo in ``dtype``: hi = x rounded, lo = x - hi
    rounded; both returned in float32."""
    hi = x.to(dtype).float()
    return hi, (x - hi).to(dtype).float()


def _split_mm(x, y, dtype, split=True):
    """x @ y with x taken as its hi + lo halves in ``dtype`` (without
    ``split``: x rounded once to ``dtype``)."""
    hi, lo = _split(x, dtype)
    return hi @ y + lo @ y if split else hi @ y


def bwd_tile_recipe(q, k, v, g, bias, scale, tile=ac.TC_KEYS, split=True,
                    keep=None, keep_scale=1.0):
    """The tensor-core backward body's arithmetic: q/g [B,H,Lq,D], k/v
    [B,H,Lk,D] in bf16 or fp32, bias [B,Lk] float32 -> dq, dk, dv in
    q.dtype and db [B,Lk] float32 (dS summed over heads and queries).
    Without ``split`` P and dS are rounded once to q.dtype before their
    products, as flash-attention kernels do: not the body's recipe. With a
    0/1 ``keep`` mask [B,H,Lq,Lk] (the dropout flavour of rows 4 and 6) its
    factor keep * keep_scale, in float32, multiplies dP in both sweeps and
    P's share of dv, not the P inside dS."""
    dt = q.dtype
    mm = lambda x, y: _split_mm(x, y, dt, split)  # noqa: E731
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    lq, lk = q.shape[2], k.shape[2]
    rows = lambda x, a: x[:, :, a:a + tile]  # noqa: E731
    factor = None if keep is None else keep.float() * keep_scale

    def keep_of(i0, j0, x):  # x times the tile's keep factor
        if factor is None:
            return x
        return x * factor[:, :, i0:i0 + tile, j0:j0 + tile]

    def scores(i0, j0):  # keys past Lk are absent: their exp is 0
        s = rows(qf, i0) @ rows(kf, j0).transpose(-1, -2)
        return s * scale + bias[:, None, None, j0:j0 + tile]

    def probs_ds(i0, j0, m, l, delta):
        p = torch.exp(scores(i0, j0) - m[..., None]) / l[..., None]
        dp = keep_of(i0, j0, rows(gf, i0) @ rows(vf, j0).transpose(-1, -2))
        return p, dp, None if delta is None else p * (dp - delta[..., None])

    dq, dk, dv = torch.zeros(qf.shape), torch.zeros(kf.shape), \
        torch.zeros(vf.shape)
    db = torch.zeros(bias.shape)
    stats = {}
    # sweep 1: a query tile at a time, its rows' statistics, dS and dq
    for i0 in range(0, lq, tile):
        m = torch.full(rows(qf, i0).shape[:3], -torch.inf)
        l = torch.zeros(m.shape)
        for j0 in range(0, lk, tile):
            s = scores(i0, j0)
            mn = torch.maximum(m, s.amax(-1))
            l = l * torch.exp(m - mn) + torch.exp(s - mn[..., None]).sum(-1)
            m = mn
        delta = torch.zeros(m.shape)
        for j0 in range(0, lk, tile):
            p, dp, _ = probs_ds(i0, j0, m, l, None)
            delta += (p * dp).sum(-1)
        for j0 in range(0, lk, tile):
            _, _, ds = probs_ds(i0, j0, m, l, delta)
            dq[:, :, i0:i0 + tile] += mm(ds, rows(kf, j0))
        stats[i0] = (m, l, delta)
    # sweep 2: a key tile at a time, P and dS again from the statistics
    for j0 in range(0, lk, tile):
        for i0 in range(0, lq, tile):
            p, _, ds = probs_ds(i0, j0, *stats[i0])
            t = lambda x: x.transpose(-1, -2)  # noqa: E731
            dv[:, :, j0:j0 + tile] += mm(t(keep_of(i0, j0, p)), rows(gf, i0))
            dk[:, :, j0:j0 + tile] += mm(t(ds), rows(qf, i0))
            db[:, j0:j0 + tile] += ds.sum(dim=(1, 2))
    return (dq * scale).to(dt), (dk * scale).to(dt), dv.to(dt), db


def _inputs(b, lq, lk, h, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, lq, h, d).astype(np.float32)
    k = rng.randn(b, lk, h, d).astype(np.float32)
    v = rng.randn(b, lk, h, d).astype(np.float32)
    g = rng.randn(b, lq, h, d).astype(np.float32)
    mask = (rng.rand(b, lk) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    mask[0, 1:] = 0  # every key of batch row 0 padded but one
    return q, k, v, g, mask


def _assert_close(got, ref, dtype, what):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32).reshape(ref.shape)
    top = float(np.abs(ref).max())
    tol = 2 ** -6 * top if dtype == "bfloat16" else 1e-5 * max(1.0, top)
    err = float(np.abs(got - ref).max())
    assert np.isfinite(got).all() and err <= tol, (what, err, tol)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_bwd_tile_recipe_matches_pallas_and_twin(shape, dtype):
    b, lq, lk, h, d = shape
    q, k, v, g, mask = _inputs(*shape, seed=lq + 2 * lk + d)
    scale = 1.0 / np.sqrt(d)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tq, tk, tv, tg = (torch.from_numpy(x).to(tdt) for x in (q, k, v, g))
    bias = (1.0 - torch.from_numpy(mask).float()) * -10000.0
    heads = lambda x: x.transpose(1, 2)  # noqa: E731
    got = bwd_tile_recipe(*map(heads, (tq, tk, tv, tg)), bias, scale)
    got = [heads(x) for x in got[:3]] + [got[3]]
    for x, like in zip(got, (tq, tk, tv)):
        assert x.dtype == tdt and x.shape == like.shape

    jq, jk, jv, jg = (jnp.asarray(x, jdt) for x in (q, k, v, g))
    jb = jattn.additive_mask(jnp.asarray(mask))
    refs = {}
    with pa.interpret_mode():
        for row, fn in (("row 2", pa.pallas_fused_attention_nat),
                        ("row 8", pa.pallas_fused_attention)):
            _, vjp = jax.vjp(lambda q, k, v, bias: fn(q, k, v, bias, scale),
                             jq, jk, jv, jb)
            refs[row] = [np.asarray(x, np.float32) for x in vjp(jg)]
    flat = lambda x: x.reshape(b, x.shape[1], h * d)  # noqa: E731
    twin = ac.attention_bwd_ref(*map(flat, (tq, tk, tv)), bias, flat(tg),
                                scale, h)
    refs["twin"] = [x.float().numpy() for x in twin]
    for name, ref in refs.items():
        for what, x, r in zip(("dq", "dk", "dv", "db"), got, ref):
            _assert_close(x.float().numpy(), r.reshape(x.shape), dtype,
                          f"{name} {what}")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_dropout_bwd_tile_recipe_matches_pallas_and_twins(shape, dtype):
    """Rows 4 and 6: the recipe with a real hash mask against
    ``_nat_bwd_core`` (row 4) and ``_dropout_bwd_core`` (row 6) in the
    interpreter, both fed the mask as bf16 0/1, and against
    ``attention_dropout_bwd_ref`` and ``attention_dropout_head_major_bwd_ref``
    fed it as bool and as uint8."""
    b, lq, lk, h, d = shape
    q, k, v, g, mask = _inputs(*shape, seed=3 * lq + lk + d)
    scale = 1.0 / np.sqrt(d)
    keep = adc.keep_mask(0xBEEF + lq + 7 * lk, (b, h, lq, lk), RATE)
    if lq * lk > 16:
        assert 0.7 < float(keep.float().mean()) < 1.0  # some dropped
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tq, tk, tv, tg = (torch.from_numpy(x).to(tdt) for x in (q, k, v, g))
    bias = (1.0 - torch.from_numpy(mask).float()) * -10000.0
    heads = lambda x: x.transpose(1, 2)  # noqa: E731
    got = bwd_tile_recipe(*map(heads, (tq, tk, tv, tg)), bias, scale,
                          keep=keep, keep_scale=adc.keep_scale(RATE))
    got = [heads(x) for x in got[:3]]
    for x, like in zip(got, (tq, tk, tv)):
        assert x.dtype == tdt and x.shape == like.shape

    jq, jk, jv, jg = (jnp.asarray(x, jdt) for x in (q, k, v, g))
    jb = pa._bias_bcast(jattn.additive_mask(jnp.asarray(mask)), b, lk)
    jkeep = jnp.asarray(keep.numpy(), jnp.bfloat16)
    hm = lambda x: jnp.transpose(x, (2, 0, 1, 3))  # noqa: E731
    with pa.interpret_mode():
        row4 = pa._nat_bwd_core(jq, jk, jv, jb, jg, jkeep, scale, RATE, 16)
        row6 = pa._dropout_bwd_core(
            hm(jq), hm(jk), hm(jv), jb, hm(jg),
            jnp.transpose(jkeep, (1, 0, 2, 3)), scale, RATE,
            pa._pick_tile(b, 16, lq, lk, d))
    refs = {"row 4": [np.asarray(x, np.float32) for x in row4],
            "row 6": [np.asarray(jnp.transpose(x, (1, 2, 0, 3)), np.float32)
                      for x in row6]}
    flat = lambda x: x.reshape(b, x.shape[1], h * d)  # noqa: E731
    twin = adc.attention_dropout_bwd_ref(*map(flat, (tq, tk, tv)), bias,
                                         flat(tg), scale, h, RATE, keep)
    refs["row 4 twin"] = [x.float().numpy() for x in twin]
    thm = lambda x: x.permute(2, 0, 1, 3).contiguous()  # noqa: E731
    twin = ahm.attention_dropout_head_major_bwd_ref(
        *map(thm, (tq, tk, tv)), bias, thm(tg),
        keep.transpose(0, 1).to(torch.uint8), scale, RATE)
    refs["row 6 twin"] = [x.permute(1, 2, 0, 3).float().numpy()
                          for x in twin]
    for name, ref in refs.items():
        for what, x, r in zip(("dq", "dk", "dv"), got, ref):
            _assert_close(x.float().numpy(), r.reshape(x.shape), dtype,
                          f"{name} {what}")


def _lane_keep_words(keep, lq_pad):
    """The dropout flavour's keep bits as the body lays them in shared
    memory, by its own index arithmetic: each thread's bits of each tile
    (tc_draw_keep), shifted into place and OR-ed over its quad
    (tc_put_keep), one word a lane. keep: [Lq, Lk] 0/1 of one (b, h)
    pair. Returns the words [key tiles][2][lq_pad] and every thread's kw,
    keyed (i0, j0, warp, lane)."""
    lq, lk = keep.shape
    tile = ac.TC_KEYS
    ktiles = -(-lk // tile)
    words = np.zeros((ktiles, 2, lq_pad), np.uint32)
    drawn = {}
    for i0 in range(0, lq, tile):
        for j0 in range(0, lk, tile):
            for warp in range(4):
                if i0 + 16 * warp >= lq:
                    continue  # the warp has no rows: it writes nothing
                quad = {}
                for lane in range(32):
                    gq, t = lane >> 2, lane & 3
                    i_row = (i0 + 16 * warp + gq, i0 + 16 * warp + gq + 8)
                    kw = [0, 0, 0, 0]
                    for n in range(8):
                        for x in range(4):
                            i, j = i_row[x >> 1], j0 + n * 8 + 2 * t + (x & 1)
                            if i < lq and j < lk and keep[i, j]:
                                kw[(x >> 1) * 2 + (n >> 2)] |= \
                                    1 << ((n & 3) * 8 + (x & 1))
                    drawn[i0, j0, warp, lane] = kw
                    quad.setdefault(gq, []).append([w << 2 * t for w in kw])
                for lane in range(32):
                    gq, t = lane >> 2, lane & 3
                    i_row = (i0 + 16 * warp + gq, i0 + 16 * warp + gq + 8)
                    ored = np.bitwise_or.reduce(np.array(quad[gq]), axis=0)
                    words[j0 // tile, t & 1, i_row[t >> 1]] = ored[t]
    return words, drawn


@pytest.mark.parametrize("lq,lk", [(1, 1), (60, 60), (63, 65), (65, 128),
                                   (128, 63), (16, 130)])
def test_keep_bits_round_trip_through_shared_memory(lq, lk):
    """The dropout flavour's keep bits by the body's index arithmetic: the
    words sweep 1 stores hold the mask at every (query, key) inside the
    lengths and 0 at rows and keys past them that an active warp covers;
    pass 3 (tc_get_keep) reads back every thread's drawn bits; sweep 2
    reads, for its keys as rows and two queries a word pair, the same bits
    (the bit of row i and key j, never its transpose)."""
    keep = adc.keep_mask(lq * 1000 + lk, (1, 1, lq, lk), 0.5)[0, 0].numpy()
    tile = ac.TC_KEYS
    lq_pad = -(-lq // tile) * tile
    words, drawn = _lane_keep_words(keep, lq_pad)
    for i in range(lq):
        for j in range(lk):
            bit = int(words[j // tile, (j % tile) >> 5, i]) >> (j % 32) & 1
            assert bit == keep[i, j], (i, j)
    for (i0, j0, warp, lane), kw in drawn.items():  # pass 3
        gq, t = lane >> 2, lane & 3
        i_row = (i0 + 16 * warp + gq, i0 + 16 * warp + gq + 8)
        got = [(int(words[j0 // tile, c & 1, i_row[c >> 1]]) >> 2 * t)
               & 0x03030303 for c in range(4)]
        assert got == kw, (i0, j0, warp, lane)
    for j0 in range(0, lk, tile):  # sweep 2, a warp per 16 keys
        for warp in range(4):
            r0 = 16 * warp
            if j0 + r0 >= lk:
                continue
            for i0 in range(0, lq, tile):
                for lane in range(32):
                    gq, t = lane >> 2, lane & 3
                    kbit = (r0 & 31) + gq
                    kwords = words[j0 // tile, r0 >> 5]
                    for n in range(8):
                        c = i0 + n * 8 + 2 * t
                        kc = (int(kwords[c]), int(kwords[c + 1]))
                        for x in range(4):
                            i, j = c + (x & 1), j0 + r0 + gq + 8 * (x >> 1)
                            if i < lq and j < lk:
                                bit = kc[x & 1] >> (kbit + 8 * (x >> 1)) & 1
                                assert bit == keep[i, j], (i, j)


def test_split_products_hold_the_float32_probabilities():
    """P's and dS's hi + lo halves give their products within 2^-15 of the
    float32 operand's, relative to the sum of magnitudes; one bf16 rounding
    of P does not (the reference keeps P in float32)."""
    rng = np.random.RandomState(9)
    s = torch.from_numpy(rng.randn(4, 64, 64).astype(np.float32) * 3)
    p = torch.softmax(s, -1)
    ds = p * (torch.from_numpy(rng.randn(4, 64, 64).astype(np.float32))
              - 0.1)
    y = torch.from_numpy(rng.randn(4, 64, 64).astype(np.float32)).to(
        torch.bfloat16).float()
    for x in (p, ds):
        exact = x.double() @ y.double()
        scale = x.abs().double() @ y.abs().double()
        split = _split_mm(x, y, torch.bfloat16).double()
        single = (x.to(torch.bfloat16).float() @ y).double()
        assert float(((split - exact).abs() / scale).max()) <= 2 ** -15
        assert float(((single - exact).abs() / scale).max()) > 2 ** -15


@pytest.mark.parametrize("shape", [(4, 60, 60, 4, 64), (2, 128, 130, 2, 64)],
                         ids=ids)
def test_split_ratio_tells_the_split_from_one_rounding(shape):
    """The card's check of the split (chip_smoke.split_ratio, and
    test_bwd_products_take_float32_probabilities): the bf16 outputs' mean
    distance from the float64 recipe over the twin's. The recipe with P and
    dS in hi + lo halves reads within 1.05; rounded once to bf16 it reads
    above 1.05 for each of dq, dk and dv."""
    b, lq, lk, h, d = shape
    q, k, v, g, mask = (torch.from_numpy(x) for x in _inputs(*shape, seed=5))
    q, k, v, g = (x.to(torch.bfloat16) for x in (q, k, v, g))
    bias = (1.0 - mask.float()) * -10000.0
    scale = d ** -0.5
    exact = ac.attention_bwd_math(*(x.double() for x in (q, k, v)),
                                  bias.double(), g.double(), scale)
    flat = lambda x: x.reshape(b, x.shape[1], h * d)  # noqa: E731
    twin = ac.attention_bwd_ref(*map(flat, (q, k, v)), bias, flat(g), scale,
                                h, want_db=False)
    heads = lambda x: x.transpose(1, 2)  # noqa: E731
    for split, ok in ((True, True), (False, False)):
        got = bwd_tile_recipe(*map(heads, (q, k, v, g)), bias, scale,
                              split=split)
        for x, t, r in zip(got[:3], twin[:3], exact[:3]):
            x = flat(heads(x)).double()
            r = flat(r)
            ratio = float((x - r).abs().mean()
                          / (t.double() - r).abs().mean())
            assert (ratio <= 1.05) == ok, (split, ratio)


# ------------------------------------------------- routing and limits
def test_bf16_backward_routes_to_the_tensor_core_body():
    name, smem = ac.bwd_body(torch.bfloat16)
    assert name == "tensor-core"
    for d in ac.HEAD_DIMS:
        for lq in (1, 60, 64, 65, 563):
            assert smem(lq, 1, d) == smem(lq, 10**7, d) \
                == ac.tc_bwd_smem_bytes(lq, d)
    name, smem = ac.bwd_body(torch.float32)
    assert name == "CUDA-core" and smem is ac.bwd_smem_bytes
    # the head-major row 8 takes the same routing; so do the dropout
    # backwards (rows 4 and 6), through the body's dropout flavour
    assert ahm.bwd_body is ac.bwd_body
    name, smem = ac.bwd_body(torch.bfloat16, dropout=True)
    assert name == "tensor-core" and smem is ac.tc_dropout_bwd_smem_bytes
    name, smem = ac.bwd_body(torch.float32, dropout=True)
    assert name == "CUDA-core" and smem is ac.bwd_smem_bytes


class _Checked(Exception):
    pass


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dropout_backward_wrappers_check_with_their_body(dtype, monkeypatch):
    """Rows 4 and 6 check a card's operands against the shared memory of
    the body their dtype routes to (``bwd_body(dtype, dropout=True)``),
    seen through a stand-in for ``check`` on tensors of no device (meta),
    which do not take the CPU twins."""
    seen = {}

    def check(name, *args, **kwargs):
        seen[name] = args[5]
        raise _Checked

    monkeypatch.setattr(adc, "check", check)
    monkeypatch.setattr(ahm, "check", check)
    x = torch.empty((2, 60, 128), dtype=dtype, device="meta")
    xh = torch.empty((2, 2, 60, 64), dtype=dtype, device="meta")
    bias = torch.empty((2, 60), device="meta")
    mask = torch.empty((2, 2, 60, 60), dtype=torch.uint8, device="meta")
    with pytest.raises(_Checked):
        adc.attention_dropout_bwd(x, x, x, bias, x, 0.125, 2, RATE, 5)
    with pytest.raises(_Checked):
        ahm.attention_dropout_head_major_bwd(xh, xh, xh, bias, xh, mask,
                                             0.125, RATE)
    want = ac.bwd_body(dtype, dropout=True)[1]
    assert seen == {"attention_dropout_bwd": want,
                    "attention_dropout_head_major_bwd": want}


@pytest.mark.parametrize("d", ac.HEAD_DIMS)
def test_tensor_core_backward_shared_memory(d):
    """Q, G, K and V tiles of bf16 rows padded by 16 bytes, a key tile's
    float32 bias and 12 bytes a query row (max, sum, delta), the rows
    rounded up to 64: within the default 48 KB at D <= 64 and Lq <= 64."""
    for lq, lq_pad in ((1, 64), (60, 64), (64, 64), (65, 128), (563, 576)):
        want = 2 * 4 * 64 * (d + 8) + 4 * 64 + 12 * lq_pad
        assert ac.tc_bwd_smem_bytes(lq, d) == want
    assert (ac.tc_bwd_smem_bytes(60, d) <= 48 * 1024) == (d <= 64)


@pytest.mark.parametrize("d", ac.HEAD_DIMS)
def test_tensor_core_dropout_backward_shared_memory(d):
    """The dropout flavour adds the keep bits, one a (query, key), both
    rounded up to a 64 tile: 512 bytes at Lq = Lk = 60."""
    for lq, lq_pad in ((1, 64), (60, 64), (65, 128), (563, 576)):
        for lk, lk_pad in ((1, 64), (60, 64), (64, 64), (65, 128),
                           (563, 576)):
            want = 2 * 4 * 64 * (d + 8) + 4 * 64 + 12 * lq_pad \
                + lq_pad * lk_pad // 8
            assert ac.tc_dropout_bwd_smem_bytes(lq, lk, d) == want
    assert ac.tc_dropout_bwd_smem_bytes(60, 60, d) \
        == ac.tc_bwd_smem_bytes(60, d) + 512


@pytest.mark.parametrize("dropout", [False, True],
                         ids=["rows_2_8", "rows_4_6"])
@pytest.mark.parametrize("d", ac.HEAD_DIMS)
def test_every_bf16_backward_shape_that_ran_still_runs(d, dropout):
    """Every (Lq, Lk) the CUDA-core backward's shared memory (8 bytes a
    (query, key)) took in bf16 before rows 2 and 8, and then rows 4 and 6,
    moved to the tensor cores is taken by the tensor-core body. Without
    dropout it also takes Lk past that limit, its shared memory growing
    with Lq alone; the dropout flavour's keep bits take an eighth of a
    byte a (query, key)."""
    core = ac.bwd_smem_bytes
    _, tc = ac.bwd_body(torch.bfloat16, dropout)
    max_lq = max(lq for lq in range(1, 10000)
                 if core(lq, 1, d) <= ac.MAX_SMEM_BYTES)
    for lq in range(1, max_lq + 1):  # every Lq the old body took at all
        ac.check_extent("new", 4, lq, 1, 12, d, tc)
    for lq in (1, 5, 16, 60, 63, 64, 65, 128, 563, max_lq):
        max_lk = max(lk for lk in range(1, 8000)
                     if core(lq, lk, d) <= ac.MAX_SMEM_BYTES)
        for lk in sorted({1, 60, 63, 64, 65, 128, max_lk // 2, max_lk}):
            if lk <= max_lk:
                ac.check_extent("old", 4, lq, lk, 12, d, core)
                ac.check_extent("new", 4, lq, lk, 12, d, tc)
        with pytest.raises(ValueError, match="shared memory"):
            ac.check_extent("old", 4, lq, max_lk + 1, 12, d, core)
        if not dropout:
            ac.check_extent("new", 4, lq, 100 * max_lk, 12, d, tc)
