"""K8's tensor-core body on the CPU: its plan's twin
(``ops.nce.nce_plan_ref``), the body rule (``ops.nce.nce_body``), and the body's recipe replayed in
plain PyTorch from the plan against the JAX package's negative scores and
their gradient.

The plan buckets every valid (query, negative) pair by (query tile of 128,
candidate tile of 64). Its properties are checked against what the indices
alone say, for JAX's sampled negatives and for indices of other shapes:
uniform with repeats, a few values repeated, clustered in one candidate
tile, all equal, and with indices out of range.

The recipe is what the card's kernels compute: the forward scores each of
the plan's non-empty 256 x 256 tiles in float32, rounds to bf16 and keeps the
tile's sampled scores; the backward sums each run of repeated (q, candidate)
pairs in float32, rounds it to bf16, builds each 128 x 64 tile of the
cotangent matrix from its bucket and multiplies it with flat in float32.
Against ``volta_tpu.losses._chunked_neg_scores`` (one block: the dense
path's numerics) and its ``jax.vjp``, bf16, the same numpy-made inputs: the
scores within one bf16 ulp of the largest and at most 1 in 100 of them on
the other bf16 neighbour (float32 sums in two orders), the gradient within
2e-2 of its largest, as the card holds the kernels.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from volta_tpu import losses as jlosses
from volta_tpu_torch.losses import sample_negatives
from volta_tpu_torch.ops import nce

N_NEG = 127
# (b, r): a query tile and a bit, an odd pair count, an odd tile count
SHAPES = [(8, 36), (3, 5), (9, 40)]
KINDS = ["sampled", "uniform", "repeated", "clustered", "all_equal",
         "out_of_range"]


def _indices(kind, b, r, seed=0):
    """[b, r, 127] int64 indices of ``kind`` into b·r candidate rows."""
    m = b * r
    rng = np.random.RandomState(seed)
    shape = (b, r, N_NEG)
    if kind == "sampled":
        return sample_negatives(b, r, 128, torch.Generator().manual_seed(
            seed), "cpu")
    if kind == "uniform":
        idx = rng.randint(0, m, shape)
    elif kind == "repeated":
        idx = rng.choice(rng.randint(0, m, 3), shape)
    elif kind == "clustered":
        lo = (m // 2) // nce.TILE_C * nce.TILE_C
        idx = lo + rng.randint(0, min(nce.TILE_C, m - lo), shape)
    elif kind == "all_equal":
        idx = np.full(shape, m // 3)
    else:
        idx = rng.randint(-3, m + 3, shape)
        idx[0, 0] = m + 7  # a query with no index in range
    return torch.from_numpy(idx.astype(np.int64))


def _expected(idx, m):
    """The valid pairs as sorted lists of (bucket, row, candidate, n, pair
    id) computed from the indices alone."""
    q = idx.numel() // N_NEG
    flat = idx.reshape(q, N_NEG)
    ct_n = -(-m // nce.TILE_C)
    out = []
    for qq in range(q):
        for n in range(N_NEG):
            c = int(flat[qq, n])
            if 0 <= c < m:
                bucket = (qq // nce.TILE_Q) * ct_n + c // nce.TILE_C
                out.append((bucket, qq % nce.TILE_Q, c, n, qq * N_NEG + n))
    return sorted(out)


def _bucket_ranges(plan, qt_n, ct_n):
    s = plan.starts.long()
    tile = s[:-1:nce.SEGMENTS]
    ends = torch.cat([tile[1:], s[-1:]])
    return tile.view(qt_n, ct_n), ends.view(qt_n, ct_n)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"b{s[0]}r{s[1]}")
@pytest.mark.parametrize("kind", KINDS)
def test_plan_lists_every_pair_once_in_its_bucket(kind, shape):
    """Every in-range (q, n) is an entry exactly once, in the bucket of its
    query tile and candidate tile, the buckets in (query tile, candidate
    tile) order and each in (q, candidate, n) order; an index out of range
    is in no bucket; the segments' starts partition each bucket by
    query rows."""
    b, r = shape
    m = b * r
    idx = _indices(kind, b, r)
    plan = nce.nce_plan_ref(idx, m)
    qt_n, ct_n, _, _, t = nce.plan_tiles(b * r, m)
    want = _expected(idx, m)
    e = int(plan.starts[-1])
    assert e == len(want) == int(((idx >= 0) & (idx < m)).sum())
    got = plan.entries[:e]
    assert got[:, 0].tolist() == [w[4] for w in want]
    assert got[:, 1].tolist() == [(w[1] << 24) | w[2] for w in want]
    # each bucket's range holds exactly its pairs, segment by segment
    s = plan.starts.tolist()
    assert s == sorted(s) and s[0] == 0
    for k, (bucket, row, c, n, p) in enumerate(want):
        seg = (bucket * nce.SEGMENTS) + row // 32
        assert s[seg] <= k < s[seg + 1], (k, bucket, row)


@pytest.mark.parametrize("kind", KINDS)
def test_plan_lists_only_non_empty_tiles(kind):
    """The forward's units are exactly the 256 x 256 pair tiles that hold a
    pair, in order; each query pair's backward list exactly the candidate
    tiles either of its query tiles uses, in order, with each tile's own
    bucket range (empty for a tile it does not use)."""
    b, r = 9, 40
    m = b * r
    idx = _indices(kind, b, r, seed=1)
    plan = nce.nce_plan_ref(idx, m)
    qt_n, ct_n, qp_n, cj_n, _ = nce.plan_tiles(b * r, m)
    lo, hi = _bucket_ranges(plan, qt_n, ct_n)
    used = set()
    for bucket, *_ in _expected(idx, m):
        used.add((bucket // ct_n, bucket % ct_n))
    fwd = sorted({(qt // 2) * cj_n + ct // 4 for qt, ct in used})
    assert int(plan.units[0]) == len(fwd)
    assert plan.units[1:1 + len(fwd)].tolist() == fwd
    for qp in range(qp_n):
        cts = sorted({ct for qt, ct in used if qt // 2 == qp})
        assert int(plan.bwd_count[qp]) == len(cts)
        for rk in range(2):
            qt = 2 * qp + rk
            rows = plan.bwd_list[qt * ct_n:qt * ct_n + len(cts)].tolist()
            assert [x[0] for x in rows] == cts
            for ct, s0, s1, zero in rows:
                assert zero == 0
                if qt < qt_n:
                    assert (s0, s1) == (int(lo[qt, ct]), int(hi[qt, ct]))
                    assert (s1 > s0) == ((qt, ct) in used)
                else:
                    assert s0 == s1 == 0


def test_plan_is_the_same_from_call_to_call():
    """The same indices give the same plan, array for array, and a
    permutation of one query's negatives moves only that query's pair ids."""
    idx = _indices("sampled", 8, 36)
    a, b = nce.nce_plan_ref(idx, 288), nce.nce_plan_ref(idx.clone(), 288)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    perm = idx.clone()
    perm[0, 0] = perm[0, 0].flip(0)
    c = nce.nce_plan_ref(perm, 288)
    assert torch.equal(a.starts, c.starts) and torch.equal(a.units, c.units)
    moved = a.entries[:, 0] != c.entries[:, 0]
    assert bool(((a.entries[moved, 0] // N_NEG) == 0).all())


def test_plan_layout_is_aligned():
    """Every array of the plan's buffer starts on a 16-byte boundary (the
    kernels read entries as int2 and the backward list as int4) and the
    buffer holds them all without overlap."""
    for q, n, m in [(9216, 127, 9216), (15, 127, 15), (18432, 127, 18432),
                    (1, 1, 1)]:
        layout, size = nce.plan_layout(q, n, m)
        end = 0
        for name, (off, shape) in layout.items():
            assert off % 4 == 0 and off >= end, name
            end = off + int(np.prod(shape))
        assert end <= size


@pytest.mark.parametrize("q,m,d,dtype,n,body", [
    (9216, 9216, 2048, torch.bfloat16, 127, "tc"),    # b256 x r36
    (18432, 18432, 2048, torch.bfloat16, 127, "gather"),  # b512 x r36
    (9216, 9216, 2048, torch.float32, 127, "gather"),
    (15, 15, 48, torch.bfloat16, 127, "tc"),          # odd and small
    (15, 15, 48, torch.bfloat16, 129, "gather"),      # beyond the sort
    (36864, 36864, 2048, torch.bfloat16, 127, "gather"),  # b1024
    (9216, 64 * 4097, 2048, torch.bfloat16, 127, "gather"),
])
def test_nce_body_rule(q, m, d, dtype, n, body):
    """The rule names the tensor-core body for bf16 up to its crossover
    (m <= TC_MAX_M_PER_NEG · n) where the plan takes the shape, the gather
    body for float32, past the crossover and past the plan's limits."""
    assert nce.nce_body(q, m, d, dtype, n) == body


def test_wrappers_route_by_the_rule():
    """The wrappers ask the rule with the call's own sizes: the query
    count, the candidate rows, the width, the dtype and the negatives."""
    seen = []
    pred = torch.zeros(2, 3, 16, dtype=torch.bfloat16)
    flat = torch.zeros(6, 16, dtype=torch.bfloat16)
    idx = torch.zeros(2, 3, 5, dtype=torch.long)
    real = nce.nce_body
    try:
        nce.nce_body = lambda *a: seen.append(a) or real(*a)
        assert nce._body(pred.shape, pred.dtype, flat, idx) == "tc"
    finally:
        nce.nce_body = real
    assert seen == [(6, 6, 16, torch.bfloat16, 5)]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def recipe_fwd(pred, flat, idx, plan):
    """The tensor-core forward from the plan: each unit's tile products in
    float32, rounded to bf16, read at the tile's entries; NaN elsewhere."""
    q, d = pred.shape
    m = flat.shape[0]
    qt_n, ct_n, _, cj_n, _ = nce.plan_tiles(q, m)
    lo, hi = _bucket_ranges(plan, qt_n, ct_n)
    out = torch.full((q * N_NEG,), float("nan"))
    seen = torch.zeros(q * N_NEG, dtype=torch.int32)
    pf, ff = pred.float(), flat.float()
    for u in plan.units[1:1 + int(plan.units[0])].tolist():
        qp, cj = divmod(u, cj_n)
        c0 = cj * nce.FWD_COLS
        for qt in (2 * qp, 2 * qp + 1):
            if qt >= qt_n:
                continue
            q0 = qt * nce.TILE_Q
            tile = _bf16(pf[q0:q0 + nce.TILE_Q] @ ff[c0:c0 + nce.FWD_COLS].t())
            c1 = min(4 * cj + 4, ct_n)
            for e in range(int(lo[qt, 4 * cj]), int(hi[qt, c1 - 1])):
                p, y = plan.entries[e].tolist()
                row, c = y >> 24, (y & 0xFFFFFF) - c0
                assert p // N_NEG == q0 + row and 0 <= c < nce.FWD_COLS
                out[p] = tile[row, c]
                seen[p] += 1
    valid = ((idx >= 0) & (idx < m)).reshape(-1)
    assert torch.equal(seen, valid.int())
    return out.view(idx.shape)


def recipe_bwd(g, flat, plan, q):
    """The tensor-core backward from the plan: each run of repeated (q,
    candidate) entries summed in float32 over bf16(g) and rounded to bf16,
    each 128 x 64 tile of the cotangent matrix built from its bucket and
    multiplied with flat's tile in float32, dpred rounded to bf16."""
    m, d = flat.shape
    qt_n, ct_n, qp_n, _, _ = nce.plan_tiles(q, m)
    e = int(plan.starts[-1])
    ent = plan.entries[:e].tolist()
    gb = _bf16(g.reshape(-1))
    packed = {}
    k = 0
    while k < e:
        p, y = ent[k]
        j = k
        acc = torch.zeros((), dtype=torch.float32)
        while j < e and ent[j][1] == y and ent[j][0] // N_NEG == p // N_NEG:
            acc = acc + gb[ent[j][0]]
            j += 1
        packed[k] = (y >> 24, (y & 0xFFFFFF) % nce.TILE_C, _bf16(acc))
        k = j
    ff = torch.nn.functional.pad(flat.float(),
                                 (0, 0, 0, ct_n * nce.TILE_C - m))
    acc = torch.zeros(2 * qp_n * nce.TILE_Q, d)
    for qp in range(qp_n):
        for i in range(int(plan.bwd_count[qp])):
            for rk in range(2):
                qt = 2 * qp + rk
                ct, s0, s1, _ = plan.bwd_list[qt * ct_n + i].tolist()
                tile = torch.zeros(nce.TILE_Q, nce.TILE_C)
                for kk in range(s0, s1):
                    if kk in packed:
                        row, col, w = packed[kk]
                        tile[row, col] = w
                q0 = qt * nce.TILE_Q
                acc[q0:q0 + nce.TILE_Q] += \
                    tile @ ff[ct * nce.TILE_C:(ct + 1) * nce.TILE_C]
    return acc[:q].to(torch.bfloat16)


def _jax_inputs(b, r, d, seed):
    rng = np.random.RandomState(seed)
    pred = (rng.randn(b, r, d) * 0.05).astype(np.float32)
    flat = np.abs(rng.randn(b * r, d) * 0.5).astype(np.float32)
    g = rng.randn(b, r, N_NEG).astype(np.float32)
    to = lambda x: x.astype(ml_dtypes.bfloat16)  # noqa: E731
    return to(pred), to(flat), g


@pytest.mark.parametrize("kind", ["sampled", "uniform", "repeated",
                                  "all_equal", "out_of_range"])
def test_recipe_matches_jax(kind):
    """The tensor-core recipe from the plan against JAX's dense negative
    scores (``_chunked_neg_scores`` with one block) and their vjp, bf16: the
    scores within one bf16 ulp of the largest, at most 1 in 100 on the
    other bf16 neighbour, NaN where JAX's gather fills; the gradient within
    2e-2 of its largest."""
    b, r, d = 3, 40, 64
    m = b * r
    pred_np, flat_np, g = _jax_inputs(b, r, d, seed=7)
    idx = _indices(kind, b, r, seed=2)
    jidx = jnp.asarray(idx.numpy().astype(np.int32))
    jfn = lambda p: jlosses._chunked_neg_scores(  # noqa: E731
        p, jnp.asarray(flat_np), jidx, m)
    ref, vjp = jax.vjp(jfn, jnp.asarray(pred_np))
    dref = np.asarray(vjp(jnp.asarray(g))[0].astype(jnp.float32))
    ref = np.asarray(ref)
    pred = torch.from_numpy(pred_np.astype(np.float32)).to(torch.bfloat16)
    flat = torch.from_numpy(flat_np.astype(np.float32)).to(torch.bfloat16)
    plan = nce.nce_plan_ref(idx, m)
    got = recipe_fwd(pred.reshape(-1, d), flat, idx, plan).numpy()
    valid = ((idx >= 0) & (idx < m)).numpy()
    # JAX's blockwise path adds 0 for an out-of-range index; the dense
    # path's gather fills NaN, as the kernel stores
    assert np.isnan(got[~valid]).all()
    scale = np.abs(ref[valid]).max()
    assert np.abs(got[valid] - ref[valid]).max() <= 2 ** -7 * scale
    assert (got[valid] != ref[valid]).sum() <= 0.01 * valid.sum()
    dgot = recipe_bwd(torch.from_numpy(g), flat, plan, b * r).float().numpy()
    dscale = max(np.abs(dref).max(), 1e-30)
    assert np.abs(dgot - dref.reshape(b * r, d)).max() <= 2e-2 * dscale
    if kind == "out_of_range":
        assert (dgot[0] == 0).all()  # query 0 has no index in range
