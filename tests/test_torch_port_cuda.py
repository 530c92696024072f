"""The hand-written CUDA kernels against their plain twins, on the card.

Marked ``cuda``: each test skips on a host without one. The file imports no
JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest

Tolerances: the no-dropout forward output bf16 2e-2 (two bf16 ulps at
|x| ~ 2; fp32 1e-5); its head-major row equals its natural row bit for bit,
and so does the no-dropout backward's. The backward sums run in another
order than the twin's einsums, then both round: bf16 within two bf16 ulps of
the tensor's largest magnitude (2^-6 * max|ref|), fp32 within 1e-5 *
max(1, max|ref|). The dropout mask is compared bit for bit.
"""

import contextlib

import numpy as np
import pytest
import torch

from volta_tpu_torch.ops import LAUNCHES, attention_cuda
from volta_tpu_torch.ops import attention_dropout_cuda as adc

SERVING = (256, 60, 60, 12, 64)
# (B, Lq, Lk, H, D): Lq != Lk, Lq < 8, D = 16 and 128
ODD = [(2, 9, 33, 4, 16), (3, 5, 37, 2, 64), (2, 17, 70, 2, 128),
       (1, 1, 1, 3, 32)]
# the tensor-core forward's tile edges (64 query rows, 64 keys a tile):
# Lq and Lk at 63, 64, 65 and 128, and the longest task sequence (563)
EDGES = [(2, 63, 65, 3, 64), (2, 64, 64, 3, 128), (2, 65, 128, 2, 16),
         (2, 128, 63, 2, 32), (2, 65, 563, 2, 64), (3, 5, 563, 12, 64)]
# the tensor-core backward's tile edges (64-row query and key tiles): Lq and
# Lk at 63, 64, 65 and 128
BWD_EDGES = EDGES[:4] + [(2, 128, 128, 2, 64), (2, 64, 130, 2, 64)]
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
@pytest.mark.parametrize("shape", [SERVING] + ODD + EDGES,
                         ids=lambda s: "x".join(map(str, s)))
def test_tensor_core_forward_matches_twin(cuda_device, shape):
    """Rows 1 and 7 in bf16 run the tensor-core body: within 2e-2 of their
    twins at the serving shape, odd shapes and the tile edges, with one
    batch row whose keys are all padded but one; row 7 equal to row 1 bit
    for bit on the same operands."""
    from volta_tpu_torch.ops import attention_head_major_cuda as ahm

    assert attention_cuda.fwd_body(torch.bfloat16)[0] == "tensor-core"
    b, lq, lk, h, d = shape
    q, k, v, bias, _ = _inputs(shape, "bfloat16", cuda_device, seed=11)
    bias[0, 1:] = -10000.0
    scale = d ** -0.5
    names = ("attention_fwd", "attention_head_major_fwd")
    before = tuple(LAUNCHES[n] for n in names)
    out = attention_cuda.attention_fwd(q, k, v, bias, scale, h)
    hq, hk, hv = (_head_major(x, h) for x in (q, k, v))
    hout = ahm.attention_head_major_fwd(hq, hk, hv, bias, scale)
    torch.cuda.synchronize()
    assert tuple(LAUNCHES[n] - c for n, c in zip(names, before)) == (1, 1)
    ref = attention_cuda.attention_fwd_ref(q, k, v, bias, scale, h)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert bool(torch.isfinite(out).all())
    assert float((out.float() - ref.float()).abs().max()) <= 2e-2
    assert torch.equal(hout.permute(1, 2, 0, 3).reshape(q.shape), out)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [SERVING] + ODD + EDGES,
                         ids=lambda s: "x".join(map(str, s)))
def test_tensor_core_dropout_forward_matches_twins(cuda_device, shape):
    """Rows 3 and 9 in bf16 run the tensor-core body's dropout flavour:
    within 2e-2 of their twins at the serving shape, odd shapes and the
    forward's tile edges, with one batch row whose keys are all padded but
    one; row 3's keep mask and row 9's probability and hidden masks
    bit-equal to the twins' hash; row 9's output equal to row 3's bit for
    bit on the same operands and seed."""
    from volta_tpu_torch.ops import attention_hidden_mask_cuda as ahc

    assert attention_cuda.fwd_body(torch.bfloat16, dropout=True)[0] \
        == "tensor-core"
    b, lq, lk, h, d = shape
    q, k, v, bias, _ = _inputs(shape, "bfloat16", cuda_device, seed=13)
    bias[0, 1:] = -10000.0
    scale, seed = d ** -0.5, 0xFACE + lq + lk
    names = ("attention_dropout_fwd", "attention_dropout_hidden_masks_fwd")
    before = tuple(LAUNCHES[n] for n in names)
    out, mask = adc.attention_dropout_fwd(q, k, v, bias, scale, h, RATE,
                                          seed, return_mask=True)
    hq, hk, hv = (_head_major(x, h) for x in (q, k, v))
    hout, hmask, hm0, hm1 = ahc.attention_dropout_hidden_masks_fwd(
        hq, hk, hv, bias, scale, RATE, seed, RATE, seed + 1, seed + 2)
    torch.cuda.synchronize()
    assert tuple(LAUNCHES[n] - c for n, c in zip(names, before)) == (1, 1)
    keep = adc.keep_mask(seed, (b, h, lq, lk), RATE, device=cuda_device)
    assert torch.equal(mask, keep)
    ref = adc.attention_dropout_fwd_ref(q, k, v, bias, scale, h, RATE, keep)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert bool(torch.isfinite(out).all())
    assert float((out.float() - ref.float()).abs().max()) <= 2e-2
    rout, rmask, r0, r1 = ahc.attention_dropout_hidden_masks_fwd_ref(
        hq, hk, hv, bias, scale, RATE, seed, RATE, seed + 1, seed + 2)
    assert torch.equal(hmask, rmask) and torch.equal(hm0, r0) \
        and torch.equal(hm1, r1)
    assert float((hout.float() - rout.float()).abs().max()) <= 2e-2
    assert torch.equal(hout.permute(1, 2, 0, 3).reshape(q.shape), out)


@pytest.mark.cuda
@pytest.mark.parametrize("want_db", [False, True], ids=["no_db", "db"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [SERVING] + ODD + BWD_EDGES,
                         ids=lambda s: "x".join(map(str, s)))
def test_bwd_kernel_matches_twin(cuda_device, dtype, shape, want_db):
    """Rows 2 and 8 run the tensor-core body in bf16 and the CUDA-core body
    in float32: dq, dk, dv (and the bias gradient) within the tolerance of
    their twins at the serving shape, odd shapes and the tensor-core tile
    edges, with one batch row whose keys are all padded but one; row 8
    equal to row 2 bit for bit on the same operands."""
    from volta_tpu_torch.ops import attention_head_major_cuda as ahm

    body = attention_cuda.bwd_body(getattr(torch, dtype))[0]
    assert body == ("tensor-core" if dtype == "bfloat16" else "CUDA-core")
    b, lq, lk, h, d = shape
    q, k, v, bias, g = _inputs(shape, dtype, cuda_device, seed=12)
    bias[0, 1:] = -10000.0
    scale = d ** -0.5
    names = ("attention_bwd", "attention_head_major_bwd")
    before = tuple(LAUNCHES[n] for n in names)
    got = attention_cuda.attention_bwd(q, k, v, bias, g, scale, h, want_db)
    hq, hk, hv, hg = (_head_major(x, h) for x in (q, k, v, g))
    hgot = ahm.attention_head_major_bwd(hq, hk, hv, bias, hg, scale, want_db)
    torch.cuda.synchronize()
    assert tuple(LAUNCHES[n] - c for n, c in zip(names, before)) == (1, 1)
    ref = attention_cuda.attention_bwd_ref(q, k, v, bias, g, scale, h,
                                           want_db)
    for name, a, r in zip(("dq", "dk", "dv"), got[:3], ref[:3]):
        _assert_close(a, r, dtype, name)
    nat = lambda x: x.permute(1, 2, 0, 3).reshape(  # noqa: E731
        x.shape[1], x.shape[2], h * d)
    for a, r in zip(hgot[:3], got[:3]):
        assert torch.equal(nat(a), r)
    if want_db:
        # db is float32 in both; its sums follow the operands' rounding
        _assert_close(got[3], ref[3], dtype, "db")
        assert hgot[3].shape == (h, b, lk)
        _assert_close(hgot[3].sum(0), ref[3], dtype, "row 8 db")
    else:
        assert got[3] is None and hgot[3] is None


def _split_ratios(got, q, k, v, bias, g, scale, h, keep=None):
    """mean|got - R64| / mean|twin - R64| for dq, dk, dv: R64 the backward
    recipe in float64 on the same bf16 operands (with ``keep``, the dropout
    recipe of rows 4 and 6 on that mask), twin the plain twin (float32,
    then rounded to bf16)."""
    heads = lambda x: x.view(x.shape[0], x.shape[1], h, -1)  # noqa: E731
    exact = attention_cuda.attention_bwd_math(
        *(heads(x.double()) for x in (q, k, v)), bias.double(),
        heads(g.double()), scale, keep, adc.keep_scale(RATE))
    if keep is None:
        twin = attention_cuda.attention_bwd_ref(q, k, v, bias, g, scale, h,
                                                False)
    else:
        twin = adc.attention_dropout_bwd_ref(q, k, v, bias, g, scale, h,
                                             RATE, keep)
    return [float((a.double() - r.reshape(a.shape)).abs().mean()
                  / (t.double() - r.reshape(a.shape)).abs().mean())
            for a, t, r in zip(got[:3], twin[:3], exact[:3])]


@pytest.mark.cuda
@pytest.mark.parametrize("row", ["row 2", "row 4"])
@pytest.mark.parametrize("shape", [SERVING, (2, 128, 130, 3, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_bwd_products_take_float32_probabilities(cuda_device, shape, row):
    """P (row 4: P * keep) and dS enter the bf16 backward's products as hi
    + lo halves, so its dq, dk, dv are as far from the float64 recipe as
    the twin's (both round the same float32 values), within 5% on the
    mean; one bf16 rounding of P and dS (as flash-attention kernels do)
    adds an error the size of the outputs' own rounding and reads far
    above."""
    b, lq, lk, h, d = shape
    q, k, v, bias, g = _inputs(shape, "bfloat16", cuda_device, seed=13)
    keep = None
    if row == "row 2":
        got = attention_cuda.attention_bwd(q, k, v, bias, g, d ** -0.5, h)
    else:
        got = adc.attention_dropout_bwd(q, k, v, bias, g, d ** -0.5, h, RATE,
                                        31)
        keep = adc.keep_mask(31, (b, h, lq, lk), RATE, device=cuda_device)
    ratios = _split_ratios(got, q, k, v, bias, g, d ** -0.5, h, keep)
    assert max(ratios) <= 1.05, ratios


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [SERVING] + ODD + BWD_EDGES,
                         ids=lambda s: "x".join(map(str, s)))
def test_dropout_kernels_match_twins(cuda_device, dtype, shape):
    """Rows 3 and 4 against their twins fed the hash mask, with one batch
    row whose keys are all padded but one: row 3 and its mask, row 4, each
    on its tensor-core body in bf16 and its CUDA-core body in float32, at
    the serving shape, odd shapes and the tensor-core backward's tile
    edges."""
    want = "tensor-core" if dtype == "bfloat16" else "CUDA-core"
    assert attention_cuda.fwd_body(getattr(torch, dtype), True)[0] == want
    assert attention_cuda.bwd_body(getattr(torch, dtype), True)[0] == want
    b, lq, lk, h, d = shape
    q, k, v, bias, g = _inputs(shape, dtype, cuda_device, seed=2)
    bias[0, 1:] = -10000.0
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
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [16, 128])
def test_largest_lengths_run_and_the_next_raise(cuda_device, d, dtype):
    """Each body at its own limit in each dtype. The no-dropout forward
    (rows 1 and 7 share the body): float32 on the CUDA-core body, the
    largest Lk its shared memory takes at Lq = 5; bf16 on the tensor-core
    body, whose shared memory does not grow with Lk, four times that Lk, and
    the largest Lq its grid takes. The dropout forwards (rows 3 and 9 share
    the body): float32 on the CUDA-core body at its largest Lk; bf16 on
    the tensor-core body at four times that Lk and the largest Lq its grid
    takes. The backwards at Lq = 128: the dropout
    backward (row 4) at the largest Lk of its body (CUDA-core in float32,
    tensor-core in bf16); the no-dropout backward (rows 2 and 8 share the
    body) on the CUDA-core body in float32 at the CUDA-core largest Lk, on
    the tensor-core body in bf16, whose shared memory grows with Lq alone,
    at four times that Lk, and at the largest Lq its shared memory
    takes."""
    from volta_tpu_torch.ops import attention_head_major_cuda as ahm

    scale = d ** -0.5
    core_lk = _max_lk(lambda lq, lk, d: attention_cuda.smem_bytes(lk, d), 5,
                      d)
    name, rows, smem = attention_cuda.fwd_body(getattr(torch, dtype))
    if name == "CUDA-core":
        assert _max_lk(smem, 5, d) == core_lk
        q, k, v, bias, _ = _inputs((1, 5, core_lk, 2, d), dtype, cuda_device)
        _assert_close(attention_cuda.attention_fwd(q, k, v, bias, scale, 2),
                      attention_cuda.attention_fwd_ref(q, k, v, bias, scale,
                                                       2), dtype, "row 1")
        hq, hk, hv = (_head_major(x, 2) for x in (q, k, v))
        _assert_close(ahm.attention_head_major_fwd(hq, hk, hv, bias, scale),
                      ahm.attention_head_major_fwd_ref(hq, hk, hv, bias,
                                                       scale), dtype, "row 7")
        _, k2, v2, bias2, _ = _inputs((1, 5, core_lk + 1, 2, d), dtype,
                                      cuda_device)
        with pytest.raises(ValueError, match="shared memory"):
            attention_cuda.attention_fwd(q, k2, v2, bias2, scale, 2)
        with pytest.raises(ValueError, match="shared memory"):
            ahm.attention_head_major_fwd(hq, _head_major(k2, 2),
                                         _head_major(v2, 2), bias2, scale)
    else:
        assert smem(5, 4 * core_lk, d) == smem(1, 1, d) <= \
            attention_cuda.MAX_SMEM_BYTES
        q, k, v, bias, _ = _inputs((1, 5, 4 * core_lk, 2, d), dtype,
                                   cuda_device)
        out = attention_cuda.attention_fwd(q, k, v, bias, scale, 2)
        ref = attention_cuda.attention_fwd_ref(q, k, v, bias, scale, 2)
        assert float((out.float() - ref.float()).abs().max()) <= 2e-2
        lq = 65535 * rows  # 4.2M queries: drawn on the card
        _, k, v, bias, _ = _inputs((1, 1, 3, 1, d), dtype, cuda_device)
        gen = torch.Generator(device=cuda_device).manual_seed(d)
        q = torch.randn((1, lq, d), generator=gen, device=cuda_device).to(
            torch.bfloat16)
        out = attention_cuda.attention_fwd(q, k, v, bias, scale, 1)
        ref = attention_cuda.attention_fwd_ref(q, k, v, bias, scale, 1)
        assert float((out.float() - ref.float()).abs().max()) <= 2e-2
        del q, out, ref
        q2 = torch.empty((1, lq + 1, d), dtype=torch.bfloat16,
                         device=cuda_device)
        with pytest.raises(ValueError, match="grid"):
            attention_cuda.attention_fwd(q2, k, v, bias, scale, 1)
    # the dropout forwards: the largest Lk of the CUDA-core body at Lq = 5
    # in float32, four times it in bf16, and in bf16 the largest Lq
    from volta_tpu_torch.ops import attention_hidden_mask_cuda as ahc

    dname, drows, dsmem = attention_cuda.fwd_body(getattr(torch, dtype),
                                                  dropout=True)
    dlk = core_lk if dname == "CUDA-core" else 4 * core_lk
    q, k, v, bias, g = _inputs((1, 5, dlk, 2, d), dtype, cuda_device)
    out, mask = adc.attention_dropout_fwd(q, k, v, bias, scale, 2, RATE, 7,
                                          return_mask=True)
    _assert_close(out, adc.attention_dropout_fwd_ref(
        q, k, v, bias, scale, 2, RATE, mask), dtype,
        f"dropout fwd ({dname}) at Lk = {dlk}")
    hq, hk, hv = (_head_major(x, 2) for x in (q, k, v))
    hout, hmask, _, _ = ahc.attention_dropout_hidden_masks_fwd(
        hq, hk, hv, bias, scale, RATE, 7, RATE, 8, 9)
    _assert_close(hout, ahc.attention_dropout_hidden_masks_fwd_ref(
        hq, hk, hv, bias, scale, RATE, 7, RATE, 8, 9)[0], dtype,
        f"row 9 ({dname}) at Lk = {dlk}")
    assert torch.equal(hmask.transpose(0, 1).bool(), mask)
    _, k2, v2, bias2, _ = _inputs((1, 5, core_lk + 1, 2, d), dtype,
                                  cuda_device)
    if dname == "CUDA-core":
        assert _max_lk(dsmem, 5, d) == core_lk
        with pytest.raises(ValueError, match="shared memory"):
            adc.attention_dropout_fwd(q, k2, v2, bias2, 0.1, 2, RATE, 7)
        with pytest.raises(ValueError, match="shared memory"):
            ahc.attention_dropout_hidden_masks_fwd(
                hq, _head_major(k2, 2), _head_major(v2, 2), bias2, 0.1, RATE,
                7, RATE, 8, 9)
    else:
        assert dsmem(5, dlk, d) == dsmem(1, 1, d) <= \
            attention_cuda.MAX_SMEM_BYTES
        lq = 65535 * drows  # 4.2M queries: drawn on the card
        _, k, v, bias, _ = _inputs((1, 1, 3, 1, d), dtype, cuda_device)
        gen = torch.Generator(device=cuda_device).manual_seed(d + 1)
        q = torch.randn((1, lq, d), generator=gen, device=cuda_device).to(
            torch.bfloat16)
        out, mask = adc.attention_dropout_fwd(q, k, v, bias, scale, 1, RATE,
                                              7, return_mask=True)
        _assert_close(out, adc.attention_dropout_fwd_ref(
            q, k, v, bias, scale, 1, RATE, mask), dtype,
            "dropout fwd at the largest Lq")
        assert torch.equal(mask, adc.keep_mask(7, (1, 1, lq, 3), RATE,
                                               device=cuda_device))
        del q, out, mask
        q2 = torch.empty((1, lq + 1, d), dtype=torch.bfloat16,
                         device=cuda_device)
        with pytest.raises(ValueError, match="grid"):
            adc.attention_dropout_fwd(q2, k, v, bias, scale, 1, RATE, 7)
        del q2
    # the dropout backward (rows 4 and 6 share the body) at Lq = 128 at the
    # largest Lk of its body: the CUDA-core body's in float32, the
    # tensor-core body's in bf16, where the keep bits grow by Lk / 8 bytes
    # a query row
    dname, dsmem = attention_cuda.bwd_body(getattr(torch, dtype), True)
    dlk = _max_lk(dsmem, 128, d)
    q, k, v, bias, g = _inputs((1, 128, dlk, 2, d), dtype, cuda_device)
    got = adc.attention_dropout_bwd(q, k, v, bias, g, scale, 2, RATE, 7)
    keep = adc.keep_mask(7, (1, 2, 128, dlk), RATE, device=cuda_device)
    ref = adc.attention_dropout_bwd_ref(q, k, v, bias, g, scale, 2, RATE,
                                        keep)
    for a, r in zip(got, ref):
        _assert_close(a, r, dtype, f"dropout bwd ({dname}) at Lk = {dlk}")
    _, k2, v2, bias2, _ = _inputs((1, 128, dlk + 1, 2, d), dtype,
                                  cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        adc.attention_dropout_bwd(q, k2, v2, bias2, g, 0.1, 2, RATE, 7)
    # the no-dropout backward: the largest Lk of the CUDA-core body at
    # Lq = 128 (at least 128 for every D)
    lk = _max_lk(attention_cuda.bwd_smem_bytes, 128, d)
    assert lk >= 128 and dlk >= lk
    q, k, v, bias, g = _inputs((1, 128, lk, 2, d), dtype, cuda_device)
    _, k2, v2, bias2, _ = _inputs((1, 128, lk + 1, 2, d), dtype,
                                  cuda_device)
    name, smem = attention_cuda.bwd_body(getattr(torch, dtype))
    if name == "CUDA-core":
        assert _max_lk(smem, 128, d) == lk
        got = attention_cuda.attention_bwd(q, k, v, bias, g, scale, 2)
        ref = attention_cuda.attention_bwd_ref(q, k, v, bias, g, scale, 2)
        for a, r in zip(got[:3], ref[:3]):
            _assert_close(a, r, dtype, "bwd at the largest Lk")
        with pytest.raises(ValueError, match="shared memory"):
            attention_cuda.attention_bwd(q, k2, v2, bias2, g, 0.1, 2)
        return
    assert name == "tensor-core"
    assert smem(128, 4 * lk, d) == smem(128, 1, d) <= \
        attention_cuda.MAX_SMEM_BYTES
    q, k, v, bias, g = _inputs((1, 128, 4 * lk, 2, d), dtype, cuda_device)
    got = attention_cuda.attention_bwd(q, k, v, bias, g, scale, 2)
    ref = attention_cuda.attention_bwd_ref(q, k, v, bias, g, scale, 2)
    for a, r in zip(got[:3], ref[:3]):
        _assert_close(a, r, dtype, "bwd at four times the old largest Lk")
    lq = 64
    while smem(lq + 64, 3, d) <= attention_cuda.MAX_SMEM_BYTES:
        lq += 64
    q, k, v, bias, g = _inputs((1, lq, 3, 1, d), dtype, cuda_device)
    got = attention_cuda.attention_bwd(q, k, v, bias, g, scale, 1)
    ref = attention_cuda.attention_bwd_ref(q, k, v, bias, g, scale, 1)
    for a, r in zip(got[:3], ref[:3]):
        _assert_close(a, r, dtype, "bwd at the largest Lq")
    q2, _, _, _, g2 = _inputs((1, lq + 1, 3, 1, d), dtype, cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        attention_cuda.attention_bwd(q2, k, v, bias, g2, scale, 1)


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


# ------------------------------------------- head-major kernels (rows 5-8)
HM_NAMES = ("attention_head_major_fwd", "attention_head_major_bwd",
            "attention_dropout_head_major_fwd",
            "attention_dropout_head_major_bwd")


def _head_major(x, heads):
    """[B, L, H·D] -> contiguous [H, B, L, D]."""
    b, l, hd = x.shape
    return x.view(b, l, heads, hd // heads).permute(2, 0, 1, 3).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [SERVING] + ODD,
                         ids=lambda s: "x".join(map(str, s)))
def test_head_major_kernels_match_twins(cuda_device, dtype, shape):
    """Rows 7, 8 (with the per-head bias partials), 5 and 6 against their
    twins; row 5's mask bit-equal to the twin's, row 6 fed it."""
    from volta_tpu_torch.ops import attention_head_major_cuda as ahm

    b, lq, lk, h, d = shape
    q, k, v, bias, g = _inputs(shape, dtype, cuda_device, seed=5)
    q, k, v, g = (_head_major(x, h) for x in (q, k, v, g))
    seed, scale = 0xFACE + lq, d ** -0.5
    before = tuple(LAUNCHES[n] for n in HM_NAMES)
    out = ahm.attention_head_major_fwd(q, k, v, bias, scale)
    grads = ahm.attention_head_major_bwd(q, k, v, bias, g, scale,
                                         want_db=True)
    dout, mask = ahm.attention_dropout_head_major_fwd(q, k, v, bias, scale,
                                                      RATE, seed)
    dgrads = ahm.attention_dropout_head_major_bwd(q, k, v, bias, g, mask,
                                                  scale, RATE)
    torch.cuda.synchronize()
    assert tuple(LAUNCHES[n] - c for n, c in zip(HM_NAMES, before)) == \
        (1, 1, 1, 1)
    _assert_close(out, ahm.attention_head_major_fwd_ref(q, k, v, bias, scale),
                  dtype, "row 7")
    ref = ahm.attention_head_major_bwd_ref(q, k, v, bias, g, scale)
    for name, a, r in zip(("dq", "dk", "dv"), grads[:3], ref[:3]):
        _assert_close(a, r, dtype, f"row 8 {name}")
    assert grads[3].shape == (h, b, lk)
    _assert_close(grads[3], ref[3], dtype, "row 8 db_part")
    assert ahm.attention_head_major_bwd(q, k, v, bias, g, scale)[3] is None
    keep = ahm.keep_mask_head_major(seed, (h, b, lq, lk), RATE,
                                    device=cuda_device)
    assert mask.dtype == torch.uint8 and torch.equal(mask, keep)
    _assert_close(dout, ahm.attention_dropout_head_major_fwd_ref(
        q, k, v, bias, scale, RATE, keep), dtype, "row 5")
    dref = ahm.attention_dropout_head_major_bwd_ref(q, k, v, bias, g, keep,
                                                    scale, RATE)
    for name, a, r in zip(("dq", "dk", "dv"), dgrads, dref):
        _assert_close(a, r, dtype, f"row 6 {name}")
    if shape == SERVING:
        frac = float(mask.float().mean())
        assert abs(frac - (1 - RATE)) <= 0.005, frac


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [SERVING, ODD[0]],
                         ids=lambda s: "x".join(map(str, s)))
def test_head_major_kernels_match_natural_kernels(cuda_device, dtype, shape):
    """For one seed rows 5-8 and rows 1-4 drop the same probabilities and
    agree on the same operands: outputs and gradients within the twins'
    tolerance, the same dropped set; rows 7, 5, 8 and 6 equal to rows 1, 3,
    2 and 4 bit for bit (one body each, two addressings; row 6's keep bits
    are read from the mask bytes, row 4's replayed from the hash)."""
    from volta_tpu_torch.ops import attention_head_major_cuda as ahm

    b, lq, lk, h, d = shape
    q, k, v, bias, g = _inputs(shape, dtype, cuda_device, seed=6)
    hq, hk, hv, hg = (_head_major(x, h) for x in (q, k, v, g))
    seed, scale = 4242, d ** -0.5
    nat = lambda x: x.permute(1, 2, 0, 3).reshape(  # noqa: E731
        x.shape[1], x.shape[2], h * d)
    hout = nat(ahm.attention_head_major_fwd(hq, hk, hv, bias, scale))
    nout = attention_cuda.attention_fwd(q, k, v, bias, scale, h)
    _assert_close(hout, nout, dtype, "row 7 vs row 1")
    assert torch.equal(hout, nout)
    hgrads = ahm.attention_head_major_bwd(hq, hk, hv, bias, hg, scale, True)
    ngrads = attention_cuda.attention_bwd(q, k, v, bias, g, scale, h, True)
    for a, r in zip(hgrads[:3], ngrads[:3]):
        _assert_close(nat(a), r, dtype, "row 8 vs row 2")
        assert torch.equal(nat(a), r)  # one body, two addressings
    _assert_close(hgrads[3].sum(0), ngrads[3], dtype, "row 8 vs row 2 db")
    hout, hmask = ahm.attention_dropout_head_major_fwd(hq, hk, hv, bias,
                                                       scale, RATE, seed)
    nout, nmask = adc.attention_dropout_fwd(q, k, v, bias, scale, h, RATE,
                                            seed, return_mask=True)
    assert torch.equal(hmask.transpose(0, 1).bool(), nmask)
    _assert_close(nat(hout), nout, dtype, "row 5 vs row 3")
    assert torch.equal(nat(hout), nout)  # one body, two addressings
    hgrads = ahm.attention_dropout_head_major_bwd(hq, hk, hv, bias, hg, hmask,
                                                  scale, RATE)
    ngrads = adc.attention_dropout_bwd(q, k, v, bias, g, scale, h, RATE, seed)
    for a, r in zip(hgrads, ngrads):
        _assert_close(nat(a), r, dtype, "row 6 vs row 4")
        assert torch.equal(nat(a), r)  # one body, two addressings


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, RATE], ids=["no_dropout", "dropout"])
def test_head_major_functions_take_the_kernels(cuda_device, rate):
    """fused_attention(natural=False) launches one head-major forward and
    one head-major backward kernel, no natural one, and agrees with its CPU
    twin path."""
    from volta_tpu_torch.ops.attention import fused_attention

    b, l, h, d = 4, 60, 12, 64
    rng = np.random.RandomState(7)
    qkv = [torch.from_numpy(rng.randn(b, l, h, d).astype(np.float32))
           for _ in range(3)]
    bias = torch.zeros(b, 1, 1, l)
    bias[1, ..., 50:] = -10000.0
    pair = HM_NAMES[2:] if rate else HM_NAMES[:2]
    outs, grads = [], []
    for dev in ("cpu", "cuda"):
        x = [t.to(dev).detach().requires_grad_() for t in qkv]
        before = dict(LAUNCHES)
        out = fused_attention(*x, bias.to(dev), d ** -0.5, rate, 99,
                              natural=False)
        out.square().sum().backward()
        launched = {n: LAUNCHES[n] - c for n, c in before.items()
                    if LAUNCHES[n] != c}
        assert launched == ({} if dev == "cpu" else dict.fromkeys(pair, 1))
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


def _ln_rows(shape, dtype):
    """(n, d) of a LayerNorm case: WAVE_EDGE is one row past a full wave of
    the forward's band grid on this card (every warp one row), 768 wide;
    BWD_WAVE_EDGE the same for row 13's backward band grid."""
    from volta_tpu_torch.ops import fused_residual as fr
    from volta_tpu_torch.ops import layernorm as ln

    if shape == WAVE_EDGE:
        return ln.full_wave_rows(0, 768, getattr(torch, dtype)) + 1, 768
    if shape == BWD_WAVE_EDGE:
        return fr.bwd_full_wave_rows(0, 768, getattr(torch, dtype)) + 1, 768
    return shape


# the b1024 eval shape and one row past a full wave of the band grid
WAVE_EDGE = "wave_edge"
BWD_WAVE_EDGE = "bwd_wave_edge"
LN_BAND_SHAPES = LN_SHAPES + [(61440, 768), WAVE_EDGE]


def _shape_id(s):
    return s if isinstance(s, str) else "x".join(map(str, s))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", LN_BAND_SHAPES,
                         ids=lambda s: s if s == WAVE_EDGE
                         else "x".join(map(str, s)))
def test_layer_norm_kernels_match_twins(cuda_device, dtype, shape):
    from volta_tpu_torch.ops import layernorm as ln

    n, d = _ln_rows(shape, dtype)
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
@pytest.mark.parametrize("shape", [(15360, 768), (61440, 768), (33, 100),
                                   WAVE_EDGE],
                         ids=lambda s: s if s == WAVE_EDGE
                         else "x".join(map(str, s)))
def test_layer_norm_backward_is_the_same_from_call_to_call(cuda_device,
                                                           dtype, shape):
    """No atomics: dx, dscale and dbias are bit-equal over two calls."""
    from volta_tpu_torch.ops import layernorm as ln

    n, d = _ln_rows(shape, dtype)
    x, g, _, w, b = _ln_inputs(n, d, dtype, cuda_device, seed=3 * n + d)
    _, mean, rstd = ln.layer_norm_fwd(x, w, b, 1e-12)
    first = ln.layer_norm_bwd(g, x, w, mean, rstd)
    second = ln.layer_norm_bwd(g, x, w, mean, rstd)
    torch.cuda.synchronize()
    for name, a, b2 in zip(("dx", "dscale", "dbias"), first, second):
        assert torch.equal(a, b2), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", LN_SHAPES + [BWD_WAVE_EDGE], ids=_shape_id)
def test_fused_residual_kernels_match_twins(cuda_device, dtype, shape):
    """Rows 12-13 against their twins; the cases include a width where
    16-byte access does not apply (33 x 100) and one row past a full wave
    of row 13's band grid."""
    from volta_tpu_torch.models.layers import hash_dropout
    from volta_tpu_torch.ops import fused_residual as fr

    n, d = _ln_rows(shape, dtype)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(15360, 768), (33, 100), BWD_WAVE_EDGE],
                         ids=_shape_id)
def test_fused_residual_backward_is_the_same_from_call_to_call(cuda_device,
                                                               dtype, shape):
    """No atomics: row 13's do, dx, dscale and dbias are bit-equal over two
    calls."""
    from volta_tpu_torch.ops import fused_residual as fr

    n, d = _ln_rows(shape, dtype)
    o, x, g, w, b = _ln_inputs(n, d, dtype, cuda_device, seed=5 * n + d)
    _, od, mean, rstd = fr.dropout_residual_ln_fwd(o, x, w, b, 99, RATE,
                                                   1e-12)
    first = fr.dropout_residual_ln_bwd(g, od, x, w, mean, rstd, 99, RATE)
    second = fr.dropout_residual_ln_bwd(g, od, x, w, mean, rstd, 99, RATE)
    torch.cuda.synchronize()
    for name, a, b2 in zip(("do", "dx", "dscale", "dbias"), first, second):
        assert torch.equal(a, b2), name


@pytest.mark.cuda
def test_kept_zero_activation_keeps_its_gradient(cuda_device):
    """tests/test_torch_port_fused_residual.py's case on the card: an
    element of o that is exactly 0 but kept gets ds / (1 - rate) from row
    13, which replays the hash instead of reading od != 0; every dropped
    element gets 0; and the card's gradients agree with the CPU twins'."""
    from volta_tpu_torch.ops import fused_residual as fr

    n, d, rate, seed = 16, 128, 0.25, 12345
    rng = np.random.RandomState(3)
    o, x, g = (rng.randn(n, d).astype(np.float32) for _ in range(3))
    w = (1 + 0.1 * rng.randn(d)).astype(np.float32)
    b = (0.1 * rng.randn(d)).astype(np.float32)
    o[0, :8] = 0.0
    grads = {}
    for dev in ("cpu", "cuda"):
        leaves = [torch.from_numpy(a).to(dev).requires_grad_()
                  for a in (o, x, w, b)]
        before = LAUNCHES["dropout_residual_ln_bwd"]
        y = fr.dropout_residual_ln(*leaves, seed=seed, rate=rate, eps=1e-12)
        y.backward(torch.from_numpy(g).to(dev))
        assert LAUNCHES["dropout_residual_ln_bwd"] - before == \
            (dev == "cuda")
        grads[dev] = [t.grad.cpu() for t in leaves]
    kept = fr.keep_mask(seed, (n, d), rate)
    zero_kept = kept & (torch.from_numpy(o) == 0)
    assert int(zero_kept.sum()) >= 4
    grad_o, grad_x = grads["cuda"][:2]
    assert bool((grad_o[zero_kept] != 0).all())
    torch.testing.assert_close(grad_o, torch.where(
        kept, grad_x * fr.keep_scale(rate), 0.0), rtol=0, atol=0)
    for name, a, r in zip(("do", "dx", "dscale", "dbias"), grads["cuda"],
                          grads["cpu"]):
        _assert_close(a, r, "float32", name)


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


# ------------------------------- hidden-dropout masks (rows 9 and 14)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [SERVING] + ODD,
                         ids=lambda s: "x".join(map(str, s)))
def test_hidden_mask_attention_matches_row_5(cuda_device, dtype, shape):
    """Row 9 against row 5's kernel for the same seed: its output and
    probability mask bit-equal in both dtypes (one body each: tensor cores
    in bf16, CUDA cores in fp32) and, in bf16, its output also to row 3's
    on the same operands in the natural layout (one tensor-core body, two
    addressings); against its twin; its hidden masks [B, Lq, H·D]
    bit-equal to the twin's hash."""
    from volta_tpu_torch.ops import attention_head_major_cuda as ahm
    from volta_tpu_torch.ops import attention_hidden_mask_cuda as ahc
    from volta_tpu_torch.ops import dropout_mask as dm

    b, lq, lk, h, d = shape
    q3, k3, v3, bias, _ = _inputs(shape, dtype, cuda_device, seed=9)
    q, k, v = (_head_major(x, h) for x in (q3, k3, v3))
    seed, scale = 0xC0DE + lq, d ** -0.5
    before = LAUNCHES["attention_dropout_hidden_masks_fwd"]
    out, mask, hm0, hm1 = ahc.attention_dropout_hidden_masks_fwd(
        q, k, v, bias, scale, RATE, seed, RATE, seed + 1, seed + 2)
    torch.cuda.synchronize()
    assert LAUNCHES["attention_dropout_hidden_masks_fwd"] == before + 1
    out5, mask5 = ahm.attention_dropout_head_major_fwd(q, k, v, bias, scale,
                                                       RATE, seed)
    assert torch.equal(mask, mask5)
    assert torch.equal(out, out5)
    if dtype == "bfloat16":
        out3 = adc.attention_dropout_fwd(q3, k3, v3, bias, scale, h, RATE,
                                         seed)
        assert torch.equal(out.permute(1, 2, 0, 3).reshape(q3.shape), out3)
    ref, rmask, r0, r1 = ahc.attention_dropout_hidden_masks_fwd_ref(
        q, k, v, bias, scale, RATE, seed, RATE, seed + 1, seed + 2)
    _assert_close(out, ref, dtype, "row 9 out")
    assert torch.equal(mask, rmask)
    assert hm0.shape == (b, lq, h * d) and hm0.dtype == torch.uint8
    assert torch.equal(hm0, r0) and torch.equal(hm1, r1)
    assert torch.equal(hm0, dm.keep_mask_ref(hm0.shape, RATE, seed + 1,
                                             cuda_device))


@pytest.mark.cuda
def test_hidden_mask_function_takes_the_kernels(cuda_device):
    """dropout_attention_hidden_masks launches row 9 forward and row 6
    backward once each, and agrees with its CPU twin path: the output, the
    gradients and the masks."""
    from volta_tpu_torch.ops.attention import dropout_attention_hidden_masks

    b, l, h, d = 4, 60, 12, 64
    rng = np.random.RandomState(8)
    qkv = [torch.from_numpy(rng.randn(b, l, h, d).astype(np.float32))
           for _ in range(3)]
    bias = torch.zeros(b, 1, 1, l)
    bias[2, ..., 40:] = -10000.0
    res = []
    for dev in ("cpu", "cuda"):
        x = [t.to(dev).detach().requires_grad_() for t in qkv]
        before = dict(LAUNCHES)
        out, hm0, hm1 = dropout_attention_hidden_masks(
            *x, bias.to(dev), d ** -0.5, RATE, RATE, (11, 12, 13))
        out.square().sum().backward()
        launched = {n: LAUNCHES[n] - c for n, c in before.items()
                    if LAUNCHES[n] != c}
        assert launched == ({} if dev == "cpu" else {
            "attention_dropout_hidden_masks_fwd": 1,
            "attention_dropout_head_major_bwd": 1})
        res.append([out.detach().cpu(), hm0.cpu(), hm1.cpu()]
                   + [t.grad.cpu() for t in x])
    cpu, gpu = res
    assert torch.equal(gpu[1], cpu[1]) and torch.equal(gpu[2], cpu[2])
    for a, r in zip(gpu[:1] + gpu[3:], cpu[:1] + cpu[3:]):
        _assert_close(a, r, "float32", "row 9 Function")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(15360, 768), (7, 768), (33, 100), (5,),
                                   (3, 14, 128), (1,)],
                         ids=lambda s: "x".join(map(str, s)))
def test_keep_mask_kernel_matches_twin(cuda_device, shape):
    """Row 14 bit-equal to its twin, with its 16-byte stores and the bytes
    past the last 16; keep fraction 0.9 +- 0.005 at the train shape."""
    from volta_tpu_torch.ops import dropout_mask as dm

    before = LAUNCHES["keep_mask"]
    got = dm.keep_mask(shape, RATE, 0xABCD, cuda_device)
    torch.cuda.synchronize()
    assert LAUNCHES["keep_mask"] == before + 1
    ref = dm.keep_mask_ref(shape, RATE, 0xABCD, cuda_device)
    assert got.dtype == torch.uint8 and torch.equal(got, ref)
    if got.numel() > 10**6:
        assert abs(float(got.float().mean()) - (1 - RATE)) < 0.005


# ------------------------------------------------- hash dropout (K10)
# the b256 train step's dropout sites: a sublayer tail [256·60, 768], the
# text and image embeddings [256, 23 | 36, 768] and the pooled output
# [256, 1024]; odd sizes that leave a scalar tail
K10_SHAPES = [(15360, 768), (256, 23, 768), (256, 36, 768), (256, 1024),
              (7, 13), (3, 5, 37), (1,)]


def _bits(t):
    """The raw bits of a bf16 or float32 tensor, on the CPU."""
    return t.detach().cpu().view(torch.int16 if t.dtype == torch.bfloat16
                                 else torch.int32)


def _assert_same_bits(got, ref, what):
    """Bit for bit, +0 and -0 apart; NaN at the same places (a NaN's
    payload is the card's)."""
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    nan = torch.isnan(ref.detach().cpu())
    assert torch.equal(torch.isnan(got.detach().cpu()), nan), what
    differ = (_bits(got) != _bits(ref)) & ~nan
    assert not bool(differ.any()), (what, int(differ.sum()))


def _k10_input(shape, dtype, seed, specials=False):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 3).astype(np.float32)
    if specials:  # NaN, Inf and -0: a dropped one writes +0, as where()
        flat = x.reshape(-1)
        flat[::5] = np.nan
        flat[1::5] = np.inf
        flat[2::5] = -0.0
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_hash_dropout_divides_as_the_cpu(cuda_device, dtype):
    """The card's hash dropout (K10), its plain twin and ``apply_keep_mask``
    equal the same calls on the CPU bit for bit at a sublayer tail's shape,
    rate 0.1: every kept value divided by 1 - rate in x's dtype, as JAX
    divides (volta_tpu/models/layers.py:255). A Python float divisor takes
    CUDA's reciprocal-multiply path, which moves last bits."""
    from volta_tpu_torch.models.layers import apply_keep_mask, hash_dropout
    from volta_tpu_torch.ops import hash_dropout as hd

    x = _k10_input((15360, 768), dtype, 31)
    keep = torch.from_numpy(np.random.RandomState(32).rand(15360, 768) > 0.1)
    xc, kc = x.to(cuda_device), keep.to(cuda_device)
    calls = {"hash_dropout": lambda t, k: hash_dropout(t, 0xD1CE, RATE),
             "hash_dropout_ref": lambda t, k: hd.hash_dropout_ref(
                 t, 0xD1CE, RATE),
             "apply_keep_mask": lambda t, k: apply_keep_mask(t, k, RATE)}
    counts = {name: int((_bits(fn(xc, kc)) != _bits(fn(x, keep))).sum())
              for name, fn in calls.items()}
    assert counts == dict.fromkeys(calls, 0), counts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", K10_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_hash_dropout_kernel_matches_twin(cuda_device, dtype, shape):
    """K10 forward and backward against the CPU twin of the same inputs,
    bit for bit (NaN, Inf and -0 among them); one launch each; keep
    fraction 0.9 +- 0.005 at the tail's shape."""
    from volta_tpu_torch.ops import hash_dropout as hd

    seed = 0xF00D + len(shape)
    x = _k10_input(shape, dtype, 33, specials=shape == (3, 5, 37))
    g = _k10_input(shape, dtype, 34)
    before = (LAUNCHES["hash_dropout_fwd"], LAUNCHES["hash_dropout_bwd"])
    out = hd.hash_dropout_fwd(x.to(cuda_device), seed, RATE)
    dx = hd.hash_dropout_bwd(g.to(cuda_device), seed, RATE)
    torch.cuda.synchronize()
    assert (LAUNCHES["hash_dropout_fwd"], LAUNCHES["hash_dropout_bwd"]) == \
        (before[0] + 1, before[1] + 1)
    _assert_same_bits(out, hd.hash_dropout_ref(x, seed, RATE), "forward")
    _assert_same_bits(dx, hd.hash_dropout_ref(g, seed, RATE), "backward")
    if out.numel() > 10**6:
        frac = float((out != 0).float().mean())
        assert abs(frac - (1 - RATE)) <= 0.005, frac


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("offset", range(8))
def test_hash_dropout_kernel_takes_misaligned_views(cuda_device, dtype,
                                                    offset):
    """K10 on a contiguous view that starts ``offset`` elements past a
    16-byte boundary, and on a non-contiguous view (made contiguous
    first): equal to the CPU twin of the same values bit for bit, forward
    and backward."""
    from volta_tpu_torch.ops import hash_dropout as hd

    n = 4099  # odd: a head, vectors and a tail
    base = _k10_input((n + 8,), dtype, 35).to(cuda_device)
    x = base[offset:offset + n]
    assert x.data_ptr() % 16 == offset * x.element_size() % 16
    for t in (x, base[:2 * 2049].view(2, 2049).t()):
        out = hd.hash_dropout_fwd(t, 77, RATE)
        dx = hd.hash_dropout_bwd(t, 77, RATE)
        ref = hd.hash_dropout_ref(t.cpu(), 77, RATE)
        assert out.is_contiguous()
        _assert_same_bits(out, ref, f"forward at offset {offset}")
        _assert_same_bits(dx, ref, f"backward at offset {offset}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_hash_dropout_function_takes_the_kernel(cuda_device, dtype):
    """models.layers.hash_dropout (the HashDropout Function) launches K10
    once forward and once backward, and its output and gradient equal
    autograd's through the twin on the CPU bit for bit; a sublayer tail of
    the LayerNorm module without flags goes through it."""
    from volta_tpu_torch.models.layers import LayerNorm, hash_dropout
    from volta_tpu_torch.ops import hash_dropout as hd

    x = _k10_input((4, 60, 768), dtype, 36)
    g = _k10_input((4, 60, 768), dtype, 37)
    xc = x.to(cuda_device).requires_grad_()
    before = dict(LAUNCHES)
    out = hash_dropout(xc, 1234, RATE)
    out.backward(g.to(cuda_device))
    launched = {k: LAUNCHES[k] - c for k, c in before.items()
                if LAUNCHES[k] != c}
    assert launched == {"hash_dropout_fwd": 1, "hash_dropout_bwd": 1}
    xr = x.clone().requires_grad_()
    ref = hd.hash_dropout_ref(xr, 1234, RATE)
    ref.backward(g)
    _assert_same_bits(out, ref, "output")
    _assert_same_bits(xc.grad, xr.grad, "gradient")
    ln = LayerNorm(768).to(cuda_device)
    before = dict(LAUNCHES)
    ln(xc, residual=xc.detach(), drop_rate=RATE, seed=5).sum().backward()
    assert {k: LAUNCHES[k] - c for k, c in before.items()
            if LAUNCHES[k] != c} == launched


# --------------------------------------------- probe matmuls (rows 15-16)
def _mm_inputs(shape, device, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy((rng.randn(*s) * 0.5).astype(np.float32)).to(
        device, torch.bfloat16) for s in shape]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,f", [(15360, 768, 3072), (1000, 100, 300),
                                   (17, 5, 9), (64, 128, 256),
                                   (1000, 104, 296)])
def test_wgrad_kernel_matches_twin(cuda_device, n, h, f):
    """Row 15 against its twin (float32 products of the same bf16 values):
    the tensor cores round each 16-deep partial sum in float32, so the
    error is held to one float32 rounding (2^-22 of the largest value) per
    16 of the n-long sum, at least 1e-5 of it."""
    from volta_tpu_torch.ops import matmul as mm

    g, a = _mm_inputs([(n, h), (n, f)], cuda_device, seed=n)
    before = LAUNCHES["wgrad"]
    got = mm.wgrad(g, a)
    torch.cuda.synchronize()
    assert LAUNCHES["wgrad"] == before + 1
    ref = mm.wgrad_ref(g, a)
    assert got.dtype == torch.float32 and got.shape == (h, f)
    top = float(ref.abs().max())
    tol = max(1e-5, 2.0 ** -22 * -(-n // 16)) * top
    assert float((got - ref).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("act", [True, False], ids=["gelu", "bias_only"])
@pytest.mark.parametrize("n,k,m", [(15360, 768, 3072), (15360, 3072, 768),
                                   (1000, 100, 300), (17, 40, 9),
                                   (1000, 40, 200)])
def test_matmul_bias_act_kernel_matches_twin(cuda_device, n, k, m, act):
    """Row 16 against its twin: bf16 outputs within two bf16 ulps of the
    largest value."""
    from volta_tpu_torch.ops import matmul as mm

    x, w, b = _mm_inputs([(n, k), (k, m), (1, m)], cuda_device, seed=k)
    w = w * (k ** -0.5)
    before = LAUNCHES["matmul_bias_act"]
    got = mm.matmul_bias_act(x, w, b, act)
    torch.cuda.synchronize()
    assert LAUNCHES["matmul_bias_act"] == before + 1
    _assert_close(got, mm.matmul_bias_act_ref(x, w, b, act), "bfloat16",
                  "row 16")


# (row, shape, body): the Hopper body where TMA can read every operand
# (rows of 16-byte multiples), ragged against its tiles or not; the mma.sync
# body at the other ragged shapes
BODIES = [("wgrad", (15360, 768, 3072), "wgmma"),
          ("wgrad", (1000, 104, 296), "wgmma"),
          ("wgrad", (64, 128, 256), "wgmma"),
          ("wgrad", (1000, 100, 300), "mma.sync"),
          ("wgrad", (17, 5, 9), "mma.sync"),
          ("matmul_bias_act", (15360, 768, 3072), "wgmma"),
          ("matmul_bias_act", (15360, 3072, 768), "wgmma"),
          ("matmul_bias_act", (1000, 40, 200), "wgmma"),
          ("matmul_bias_act", (1000, 100, 300), "mma.sync"),
          ("matmul_bias_act", (17, 40, 9), "mma.sync")]


def _profiled_kernel_names(call, row, active=3, tries=3):
    """The kernel names the profiler records over ``active`` calls of
    ``call``, after one warm-up call inside the same profiler context: a
    profiler's first short launch can be missing from its records. A
    session that records no device kernel at all (the host's
    ``cudaLaunchKernel`` alone) is tried again, up to ``tries`` sessions;
    one with device records is judged as it is. The port's own count of
    ``row``'s launches must agree that every call launched."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(tries):
        events = []
        before = LAUNCHES[row]
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=active,
                                       repeat=1),
                     on_trace_ready=lambda p: events.extend(
                         p.key_averages())) as prof:
            for _ in range(1 + active):
                call()
                torch.cuda.synchronize()
                prof.step()
        assert LAUNCHES[row] == before + 1 + active
        if any(e.device_type == torch.autograd.DeviceType.CUDA
               for e in events):
            break
    return " ".join(e.key for e in events)


def _body_call(row, shape, device):
    from volta_tpu_torch.ops import matmul as mm

    n, k, m = shape
    if row == "wgrad":
        ops = _mm_inputs([(n, k), (n, m)], device, seed=n)
        return mm.matmul_body(*ops), lambda: mm.wgrad(*ops)
    ops = _mm_inputs([(n, k), (k, m), (1, m)], device, seed=k)
    return mm.matmul_body(*ops), lambda: mm.matmul_bias_act(*ops, True)


@pytest.mark.cuda
@pytest.mark.parametrize("row,shape,body", BODIES)
def test_matmul_runs_the_body_its_rule_gives(cuda_device, row, shape, body):
    """``matmul_body`` names the body, and the profiler shows that body's
    kernel and not the other's: no operand set that the rule gives to the
    Hopper body runs the mma.sync body."""
    rule, call = _body_call(row, shape, cuda_device)
    assert rule == body
    call()
    torch.cuda.synchronize()
    names = _profiled_kernel_names(call, row)
    assert ("wgmma_kernel" in names) == (body == "wgmma"), names
    assert ("matmul_kernel" in names) == (body == "mma.sync"), names


@pytest.mark.cuda
def test_body_profiler_harness_repeats(cuda_device):
    """The harness of ``test_matmul_runs_the_body_its_rule_gives`` at the
    shape whose single profiled call came back without its kernel now and
    then: 20 profiler contexts in a row each see the mma.sync body's
    kernel."""
    rule, call = _body_call("matmul_bias_act", (17, 40, 9), cuda_device)
    assert rule == "mma.sync"
    for _ in range(20):
        names = _profiled_kernel_names(call, "matmul_bias_act")
        assert "matmul_kernel" in names and "wgmma_kernel" not in names, \
            names


@pytest.mark.cuda
def test_wgrad_split_sums_are_deterministic(cuda_device):
    """Row 15 at the probes' shape sums its partial tiles in a fixed order
    without float atomics: two calls equal to the bit."""
    from volta_tpu_torch.ops import matmul as mm

    g, a = _mm_inputs([(15360, 768), (15360, 3072)], cuda_device, seed=5)
    assert mm.matmul_body(g, a) == "wgmma"
    first = mm.wgrad(g, a)
    second = mm.wgrad(g, a)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# ---------------------------------------- remat_ff and the int threshold
SMALL_TASK = {"TASK1": {"type": "VL-classifier", "num_labels": 9,
                        "process": "normal", "loss": "BCEWithLogitLoss"}}


def _small_model(device, **fields):
    """ctrl_uniter_base's plan (12 layers) at hidden 128 (2 heads of 64),
    FFN 256, in bf16, random weights from a seed."""
    import dataclasses
    import os

    from volta_tpu_torch import VoltaForVLTasks
    from volta_tpu_torch.config import VoltaConfig
    from volta_tpu_torch.models.layers import init_weights

    cfg = VoltaConfig.from_json_file(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs", "ctrl_uniter_base.json"))
    cfg = dataclasses.replace(cfg, **{
        "hidden_size": 128, "v_hidden_size": 128, "num_attention_heads": 2,
        "v_num_attention_heads": 2, "intermediate_size": 256,
        "v_intermediate_size": 256, "pooler_size": 128,
        "v_pooler_size": 128, "clf_hidden_size": 96,
        "compute_dtype": "bfloat16", **fields})
    model = VoltaForVLTasks(cfg, SMALL_TASK, ("TASK1",))
    init_weights(model, torch.Generator().manual_seed(0))
    return model.to(device).train()


def _small_batch(device, b=8, lt=23, lv=36, feat=2048):
    rng = np.random.RandomState(4)
    t_mask = np.ones((b, lt), np.int64)
    t_mask[1, 9:] = 0
    target = np.zeros((b, 9), np.float32)
    target[np.arange(b), rng.randint(0, 9, b)] = 1.0
    arrays = {"question": rng.randint(1, 1000, (b, lt)) * t_mask,
              "features": rng.randn(b, lv, feat).astype(np.float32),
              "spatials": rng.rand(b, lv, 5).astype(np.float32),
              "segment_ids": np.zeros((b, lt), np.int64),
              "input_mask": t_mask, "image_mask": np.ones((b, lv), np.int64),
              "target": target}
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def _loss_and_grads(model, batch, seed):
    """The loss and every gradient of one training forward and backward,
    with torch's default algorithms: the token-type table sums its
    gradient in a fixed order (``models.layers._SmallTableLookup``)."""
    from volta_tpu_torch.task_utils import process_batch, \
        task_loss_and_score

    tc = SMALL_TASK["TASK1"]
    inputs, info = process_batch(tc, batch)
    pred = model(inputs["input_ids"], inputs["image_feat"],
                 inputs["image_loc"], "TASK1", inputs["token_type_ids"],
                 inputs["attention_mask"], inputs["image_attention_mask"],
                 dropout_seed=seed)
    loss, _ = task_loss_and_score(tc["type"], pred, batch, info, tc["loss"])
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [
    {}, {"use_pallas_layernorm": True, "use_fused_residual_ln": True},
    {"use_pallas_dropout_mask": True}], ids=["default", "ln", "keep_mask"])
def test_remat_step_is_bit_equal_on_the_card(cuda_device, flags):
    """remat_ff recomputes the 12 feed-forwards: the loss and every
    gradient bit-equal to the plain step's; the recomputation replays each
    tail's K10 or row 12 forward; row 14 is gated off under remat_ff."""
    from volta_tpu_torch.ops import reset_launches

    batch = _small_batch(cuda_device)
    runs = {}
    for remat in (False, True):
        model = _small_model(cuda_device, remat_ff=remat, **flags)
        reset_launches()
        runs[remat] = _loss_and_grads(model, batch, seed=21) + (
            dict(LAUNCHES),)
    (l0, g0, c0), (l1, g1, c1) = runs[False], runs[True]
    assert torch.isfinite(l0) and torch.equal(l0, l1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    if "use_fused_residual_ln" in flags:
        moved = "dropout_residual_ln_fwd"
        assert c0[moved] == 24 and c0["hash_dropout_fwd"] == 3
    elif "use_pallas_dropout_mask" in flags:
        assert c0["keep_mask"] == 24 and c1["keep_mask"] == 0
        moved = "hash_dropout_fwd"
        assert c0[moved] == 3
        assert c1[moved] == 27 + 12 and c1["hash_dropout_bwd"] == 27
        return
    else:
        moved = "hash_dropout_fwd"
        assert c0[moved] == 27
    assert c1 == dict(c0, **{moved: c0[moved] + 12})


@pytest.mark.cuda
def test_int_threshold_on_the_card(cuda_device):
    """The draws come from a generator on the card, seeded by the site's
    seed: the same seed the same output; keep fraction 0.9; the tails of a
    ``use_hash_dropout: false`` step launch no K10 and it repeats to the
    bit."""
    from volta_tpu_torch.models import layers
    from volta_tpu_torch.ops import reset_launches

    x = torch.ones(15360, 768, device=cuda_device, dtype=torch.bfloat16)
    a = layers.int_threshold_dropout(x, 7, 0.1)
    assert torch.equal(a, layers.int_threshold_dropout(x, 7, 0.1))
    keep = float((a != 0).float().mean())
    assert abs(keep - 0.9) <= 0.005, keep
    assert torch.equal(a[a != 0], torch.full_like(a[a != 0], 1 / 0.8984375))

    batch = _small_batch(cuda_device)
    model = _small_model(cuda_device, use_hash_dropout=False)
    reset_launches()
    first = _loss_and_grads(model, batch, seed=5)
    assert LAUNCHES["hash_dropout_fwd"] == LAUNCHES["hash_dropout_bwd"] == 3
    second = _loss_and_grads(model, batch, seed=5)
    assert torch.equal(first[0], second[0])
    for n in first[1]:
        assert torch.equal(first[1][n], second[1][n]), n


# the (B, L) rows 1-4 take on the task paths (chip_smoke.py phase 16):
# NLVR2 eval (512 pairs, 40 + 37 tokens) and train (64 pairs), retrieval
# eval and train (64 x 4 ways, 30 + 37), refcoco+ train (256, 20 + 37)
TASK_SHAPES = [(1024, 77, 77, 12, 64), (256, 67, 67, 12, 64),
               (256, 57, 57, 12, 64), (128, 77, 77, 12, 64)]


def _hold_rows_1_to_4(shape, dtype, device, frac=True):
    b, lq, lk, h, d = shape
    q, k, v, bias, g = _inputs(shape, dtype, device, seed=lq)
    scale, seed = d ** -0.5, 0xBEEF + lq
    out1 = attention_cuda.attention_fwd(q, k, v, bias, scale, h)
    got2 = attention_cuda.attention_bwd(q, k, v, bias, g, scale, h)
    out3, mask = adc.attention_dropout_fwd(q, k, v, bias, scale, h, RATE,
                                           seed, return_mask=True)
    got4 = adc.attention_dropout_bwd(q, k, v, bias, g, scale, h, RATE, seed)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    ref1 = attention_cuda.attention_fwd_ref(q, k, v, bias, scale, h)
    assert float((out1.float() - ref1.float()).abs().max()) <= tol
    ref2 = attention_cuda.attention_bwd_ref(q, k, v, bias, g, scale, h,
                                            False)
    for name, a, r in zip(("dq", "dk", "dv"), got2, ref2):
        _assert_close(a, r, dtype, "row 2 " + name)
    keep = adc.keep_mask(seed, (b, h, lq, lk), RATE, device=device)
    assert torch.equal(mask, keep)
    ref3 = adc.attention_dropout_fwd_ref(q, k, v, bias, scale, h, RATE, keep)
    assert float((out3.float() - ref3.float()).abs().max()) <= tol
    ref4 = adc.attention_dropout_bwd_ref(q, k, v, bias, g, scale, h, RATE,
                                         keep)
    for name, a, r in zip(("dq", "dk", "dv"), got4, ref4):
        _assert_close(a, r, dtype, "row 4 " + name)
    if frac:
        frac = float(mask.float().mean())
        assert abs(frac - (1 - RATE)) <= 0.005, frac


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", TASK_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_rows_1_to_4_at_the_task_lengths(cuda_device, dtype, shape):
    """Rows 1-4 at odd L = Lq = Lk 77, 67, 57 against their twins: the
    forwards within 2e-2 (bf16) / 1e-5, the backwards within two bf16 ulps
    of the largest value (fp32 1e-5 relative), row 3's mask bit-equal to
    the hash, its keep fraction 0.9 +- 0.005."""
    _hold_rows_1_to_4(shape, dtype, cuda_device)


# the (Lq, Lk) of the dual-stream families' cross-attention (chip_smoke.py
# phase 18): ViLBERT's 23 text tokens and 37 regions (36 and the global
# feature) both ways, LXMERT's 20 and 36; 12 heads of 64 and vilbert_base's
# 8 heads of 128
FAMILY_SHAPES = [(b, lq, lk, h, d) for b, (lq, lk) in zip(
    (3, 2, 4, 2), ((23, 37), (37, 23), (20, 36), (36, 20)))
    for h, d in ((12, 64), (8, 128))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", FAMILY_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_rows_1_to_4_at_the_family_lengths(cuda_device, dtype, shape):
    """Rows 1-4 at the families' Lq != Lk, D 64 and 128, against their
    twins as at the task lengths, row 3's mask bit-equal to the hash."""
    _hold_rows_1_to_4(shape, dtype, cuda_device, frac=False)


HEADS_TASK = {
    "TASK10": {"type": "V-logit", "process": "normal",
               "loss": "BCEWithLogitLoss"},
    "TASK12": {"type": "VL-binary-classifier", "num_labels": 2,
               "process": "nlvr", "loss": "BCEWithLogitLoss"},
}


def _heads_batch(task, b=2, lt=8, lv=6, feat=2048):
    """A small numpy batch in the layout of ``task``'s dataset: NLVR2's
    two images on one region axis; refcoco+'s region targets, one row's
    last two regions padded."""
    rng = np.random.RandomState(8)
    nv = 2 * lv if task == "TASK12" else lv
    v_mask = np.ones((b, nv), np.int64)
    v_mask[1, nv - 2:] = 0
    target = (np.eye(2, dtype=np.float32)[[0, 1]] if task == "TASK12"
              else rng.rand(b, nv, 1).astype(np.float32))
    return {"question": rng.randint(1, 1000, (b, lt)),
            "features": rng.randn(b, nv, feat).astype(np.float32),
            "spatials": rng.rand(b, nv, 5).astype(np.float32),
            "segment_ids": np.zeros((b, lt), np.int64),
            "input_mask": np.ones((b, lt), np.int64),
            "image_mask": v_mask, "target": target}


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["TASK10", "TASK12"],
                         ids=["v_logit", "nlvr2"])
def test_task_heads_on_the_card_equal_the_cpu(cuda_device, task):
    """ctrl_uniter_base with the V-logit and the NLVR2 head: the nlvr
    pairing on the card equal to the CPU's bit for bit; the fp32 logits on
    the card within 1e-4 of the CPU's; in bf16 the padded regions' logits
    are -10000 rounded to bf16 (-9984) on both."""
    import copy
    import os

    from volta_tpu_torch import VoltaForVLTasks
    from volta_tpu_torch.config import VoltaConfig
    from volta_tpu_torch.eval_step import make_task_eval_step, to_device
    from volta_tpu_torch.models.layers import init_weights
    from volta_tpu_torch.task_utils import process_batch

    batch = _heads_batch(task)
    cpu_in, cpu_info = process_batch(
        HEADS_TASK[task], to_device(batch, "cpu"))
    card_in, card_info = process_batch(
        HEADS_TASK[task], to_device(batch, cuda_device))
    assert card_info == cpu_info
    for k in cpu_in:
        assert torch.equal(card_in[k].cpu(), cpu_in[k]), k
    if task == "TASK12":
        assert torch.equal(card_in["input_ids"][0::2],
                           card_in["input_ids"][1::2])
    for dtype in ("float32", "bfloat16"):
        cfg = VoltaConfig.from_json_file(os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "configs", "ctrl_uniter_base.json"))
        cfg.compute_dtype = dtype
        model = VoltaForVLTasks(cfg, HEADS_TASK, (task,))
        init_weights(model, torch.Generator().manual_seed(3))
        cpu = make_task_eval_step(model.eval(), HEADS_TASK, task)(batch)
        card_model = copy.deepcopy(model).to(cuda_device)
        card = make_task_eval_step(card_model, HEADS_TASK, task)(batch)
        got, want = card["prediction"].cpu(), cpu["prediction"]
        assert got.dtype == want.dtype and got.shape == want.shape
        assert bool(torch.isfinite(got).all())
        if dtype == "float32":
            assert float((got - want).abs().max()) <= 1e-4
        elif task == "TASK10":
            pad = torch.from_numpy(batch["image_mask"] == 0)
            for pred in (got, want):
                assert torch.equal(pred[..., 0][pad], torch.full(
                    (int(pad.sum()),), -9984.0, dtype=torch.bfloat16))
        del card_model


@pytest.mark.cuda
def test_token_type_gradient_repeats_without_the_global_switch(cuda_device):
    """The token-type table's gradient at the b256 train shape (256 x 60
    tokens on 2 rows) is the same over two runs with torch's default
    algorithms, and within float32 rounding of an ``index_add_``."""
    from volta_tpu_torch.models.layers import Embed

    assert not torch.are_deterministic_algorithms_enabled()
    table = Embed(2, 768, 0.02, fixed_order_grad=True).to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    ids = torch.randint(0, 2, (256, 60), generator=gen, device=cuda_device)
    g = torch.randn(256, 60, 768, generator=gen, device=cuda_device)
    grads = []
    for _ in range(2):
        table(ids).backward(g)
        grads.append(table.weight.grad.clone())
        table.weight.grad = None
    assert torch.equal(grads[0], grads[1])
    want = torch.zeros_like(table.weight).index_add_(
        0, ids.reshape(-1), g.reshape(-1, 768))
    torch.testing.assert_close(grads[0], want, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_plain_route_runs_on_the_card(cuda_device, mode):
    """``use_pallas: false`` on the card: no attention kernel launches (the
    tails' K10 does in training), the eval logits within 1e-4 of the same
    fp32 model on the CPU, and a training step finite and repeatable to
    the bit with the default algorithms."""
    import copy

    from volta_tpu_torch.eval_step import make_task_eval_step
    from volta_tpu_torch.ops import reset_launches

    batch = _small_batch(cuda_device)
    attention = [k for k in LAUNCHES if k.startswith("attention")]
    reset_launches()
    if mode == "eval":
        model = _small_model(cuda_device, use_pallas=False,
                             compute_dtype="float32").eval()
        card = make_task_eval_step(model, SMALL_TASK, "TASK1")(batch)
        cpu = copy.deepcopy(model).cpu()
        want = make_task_eval_step(cpu, SMALL_TASK, "TASK1")(
            {k: v.cpu() for k, v in batch.items()})
        assert bool(torch.isfinite(card["prediction"]).all())
        assert float((card["prediction"].cpu() - want["prediction"])
                     .abs().max()) <= 1e-4
        assert all(LAUNCHES[k] == 0 for k in LAUNCHES)
        return
    model = _small_model(cuda_device, use_pallas=False)
    first = _loss_and_grads(model, batch, seed=3)
    assert all(LAUNCHES[k] == 0 for k in attention)
    assert LAUNCHES["hash_dropout_fwd"] == LAUNCHES["hash_dropout_bwd"] == 27
    second = _loss_and_grads(model, batch, seed=3)
    assert torch.isfinite(first[0]) and torch.equal(first[0], second[0])
    for n in first[1]:
        assert torch.equal(first[1][n], second[1][n]), n


# ------------------------------------------------------ the other families
SMALL_WIDTHS = {"hidden_size": 128, "v_hidden_size": 128,
                "num_attention_heads": 2, "v_num_attention_heads": 2,
                "intermediate_size": 256, "v_intermediate_size": 256,
                "pooler_size": 128, "v_pooler_size": 128,
                "clf_hidden_size": 96}


def _family_model(name, dtype, **fields):
    """``configs/<name>.json``'s plan at SMALL_WIDTHS (vilbert_base's wide
    vision stream and co-attention at 256, 2 heads of 128), random weights
    from a seed, on the CPU."""
    import dataclasses
    import os

    from volta_tpu_torch import VoltaForVLTasks
    from volta_tpu_torch.config import VoltaConfig
    from volta_tpu_torch.models.layers import init_weights

    cfg = VoltaConfig.from_json_file(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs", name + ".json"))
    widths = dict(SMALL_WIDTHS, compute_dtype=dtype, **fields)
    if name == "vilbert_base":
        widths.update(
            v_hidden_size=256, v_intermediate_size=256,
            sublayer2attn_hidden_size={
                k: 256 for k in cfg.sublayer2attn_hidden_size},
            sublayer2num_attention_heads={
                k: 2 for k in cfg.sublayer2num_attention_heads})
    cfg = dataclasses.replace(cfg, **widths)
    model = VoltaForVLTasks(cfg, SMALL_TASK, ("TASK1",))
    return init_weights(model, torch.Generator().manual_seed(5)), cfg


def _streams(cfg):
    """Attention launches a forward: one a query stream of each attention
    sublayer, one a sublayer on the single-stream families' fused loop."""
    plan = [s for s in cfg.sublayer_plan() if s.kind == "attn"]
    if all(s.single_ln for s in plan):
        return len(plan)
    return sum(s.has_text + s.has_vision for s in plan)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ctrl_vilbert_base", "vilbert_base",
                                  "ctrl_lxmert", "vl-bert_base"])
def test_families_on_the_card_equal_the_cpu(cuda_device, name):
    """Each family's plan at small widths: the fp32 eval logits on the card
    (row 1 once a query stream) within 1e-4 of the same model's on the
    CPU; a bf16 training forward and backward with the config's dropout
    runs rows 3 and 4 once a stream, finite."""
    import copy

    from volta_tpu_torch.eval_step import make_task_eval_step
    from volta_tpu_torch.ops import reset_launches

    fusion = {"fusion_method": "vl-bert_vqa"} if name == "vl-bert_base" \
        else {}
    batch = _small_batch(cuda_device)
    model, cfg = _family_model(name, "float32", **fusion)
    n = _streams(cfg)
    want = make_task_eval_step(model.eval(), SMALL_TASK, "TASK1")(
        {k: v.cpu() for k, v in batch.items()})["prediction"]
    card_model = copy.deepcopy(model).to(cuda_device)
    reset_launches()
    got = make_task_eval_step(card_model, SMALL_TASK, "TASK1")(batch)[
        "prediction"]
    torch.cuda.synchronize()
    assert LAUNCHES["attention_fwd"] == n
    assert bool(torch.isfinite(got).all())
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    model, _ = _family_model(name, "bfloat16", **fusion)
    model = model.to(cuda_device).train()
    reset_launches()
    loss, grads = _loss_and_grads(model, batch, seed=3)
    assert LAUNCHES["attention_dropout_fwd"] == \
        LAUNCHES["attention_dropout_bwd"] == n
    assert LAUNCHES["attention_fwd"] == LAUNCHES["attention_bwd"] == 0
    assert torch.isfinite(loss) and all(
        bool(torch.isfinite(g).all()) for g in grads.values())


# ------------------------------------------------------------------- K8
# the pretraining step's queries (b x 36 regions of 2048) and a small odd
# shape; the b256 one also against the blockwise twin
K8_SHAPES = [(256, 36, 2048, None), (512, 36, 2048, None),
             (256, 36, 2048, 4096), (3, 5, 48, None)]


def _k8_inputs(b, r, d, dtype, device, seed=0):
    from volta_tpu_torch.losses import sample_negatives

    rng = np.random.RandomState(seed)
    dt = getattr(torch, dtype)
    pred = torch.from_numpy((rng.randn(b, r, d) * 0.05).astype(
        np.float32)).to(device, dt)
    flat = torch.from_numpy(np.abs(rng.randn(b * r, d) * 0.5).astype(
        np.float32)).to(device, dt)
    idx = sample_negatives(b, r, 128, torch.Generator(device).manual_seed(
        seed), device)
    g = torch.from_numpy(rng.randn(b, r, idx.shape[-1]).astype(
        np.float32)).to(device)
    return pred, flat, idx, g


def _k8_bodies(dtype):
    return ("tc", "gather") if dtype == "bfloat16" else ("gather",)


@contextlib.contextmanager
def _k8_body(body):
    """K8's wrappers held to one body, "tc" or "gather", whatever the
    shape: ``nce_body``'s crossover moved past every shape or below it."""
    from volta_tpu_torch.ops import nce

    saved = nce.TC_MAX_M_PER_NEG
    nce.TC_MAX_M_PER_NEG = 2 ** 31 if body == "tc" else 0
    try:
        yield
    finally:
        nce.TC_MAX_M_PER_NEG = saved


def _within_one_ulp(got, *refs):
    """Every bf16 score within one bf16 ulp of one of ``refs``' scores."""
    near = torch.zeros_like(got, dtype=torch.bool)
    for ref in refs:
        ulp = torch.exp2(torch.floor(torch.log2(
            ref.abs().clamp_min(torch.finfo(torch.float32).tiny))) - 7)
        near |= (got - ref).abs() <= ulp
    return bool(near.all())


def _hold_k8_scores(got, pred, flat, idx, ref, dtype, body):
    """K8's scores by ``body`` against the float32 twin ``ref``: fp32
    within 1e-5 of the largest; bf16 within 2^-7 of the largest and on the
    other bf16 neighbour than the float64 sums': the gather body (float64
    sums itself) for at most 1 in 10^4 scores; the tensor-core body
    (float32 sums) at most twice as often as the float32 twin or torch's
    bf16 all-pairs product (JAX's composition on the card, float32 sums on
    the tensor cores), and each within one bf16 ulp of that product's or of
    the float64 sums' (not of the twin's: where a sum nearly cancels,
    tensor-core float32 sums land many of its small ulps from the
    twin's)."""
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= (
        1e-5 if dtype == "float32" else 2 ** -7) * scale, body
    if dtype == "float32":
        return
    s64 = torch.gather(torch.matmul(pred.double(), flat.double().t()), -1,
                       idx).float().to(torch.bfloat16).float()
    if body == "gather":
        assert int((got != s64).sum()) <= 1e-4 * got.numel(), body
        return
    lib = torch.gather(torch.matmul(pred, flat.t()), -1, idx).float()
    flips = int((got != s64).sum())
    limit = 2 * max(int((ref != s64).sum()), int((lib != s64).sum()))
    assert flips <= limit, (body, flips, limit)
    assert _within_one_ulp(got, lib, s64), body


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", K8_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:3]))
                         + (f"_chunk{s[3]}" if s[3] else ""))
def test_k8_matches_its_twins(cuda_device, dtype, shape):
    """K8 forward and backward against the dense (or blockwise) twin, by
    each body that takes the dtype (the tensor-core body and the gather
    body in bf16, the gather body in fp32): the scores as
    ``_hold_k8_scores`` holds them; fp32 gradients within 1e-5 of the
    largest, bf16 gradients within 2e-2."""
    from volta_tpu_torch.ops import nce

    b, r, d, chunk = shape
    pred, flat, idx, g = _k8_inputs(b, r, d, dtype, cuda_device)
    ref = nce.neg_scores_ref(pred, flat, idx, chunk)
    dref = nce.nce_scores_bwd_ref(g, pred.shape, flat, idx)
    for body in _k8_bodies(dtype):
        with _k8_body(body):
            got = nce.nce_scores_fwd(pred, flat, idx)
            dgot = nce.nce_scores_bwd(g, pred.shape, flat, idx)
        assert got.dtype == torch.float32 and got.shape == idx.shape
        assert dgot.dtype == pred.dtype and dgot.shape == pred.shape
        _hold_k8_scores(got, pred, flat, idx, ref, dtype, body)
        derr = float((dgot.float() - dref.float()).abs().max()
                     / dref.float().abs().max())
        assert derr <= (1e-5 if dtype == "float32" else 2e-2), body


def _k8_kinds(b, r, device, seed):
    """neg_idx [b, r, 127] of other shapes than the sampler's: uniform with
    repeats, every query's all on one row, and uniform with query 0's all
    out of range and a few others past either end."""
    m = b * r
    gen = torch.Generator(device).manual_seed(seed)
    uniform = torch.randint(0, m, (b, r, 127), generator=gen, device=device)
    bad = uniform.clone()
    bad[0, 0] = m + 5
    bad[1, 2, :3] = torch.tensor([-1, m, 2 * m], device=device)
    return {"uniform": uniform,
            "one_row": torch.full_like(uniform, m // 2),
            "out_of_range": bad}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uniform", "one_row", "out_of_range"])
def test_k8_takes_any_indices(cuda_device, kind):
    """Both bf16 bodies on indices of other shapes than the sampler's: the
    tensor-core body's plan equals its twin, the scores are within 2^-7 of
    the largest and one bf16 ulp of torch's bf16 all-pairs product or the
    float64 sums at the valid indices and NaN at the others, the gradient
    is within 2e-2 of the float64 one with the invalid indices' cotangent
    left out (a query with none in range gets 0)."""
    from volta_tpu_torch.ops import nce

    b, r = 8, 36
    pred, flat, _, _ = _k8_inputs(b, r, 2048, "bfloat16", cuda_device, seed=9)
    idx = _k8_kinds(b, r, cuda_device, seed=4)[kind]
    g = torch.from_numpy(np.random.RandomState(5).randn(*idx.shape).astype(
        np.float32)).to(cuda_device)
    m = flat.shape[0]
    valid = (idx >= 0) & (idx < m)
    plan, twin = nce.nce_plan(idx, m), nce.nce_plan_ref(idx, m)
    e = int(twin.starts[-1])
    assert e == int(valid.sum())
    assert torch.equal(plan.entries[:e], twin.entries[:e])
    assert torch.equal(plan.starts, twin.starts)
    safe = torch.where(valid, idx, torch.zeros_like(idx))
    ref = nce.neg_scores_ref(pred, flat, safe)
    # the gradient in float64 from g rounded to bf16 (the twin adds
    # repeated pairs in bf16, a query's 127 on one row drifting 2e-2)
    q = b * r
    gb = (g * valid).to(torch.bfloat16).double().reshape(q, -1)
    dref = torch.zeros(q, m, dtype=torch.float64, device=cuda_device)
    dref = (dref.scatter_add_(1, safe.reshape(q, -1), gb)
            @ flat.double()).view(pred.shape)
    for body in ("tc", "gather"):
        with _k8_body(body):
            got = nce.nce_scores_fwd(pred, flat, idx)
            dgot = nce.nce_scores_bwd(g, pred.shape, flat, idx)
        assert bool(torch.isnan(got[~valid]).all()), body
        # within 2^-7 of the largest, each within one bf16 ulp of torch's
        # bf16 all-pairs product's or of the float64 sums'
        gv, rv = got[valid], ref[valid]
        assert float((gv - rv).abs().max()) <= 2 ** -7 * float(
            rv.abs().max()), body
        lib = torch.gather(torch.matmul(pred, flat.t()), -1, safe).float()
        s64 = torch.gather(torch.matmul(pred.double(), flat.double().t()),
                           -1, safe).float().to(torch.bfloat16).float()
        assert _within_one_ulp(gv, lib[valid], s64[valid]), body
        derr = float((dgot.float() - dref.float()).abs().max()
                     / dref.float().abs().max())
        assert derr <= 2e-2, body
        if kind == "out_of_range":
            assert bool((dgot[0, 0] == 0).all()), body


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_k8_is_the_same_from_call_to_call(cuda_device, dtype):
    """Every body's forward and backward at the b256 step's shape: two
    calls equal to the bit (the tensor-core body sums repeated pairs and
    tiles in a fixed order, with no float atomics)."""
    from volta_tpu_torch.ops import nce

    pred, flat, idx, g = _k8_inputs(256, 36, 2048, dtype, cuda_device, seed=2)
    for body in _k8_bodies(dtype):
        with _k8_body(body):
            calls = [(nce.nce_scores_fwd(pred, flat, idx),
                      nce.nce_scores_bwd(g, pred.shape, flat, idx))
                     for _ in range(2)]
        assert torch.equal(calls[0][0], calls[1][0]), body
        assert torch.equal(calls[0][1], calls[1][1]), body


@pytest.mark.cuda
def test_k8_b512_takes_the_route_its_rule_gives(cuda_device):
    """At b512 x 36 regions the rule keeps the gather body: the autograd
    Function launches no plan, its forward and backward once each, and
    agrees with the twins."""
    from volta_tpu_torch.ops import nce, reset_launches

    pred, flat, idx, g = _k8_inputs(512, 36, 2048, "bfloat16", cuda_device)
    assert nce.nce_body(idx.numel() // 127, flat.shape[0], 2048,
                        torch.bfloat16, 127) == "gather"
    x = pred.clone().requires_grad_()
    reset_launches()
    got = nce.NCEScores.apply(x, flat, idx)
    got.backward(g)
    assert (LAUNCHES["nce_plan"], LAUNCHES["nce_scores_fwd"],
            LAUNCHES["nce_scores_bwd"]) == (0, 1, 1)
    ref = nce.neg_scores_ref(pred, flat, idx)
    _hold_k8_scores(got.detach(), pred, flat, idx, ref, "bfloat16", "gather")
    dref = nce.nce_scores_bwd_ref(g, pred.shape, flat, idx)
    assert float((x.grad.float() - dref.float()).abs().max()
                 / dref.float().abs().max()) <= 2e-2


# (b, r, dtype, body): the tensor-core body at the b256 step's shape and
# an odd one, the gather body at b512 and in fp32
K8_BODIES = [(256, 36, "bfloat16", "tc"), (3, 5, "bfloat16", "tc"),
             (512, 36, "bfloat16", "gather"), (256, 36, "float32", "gather")]


@pytest.mark.cuda
@pytest.mark.parametrize("b,r,dtype,body", K8_BODIES)
def test_nce_runs_the_body_its_rule_gives(cuda_device, b, r, dtype, body):
    """``nce_body`` names the body, and the profiler shows that body's
    forward kernel and not the other's."""
    from volta_tpu_torch.ops import nce

    d = 2048 if b > 3 else 48
    pred, flat, idx, _ = _k8_inputs(b, r, d, dtype, cuda_device)
    assert nce.nce_body(b * r, flat.shape[0], d, getattr(torch, dtype),
                        idx.shape[-1]) == body
    call = lambda: nce.nce_scores_fwd(pred, flat, idx)  # noqa: E731
    call()
    torch.cuda.synchronize()
    names = _profiled_kernel_names(call, "nce_scores_fwd")
    assert ("nce_tc::fwd_kernel" in names) == (body == "tc"), names
    assert ("nce_scores_fwd_kernel" in names) == (body == "gather"), names


@pytest.mark.cuda
def test_k8_raises_on_what_it_cannot_take(cuda_device):
    """No silent fallback: mixed dtypes, rows that are not whole 16-byte
    vectors and CPU operands raise."""
    from volta_tpu_torch.ops import nce

    pred, flat, idx, _ = _k8_inputs(2, 3, 16, "float32", cuda_device)
    with pytest.raises(ValueError, match="share a dtype"):
        nce.nce_scores_fwd(pred, flat.to(torch.bfloat16), idx)
    odd, oflat, oidx, _ = _k8_inputs(2, 3, 10, "bfloat16", cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        nce.nce_scores_fwd(odd, oflat, oidx)
    with pytest.raises(ValueError, match="CUDA device"):
        nce.nce_scores_fwd(pred, flat.cpu(), idx)
    # an index out of range scores NaN, as JAX's gather fills
    bad = idx.clone()
    bad[0, 0, 0] = flat.shape[0]
    out = nce.nce_scores_fwd(pred, flat, bad)
    assert bool(torch.isnan(out[0, 0, 0])) and bool(
        torch.isfinite(out.view(-1)[1:]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_nce_2048_launches_k8(cuda_device, dtype):
    """nce_2048 on CUDA tensors runs K8 once forward and once backward,
    dense size or blockwise (``score_chunk``), and its loss and gradient
    agree with the CPU twin's for the same negatives."""
    from volta_tpu_torch import losses
    from volta_tpu_torch.ops import reset_launches

    b, r = 8, 6
    pred, feat, idx, _ = _k8_inputs(b, r, 2048, dtype, cuda_device, seed=3)
    feat = feat.view(b, r, -1)
    label = torch.from_numpy(np.where(np.random.RandomState(4).rand(b, r)
                                      < 0.4, 1, -1)).to(cuda_device)
    for chunk in (None, 16):
        p = pred.clone().requires_grad_()
        reset_launches()
        loss = losses.nce_2048(p, 1.0, label, image_feat=feat, neg_idx=idx,
                               score_chunk=chunk)
        loss.backward()
        assert (LAUNCHES["nce_scores_fwd"], LAUNCHES["nce_scores_bwd"]) \
            == (1, 1)
        q = pred.cpu().clone().requires_grad_()
        ref = losses.nce_2048(q, 1.0, label.cpu(), image_feat=feat.cpu(),
                              neg_idx=idx.cpu(), score_chunk=chunk)
        ref.backward()
        tol = 1e-5 if dtype == "float32" else 2e-2
        assert abs(float(loss) - float(ref)) <= tol * abs(float(ref))
        err = float((p.grad.float().cpu() - q.grad.float()).abs().max())
        assert err <= tol * float(q.grad.float().abs().max())


# ---------------------------------------------------------------------- K9
# (M, K, N): the odd shapes of the int8 dense layer: K = num_locs = 5, the
# VL-logit head's N = 1, a ragged M past the 128-row tile, K = 100 (no
# 16-byte rows) and a dispatch's FFN width; then the Hopper body's ragged
# edges: M past its 256-row pair tile, N = 100 and 1 (not multiples of 8:
# the pair and single stores), 264 (past the 256-column tile, 16-byte
# stores), and K = 2048 (the image features')
K9_SHAPES = [(7, 5, 1), (1000, 100, 100), (150_001, 5, 768), (7, 768, 3072),
             (1000, 3072, 768), (150_001, 768, 768), (1000, 768, 100),
             (7, 768, 1), (300, 2048, 768), (1000, 768, 264)]


def _k9_inputs(m, k, n, dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32) * rng.uniform(0.1, 4.0, (m, 1))
    x[m // 2] = 0.0  # a padded row
    w = torch.from_numpy((rng.randn(n, k) * 0.05).astype(np.float32))
    b = torch.from_numpy(rng.randn(n).astype(np.float32))
    return (torch.from_numpy(x.astype(np.float32)).to(device, dtype),
            w.to(device), b.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", K9_SHAPES, ids=lambda s: "x".join(map(
    str, s)))
def test_k9_matches_its_twins_bit_for_bit(cuda_device, shape, dtype, static):
    """K9a's xq and a and K9b's y equal their twins' on the card to the
    bit, dynamic and static, bf16 and float32 in and out; a zero row gives
    a = 1e-12 and xq = 0; one launch each."""
    from volta_tpu_torch.ops import int8_dense as i8

    m, k, n = shape
    x, w, b = _k9_inputs(m, k, n, dtype, cuda_device)
    q, scale = i8.quantize_kernel(w)
    qc, sc = i8.quantize_kernel(w.cpu())
    assert torch.equal(q.cpu(), qc) and torch.equal(scale.cpu(), sc)
    a_static = torch.tensor(float(x.float().abs().max()) / 127 + 1e-12,
                            device=cuda_device) if static else None
    before = dict(LAUNCHES)
    xq, a = i8.int8_quantize(x, a_static)
    rq, ra = i8.quantize_ref(x, a_static)
    assert torch.equal(xq, rq) and torch.equal(a, ra)
    assert int(xq[m // 2].abs().max()) == 0
    if not static:
        assert float(a[m // 2]) == float(np.float32(1e-12))
    for out in (torch.bfloat16, torch.float32):
        y = i8.int8_matmul(xq, a, q, scale, b, out)
        ref = i8.int8_matmul_ref(xq, a, q, scale, b, out)
        assert y.dtype == out and torch.equal(y, ref), (out, (y.float()
                                                            - ref.float())
                                                        .abs().max())
    y0 = i8.int8_matmul(xq, a, q, scale, None, torch.float32)
    assert torch.equal(y0, i8.int8_matmul_ref(xq, a, q, scale, None,
                                              torch.float32))
    assert LAUNCHES["int8_quantize"] - before["int8_quantize"] == 1
    assert LAUNCHES["int8_matmul"] - before["int8_matmul"] == 3
    # the CPU twins give the card's numbers
    cq, ca = i8.quantize_ref(x.cpu(), None if a_static is None
                             else a_static.cpu())
    assert torch.equal(cq, xq.cpu()) and torch.equal(ca, a.cpu())


def _k9_tie_inputs(device):
    """K9b's operands where float64 rounding of the epilogue's exact
    fma(acc, a * scale, bias) lands halfway between two float32 values:
    acc = +-(2^18 - 1), a * scale = (2^18 + 1) 2^-60, so the product is
    +-(2^-24 - 2^-60), and bias +-(1 + 2^-23). Every exact result rounds
    once to +-(1 + 2^-23); rounded through float64 it would go to the even
    neighbour, +-1 or +-(1 + 2^-22)."""
    row = [127] * 17 + [15]
    xq = torch.tensor([row, [-v for v in row]], dtype=torch.int8)
    q = torch.tensor([[127] * 16 + [32, 1]] * 2, dtype=torch.int8)
    a = torch.full((2,), (2 ** 18 + 1) * 2.0 ** -30)
    scale = torch.full((2,), 2.0 ** -30)
    bias = torch.tensor([1 + 2 ** -23, -(1 + 2 ** -23)])
    want = bias[None, :].expand(2, 2)
    return [t.to(device) for t in (xq, a, q, scale, bias, want)]


@pytest.mark.cuda
def test_k9_epilogue_rounds_once_as_its_twin(cuda_device):
    """K9b's single-rounded epilogue and its twin agree on the operands
    where a float64 twin that rounded twice would be one ulp off."""
    from volta_tpu_torch.ops import int8_dense as i8

    xq, a, q, scale, bias, want = _k9_tie_inputs(cuda_device)
    y = i8.int8_matmul(xq, a, q, scale, bias, torch.float32)
    assert torch.equal(y, want)
    assert torch.equal(i8.int8_matmul_ref(xq, a, q, scale, bias,
                                          torch.float32), want)


@pytest.mark.cuda
def test_k9_hopper_epilogue_rounds_once_as_its_twin(cuda_device):
    """The same ties on the Hopper body: the operands zero-padded to K = 32
    (the same sums), at rows and columns spread over a ragged tile."""
    from volta_tpu_torch.ops import int8_dense as i8

    xq, a, q, scale, bias, want = _k9_tie_inputs(cuda_device)
    rows, cols = [0, 77, 200, 299], [0, 9, 130, 263]
    big = torch.zeros(300, 32, dtype=torch.int8, device=cuda_device)
    wq = torch.zeros(264, 32, dtype=torch.int8, device=cuda_device)
    ab = torch.ones(300, device=cuda_device)
    sb = torch.ones(264, device=cuda_device)
    bb = torch.zeros(264, device=cuda_device)
    for i, r in enumerate(rows):
        big[r, :18] = xq[i % 2]
        ab[r] = a[i % 2]
    for j, c in enumerate(cols):
        wq[c, :18] = q[j % 2]
        sb[c] = scale[j % 2]
        bb[c] = bias[j % 2]
    assert i8.int8_body(big, wq) == "wgmma"
    y = i8.int8_matmul(big, ab, wq, sb, bb, torch.float32)
    ref = i8.int8_matmul_ref(big, ab, wq, sb, bb, torch.float32)
    assert torch.equal(y, ref)
    for i, r in enumerate(rows):
        for j, c in enumerate(cols):
            assert float(y[r, c]) == float(want[i % 2, j % 2])


# (shape, body): int8_matmul on the rule's two bodies, the Hopper body at a
# dispatch's FFN1 and at ragged edges
K9_BODIES = [((150_000, 768, 3072), "wgmma"), ((1000, 768, 100), "wgmma"),
             ((7, 768, 1), "wgmma"), ((7, 5, 1), "mma.sync"),
             ((1000, 100, 100), "mma.sync")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,body", K9_BODIES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else v)
def test_int8_matmul_runs_the_body_its_rule_gives(cuda_device, shape, body):
    """``int8_body`` names the body, and the profiler shows that body's
    kernel and not the other's: no operand pair that the rule gives to the
    Hopper body runs the mma.sync body, nor the other way round."""
    from volta_tpu_torch.ops import int8_dense as i8

    m, k, n = shape
    x, w, b = _k9_inputs(m, k, n, torch.bfloat16, cuda_device)
    q, scale = i8.quantize_kernel(w)
    xq, a = i8.int8_quantize(x)
    assert i8.int8_body(xq, q) == body

    def call():
        return i8.int8_matmul(xq, a, q, scale, b, torch.bfloat16)

    call()
    torch.cuda.synchronize()
    # more sessions than the harness's default: a session of this file's
    # full run once recorded no device kernel three times in a row
    names = _profiled_kernel_names(call, "int8_matmul", tries=8)
    assert ("int8_wgmma_kernel" in names) == (body == "wgmma"), names
    assert ("int8_matmul_kernel" in names) == (body == "mma.sync"), names


@pytest.mark.cuda
def test_k9_raises_on_what_it_cannot_take(cuda_device):
    from volta_tpu_torch.ops import int8_dense as i8

    x = torch.randn(4, 8, device=cuda_device)
    with pytest.raises(ValueError, match="2-D"):
        i8.int8_quantize(x.half())
    xq, a = i8.int8_quantize(x)
    q = torch.zeros(3, 8, dtype=torch.int8, device=cuda_device)
    s = torch.ones(3, device=cuda_device)
    with pytest.raises(ValueError, match="int8"):
        i8.int8_matmul(xq, a, q[:, :4], s, None, torch.float32)
    with pytest.raises(ValueError, match="out_dtype"):
        i8.int8_matmul(xq, a, q, s, None, torch.float16)
    with pytest.raises(ValueError, match="CUDA"):
        i8.int8_matmul(xq, a, q.cpu(), s, None, torch.float32)
