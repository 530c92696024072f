"""The hand-written CUDA no-dropout attention, forward
(``csrc/attention_fwd.cu``) and backward (``csrc/attention_bwd.cu``), their
wrappers, their plain twins and the autograd Function over them.

Ports of the TPU kernels behind ``pallas_fused_attention_nat``
(volta_tpu/ops/pallas_attention.py:670-775): ``_attn_kernel_nat_bh``, the
no-dropout joint attention on the natural [B, L, H·D] layout, and
``_attn_bwd_kernel_nat_bh``, its backward. Each runs one of two block
bodies by dtype (``fwd_body``, ``bwd_body``): the tensor-core body for
bf16, the CUDA-core body for fp32. ``attention_fwd`` and
``attention_bwd`` launch the kernels for CUDA tensors and raise on anything
they do not take; for CPU tensors they run ``attention_fwd_ref`` and
``attention_bwd_ref``, the same functions in plain PyTorch. There is no
fallback from the card to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from . import LAUNCHES, _build
from .attention import acc_dtype, attention_out, attention_probs

HEAD_DIMS = (16, 32, 64, 128)
# the CUDA-core bodies (csrc/attention_common.cuh): every float32 forward
# and backward
ROWS_PER_BLOCK = 16  # kRowsPerBlock, the forward's query tile
KEY_CHUNK = 32  # kKeyChunk
BWD_ROWS = 32  # kBwdRows
# the tensor-core bodies of every bf16 forward (rows 1, 3, 5, 7 and 9,
# csrc/attention_fwd_tc.cuh) and of every bf16 backward (rows 2, 4, 6 and
# 8, csrc/attention_bwd_tc.cuh)
TC_ROWS_PER_BLOCK = 64  # kTcRows, their query tile
TC_KEYS = 64  # kTcKeys, their key tile
TC_PAD = 8  # kTcPad, bf16 of padding a shared row
MAX_SMEM_BYTES = 232448  # a Hopper block's dynamic shared memory limit
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _heads4(x, heads):
    b, l, hd = x.shape
    return x.view(b, l, heads, hd // heads)


def attention_fwd_ref(q, k, v, bias, scale, heads):
    """Plain twin: q [B,Lq,H·D], k/v [B,Lk,H·D], bias [B,Lk] float32 ->
    [B,Lq,H·D] in q.dtype."""
    b, lq, hd = q.shape
    lk = k.shape[1]
    probs = attention_probs(_heads4(q, heads), _heads4(k, heads),
                            bias.view(b, 1, 1, lk), scale)
    out = attention_out(probs, _heads4(v, heads))
    return out.to(q.dtype).reshape(b, lq, hd)


def attention_bwd_math(q, k, v, bias, g, scale, keep=None, keep_scale=1.0):
    """The backward recipe of ``_attn_bwd_math`` / ``_dropout_bwd_math``
    (pallas_attention.py:884-904, 147-166) on [B, L, H, D] operands (views
    of either layout), bias [B, Lk]: P recomputed in float32; with a keep
    mask [B,H,Lq,Lk], dP and P's share of dv carry its factor ``keep *
    keep_scale``. Returns float32 (float64 for float64 operands) dq, dk, dv
    [B, L, H, D] and dS [B, H, Lq, Lk]."""
    b, lk = bias.shape
    acc = acc_dtype(q)
    qf, kf, vf, gf = (x.to(acc) for x in (q, k, v, g))
    probs = attention_probs(qf, kf, bias.view(b, 1, 1, lk), scale)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    pd = probs
    if keep is not None:
        factor = keep.to(acc) * keep_scale
        pd = probs * factor
        dp = dp * factor
    dv = torch.einsum("bhqk,bqhd->bkhd", pd, gf)
    ds = probs * (dp - torch.sum(dp * probs, dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq, dk, dv, ds


def attention_bwd_ref(q, k, v, bias, g, scale, heads, want_db=True):
    """Plain twin of the backward: q/g [B,Lq,H·D], k/v [B,Lk,H·D], bias
    [B,Lk] float32 -> dq, dk, dv in the operand dtype, and db [B,Lk] float32
    (dS summed over heads and queries; None unless ``want_db``)."""
    dq, dk, dv, ds = attention_bwd_math(
        *(_heads4(x, heads) for x in (q, k, v)), bias, _heads4(g, heads),
        scale)
    flat = lambda x, like: x.to(like.dtype).reshape(like.shape)  # noqa: E731
    db = ds.sum(dim=(1, 2)).to(torch.float32) if want_db else None
    return flat(dq, q), flat(dk, k), flat(dv, v), db


def smem_bytes(lk: int, head_dim: int) -> int:
    """Dynamic shared memory of one block of the CUDA-core forward body, all
    float32: its query rows, a chunk of K rows (stride D + 1) and its rows
    of Lk scores (padded to 4)."""
    return 4 * (ROWS_PER_BLOCK * (head_dim + (lk + 3) // 4 * 4)
                + KEY_CHUNK * (head_dim + 1))


def tc_smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one block of the tensor-core forward body:
    a Q tile and a K and a V key tile in bf16 (rows padded by TC_PAD) and a
    key tile's float32 bias. It does not grow with Lk."""
    return (2 * (TC_ROWS_PER_BLOCK + 2 * TC_KEYS) * (head_dim + TC_PAD)
            + 4 * TC_KEYS)


def fwd_body(dtype, dropout=False):
    """The body the forward kernels run for operands of ``dtype``, as their
    launchers choose it: the no-dropout rows 1 and 7 or, with ``dropout``,
    rows 3 and 9 run the tensor-core body for bf16 (with ``dropout`` its
    flavour that draws the keep bits and writes the keep mask, on the same
    tile and shared memory) and the CUDA-core body otherwise (float32;
    ``check`` refuses other dtypes), whose tensor-core counterpart would
    compute in TF32. The head-major dropout forward, row 5, routes as rows
    3 and 9 do. Returns (name, query rows per block, shared memory (lq, lk,
    d) -> bytes)."""
    if dtype == torch.bfloat16:
        return ("tensor-core", TC_ROWS_PER_BLOCK,
                lambda lq, lk, d: tc_smem_bytes(d))
    return "CUDA-core", ROWS_PER_BLOCK, lambda lq, lk, d: smem_bytes(lk, d)


def bwd_smem_bytes(lq: int, lk: int, head_dim: int) -> int:
    """Dynamic shared memory of one backward block, all float32: two
    [Lq, Lk] tiles (lengths padded to 4), 32 staged q and g rows and 32
    staged k and v rows (stride D + 1)."""
    return 4 * (2 * ((lq + 3) // 4 * 4) * ((lk + 3) // 4 * 4)
                + 2 * BWD_ROWS * head_dim + 2 * KEY_CHUNK * (head_dim + 1))


def tc_bwd_smem_bytes(lq: int, head_dim: int) -> int:
    """Dynamic shared memory of one block of the tensor-core backward body:
    Q, G, K and V tiles in bf16 (rows padded by TC_PAD), a key tile's
    float32 bias and each query row's softmax max, sum and delta in float32
    (Lq rounded up to a tile). It does not grow with Lk."""
    lq_pad = -(-lq // TC_ROWS_PER_BLOCK) * TC_ROWS_PER_BLOCK
    return (2 * 4 * TC_ROWS_PER_BLOCK * (head_dim + TC_PAD) + 4 * TC_KEYS
            + 4 * 3 * lq_pad)


def tc_dropout_bwd_smem_bytes(lq: int, lk: int, head_dim: int) -> int:
    """Dynamic shared memory of one block of the tensor-core backward body's
    dropout flavour (rows 4 and 6): ``tc_bwd_smem_bytes`` and the keep bits,
    one a query row and key, both rounded up to a tile: Lq·Lk/8 bytes, a
    64th of the CUDA-core body's 8 bytes a (query, key)."""
    lq_pad = -(-lq // TC_ROWS_PER_BLOCK) * TC_ROWS_PER_BLOCK
    lk_pad = -(-lk // TC_KEYS) * TC_KEYS
    return tc_bwd_smem_bytes(lq, head_dim) + lq_pad * lk_pad // 8


def bwd_body(dtype, dropout=False):
    """The body the backward kernels run for operands of ``dtype``, as their
    launchers choose it: the no-dropout rows 2 and 8 or, with ``dropout``,
    rows 4 and 6 run the tensor-core body for bf16 (the dropout flavour
    with its keep bits) and the CUDA-core body otherwise (float32). Returns
    (name, shared memory (lq, lk, d) -> bytes)."""
    if dtype == torch.bfloat16:
        if dropout:
            return "tensor-core", tc_dropout_bwd_smem_bytes
        return "tensor-core", lambda lq, lk, d: tc_bwd_smem_bytes(lq, d)
    return "CUDA-core", bwd_smem_bytes


def check_extent(name, b, lq, lk, heads, d, smem, rows=ROWS_PER_BLOCK):
    """Raise ValueError where a body cannot take the lengths: its grid (B·H
    blocks by query tiles of ``rows``) or its shared memory (``smem(lq, lk,
    d)`` bytes a block) over the card's limits."""
    if min(b, lq, lk) < 1 or b * heads >= 2**31 or -(-lq // rows) > 65535:
        raise ValueError(f"{name}: B={b}, Lq={lq}, Lk={lk}, H={heads} is "
                         "outside the kernel's grid")
    need = smem(lq, lk, d)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: Lq={lq}, Lk={lk} at D={d} "
                         f"needs {need} bytes of shared memory per block, "
                         f"over the limit of {MAX_SMEM_BYTES}")


def check(name, q, k, v, bias, heads, smem, g=None, head_major=False,
          rows=ROWS_PER_BLOCK):
    """Raise ValueError for anything the kernels do not take: operands off
    one CUDA device, dtypes other than bf16/fp32 (bias fp32), shapes that do
    not agree (q [B,Lq,H·D], k/v [B,Lk,H·D] with ``heads`` heads or, with
    ``head_major``, q [H,B,Lq,D], k/v [H,B,Lk,D]; bias [B,Lk]; g like q),
    head dims outside HEAD_DIMS, lengths past the body's grid (query tiles
    of ``rows``) or shared memory (``smem(lq, lk, head_dim)`` bytes) by
    ``check_extent``, non-contiguous or unaligned operands."""
    ops = [("q", q), ("k", k), ("v", v)] + ([("g", g)] if g is not None
                                            else [])
    if not (q.is_cuda and all(t.device == q.device for _, t in ops)
            and bias.device == q.device):
        raise ValueError(f"{name}: q, k, v, bias (and g) must lie on one "
                         f"CUDA device, got "
                         f"{[str(t.device) for _, t in ops + [('b', bias)]]}")
    if q.dtype not in DTYPE_CODE or any(t.dtype != q.dtype for _, t in ops):
        raise ValueError(f"{name}: q, k, v (and g) must share a dtype of "
                         f"bfloat16 or float32, got "
                         f"{[t.dtype for _, t in ops]}")
    if bias.dtype != torch.float32:
        raise ValueError(f"{name}: bias must be float32, got {bias.dtype}")
    if head_major:
        if q.dim() != 4 or k.dim() != 4 or bias.dim() != 2:
            raise ValueError(f"{name}: expected q [H,B,Lq,D], k/v "
                             "[H,B,Lk,D], bias [B,Lk]")
        heads, b, lq, d = q.shape
        lk = k.shape[2]
        k_shape = (heads, b, lk, d)
    else:
        if q.dim() != 3 or k.dim() != 3 or bias.dim() != 2:
            raise ValueError(f"{name}: expected q [B,Lq,H·D], k/v "
                             "[B,Lk,H·D], bias [B,Lk]")
        b, lq, hd = q.shape
        lk = k.shape[1]
        k_shape = (b, lk, hd)
        if heads < 1 or hd % heads:
            raise ValueError(f"{name}: {heads} heads do not divide {hd}")
        d = hd // heads
    if (k.shape != k_shape or v.shape != k.shape
            or bias.shape != (b, lk) or (g is not None and g.shape != q.shape)):
        raise ValueError(f"{name}: shapes "
                         f"{[(n, tuple(t.shape)) for n, t in ops]}, bias "
                         f"{tuple(bias.shape)} do not agree")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} must be one of {HEAD_DIMS}")
    check_extent(name, b, lq, lk, heads, d, smem, rows)
    for n, t in ops + [("bias", bias)]:
        if not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous")
    for n, t in ops:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {n} must be 16-byte aligned")


def launch_error(name, rc, err_str):
    return RuntimeError(f"{name} kernel launch failed: "
                        f"{err_str(rc).decode()} (cudaError {rc})")


@functools.cache
def _kernels():
    lib = _build.load()
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd = lib.volta_attention_fwd
    fwd.argtypes = [P] * 5 + [I] * 5 + [F, I, I, P]
    fwd.restype = I
    bwd = lib.volta_attention_bwd
    bwd.argtypes = [P] * 9 + [I] * 5 + [F, I, I, P]
    bwd.restype = I
    lib.volta_cuda_error_string.argtypes = [I]
    lib.volta_cuda_error_string.restype = ctypes.c_char_p
    return fwd, bwd, lib.volta_cuda_error_string


def attention_fwd(q, k, v, bias, scale, heads):
    """softmax(q·kᵀ·scale + bias)·v per head on the natural layout:
    q [B,Lq,H·D], k/v [B,Lk,H·D] (bf16 or fp32), bias [B,Lk] float32 ->
    [B,Lq,H·D] in q.dtype. bf16 runs the tensor-core body, fp32 the
    CUDA-core body (``fwd_body``); either raises ValueError on what it
    cannot take. CPU tensors take the plain twin."""
    if q.device.type == "cpu":
        return attention_fwd_ref(q, k, v, bias, scale, heads)
    _, rows, smem = fwd_body(q.dtype)
    check("attention_fwd", q, k, v, bias, heads, smem, rows=rows)
    fn, _, err_str = _kernels()
    b, lq, hd = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, lq, k.shape[1], heads, hd // heads,
            float(scale), DTYPE_CODE[q.dtype], q.device.index, stream)
    if rc != 0:
        raise launch_error("attention_fwd", rc, err_str)
    LAUNCHES["attention_fwd"] += 1
    return out


def attention_bwd(q, k, v, bias, g, scale, heads, want_db=False):
    """The backward of ``attention_fwd`` for its output cotangent g
    [B,Lq,H·D]: dq, dk, dv in the operand dtype and, with ``want_db``, db
    [B,Lk] float32 (else None). bf16 runs the tensor-core body, fp32 the
    CUDA-core body (``bwd_body``). CPU tensors take the plain twin."""
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, bias, g, scale, heads, want_db)
    check("attention_bwd", q, k, v, bias, heads, bwd_body(q.dtype)[1], g=g)
    _, fn, err_str = _kernels()
    b, lq, hd = q.shape
    lk = k.shape[1]
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    db_part = torch.empty((b, heads, lk), dtype=torch.float32,
                          device=q.device) if want_db else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            db_part.data_ptr() if want_db else None, b, lq, lk, heads,
            hd // heads, float(scale), DTYPE_CODE[q.dtype], q.device.index,
            stream)
    if rc != 0:
        raise launch_error("attention_bwd", rc, err_str)
    LAUNCHES["attention_bwd"] += 1
    # the per-head partial sums of the bias gradient, summed over heads
    return dq, dk, dv, (db_part.sum(dim=1) if want_db else None)


class FusedAttention(torch.autograd.Function):
    """No-dropout attention on [B, L, H·D] operands, bias [B, Lk] float32:
    forward ``attention_fwd``, backward ``attention_bwd`` (the kernels on the
    card, the twins on the CPU). The bias gradient is computed only when the
    bias requires one; every bias of the repo comes from ``additive_mask``
    and needs none."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, heads):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale, ctx.heads = scale, heads
        return attention_fwd(q, k, v, bias, scale, heads)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv, db = attention_bwd(q, k, v, bias, g.contiguous(),
                                       ctx.scale, ctx.heads,
                                       want_db=ctx.needs_input_grad[3])
        return dq, dk, dv, db, None, None
