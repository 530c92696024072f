"""K8: the hand-written CUDA NCE sampled-negative scores
(``csrc/nce_scores.cu``), forward and backward, their plain twins and the
autograd Function over them.

Port of the negative scores of the JAX package's ``nce_2048``
(volta_tpu/losses.py:240-321), which has no Pallas kernel: XLA scores every
query against every candidate row and gathers the sampled ones, dense
(:299-317) or in column blocks (``_chunked_neg_scores``, :144-176). For
query rows ``pred`` [b, r, d], candidate rows ``flat`` [b·r, d] of the same
dtype and ``neg_idx`` [b, r, N] (flat row indices):

    neg_scores[b, r, n] = pred[b, r] · flat[neg_idx[b, r, n]]

returned in float32; in bf16 each score is first rounded to bf16, as JAX
rounds its score tensor to the inputs' dtype. The backward gives ``pred``
its gradient, sum_n g[b, r, n] · flat[neg_idx[b, r, n]] (g rounded to bf16
in the bf16 case, as the vjp of JAX's astype rounds it); ``flat`` is data
and gets none. CUDA tensors take the kernels or raise; CPU tensors take the
twins, the dense composition or, with ``chunk``, the blockwise one, through
which autograd takes JAX's gradient. The twins sum in float32 (torch's
matmul, as JAX's einsum).

Two bodies on the card, routed by ``nce_body``:

- "gather" (float32, and bf16 where the rule keeps it): a warp a query
  reading its N rows, float64 sums rounded once to float32;
- "tc" (bf16): a plan (``nce_plan``, twin ``nce_plan_ref``) buckets the
  valid (q, n) pairs by (query tile of TILE_Q, candidate tile of TILE_C);
  the forward multiplies pred · flatᵀ on the tensor cores over the plan's
  non-empty 256 x 256 tiles and stores only the sampled scores; the
  backward builds each tile of the sparse bf16 cotangent matrix from its
  bucket in shared memory and multiplies it with flat on the tensor cores.
  Both sum in float32, as JAX's einsum; no [Q, M] tensor is made.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import LAUNCHES, _build
from .attention_cuda import DTYPE_CODE
from .matmul import _raise as launch_failure

VEC_BYTES = 16  # each lane's loads
# the tensor-core body's plan (csrc/nce_scores.cu, namespace nce_tc): query
# tiles of TILE_Q rows (a block's), candidate tiles of TILE_C (a backward
# step), SEGMENTS counts a query tile, the forward's tiles FWD_COLS
# candidates wide; at most MAX_NEG negatives a query and MAX_TILES_C
# candidate tiles
TILE_Q, TILE_C, SEGMENTS, FWD_COLS = 128, 64, 4, 256
MAX_NEG, MAX_TILES_C = 128, 512
# The body rule's crossover: the tensor-core body's work grows with Q·M·d
# (every tile of the all-pairs product), the gather body's with Q·N·d, so
# the rule compares M with N. Set from both bodies' bf16 forward (plan
# included) + backward times at 36 regions, d 2048, N 127, in turns
# (chip_ab.py --what kernels, an H100 at 700 W): at b256 (M = 72.6 N)
# 1.04 ms against the gather body's 1.78, at b512 (M = 145 N) 4.13-4.39
# against 4.04.
TC_MAX_M_PER_NEG = 128


def _round_scores(s: torch.Tensor, dtype) -> torch.Tensor:
    """float32 scores rounded to the inputs' dtype where that is below
    float32 (JAX's ``astype(predf.dtype)`` of the score tensor)."""
    return s.to(dtype) if dtype != torch.float32 else s


def dense_neg_scores(pred: torch.Tensor, flat: torch.Tensor,
                     neg_idx: torch.Tensor, plan=None) -> torch.Tensor:
    """Plain twin of ``nce_scores_fwd``, dense: all [b, r, b·r] scores in
    float32 (rounded to the inputs' dtype below float32), the sampled ones
    gathered, as float32 (volta_tpu/losses.py:308-317). ``plan`` (the
    wrapper's) is not needed."""
    scores = torch.matmul(pred.float(), flat.float().t())
    scores = _round_scores(scores, pred.dtype)
    return torch.gather(scores, -1, neg_idx.long()).float()


def _chunked_neg_scores(pred: torch.Tensor, flat: torch.Tensor,
                        neg_idx: torch.Tensor, chunk: int) -> torch.Tensor:
    """Plain twin, blockwise (volta_tpu/losses.py:144-176): the candidate
    rows in blocks of ``chunk`` (the last one zero-padded), each block's
    [b, r, chunk] scores rounded as the dense path rounds them and the
    sampled ones that fall in it added to a float32 accumulator."""
    m, d = flat.shape
    pad = (-m) % chunk
    flat_p = F.pad(flat, (0, 0, 0, pad))
    idx = neg_idx.long()
    acc = torch.zeros(neg_idx.shape, dtype=torch.float32, device=pred.device)
    for c in range((m + pad) // chunk):
        block = flat_p[c * chunk:(c + 1) * chunk]
        s = _round_scores(torch.matmul(pred.float(), block.float().t()),
                          pred.dtype)
        off = idx - c * chunk
        valid = (off >= 0) & (off < chunk)
        got = torch.gather(s, -1, off.clamp(0, chunk - 1)).float()
        acc = acc + torch.where(valid, got, got.new_zeros(()))
    return acc


def nce_scores_bwd_ref(g, pred_shape, flat, neg_idx, plan=None):
    """The twin of ``nce_scores_bwd``: the transpose of the dense
    composition, as autograd takes it through ``dense_neg_scores`` (and
    JAX's vjp through its gather): g rounded to flat's dtype, scattered
    into the [Q, M] score cotangent with additions in that dtype, times
    flat in float32, rounded to flat's dtype. ``plan`` is not needed."""
    q = neg_idx.numel() // max(neg_idx.shape[-1], 1)
    gs = g.reshape(q, -1).to(flat.dtype)
    full = gs.new_zeros((q, flat.shape[0])).scatter_add_(
        1, neg_idx.reshape(q, -1).long(), gs)
    return torch.matmul(full.float(), flat.float()).to(flat.dtype).view(
        pred_shape)


def neg_scores_ref(pred, flat, neg_idx, chunk=None):
    """The twin of ``neg_scores``: dense, or blockwise with ``chunk``."""
    if chunk:
        return _chunked_neg_scores(pred, flat, neg_idx, chunk)
    return dense_neg_scores(pred, flat, neg_idx)


def nce_body(q, m, d, dtype, n=127) -> str:
    """The body that the K8 wrappers run for q queries of width d scored
    against m candidate rows, n negatives a query: "tc" (the tensor cores)
    for bf16 where the plan can take the shape and m <= TC_MAX_M_PER_NEG ·
    n, else "gather"."""
    if (dtype != torch.bfloat16 or not 0 < n <= MAX_NEG or q < 1
            or not 0 < -(-m // TILE_C) <= MAX_TILES_C
            or m > TC_MAX_M_PER_NEG * n):
        return "gather"
    return "tc"


class Plan(NamedTuple):
    """The tensor-core body's plan of neg_idx [Q, N] over M candidates
    (QT, CT query and candidate tiles, QP = ⌈QT / 2⌉ query pairs, CJ =
    ⌈CT / 4⌉ forward column tiles, T = QT · CT · SEGMENTS):

    - ``entries`` [Q·N, 2] int32, the first E rows used: each valid pair
      as (q·N + n, row << 24 | candidate), row = q % TILE_Q, bucket after
      bucket in (query tile, candidate tile) order, inside one in (q,
      candidate, n) order;
    - ``starts`` [T + 1]: bucket (qt, ct)'s segment s (queries [32 s, 32 s
      + 32) of the tile) begins at starts[(qt·CT + ct)·SEGMENTS + s];
      starts[T] = E;
    - ``units`` [1 + QP·CJ]: their count, then the forward's pair tiles
      qp·CJ + cj (queries [256 qp, 256 qp + 256) x candidates [256 cj, 256
      cj + 256)) that hold a pair, in order;
    - ``bwd_count`` [QP] and ``bwd_list`` [2·QP·CT, 4]: for query pair qp,
      the bwd_count[qp] candidate tiles that either of its query tiles uses,
      in order, row (2 qp + r)·CT + i = (ct, start, end of query tile 2 qp +
      r's bucket, 0);
    - ``scratch`` [QT + QP·CJ]: each query tile's pair count, then whether
      each of the forward's pair tiles holds a pair."""
    entries: torch.Tensor
    starts: torch.Tensor
    units: torch.Tensor
    bwd_count: torch.Tensor
    bwd_list: torch.Tensor
    scratch: torch.Tensor


def plan_tiles(q, m):
    """(QT, CT, QP, CJ, T) of a plan for q queries over m candidates."""
    qt, ct = -(-q // TILE_Q), -(-m // TILE_C)
    return qt, ct, -(-qt // 2), -(-ct // 4), qt * ct * SEGMENTS


@functools.lru_cache(maxsize=64)
def plan_layout(q, n, m):
    """The plan's arrays as (offset, shape) in one int32 buffer, each at a
    16-byte boundary, and the buffer's length."""
    qt, ct, qp, cj, t = plan_tiles(q, m)
    shapes = {"entries": (q * n, 2), "starts": (t + 1,),
              "units": (1 + qp * cj,), "bwd_count": (qp,),
              "bwd_list": (2 * qp * ct, 4), "scratch": (qt + qp * cj,)}
    layout, at = {}, 0
    for name, shape in shapes.items():
        layout[name] = (at, shape)
        at += -(-math.prod(shape) // 4) * 4
    return layout, at


def nce_plan_ref(neg_idx, m) -> Plan:
    """Plain twin of ``nce_plan``: the same arrays (unused tails zero)."""
    n = neg_idx.shape[-1]
    idx = neg_idx.reshape(-1, n).long()
    q = idx.shape[0]
    qt_n, ct_n, qp_n, cj_n, t = plan_tiles(q, m)
    dev = idx.device
    rows = torch.arange(q, device=dev)[:, None].expand(q, n)
    cols = torch.arange(n, device=dev)[None, :].expand(q, n)
    valid = ((idx >= 0) & (idx < m)).reshape(-1)
    qq, nn, mm = rows.reshape(-1)[valid], cols.reshape(-1)[valid], \
        idx.reshape(-1)[valid]
    qt, row, ct = qq // TILE_Q, qq % TILE_Q, mm // TILE_C
    order = torch.argsort((((qt * ct_n + ct) * TILE_Q + row) * m + mm) * n
                          + nn)
    layout, size = plan_layout(q, n, m)
    buf = torch.zeros(size, dtype=torch.int32, device=dev)
    plan = Plan(**{k: buf[o:o + math.prod(s)].view(s)
                   for k, (o, s) in layout.items()})
    e = int(valid.sum())
    plan.entries[:e, 0] = (qq * n + nn)[order].int()
    plan.entries[:e, 1] = ((row << 24) | mm)[order].int()
    counts = torch.bincount((qt * ct_n + ct) * SEGMENTS + row // 32,
                            minlength=t)
    plan.starts[1:] = torch.cumsum(counts, 0).int()
    tile = plan.starts[:-1:SEGMENTS].long()  # start of bucket (qt, ct)
    used = torch.zeros(2 * qp_n, ct_n, dtype=torch.bool, device=dev)
    used[:qt_n] = (torch.cat([tile, plan.starts[-1:].long()])[1:]
                   > tile).view(qt_n, ct_n)
    pairs = used.view(qp_n, 2, ct_n).any(1)
    fwd = F.pad(pairs, (0, cj_n * 4 - ct_n)).view(qp_n, cj_n, 4).any(-1)
    plan.scratch[:qt_n] = torch.bincount(qt, minlength=qt_n).int()
    plan.scratch[qt_n:] = fwd.reshape(-1).int()
    units = torch.nonzero(fwd.reshape(-1)).reshape(-1)
    plan.units[0] = units.numel()
    plan.units[1:1 + units.numel()] = units.int()
    plan.bwd_count[:] = pairs.sum(1).int()
    pad = (0, 2 * qp_n * ct_n - tile.numel())
    starts = F.pad(tile, pad)
    ends = F.pad(torch.cat([tile[1:], plan.starts[-1:].long()]), pad)
    for p in range(qp_n):
        cts = torch.nonzero(pairs[p]).reshape(-1)
        for r in range(2):
            at = (2 * p + r) * ct_n
            lst = plan.bwd_list[at:at + cts.numel()]
            lst[:, 0] = cts.int()
            lst[:, 1] = starts[at + cts].int()
            lst[:, 2] = ends[at + cts].int()
    return plan


@functools.cache
def _kernels():
    lib = _build.load()
    P, I = ctypes.c_void_p, ctypes.c_int
    for name in ("volta_nce_scores_fwd", "volta_nce_scores_bwd"):
        fn = getattr(lib, name)
        fn.argtypes = [P] * 4 + [I] * 6 + [P]
        fn.restype = I
    lib.volta_nce_plan.argtypes = [P] * 7 + [I] * 4 + [P]
    lib.volta_nce_tc_fwd.argtypes = [P] * 7 + [I] * 6 + [P]
    lib.volta_nce_tc_bwd.argtypes = [P] * 8 + [I] * 6 + [P]
    for fn in (lib.volta_nce_plan, lib.volta_nce_tc_fwd,
               lib.volta_nce_tc_bwd):
        fn.restype = I
    lib.volta_cuda_error_string.argtypes = [I]
    lib.volta_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _clusters(index):
    """How many clusters of two blocks the tensor-core body runs at once on
    card ``index``."""
    lib = _kernels()
    lib.volta_nce_clusters.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.volta_nce_clusters.restype = ctypes.c_int
    n = ctypes.c_int(0)
    rc = lib.volta_nce_clusters(index, ctypes.byref(n))
    if rc != 0 or n.value < 1:
        raise RuntimeError(f"the NCE tensor-core kernels' clusters do not "
                           f"fit on card {index} (cudaError {rc}, "
                           f"{n.value})")
    return n.value


def _raise(name, rc):
    return launch_failure(name, rc, _kernels().volta_cuda_error_string)


def _idx32(neg_idx, q):
    """neg_idx as contiguous int32 [q, N] (itself where it is one)."""
    return neg_idx.reshape(q, neg_idx.shape[-1]).to(torch.int32).contiguous()


def nce_plan(neg_idx, m) -> Plan:
    """The tensor-core body's plan of neg_idx [..., N] over m candidate
    rows on its card (``Plan``; CPU tensors take ``nce_plan_ref``)."""
    if neg_idx.device.type == "cpu":
        return nce_plan_ref(neg_idx, m)
    n = neg_idx.shape[-1]
    q = neg_idx.numel() // max(n, 1)
    if not (0 < n <= MAX_NEG and q > 0
            and 0 < -(-m // TILE_C) <= MAX_TILES_C and q * n < 2**31):
        raise ValueError(f"nce_plan: {q} queries of {n} negatives over {m} "
                         f"candidates are beyond the plan")
    idx = _idx32(neg_idx, q)
    layout, size = plan_layout(q, n, m)
    buf = torch.empty(size, dtype=torch.int32, device=neg_idx.device)
    plan = Plan(**{k: buf[o:o + math.prod(s)].view(s)
                   for k, (o, s) in layout.items()})
    rc = _kernels().volta_nce_plan(
        idx.data_ptr(), *(t.data_ptr() for t in plan), q, n, m,
        neg_idx.device.index, torch.cuda.current_stream(
            neg_idx.device).cuda_stream)
    if rc != 0:
        raise _raise("nce_plan", rc)
    LAUNCHES["nce_plan"] += 1
    return plan


def check(name, shape, dtype, device, flat, neg_idx):
    """Raise ValueError where the kernel cannot take its operands: query
    rows of ``shape`` [..., d], ``dtype`` and ``device``, and ``flat``
    [M, d] of that dtype (bf16 or float32) on that CUDA device, rows of
    whole 16-byte vectors, integer ``neg_idx`` [..., N] of the rows'
    leading shape on the device, sizes within int32."""
    devices = (device, flat.device, neg_idx.device)
    if any(dv.type != "cuda" or dv != device for dv in devices):
        raise ValueError(f"{name}: pred, flat and neg_idx must lie on one "
                         f"CUDA device, got {[str(dv) for dv in devices]}")
    if dtype not in DTYPE_CODE or flat.dtype != dtype:
        raise ValueError(f"{name}: pred and flat must share a dtype of "
                         f"bfloat16 or float32, got {dtype} and "
                         f"{flat.dtype}")
    if neg_idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: neg_idx must be int32 or int64, got "
                         f"{neg_idx.dtype}")
    d = shape[-1]
    if flat.dim() != 2 or flat.shape[1] != d \
            or tuple(neg_idx.shape[:-1]) != tuple(shape[:-1]):
        raise ValueError(f"{name}: expected pred [..., d], flat [M, d], "
                         f"neg_idx [..., N], got {tuple(shape)}, "
                         f"{tuple(flat.shape)}, {tuple(neg_idx.shape)}")
    if d * flat.element_size() % VEC_BYTES:
        raise ValueError(f"{name}: rows of {d} x {flat.element_size()} "
                         f"bytes are not whole {VEC_BYTES}-byte vectors")
    if max(flat.numel(), neg_idx.numel(),
           neg_idx.numel() // max(neg_idx.shape[-1], 1) * d) >= 2**31:
        raise ValueError(f"{name}: operands beyond int32 sizes")


def _rows(x):
    """x as contiguous [rows, last] at a 16-byte-aligned address."""
    x = x.reshape(-1, x.shape[-1]).contiguous()
    if x.data_ptr() % VEC_BYTES:
        x = x.clone()
    return x


def _body(pred_shape, dtype, flat, neg_idx):
    q = neg_idx.numel() // max(neg_idx.shape[-1], 1)
    return nce_body(q, flat.shape[0], pred_shape[-1], dtype,
                    neg_idx.shape[-1])


def nce_scores_fwd(pred, flat, neg_idx, plan=None):
    """``neg_scores`` forward on the card: float32 [..., N], by the body
    ``nce_body`` names (the tensor-core body with ``plan``, or a plan it
    makes); raises ValueError on operands the kernel cannot take."""
    check("nce_scores_fwd", pred.shape, pred.dtype, pred.device, flat,
          neg_idx)
    lib = _kernels()
    p, f = _rows(pred), _rows(flat)
    q, n = p.shape[0], neg_idx.shape[-1]
    idx = _idx32(neg_idx, q)
    out = torch.empty(idx.shape, dtype=torch.float32, device=pred.device)
    stream = torch.cuda.current_stream(pred.device).cuda_stream
    if _body(pred.shape, pred.dtype, flat, neg_idx) == "tc":
        if plan is None:
            plan = nce_plan(idx, f.shape[0])
        rc = lib.volta_nce_tc_fwd(
            out.data_ptr(), p.data_ptr(), f.data_ptr(), idx.data_ptr(),
            plan.entries.data_ptr(), plan.starts.data_ptr(),
            plan.units.data_ptr(), _clusters(pred.device.index), q, n,
            f.shape[0], p.shape[1], pred.device.index, stream)
    else:
        rc = lib.volta_nce_scores_fwd(
            out.data_ptr(), p.data_ptr(), f.data_ptr(), idx.data_ptr(), q, n,
            f.shape[0], p.shape[1], DTYPE_CODE[pred.dtype], pred.device.index,
            stream)
    if rc != 0:
        raise _raise("nce_scores_fwd", rc)
    LAUNCHES["nce_scores_fwd"] += 1
    return out.view(neg_idx.shape)


def nce_scores_bwd(g, pred_shape, flat, neg_idx, plan=None):
    """The backward of ``nce_scores_fwd`` for the float32 cotangent g
    [..., N]: d pred of ``pred_shape`` in flat's dtype, by the same body."""
    check("nce_scores_bwd", pred_shape, flat.dtype, g.device, flat,
          neg_idx)
    lib = _kernels()
    f = _rows(flat)
    n = neg_idx.shape[-1]
    q = neg_idx.numel() // max(n, 1)
    idx = _idx32(neg_idx, q)
    gg = g.reshape(q, -1).to(torch.float32).contiguous()
    dpred = torch.empty((q, f.shape[1]), dtype=flat.dtype,
                        device=flat.device)
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    if _body(pred_shape, flat.dtype, flat, neg_idx) == "tc":
        if plan is None:
            plan = nce_plan(idx, f.shape[0])
        # each entry's summed bf16 weight with its tile row and column (and
        # room for the kernel's copies rounded up to 16 bytes)
        packed = torch.empty(q * n + 4, dtype=torch.int32,
                             device=flat.device)
        rc = lib.volta_nce_tc_bwd(
            dpred.data_ptr(), gg.data_ptr(), f.data_ptr(),
            plan.entries.data_ptr(), plan.starts.data_ptr(),
            plan.bwd_count.data_ptr(), plan.bwd_list.data_ptr(),
            packed.data_ptr(), _clusters(flat.device.index), q, n,
            f.shape[0], f.shape[1], flat.device.index, stream)
    else:
        rc = lib.volta_nce_scores_bwd(
            dpred.data_ptr(), gg.data_ptr(), f.data_ptr(), idx.data_ptr(), q,
            n, f.shape[0], f.shape[1], DTYPE_CODE[flat.dtype],
            flat.device.index, stream)
    if rc != 0:
        raise _raise("nce_scores_bwd", rc)
    LAUNCHES["nce_scores_bwd"] += 1
    return dpred.view(pred_shape)


class NCEScores(torch.autograd.Function):
    """``neg_scores`` on the card: forward ``nce_scores_fwd``, backward
    ``nce_scores_bwd`` (pred's gradient; none for flat and neg_idx), the
    tensor-core body's plan made once in the forward and kept for the
    backward."""

    @staticmethod
    def forward(ctx, pred, flat, neg_idx):
        plan = None
        if _body(pred.shape, pred.dtype, flat, neg_idx) == "tc":
            check("nce_scores_fwd", pred.shape, pred.dtype, pred.device,
                  flat, neg_idx)
            # the indices as the kernels read them, converted once
            neg_idx = _idx32(neg_idx, -1).view(neg_idx.shape)
            plan = nce_plan(neg_idx, flat.shape[0])
        ctx.save_for_backward(flat, neg_idx, *(plan or ()))
        ctx.pred_shape = pred.shape
        return nce_scores_fwd(pred, flat, neg_idx, plan)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        flat, neg_idx, *plan = ctx.saved_tensors
        plan = Plan(*plan) if plan else None
        return (nce_scores_bwd(g, ctx.pred_shape, flat, neg_idx, plan), None,
                None)


def neg_scores(pred: torch.Tensor, flat: torch.Tensor,
               neg_idx: torch.Tensor, chunk=None) -> torch.Tensor:
    """The sampled negatives' scores, float32 [..., N]: on the card the K8
    kernels (forward and backward, whatever ``chunk``; no fallback: an
    operand they cannot take raises), on the CPU the twin (dense, or
    blockwise with ``chunk``)."""
    if pred.device.type == "cpu":
        return neg_scores_ref(pred, flat, neg_idx, chunk)
    return NCEScores.apply(pred, flat, neg_idx)
