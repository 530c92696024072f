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
rounds its score tensor to the inputs' dtype. The twins sum in float32
(torch's matmul, as JAX's einsum); the kernel sums in float64 and rounds
the sum to float32, so that no summation order moves a bf16 rounding. The
backward gives ``pred`` its gradient, sum_n g[b, r, n] · flat[neg_idx[b, r,
n]] (g rounded to bf16 in the bf16 case, as the vjp of JAX's astype rounds
it); ``flat`` is data and gets none. CUDA tensors take the kernels or
raise; CPU tensors take the twins, the dense composition or, with
``chunk``, the blockwise one, through which autograd takes JAX's gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import LAUNCHES, _build
from .attention_cuda import DTYPE_CODE, launch_error

VEC_BYTES = 16  # each lane's loads


def _round_scores(s: torch.Tensor, dtype) -> torch.Tensor:
    """float32 scores rounded to the inputs' dtype where that is below
    float32 (JAX's ``astype(predf.dtype)`` of the score tensor)."""
    return s.to(dtype) if dtype != torch.float32 else s


def dense_neg_scores(pred: torch.Tensor, flat: torch.Tensor,
                     neg_idx: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``nce_scores_fwd``, dense: all [b, r, b·r] scores in float32 (rounded to the
    inputs' dtype below float32), the sampled ones gathered, as float32
    (volta_tpu/losses.py:308-317)."""
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


def nce_scores_bwd_ref(g, pred_shape, flat, neg_idx):
    """The twin of ``nce_scores_bwd``: the transpose of the dense
    composition, as autograd takes it through ``dense_neg_scores`` (and
    JAX's vjp through its gather): g rounded to flat's dtype, scattered
    into the [Q, M] score cotangent with additions in that dtype, times
    flat in float32, rounded to flat's dtype."""
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


@functools.cache
def _kernels():
    lib = _build.load()
    P, I = ctypes.c_void_p, ctypes.c_int
    for name in ("volta_nce_scores_fwd", "volta_nce_scores_bwd"):
        fn = getattr(lib, name)
        fn.argtypes = [P] * 4 + [I] * 6 + [P]
        fn.restype = I
    lib.volta_cuda_error_string.argtypes = [I]
    lib.volta_cuda_error_string.restype = ctypes.c_char_p
    return (lib.volta_nce_scores_fwd, lib.volta_nce_scores_bwd,
            lib.volta_cuda_error_string)


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


def nce_scores_fwd(pred, flat, neg_idx):
    """``neg_scores`` forward on the card: float32 [..., N]; raises
    ValueError on operands the kernel cannot take."""
    check("nce_scores_fwd", pred.shape, pred.dtype, pred.device, flat,
          neg_idx)
    fn, _, err_str = _kernels()
    p, f = _rows(pred), _rows(flat)
    idx = neg_idx.reshape(p.shape[0], -1).to(torch.int32).contiguous()
    out = torch.empty(idx.shape, dtype=torch.float32, device=pred.device)
    stream = torch.cuda.current_stream(pred.device).cuda_stream
    rc = fn(out.data_ptr(), p.data_ptr(), f.data_ptr(), idx.data_ptr(),
            p.shape[0], idx.shape[1], f.shape[0], p.shape[1],
            DTYPE_CODE[pred.dtype], pred.device.index, stream)
    if rc != 0:
        raise launch_error("nce_scores_fwd", rc, err_str)
    LAUNCHES["nce_scores_fwd"] += 1
    return out.view(neg_idx.shape)


def nce_scores_bwd(g, pred_shape, flat, neg_idx):
    """The backward of ``nce_scores_fwd`` for the float32 cotangent g
    [..., N]: d pred of ``pred_shape`` in flat's dtype."""
    check("nce_scores_bwd", pred_shape, flat.dtype, g.device, flat,
          neg_idx)
    _, fn, err_str = _kernels()
    f = _rows(flat)
    q = neg_idx.numel() // max(neg_idx.shape[-1], 1)
    idx = neg_idx.reshape(q, -1).to(torch.int32).contiguous()
    gg = g.reshape(q, -1).to(torch.float32).contiguous()
    dpred = torch.empty((q, f.shape[1]), dtype=flat.dtype,
                        device=flat.device)
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    rc = fn(dpred.data_ptr(), gg.data_ptr(), f.data_ptr(), idx.data_ptr(),
            q, idx.shape[1], f.shape[0], f.shape[1], DTYPE_CODE[flat.dtype],
            flat.device.index, stream)
    if rc != 0:
        raise launch_error("nce_scores_bwd", rc, err_str)
    LAUNCHES["nce_scores_bwd"] += 1
    return dpred.view(pred_shape)


class NCEScores(torch.autograd.Function):
    """``neg_scores`` on the card: forward ``nce_scores_fwd``, backward
    ``nce_scores_bwd`` (pred's gradient; none for flat and neg_idx)."""

    @staticmethod
    def forward(ctx, pred, flat, neg_idx):
        ctx.save_for_backward(flat, neg_idx)
        ctx.pred_shape = pred.shape
        return nce_scores_fwd(pred, flat, neg_idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        flat, neg_idx = ctx.saved_tensors
        return nce_scores_bwd(g, ctx.pred_shape, flat, neg_idx), None, None


def neg_scores(pred: torch.Tensor, flat: torch.Tensor,
               neg_idx: torch.Tensor, chunk=None) -> torch.Tensor:
    """The sampled negatives' scores, float32 [..., N]: on the card the K8
    kernels (forward and backward, whatever ``chunk``; no fallback: an
    operand they cannot take raises), on the CPU the twin (dense, or
    blockwise with ``chunk``)."""
    if pred.device.type == "cpu":
        return neg_scores_ref(pred, flat, neg_idx, chunk)
    return NCEScores.apply(pred, flat, neg_idx)
