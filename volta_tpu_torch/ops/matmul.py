"""The hand-written CUDA matrix products of the tools' decision probes
(``csrc/matmul.cu``), their wrappers and their plain twins.

Ports of Queue 2 rows 15 and 16, the two TPU kernels that only the probes
launch:

- row 15, ``_wgrad_kernel`` (tools/wgrad_probe.py:36, launched by
  ``make_pallas_wgrad`` :50): ``wgrad(g, a)``, the weight gradient gᵀa of g
  [n, h] and a [n, f] bf16 over the token axis, accumulated and returned in
  float32 [h, f];
- row 16, ``_ffn1_kernel`` (tools/pallas_ffn_probe.py:46, launched by
  ``make_pallas_matmul`` :59): ``matmul_bias_act(x, w, b, act)``, x [n, k]
  · w [k, m] + b [1, m] in bf16 with float32 accumulation, the bias added
  and, with ``act``, the tanh gelu applied in float32 with the probe's
  constants (:38-43), stored bf16.

CUDA tensors take the kernels or raise; CPU tensors take the twins, which
multiply the bf16 operands exactly in float32.

Two bodies (``matmul_body``): the Hopper body (``csrc/matmul_wgmma.cuh``:
TMA, a ring of shared-memory stages, wgmma, a persistent grid walking
``wgmma_plan``'s work units) for every operand set that TMA can read, and
the ``mma.sync`` body (``csrc/matmul.cu``) for the rest, whose rows are not
16-byte multiples. A set that the rule gives to the Hopper body runs it or
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import LAUNCHES, _build
from .attention_cuda import launch_error

# the Hopper body's output tile (a cluster of two blocks, 128 rows each) and
# k depth a stage (csrc/matmul_wgmma.cuh)
TILE_M, TILE_N, TILE_K = 256, 256, 64
# the Hopper body's code for a driver without cuTensorMapEncodeTiled
# (wg::kNoEncode)
NO_ENCODE = -100000


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The probe's tanh gelu (tools/pallas_ffn_probe.py:38-43) on float32."""
    c = 0.7978845608028654  # sqrt(2 / pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3)))


def wgrad_ref(g, a):
    """Plain twin of row 15: gᵀa in float32, [h, f]."""
    return g.float().t() @ a.float()


def matmul_bias_act_ref(x, w, b, act):
    """Plain twin of row 16: x·w + b in float32, tanh gelu with ``act``,
    rounded to x.dtype."""
    y = x.float() @ w.float() + b.float().reshape(1, -1)
    return (gelu_tanh(y) if act else y).to(x.dtype)


def matmul_body(*tensors) -> str:
    """The body that a wrapper runs for these operands: "wgmma" where TMA
    can read every one of them (non-empty contiguous bf16 matrices, each
    starting on a 16-byte boundary with rows of a multiple of 16 bytes),
    else "mma.sync"."""
    for t in tensors:
        if not (t.dtype == torch.bfloat16 and t.dim() == 2 and t.numel() > 0
                and t.is_contiguous() and t.data_ptr() % 16 == 0
                and t.shape[1] * 2 % 16 == 0):
            return "mma.sync"
    return "wgmma"


def wgmma_plan(m, n, k, clusters, split):
    """The Hopper body's work for out[m, n] = A[m, k] · B[k, n] on at most
    ``clusters`` persistent clusters of two blocks: (units, cluster_first,
    tile_slots). A unit is (tile, first k block, end k block, slot) on
    TILE_M x TILE_N tiles (row-major over the output, TILE_K-deep k
    blocks); cluster c walks units [cluster_first[c], cluster_first[c +
    1]), its block r taking rows [128 r, 128 r + 128) of each tile.

    With ``split`` (row 15) the tiles' k blocks, in order, are cut into
    equal shares, one a cluster (stream-K); each unit writes its partial
    tile to slot = its index, and tile t's partials are slots
    [tile_slots[2t], tile_slots[2t + 1]), summed in that order. Without it
    (row 16) units are whole tiles dealt round robin, slot -1, and
    tile_slots is empty."""
    tiles = -(-m // TILE_M) * -(-n // TILE_N)
    kb = -(-k // TILE_K)
    units, cluster_first, tile_slots = [], [0], []
    if split:
        total = tiles * kb
        grid = min(clusters, total)
        for b in range(grid):
            lo, hi = b * total // grid, (b + 1) * total // grid
            while lo < hi:
                t = lo // kb
                end = min(hi, (t + 1) * kb)
                units.append((t, lo - t * kb, end - t * kb, len(units)))
                lo = end
            cluster_first.append(len(units))
        for t in range(tiles):
            slots = [u[3] for u in units if u[0] == t]
            tile_slots += [slots[0], slots[-1] + 1]
    else:
        grid = min(clusters, tiles)
        for b in range(grid):
            units += [(t, 0, kb, -1) for t in range(b, tiles, grid)]
            cluster_first.append(len(units))
    return units, cluster_first, tile_slots


@functools.lru_cache(maxsize=64)
def _device_plan(m, n, k, split, device, clusters=None):
    """wgmma_plan for ``clusters`` clusters (default: as many as the card
    runs at once), as one int32 tensor on it: units, then cluster_first,
    then tile_slots (cached: a plan is made once a shape). Returns (tensor,
    clusters, slots, offsets of the three)."""
    units, cluster_first, tile_slots = wgmma_plan(
        m, n, k, clusters or _clusters(device.index), split)
    flat = [v for u in units for v in u] + cluster_first + tile_slots
    plan = torch.tensor(flat, dtype=torch.int32, device=device)
    return (plan, len(cluster_first) - 1, len(units),
            (0, 4 * len(units), 4 * len(units) + len(cluster_first)))


@functools.cache
def _clusters(index):
    """How many clusters of two blocks the Hopper body runs at once on
    card ``index`` (66 on an H100 SXM's 132 SMs)."""
    lib = _build.load()
    lib.volta_matmul_clusters.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.volta_matmul_clusters.restype = ctypes.c_int
    n = ctypes.c_int(0)
    rc = lib.volta_matmul_clusters(index, ctypes.byref(n))
    if rc != 0 or n.value < 1:
        raise RuntimeError(f"the matmul kernels' clusters do not fit on "
                           f"card {index} (cudaError {rc}, {n.value})")
    return n.value


@functools.cache
def _kernels():
    lib = _build.load()
    P, I = ctypes.c_void_p, ctypes.c_int
    wg = lib.volta_wgrad
    wg.argtypes = [P] * 3 + [I] * 4 + [P]
    mm = lib.volta_matmul_bias_act
    mm.argtypes = [P] * 4 + [I] * 5 + [P]
    wg_h = lib.volta_wgrad_wgmma
    wg_h.argtypes = [P] * 7 + [I] * 5 + [P]
    mm_h = lib.volta_matmul_bias_act_wgmma
    mm_h.argtypes = [P] * 6 + [I] * 6 + [P]
    for fn in (wg, mm, wg_h, mm_h):
        fn.restype = I
    lib.volta_cuda_error_string.argtypes = [I]
    lib.volta_cuda_error_string.restype = ctypes.c_char_p
    return wg, mm, wg_h, mm_h, lib.volta_cuda_error_string


def _raise(name, rc, err_str):
    """A failed launch's error: a negative code is a tensor map that did
    not encode (the driver's CUresult, negated)."""
    if rc < 0:
        return RuntimeError(f"{name}: cuTensorMapEncodeTiled failed ("
                            + ("no driver entry point" if rc == NO_ENCODE
                               else f"CUresult {-rc}") + ")")
    return launch_error(name, rc, err_str)


def _check(name, tensors):
    """Raise ValueError unless every operand is a contiguous bf16 matrix on
    one CUDA device with at most 2^31 - 1 elements."""
    dev = tensors[0][1].device
    for n, t in tensors:
        if not (t.is_cuda and t.device == dev):
            raise ValueError(f"{name}: {n} must lie on the CUDA device of "
                             f"the others, got {t.device}")
        if t.dtype != torch.bfloat16 or t.dim() != 2:
            raise ValueError(f"{name}: {n} must be a bf16 matrix, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.numel() >= 2**31:
            raise ValueError(f"{name}: {n} must be contiguous with fewer "
                             f"than 2^31 elements")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def wgrad(g, a, clusters=None):
    """gᵀa for g [n, h] and a [n, f] bf16: [h, f] float32 with float32
    accumulation. CPU tensors take the plain twin. ``clusters`` caps the
    Hopper body's grid (default: as many clusters as the card runs at
    once), for measurements of the body on part of the card."""
    if g.device.type == "cpu":
        return wgrad_ref(g, a)
    _check("wgrad", [("g", g), ("a", a)])
    if g.shape[0] != a.shape[0]:
        raise ValueError(f"wgrad: g {tuple(g.shape)} and a "
                         f"{tuple(a.shape)} differ in tokens")
    n, h = g.shape
    f = a.shape[1]
    out = torch.empty((h, f), dtype=torch.float32, device=g.device)
    fn, _, fn_h, _, err_str = _kernels()
    if matmul_body(g, a) == "wgmma":
        plan, clusters, slots, (u, cf, ts) = _device_plan(h, f, n, True,
                                                           g.device, clusters)
        # each slot holds a pair tile's partial, [256, 256] float32
        ws = torch.empty((slots, TILE_M, TILE_N), dtype=torch.float32,
                         device=g.device)
        p = plan.data_ptr()
        rc = fn_h(g.data_ptr(), a.data_ptr(), ws.data_ptr(), out.data_ptr(),
                  p + 4 * u, p + 4 * cf, p + 4 * ts, clusters, n, h, f,
                  g.device.index, _stream(g))
    else:
        rc = fn(g.data_ptr(), a.data_ptr(), out.data_ptr(), n, h, f,
                g.device.index, _stream(g))
    if rc != 0:
        raise _raise("wgrad", rc, err_str)
    LAUNCHES["wgrad"] += 1
    return out


def matmul_bias_act(x, w, b, act):
    """x [n, k] · w [k, m] + b [1, m] (or [m]), all bf16, with float32
    accumulation; tanh gelu in float32 with ``act``: [n, m] bf16. CPU tensors
    take the plain twin."""
    if x.device.type == "cpu":
        return matmul_bias_act_ref(x, w, b, act)
    b2 = b.reshape(1, -1)
    _check("matmul_bias_act", [("x", x), ("w", w), ("b", b2)])
    n, k = x.shape
    m = w.shape[1]
    if w.shape[0] != k or b2.shape[1] != m:
        raise ValueError(f"matmul_bias_act: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)} do not agree")
    out = torch.empty((n, m), dtype=torch.bfloat16, device=x.device)
    _, fn, _, fn_h, err_str = _kernels()
    if matmul_body(x, w, b2) == "wgmma":
        plan, clusters, _, (u, cf, _) = _device_plan(n, m, k, False,
                                                      x.device)
        p = plan.data_ptr()
        rc = fn_h(x.data_ptr(), w.data_ptr(), b2.data_ptr(), out.data_ptr(),
                  p + 4 * u, p + 4 * cf, clusters, n, k, m, int(bool(act)),
                  x.device.index, _stream(x))
    else:
        rc = fn(x.data_ptr(), w.data_ptr(), b2.data_ptr(), out.data_ptr(), n,
                k, m, int(bool(act)), x.device.index, _stream(x))
    if rc != 0:
        raise _raise("matmul_bias_act", rc, err_str)
    LAUNCHES["matmul_bias_act"] += 1
    return out
