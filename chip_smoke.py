#!/usr/bin/env python3
"""Drive the PyTorch port's serving and fine-tuning paths once on one
NVIDIA GPU, without and with the LayerNorm kernels.

    python3 chip_smoke.py [--profile]

From the root of a checkout, on a host with a card, nvcc and PyTorch built
for CUDA. Phases, each of which raises (and so exits non-zero) on failure,
and each of which prints its seconds:

1. card: its name and power limit as nvidia-smi gives them; TF32 off;
2. build: the CUDA kernels of ``volta_tpu_torch/ops/csrc`` through first
   use, with ptxas' register report;
3. kernel 1 (attention forward) vs its plain twin on the card, numpy inputs
   with a random padding mask: (a) B=256, L=60, H=12, D=64 bf16 (the
   serving shape), (b) the same in fp32, (c) B=3, Lq=5, Lk=563 bf16 (the
   longest task sequence); tolerances bf16 2e-2 (two bf16 ulps at |x| ~ 2),
   fp32 1e-5; times at (a), with ``F.scaled_dot_product_attention`` on the
   same inputs and additive mask as the library yardstick;
4. kernels 2-4 (attention backward, dropout attention forward and
   backward) vs their twins at the serving shape in bf16 and fp32 and at
   odd shapes (Lq != Lk, Lq < 8, D = 16 and 128): dq/dk/dv/db and the
   dropout output within two bf16 ulps of the largest value (fp32 1e-5
   relative), the dropout mask bit-equal to the twin's, its keep fraction
   0.9 +- 0.005 at b256; times of each kernel and twin at (a), kernel 2
   beside SDPA's forward + backward;
5. kernels 10-13 (LayerNorm forward and backward, fused dropout + residual
   + LayerNorm forward and backward) vs their twins at the b256 train shape
   (15360 rows of 768) in bf16 and fp32, at 7 and 1000 rows and at the
   classifier width 1536: y/dx/do within two bf16 ulps of the largest value
   (fp32 1e-5 relative), mean/rstd and dscale/dbias within 1e-5 relative
   (float32 sums in another order), the row-12 mask and od bit-equal to the
   twin's and the mask to ``hash_dropout``'s zero pattern, keep fraction
   0.9 +- 0.005; times at the train shape in bf16, rows 10-11 beside the
   torch LayerNorm forward and backward as the library yardstick; the
   host time per call of an eval-mode sublayer tail with and without
   kernel 10;
6. eval slice: a synthetic VQA dataroot at full feature width (2048 dims,
   36 boxes, 3129 labels, 1200 train and 1024 val questions, written here
   through the port's own LMDB writer) through
   ``python -m volta_tpu_torch.eval_task``'s ``main()`` with
   ctrl_uniter_base in bf16 and random weights from a seed; kernel 1 must
   run 12 times per batch and no other kernel, all logits must be finite
   and every question must get one answer; one batch is compared with the
   same model on the plain twins (logits within 5e-2, the kernel being
   bit-equal to its twin); eval throughput at b256 and b1024, kernels vs
   twins;
7. the eval slice again with ``use_pallas_layernorm`` and
   ``use_fused_residual_ln`` on (a copy of the config in a temporary
   directory): kernel 1 12 and kernel 10 29 times per batch, one answer per
   question; one batch through the kernels, the twins and the torch
   LayerNorm path in bf16 and, with the same weights, in fp32: fp32 logits
   within 1e-4 of the twins'; kernel 10 sums in another order than its
   twin, so bf16 logits differ by a few bf16 ulps after 12 layers, and are
   held to twice the twins' own distance from the torch LayerNorm path,
   with at most 4 more answers flipped than that path flips; eval
   throughput at b256 and b1024 with the LayerNorm kernels on and off, in
   turns;
8. train slice: ``python -m volta_tpu_torch.train_task``'s ``main()``, 2
   epochs at b256 in bf16 with the config's dropout: kernels 3 and 4 must
   run exactly 12 times per step and kernel 1 12 times per validation
   batch, losses finite and falling, one VAL line per epoch; 1 epoch of the
   same config with its dropout rates set to 0, which must run kernel 2 12
   times per step; 1 epoch with the LayerNorm flags on, which must run
   kernels 12 and 13 24 times and kernels 10 and 11 5 times per step (and
   kernel 10 29 times per validation batch);
9. one fp32 train step at full width (64 rows) with the kernels and with
   the twins from the same weights and seed, with dropout and without,
   without and with the LayerNorm flags: the losses within 1e-5 relative,
   every parameter within 2% of the step's largest update, the exact
   launches of each kernel;
10. train-step throughput at b256 bf16, inputs on the card (forward,
    backward, clip, AdamW), with the kernels and with the twins, then with
    the LayerNorm kernels on and off, and the peak memory of each; with
    ``--profile`` the device time of a step by kernel, without and with
    the LayerNorm kernels;
11. the kernels' JSON line, then ``{"ok": true, "device": ...}`` last.

It exits non-zero without a result where CUDA is absent, or where the
package is missing beside it.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TOL = {"bfloat16": 2e-2, "float32": 1e-5}
LOGIT_TOL = 5e-2
# the float32 model with the LayerNorm kernels vs the twins: float32 sums in
# another order through 12 layers, 8.6e-6 on an H100 (the twins vs the torch
# LayerNorm path 9.3e-6), held with a tenfold margin
LOGIT_TOL_FP32 = 1e-4
# bf16 with the LayerNorm kernels: the bf16 rounding of 12 layers lets two
# summation orders differ by 6e-2 (6.4e-2 kernels vs twins, 6.2e-2 twins vs
# torch on an H100); the kernels are held to NOISE_FACTOR times the twins'
# distance from torch, and to at most AGREE_SLACK more flipped answers
NOISE_FACTOR = 2.0
AGREE_SLACK = 4
STEP_TOL = 0.02
RATE = 0.1
EPS = 1e-12
SERVING = (256, 60, 60, 12, 64)
ODD = [(2, 9, 33, 4, 16), (3, 5, 37, 2, 64), (2, 17, 70, 2, 128)]
TRAIN_ROWS = (15360, 768)  # the b256 train shape: 256 x 60 rows of 768
LN_SHAPES = [(TRAIN_ROWS, "bfloat16"), (TRAIN_ROWS, "float32"),
             ((7, 768), "bfloat16"), ((1000, 768), "float32"),
             ((256, 1536), "bfloat16")]
CONFIG = os.path.join(REPO, "configs", "ctrl_uniter_base.json")
CSRC = "volta_tpu_torch/ops/csrc/"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS = {"bf16 tensor": 989e12, "fp32": 67e12}  # H100 SXM, dense
# name -> (source, TPU kernel it replaces)
KERNELS = {
    "attention_fwd": ("attention_fwd.cu",
                      "volta_tpu/ops/pallas_attention.py:670"),
    "attention_bwd": ("attention_bwd.cu",
                      "volta_tpu/ops/pallas_attention.py:683"),
    "attention_dropout_fwd": ("attention_dropout.cu",
                              "volta_tpu/ops/pallas_attention.py:510"),
    "attention_dropout_bwd": ("attention_dropout.cu",
                              "volta_tpu/ops/pallas_attention.py:530"),
    "layer_norm_fwd": ("layernorm.cu", "volta_tpu/ops/layernorm.py:27"),
    "layer_norm_bwd": ("layernorm.cu", "volta_tpu/ops/layernorm.py:40"),
    "dropout_residual_ln_fwd": ("fused_residual.cu",
                                "volta_tpu/ops/fused_residual.py:49"),
    "dropout_residual_ln_bwd": ("fused_residual.cu",
                                "volta_tpu/ops/fused_residual.py:72"),
}
# the profile's kernel families, first match wins: the int64 ops are the
# hash dropout's mask draws (the only int64 arithmetic of the step)
KERNEL_FAMILIES = (
    ("attention kernels", ("attention_",)),
    ("LayerNorm kernels (rows 10-11)", ("layer_norm_fwd_kernel",
                                        "layer_norm_bwd_kernel")),
    ("fused residual-LN kernels (rows 12-13)", ("dropout_residual_ln_",)),
    ("hash dropout (int64 ops)", ("<long", "long>", "arange")),
    ("matmuls", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("torch LayerNorm fwd+bwd", ("layer_norm", "GammaBeta")),
    ("AdamW + clip", ("multi_tensor_apply",)),
    ("gelu fwd+bwd", ("Gelu",)),
    ("casts and copies", ("copy",)),
    ("reductions", ("reduce_kernel",)),
)


def ab_turns(name_a, route_a, name_b, route_b):
    """The turns of an A/B on one card: a, b, b, a, a, b, b, a, so that
    drift in the card's or the host's speed falls on both sides alike."""
    a, b = (name_a, route_a), (name_b, route_b)
    return (a, b, b, a) * 2


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def phase(name):
    t0 = time.time()
    yield
    print(f"phase {name}: {time.time() - t0:.1f} s", flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, ops, peak):
    """The least time of a function on the card, ms: the larger of its
    bytes over the memory rate and its operations over the peak rate of
    their type, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound(b, lq, lk, h, d, itemsize, backward):
    """Forward: q, k, v, bias read, out written; 4·B·H·Lq·Lk·D operations
    (QKᵀ and PV). Backward: q, k, v, g, bias read, dq, dk, dv written;
    10·B·H·Lq·Lk·D (QKᵀ again, dV, dP, dQ, dK)."""
    rows = b * (3 * lq + 4 * lk) if backward else b * (2 * lq + 2 * lk)
    nbytes = rows * h * d * itemsize + b * lk * 4
    return bound(nbytes, (10 if backward else 4) * b * h * lq * lk * d,
                 "bf16 tensor")


def row_bound(name, n, d, itemsize):
    """Rows 10-13 over [n, d]: each [n, d] operand read or written once, the
    [d] float32 vectors and [n] float32 statistics once; float32 operations
    per element (statistics, normalisation, VJP) on the CUDA cores."""
    rows, vecs, stats, ops = {
        "layer_norm_fwd": (2, 2, 2, 8),            # x -> y; w, b; mean, rstd
        "layer_norm_bwd": (3, 3, 2, 13),           # g, x -> dx; w, dw, db
        "dropout_residual_ln_fwd": (4, 2, 2, 10),  # o, x -> y, od
        "dropout_residual_ln_bwd": (5, 3, 2, 15),  # g, od, x -> do, dx
    }[name]
    nbytes = rows * n * d * itemsize + vecs * d * 4 + stats * n * 4
    return bound(nbytes, ops * n * d, "fp32")


def expect(**counts):
    """A full launch table: the given counts, every other kernel 0."""
    from volta_tpu_torch.ops import LAUNCHES

    return {name: counts.get(name, 0) for name in LAUNCHES}


def attention_inputs(b, lq, lk, h, d, dtype, seed):
    import torch

    rng = np.random.RandomState(seed)
    dev = torch.device("cuda")
    mk = lambda l: torch.from_numpy(
        rng.randn(b, l, h * d).astype(np.float32)).to(dev, dtype)
    q, k, v = mk(lq), mk(lk), mk(lk)
    mask = (rng.rand(b, lk) > 0.25).astype(np.float32)
    mask[:, 0] = 1.0
    bias = torch.from_numpy((1.0 - mask) * -10000.0).to(dev)
    return q, k, v, bias


def sdpa_operands(q, k, v, bias, h):
    """q, k, v [B, L, H·D] as SDPA's [B, H, L, D] and the additive bias as
    a [B, 1, 1, Lk] mask in their dtype: the library yardstick's inputs."""
    b, lk = bias.shape
    heads = lambda x: x.view(x.shape[0], x.shape[1], h, -1).transpose(1, 2)
    return (heads(q), heads(k), heads(v),
            bias.view(b, 1, 1, lk).to(q.dtype))


def check_kernel(attention_cuda):
    """Phase 3: kernel 1 against its twin at three shapes; the times of
    both, and of SDPA on the same inputs, at the serving shape."""
    import torch
    import torch.nn.functional as F

    shapes = [("a", (256, 60, 60, 12, 64), "bfloat16"),
              ("b", (256, 60, 60, 12, 64), "float32"),
              ("c", (3, 5, 563, 12, 64), "bfloat16")]
    report = {}
    for tag, (b, lq, lk, h, d), dt in shapes:
        q, k, v, bias = attention_inputs(b, lq, lk, h, d, getattr(torch, dt),
                                         seed=ord(tag))
        out = attention_cuda.attention_fwd(q, k, v, bias, d ** -0.5, h)
        torch.cuda.synchronize()
        ref = attention_cuda.attention_fwd_ref(q, k, v, bias, d ** -0.5, h)
        err = float((out.float() - ref.float()).abs().max())
        ok = out.shape == ref.shape and out.dtype == ref.dtype \
            and bool(torch.isfinite(out).all()) and err <= TOL[dt]
        print(f"kernel ({tag}) B={b} Lq={lq} Lk={lk} H={h} D={d} {dt}: "
              f"max abs diff vs twin {err:.3e} (tol {TOL[dt]:g})", flush=True)
        if not ok:
            raise RuntimeError(f"attention kernel disagrees at shape {tag}")
        if tag == "a":
            report["max_abs_err"] = err
            ms = cuda_ms(lambda: attention_cuda.attention_fwd(
                q, k, v, bias, d ** -0.5, h), iters=100)
            plain_ms = cuda_ms(lambda: attention_cuda.attention_fwd_ref(
                q, k, v, bias, d ** -0.5, h), iters=100)
            ms2 = cuda_ms(lambda: attention_cuda.attention_fwd(
                q, k, v, bias, d ** -0.5, h), iters=100)
            sq, sk, sv, mask = sdpa_operands(q, k, v, bias, h)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=mask), iters=100)
            report.update(ms=(ms + ms2) / 2, plain_ms=plain_ms,
                          library_ms=lib_ms,
                          bound=attention_bound(b, lq, lk, h, d, 2, False))
            print(f"kernel (a) time {report['ms']:.4f} ms (runs {ms:.4f}, "
                  f"{ms2:.4f}), plain twin {plain_ms:.4f} ms, SDPA "
                  f"{lib_ms:.4f} ms, bound {report['bound'][0]:.4f} ms "
                  f"({report['bound'][1]})", flush=True)
    return report


def close(got, ref, dtype, what):
    """Max abs difference of got vs ref; raises past two bf16 ulps of the
    largest |ref| (bf16) or 1e-5 * max(1, |ref|) (fp32)."""
    import torch

    top = float(ref.float().abs().max())
    tol = 2 ** -6 * top if dtype == "bfloat16" else 1e-5 * max(1.0, top)
    err = float((got.float() - ref.float()).abs().max())
    if got.shape != ref.shape or got.dtype != ref.dtype \
            or not bool(torch.isfinite(got).all()) or err > tol:
        raise RuntimeError(f"{what}: max abs diff {err:.3e} over tol "
                           f"{tol:.3e}")
    return err


def check_train_kernels():
    """Phase 4: kernels 2-4 against their twins; their times at (a), and
    SDPA's forward + backward beside kernel 2."""
    import torch
    import torch.nn.functional as F

    from volta_tpu_torch.ops import attention_cuda as ac
    from volta_tpu_torch.ops import attention_dropout_cuda as adc

    report = {}
    for i, shape in enumerate([SERVING] + ODD):
        b, lq, lk, h, d = shape
        for dt in ("bfloat16", "float32"):
            q, k, v, bias = attention_inputs(b, lq, lk, h, d,
                                             getattr(torch, dt), 100 + i)
            g = torch.randn_like(q)
            scale, seed = d ** -0.5, 1000 + i
            got = ac.attention_bwd(q, k, v, bias, g, scale, h, want_db=True)
            out, mask = adc.attention_dropout_fwd(q, k, v, bias, scale, h,
                                                  RATE, seed,
                                                  return_mask=True)
            dgot = adc.attention_dropout_bwd(q, k, v, bias, g, scale, h,
                                             RATE, seed)
            torch.cuda.synchronize()
            ref = ac.attention_bwd_ref(q, k, v, bias, g, scale, h)
            keep = adc.keep_mask(seed, (b, h, lq, lk), RATE, device="cuda")
            if not torch.equal(mask, keep):
                raise RuntimeError(f"dropout mask differs from the twin's "
                                   f"at {shape} {dt}")
            oref = adc.attention_dropout_fwd_ref(q, k, v, bias, scale, h,
                                                 RATE, keep)
            dref = adc.attention_dropout_bwd_ref(q, k, v, bias, g, scale, h,
                                                 RATE, keep)
            errs = {
                "attention_bwd": max(close(a, r, dt, f"kernel 2 {n}")
                                     for n, a, r in zip("q k v b".split(),
                                                        got, ref)),
                "attention_dropout_fwd": close(out, oref, dt, "kernel 3"),
                "attention_dropout_bwd": max(close(a, r, dt, "kernel 4")
                                             for a, r in zip(dgot, dref))}
            frac = float(mask.float().mean())
            print(f"kernels 2-4 B={b} Lq={lq} Lk={lk} H={h} D={d} {dt}: "
                  f"max abs diff vs twins {errs['attention_bwd']:.3e} / "
                  f"{errs['attention_dropout_fwd']:.3e} / "
                  f"{errs['attention_dropout_bwd']:.3e}, mask bit-equal, "
                  f"keep fraction {frac:.5f}", flush=True)
            if shape == SERVING:
                if abs(frac - (1 - RATE)) > 0.005:
                    raise RuntimeError(f"keep fraction {frac} at b256")
                if dt == "bfloat16":
                    report = {n: {"max_abs_err": e} for n, e in errs.items()}
                    args = (q, k, v, bias, g, scale, h, seed)
    q, k, v, bias, g, scale, h, seed = args
    b, lq, lk, d = q.shape[0], q.shape[1], k.shape[1], q.shape[2] // h
    shape = (b, h, lq, lk)
    pairs = {
        "attention_bwd": (
            lambda: ac.attention_bwd(q, k, v, bias, g, scale, h),
            lambda: ac.attention_bwd_ref(q, k, v, bias, g, scale, h,
                                         want_db=False)),
        "attention_dropout_fwd": (
            lambda: adc.attention_dropout_fwd(q, k, v, bias, scale, h, RATE,
                                              seed),
            lambda: adc.attention_dropout_fwd_ref(
                q, k, v, bias, scale, h, RATE,
                adc.keep_mask(seed, shape, RATE, device="cuda"))),
        "attention_dropout_bwd": (
            lambda: adc.attention_dropout_bwd(q, k, v, bias, g, scale, h,
                                              RATE, seed),
            lambda: adc.attention_dropout_bwd_ref(
                q, k, v, bias, g, scale, h, RATE,
                adc.keep_mask(seed, shape, RATE, device="cuda")))}
    for name, (kern, plain) in pairs.items():
        ms = cuda_ms(kern, iters=50)
        plain_ms = cuda_ms(plain, iters=50)
        ms2 = cuda_ms(kern, iters=50)
        report[name].update(
            ms=(ms + ms2) / 2, plain_ms=plain_ms, library_ms=None,
            bound=attention_bound(b, lq, lk, h, d, 2,
                                  name != "attention_dropout_fwd"))
        print(f"{name} (a) time {(ms + ms2) / 2:.4f} ms (runs {ms:.4f}, "
              f"{ms2:.4f}), plain twin {plain_ms:.4f} ms (mask draw "
              f"included), bound {report[name]['bound'][0]:.4f} ms",
              flush=True)
    # the library yardstick of kernel 2: SDPA forward + backward
    sq, sk, sv, mask = sdpa_operands(q, k, v, bias, h)
    leaves = [t.detach().requires_grad_() for t in (sq, sk, sv)]
    sg = g.view(b, lq, h, d).transpose(1, 2)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*leaves, attn_mask=mask), leaves, sg),
        iters=50)
    report["attention_bwd"]["library_ms"] = lib_ms
    print(f"attention_bwd library yardstick: SDPA forward + backward "
          f"{lib_ms:.4f} ms", flush=True)
    return report


def ln_inputs(n, d, dtype, seed):
    import torch

    rng = np.random.RandomState(seed)
    dt = getattr(torch, dtype)
    mk = lambda: torch.from_numpy(
        (rng.randn(n, d) * 2 + 0.5).astype(np.float32)).to("cuda", dt)
    vec = lambda: torch.from_numpy(
        (1 + 0.1 * rng.randn(d)).astype(np.float32)).to("cuda")
    return mk(), mk(), mk(), vec(), vec()


def check_ln_kernels():
    """Phase 5: kernels 10-13 against their twins; their times at the
    train shape in bf16, rows 10-11 beside the torch LayerNorm."""
    import torch
    import torch.nn.functional as F

    from volta_tpu_torch.models.layers import LayerNorm, hash_dropout
    from volta_tpu_torch.ops import attention_dropout_cuda as adc
    from volta_tpu_torch.ops import fused_residual as fr
    from volta_tpu_torch.ops import layernorm as ln

    # statistics and the float32 row sums dscale / dbias are compared as
    # float32 (1e-5 of the largest value): sums in another order
    f32 = "float32"
    report = {}
    for (n, d), dt in LN_SHAPES:
        x, o, g, w, b = ln_inputs(n, d, dt, seed=n + d)
        seed = 0xBEEF + n
        y, mean, rstd = ln.layer_norm_fwd(x, w, b, EPS)
        dx, dw, db = ln.layer_norm_bwd(g, x, w, mean, rstd)
        fy, od, fmean, frstd = fr.dropout_residual_ln_fwd(o, x, w, b, seed,
                                                          RATE, EPS)
        fdo, fdx, fdw, fdb = fr.dropout_residual_ln_bwd(g, od, x, w, fmean,
                                                        frstd, seed, RATE)
        torch.cuda.synchronize()
        keep = adc.keep_mask(seed, (n, d), RATE, device="cuda")
        if not torch.equal(od != 0, keep) or not torch.equal(
                od != 0, hash_dropout(o, seed, RATE) != 0):
            raise RuntimeError(f"row-12 mask differs from the twin's at "
                               f"{(n, d)} {dt}")
        ry, rmean, rrstd = ln.layer_norm_fwd_ref(x, w, b, EPS)
        rdx, rdw, rdb = ln.layer_norm_bwd_ref(g, x, w, mean, rstd)
        fry, rod, frmean, frrstd = fr.dropout_residual_ln_fwd_ref(
            o, x, w, b, keep, RATE, EPS)
        if not torch.equal(od, rod):
            raise RuntimeError(f"row-12 od differs at {(n, d)} {dt}")
        frdo, frdx, frdw, frdb = fr.dropout_residual_ln_bwd_ref(
            g, od, x, w, fmean, frstd, keep, RATE)
        errs = {
            "layer_norm_fwd": max(close(y, ry, dt, "kernel 10 y"),
                                  close(mean, rmean, f32, "kernel 10 mean"),
                                  close(rstd, rrstd, f32, "kernel 10 rstd")),
            "layer_norm_bwd": max(close(dx, rdx, dt, "kernel 11 dx"),
                                  close(dw, rdw, f32, "kernel 11 dscale"),
                                  close(db, rdb, f32, "kernel 11 dbias")),
            "dropout_residual_ln_fwd": max(
                close(fy, fry, dt, "kernel 12 y"),
                close(fmean, frmean, f32, "kernel 12 mean"),
                close(frstd, frrstd, f32, "kernel 12 rstd")),
            "dropout_residual_ln_bwd": max(
                close(fdo, frdo, dt, "kernel 13 do"),
                close(fdx, frdx, dt, "kernel 13 dx"),
                close(fdw, frdw, f32, "kernel 13 dscale"),
                close(fdb, frdb, f32, "kernel 13 dbias"))}
        frac = float(keep.float().mean())
        print(f"kernels 10-13 n={n} d={d} {dt}: max abs diff vs twins "
              + " / ".join(f"{e:.3e}" for e in errs.values())
              + f", row-12 mask and od bit-equal, keep fraction {frac:.5f}",
              flush=True)
        if (n, d) == TRAIN_ROWS:
            if abs(frac - (1 - RATE)) > 0.005:
                raise RuntimeError(f"row-12 keep fraction {frac}")
            if dt == "bfloat16":
                report = {k: {"max_abs_err": e} for k, e in errs.items()}
                args = (x, o, g, w, b, seed, mean, rstd, od, fmean, frstd)

    x, o, g, w, b, seed, mean, rstd, od, fmean, frstd = args
    n, d = x.shape
    keep = lambda: adc.keep_mask(seed, (n, d), RATE, device="cuda")
    # the yardstick takes weights in x's dtype: cast once, outside the timing
    w16, b16 = w.to(x.dtype), b.to(x.dtype)
    _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [d], w16, b16, EPS)
    pairs = {
        "layer_norm_fwd": (
            lambda: ln.layer_norm_fwd(x, w, b, EPS),
            lambda: ln.layer_norm_fwd_ref(x, w, b, EPS),
            lambda: F.layer_norm(x, (d,), w16, b16, EPS)),
        "layer_norm_bwd": (
            lambda: ln.layer_norm_bwd(g, x, w, mean, rstd),
            lambda: ln.layer_norm_bwd_ref(g, x, w, mean, rstd),
            lambda: torch.ops.aten.native_layer_norm_backward(
                g, x, [d], lmean, lrstd, w16, b16, [True, True, True])),
        "dropout_residual_ln_fwd": (
            lambda: fr.dropout_residual_ln_fwd(o, x, w, b, seed, RATE, EPS),
            lambda: fr.dropout_residual_ln_fwd_ref(o, x, w, b, keep(), RATE,
                                                   EPS),
            None),
        "dropout_residual_ln_bwd": (
            lambda: fr.dropout_residual_ln_bwd(g, od, x, w, fmean, frstd,
                                               seed, RATE),
            lambda: fr.dropout_residual_ln_bwd_ref(g, od, x, w, fmean, frstd,
                                                   keep(), RATE),
            None)}
    for name, (kern, plain, lib) in pairs.items():
        ms = cuda_ms(kern, iters=100)
        plain_ms = cuda_ms(plain, iters=20)
        ms2 = cuda_ms(kern, iters=100)
        lib_ms = cuda_ms(lib, iters=100) if lib is not None else None
        report[name].update(ms=(ms + ms2) / 2, plain_ms=plain_ms,
                            library_ms=lib_ms,
                            bound=row_bound(name, n, d, x.element_size()))
        print(f"{name} n={n} d={d} bf16 time {(ms + ms2) / 2:.4f} ms (runs "
              f"{ms:.4f}, {ms2:.4f}), plain twin {plain_ms:.4f} ms"
              + (" (mask draw included)" if lib is None else
                 f", torch LayerNorm {lib_ms:.4f} ms")
              + f", bound {report[name]['bound'][0]:.4f} ms "
              f"({report[name]['bound'][1]})", flush=True)
    # what an eval-mode sublayer tail LN(o + x) costs the host with and
    # without the LayerNorm kernels: 29 such calls make a forward
    mods = {kern: LayerNorm(d, use_kernel=kern).cuda()
            for kern in (True, False)}
    with torch.no_grad():
        host = {"layer_norm_fwd wrapper": host_us(
                    lambda: ln.layer_norm_fwd(x, w, b, EPS)),
                "tail, LayerNorm kernel": host_us(
                    lambda: mods[True](o, residual=x)),
                "tail, torch LayerNorm": host_us(
                    lambda: mods[False](o, residual=x))}
    print(f"host time per call, n={n} d={d} bf16: "
          + ", ".join(f"{k} {us:.1f} us" for k, us in host.items()),
          flush=True)
    return report


def host_us(fn, iters=200):
    """Host microseconds per call of ``fn`` on the host clock, the device
    left to catch up afterwards: its Python, checks, allocations and
    launches, which bound a step when they outlast its device time."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


@contextlib.contextmanager
def twins():
    """The eight kernels' plain twins in their wrappers' places: the
    autograd Functions look their wrappers up at call time, so the card
    runs the twins (the dropout twins with the kernels' hash mask). No
    kernel may launch meanwhile."""
    from volta_tpu_torch.ops import LAUNCHES
    from volta_tpu_torch.ops import attention_cuda as ac
    from volta_tpu_torch.ops import attention_dropout_cuda as adc
    from volta_tpu_torch.ops import fused_residual as fr
    from volta_tpu_torch.ops import layernorm as ln

    def keep(q, k, heads, rate, seed):
        return adc.keep_mask(seed, (q.shape[0], heads, q.shape[1],
                                    k.shape[1]), rate, device=q.device)

    def dropout_fwd(q, k, v, bias, scale, heads, rate, seed):
        return adc.attention_dropout_fwd_ref(q, k, v, bias, scale, heads,
                                             rate, keep(q, k, heads, rate,
                                                        seed))

    def dropout_bwd(q, k, v, bias, g, scale, heads, rate, seed):
        return adc.attention_dropout_bwd_ref(q, k, v, bias, g, scale, heads,
                                             rate, keep(q, k, heads, rate,
                                                        seed))

    def residual_fwd(o, x, w, b, seed, rate, eps):
        keep = fr.tail_keep_mask(seed, o.shape, rate, o.device)
        return fr.dropout_residual_ln_fwd_ref(o, x, w, b, keep, rate, eps)

    def residual_bwd(g, od, x, w, mean, rstd, seed, rate):
        keep = fr.tail_keep_mask(seed, x.shape, rate, x.device)
        return fr.dropout_residual_ln_bwd_ref(g, od, x, w, mean, rstd, keep,
                                              rate)

    swaps = [(ac, "attention_fwd", ac.attention_fwd_ref),
             (ac, "attention_bwd", ac.attention_bwd_ref),
             (adc, "attention_dropout_fwd", dropout_fwd),
             (adc, "attention_dropout_bwd", dropout_bwd),
             (ln, "layer_norm_fwd", ln.layer_norm_fwd_ref),
             (ln, "layer_norm_bwd", ln.layer_norm_bwd_ref),
             (fr, "dropout_residual_ln_fwd", residual_fwd),
             (fr, "dropout_residual_ln_bwd", residual_bwd)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    before = dict(LAUNCHES)
    for mod, name, twin in swaps:
        setattr(mod, name, twin)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)
    if LAUNCHES != before:
        raise RuntimeError("a kernel launched while the twins were in place")


@contextlib.contextmanager
def ln_kernels_off(model):
    """The model's LayerNorms on the plain torch path (both LayerNorm flags
    off) for the duration: the same weights without kernels 10-13."""
    from volta_tpu_torch.models.layers import LayerNorm

    lns = [m for m in model.modules() if isinstance(m, LayerNorm)]
    saved = [(m.use_kernel, m.fused_residual) for m in lns]
    for m in lns:
        m.use_kernel = m.fused_residual = False
    try:
        yield
    finally:
        for m, (kern, fused) in zip(lns, saved):
            m.use_kernel, m.fused_residual = kern, fused


WORD_STEMS = [
    "dog", "cat", "man", "woman", "ball", "car", "tree", "house", "red",
    "blue", "green", "small", "large", "play", "run", "sit", "stand", "hold",
    "wear", "table", "chair", "street", "water", "sky", "grass", "food",
    "plate", "glass", "phone", "book", "sign", "light", "window", "door",
    "hand", "head", "shirt", "hat", "bag", "bike", "bus", "train", "plane",
    "boat", "bird", "horse", "cow", "sheep", "bear", "zebra",
]


def write_synth_vocab(path, size=30522):
    """A WordPiece vocab of bert-base-uncased's size over WORD_STEMS."""
    toks = ["[PAD]", "[unused0]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    toks += list("abcdefghijklmnopqrstuvwxyz0123456789.,?!'-")
    toks += ["what", "where", "who", "why", "how", "is", "are", "the", "a",
             "an", "of", "on", "in", "at", "there", "color", "many", "doing",
             "and", "with", "to", "two", "three"]
    toks += WORD_STEMS
    i = 0
    while len(toks) < size:
        stem = WORD_STEMS[i % len(WORD_STEMS)]
        n = i // len(WORD_STEMS)
        toks.append(f"##{stem}{n}" if n % 2 else f"{stem}{n}")
        i += 1
    with open(path, "w") as f:
        f.write("\n".join(toks[:size]) + "\n")


def write_synth_vqa(out, images, questions, boxes, feat_dim, num_labels,
                    seed):
    """A synthetic VQA dataroot in the reference's on-disk formats, through
    the port's own LMDB writer: a features LMDB of pickled base64 float32
    records (``boxes`` x ``feat_dim``), VQA v2 question JSONs and target
    pickles for ``questions`` train and max(questions // 12, 1024) val
    questions, the answer space of ``num_labels`` and a vocab. The same
    files, byte for byte, as ``tools/make_synth_data.py vqa`` with the same
    arguments."""
    import base64
    import pickle

    from volta_tpu_torch.data import lmdbx

    os.makedirs(out, exist_ok=True)
    rng = np.random.RandomState(seed)
    items, keys = [], []
    for i in range(images):
        key = str(1000000 + i).encode()
        keys.append(key)
        feats = (rng.randn(boxes, feat_dim) * 0.5).astype(np.float32)
        x1 = rng.rand(boxes, 1) * (640 * 0.7)
        y1 = rng.rand(boxes, 1) * (480 * 0.7)
        x2 = x1 + 8 + rng.rand(boxes, 1) * (640 * 0.3 - 8)
        y2 = y1 + 8 + rng.rand(boxes, 1) * (480 * 0.3 - 8)
        box = np.concatenate([x1, y1, x2, y2], 1).astype(np.float32)
        rec = {"img_id": 1000000 + i, "img_h": 480, "img_w": 640,
               "num_boxes": boxes,
               "features": base64.b64encode(feats.tobytes()),
               "boxes": base64.b64encode(box.tobytes())}
        items.append((key, pickle.dumps(rec)))
    items.append((b"keys", pickle.dumps(keys)))
    lmdbx.write(os.path.join(out, "features.lmdb"), items)
    del items

    with open(os.path.join(out, "trainval_ans2label.pkl"), "wb") as f:
        pickle.dump({f"answer{i}": i for i in range(num_labels)}, f)
    with open(os.path.join(out, "trainval_label2ans.pkl"), "wb") as f:
        pickle.dump([f"answer{i}" for i in range(num_labels)], f)
    os.makedirs(os.path.join(out, "cache"), exist_ok=True)
    for name, year, n_q in (("train", "2014", questions),
                            ("val", "2014", max(questions // 12, 1024))):
        qs, ts = [], []
        for q in range(n_q):
            qid = q if name == "train" else 10_000_000 + q
            iid = 1000000 + int(rng.randint(images))
            words = [WORD_STEMS[int(j)] for j in
                     rng.randint(0, len(WORD_STEMS), rng.randint(4, 9))]
            qs.append({"question_id": qid, "image_id": iid,
                       "question": "what is the " + " ".join(words) + " ?"})
            ts.append({"question_id": qid, "image_id": iid,
                       "labels": [int(rng.randint(num_labels))],
                       "scores": [1.0]})
        with open(os.path.join(
                out, f"v2_OpenEnded_mscoco_{name}{year}_questions.json"),
                "w") as f:
            json.dump({"questions": qs}, f)
        with open(os.path.join(out, "cache", f"{name}_target.pkl"),
                  "wb") as f:
            pickle.dump(ts, f)
    write_synth_vocab(os.path.join(out, "vocab.txt"))


def make_dataroot(root):
    data = os.path.join(root, "vqa")
    write_synth_vqa(data, images=256, questions=1200, boxes=36,
                    feat_dim=2048, num_labels=3129, seed=0)
    yml = os.path.join(root, "tasks.yml")
    with open(yml, "w") as f:
        f.write(f"""TASK1:
  name: VQA
  type: VL-classifier
  num_labels: 3129
  loss: BCEWithLogitLoss
  process: normal
  task_id: 1
  dataroot: {data}
  features_h5path1: {data}/features.lmdb
  features_h5path2: ''
  train_annotations_jsonpath: ''
  val_annotations_jsonpath: ''
  max_seq_length: 23
  max_region_num: 36
  batch_size: 256
  eval_batch_size: 256
  train_split: train
  val_split: val
  lr: 0.0001
""")
    return data, yml


def write_config(root, name, **fields):
    """A copy of ctrl_uniter_base's config with ``fields`` replaced, in
    ``root``; the repo's configs stay as they are."""
    from volta_tpu_torch.config import VoltaConfig

    cfg = VoltaConfig.from_json_file(CONFIG)
    for key, val in fields.items():
        if not hasattr(cfg, key):
            raise KeyError(key)
        setattr(cfg, key, val)
    path = os.path.join(root, name)
    with open(path, "w") as f:
        f.write(cfg.to_json_string())
    if VoltaConfig.from_json_file(path).to_dict() != cfg.to_dict():
        raise RuntimeError(f"{path} does not load as written")
    return path


def concat_batches(batches):
    return {k: np.concatenate([b[k] for b in batches])
            for k in batches[0]}


def throughput(step, batch, iters):
    """pairs/s of the eval step on a batch already on the card, and the
    peak device memory of the run."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(batch), iters=iters, warmup=2)
    n = int(batch["question"].shape[0])
    return n / (ms / 1e3), torch.cuda.max_memory_allocated() / 2**30


def run_slice(root, data_dir, yml, power, config, tag, per_batch, routes,
              exact_twins):
    """Phases 6-7: the eval CLI on synthetic VQA at full width with
    ``config``. ``per_batch`` holds the launches of one batch; ``routes``
    gives, for the model, two named context managers whose eval throughputs
    are compared in turns (ab_turns); ``exact_twins`` says whether the
    path's kernels are bit-equal to their twins. Returns the launches and
    the rates."""
    import torch

    from volta_tpu_torch import eval_task
    from volta_tpu_torch.eval_step import make_task_eval_step, to_device
    from volta_tpu_torch.ops import LAUNCHES, reset_launches

    argv = ["--config_file", config, "--tasks_config_file", yml,
            "--task", "1", "--vocab_file", os.path.join(data_dir, "vocab.txt"),
            "--output_dir", os.path.join(root, f"results_{tag}"),
            "--num_workers", "4", "--compute_dtype", "bfloat16",
            "--device", "cuda", "--seed", "0"]

    reset_launches()
    t0 = time.time()
    summary = eval_task.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(LAUNCHES)

    args = eval_task.parse_args(argv)
    model, task_cfg, task, data = eval_task.setup(args)
    n_q = len(data["dataset"])
    n_batches = -(-n_q // 256)
    print(f"eval_task.main ({tag}): {summary['n']} questions in {n_batches} "
          f"batches, {wall:.1f} s wall (data and model set-up included), "
          f"loss {summary['loss']:.4f} score {summary['score']:.4f}, "
          f"kernel launches {launches}", flush=True)
    want = expect(**{k: c * n_batches for k, c in per_batch.items()})
    if launches != want:
        raise RuntimeError(f"eval launches {launches}, expected {want}")
    if summary["nonfinite_batches"]:
        raise RuntimeError("non-finite logits in "
                           f"{summary['nonfinite_batches']} batches")
    with open(summary["out_file"]) as f:
        results = json.load(f)
    qids = sorted(r["question_id"] for r in results)
    want_q = sorted(int(e["question_id"]) for e in data["dataset"].entries)
    if qids != want_q or summary["n"] != n_q:
        raise RuntimeError(f"{len(results)} answers for {n_q} questions")

    step = make_task_eval_step(model, task_cfg, task)
    batches = list(data["loader"])
    one = to_device(batches[0], "cuda")
    models = [("bfloat16", model, step)]
    if not exact_twins:
        # the same weights in float32: the two LayerNorm implementations
        # compared without 12 layers of bf16 rounding in between
        args32 = eval_task.parse_args(argv + ["--compute_dtype", "float32"])
        model32 = eval_task.setup(args32)[0]
        models.append(("float32", model32,
                       make_task_eval_step(model32, task_cfg, task)))
    for dtype, net, fn in models:
        kernel_logits = fn(one)["prediction"].float()
        with twins():
            plain_logits = fn(one)["prediction"].float()
        with ln_kernels_off(net):
            torch_logits = fn(one)["prediction"].float()
        diff = float((kernel_logits - plain_logits).abs().max())
        noise = float((plain_logits - torch_logits).abs().max())
        agree = float((kernel_logits.argmax(1) == plain_logits.argmax(1))
                      .float().mean())
        agree_noise = float((torch_logits.argmax(1) == plain_logits.argmax(1))
                            .float().mean())
        # bf16 logits are held to LOGIT_TOL where the kernels are bit-equal
        # to their twins (attention). The LayerNorm kernels sum in another
        # order: there the float32 model is held to LOGIT_TOL_FP32, and the
        # bf16 model may stray from the twins no further than NOISE_FACTOR
        # times, and flip no more than AGREE_SLACK answers beyond, what the
        # torch LayerNorm path (another summation order again) shows
        if exact_twins:
            tol, min_agree = LOGIT_TOL, 0.0
        elif dtype == "float32":
            tol, min_agree = LOGIT_TOL_FP32, 0.0
        else:
            tol = NOISE_FACTOR * noise
            min_agree = agree_noise - AGREE_SLACK / kernel_logits.shape[0]
        print(f"logits b256 ({tag}, {dtype}) kernels vs plain twins: max abs "
              f"diff {diff:.3e} (tol {tol:.3e}), answers agree {agree:.4f} "
              f"(min {min_agree:.4f}); plain twins vs the torch LayerNorm "
              f"path {noise:.3e}, answers agree {agree_noise:.4f}; |logits| "
              f"max {float(kernel_logits.abs().max()):.3f}", flush=True)
        if not bool(torch.isfinite(kernel_logits).all()):
            raise RuntimeError(f"non-finite {dtype} logits")
        if not (diff <= tol and agree >= min_agree):
            raise RuntimeError("kernel model disagrees with the plain twins")

    (name_a, route_a), (name_b, route_b) = routes(model)
    rates = {}
    for bsz, batch in ((256, one),
                       (1024, to_device(concat_batches(batches[:4]),
                                        "cuda"))):
        runs = {name_a: [], name_b: []}
        for name, route in ab_turns(name_a, route_a, name_b, route_b):
            with route():
                runs[name].append(throughput(step, batch, iters=10))
        for name, rs in runs.items():
            rate = float(np.median([r for r, _ in rs]))
            rates[(bsz, name)] = rate
            print(f"eval forward b{bsz} {name}: median {rate:.1f} pairs/s "
                  f"(runs {', '.join(f'{r:.1f}' for r, _ in rs)}), peak "
                  f"{max(m for _, m in rs):.2f} GiB [{power}]", flush=True)
    print(f"eval end to end ({tag}, eval_task.main, b256, 1024 questions): "
          f"{summary['n'] / wall:.1f} pairs/s [{power}]", flush=True)
    return launches, rates


def train_argv(root, data_dir, yml, config, epochs, tag):
    return ["--config_file", config, "--tasks_config_file", yml,
            "--task", "1", "--vocab_file", os.path.join(data_dir, "vocab.txt"),
            "--output_dir", os.path.join(root, f"save_{tag}"),
            "--logdir", os.path.join(root, f"logs_{tag}"),
            "--num_train_epochs", str(epochs), "--num_workers", "4",
            "--compute_dtype", "bfloat16", "--clip_grad_norm", "1.0",
            "--device", "cuda", "--seed", "0"]


def run_train(root, data_dir, yml, flagged):
    """Phase 8: the train CLI at full width, with the config's dropout, with
    its dropout rates set to 0, and with the LayerNorm flags on
    (``flagged``). Returns the launches of each run."""
    import torch

    from volta_tpu_torch import train_task
    from volta_tpu_torch.config import VoltaConfig
    from volta_tpu_torch.ops import LAUNCHES, reset_launches
    from volta_tpu_torch.task_utils import load_dataset, load_task_config

    free = write_config(root, "ctrl_uniter_base_dropout_free.json",
                        attention_probs_dropout_prob=0.0,
                        hidden_dropout_prob=0.0)
    cfg = VoltaConfig.from_json_file(CONFIG)
    out = {}
    for tag, config, epochs in (("dropout", CONFIG, 2),
                                ("dropout_free", free, 1),
                                ("flagged", flagged, 1)):
        argv = train_argv(root, data_dir, yml, config, epochs, tag)
        data = load_dataset(train_task.parse_args(argv), cfg,
                            load_task_config(yml), "1")
        n_train, n_val = len(data["train_loader"]), len(data["val_loader"])
        reset_launches()
        t0 = time.time()
        summary = train_task.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(LAUNCHES)
        steps, losses = summary["steps"], summary["train_losses"]
        with open(os.path.join(summary["log_dir"], "out.txt")) as f:
            val_lines = [l.strip() for l in f if " VAL epoch " in l]
        print(f"train_task.main ({tag}): {epochs} epochs, {steps} steps at "
              f"b256, {wall:.1f} s wall (data and model set-up included), "
              f"losses {[round(l, 4) for l in losses]}, launches "
              f"{launches}", flush=True)
        for line in val_lines:
            print("  " + line, flush=True)
        if steps != epochs * n_train or len(losses) != steps:
            raise RuntimeError(f"{steps} steps, {len(losses)} losses")
        if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise RuntimeError(f"train losses {losses}")
        if len(val_lines) != epochs:
            raise RuntimeError(f"{len(val_lines)} VAL lines")
        val = epochs * n_val
        want = {
            "dropout": expect(attention_dropout_fwd=12 * steps,
                              attention_dropout_bwd=12 * steps,
                              attention_fwd=12 * val),
            "dropout_free": expect(attention_fwd=12 * steps + 12 * val,
                                   attention_bwd=12 * steps),
            "flagged": expect(attention_dropout_fwd=12 * steps,
                              attention_dropout_bwd=12 * steps,
                              attention_fwd=12 * val,
                              layer_norm_fwd=5 * steps + 29 * val,
                              layer_norm_bwd=5 * steps,
                              dropout_residual_ln_fwd=24 * steps,
                              dropout_residual_ln_bwd=24 * steps)}[tag]
        if launches != want:
            raise RuntimeError(f"{tag} launches {launches}, expected {want}")
        out[tag] = launches
    return out, data


def build_model(task_cfg, dtype, config=CONFIG, seed=0):
    """ctrl_uniter_base (``config``) with a VQA head on the card, random
    weights from ``seed``."""
    import torch

    from volta_tpu_torch import VoltaForVLTasks
    from volta_tpu_torch.config import VoltaConfig
    from volta_tpu_torch.models.layers import init_weights

    cfg = VoltaConfig.from_json_file(config)
    cfg.compute_dtype = dtype
    model = VoltaForVLTasks(cfg, task_cfg, ("TASK1",))
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.cuda()


def new_step(model, task_cfg, lr):
    """A fresh clip + AdamW over ``model``: its train state and step."""
    from volta_tpu_torch.optimization import build_optimizer
    from volta_tpu_torch.train_step import create_train_state, \
        make_task_train_step

    opt = build_optimizer("adamw", lr, model, clip_norm=1.0)
    return (create_train_state(model, opt, seed=11),
            make_task_train_step(model, opt, task_cfg, "TASK1"))


def compare_steps(task_cfg, batch_np, flagged):
    """Phase 9: one fp32 step with the kernels and with the twins, without
    and with the LayerNorm flags (``flagged``)."""
    import torch

    from volta_tpu_torch.eval_step import to_device
    from volta_tpu_torch.ops import LAUNCHES, reset_launches

    batch = to_device({k: v[:64] for k, v in batch_np.items()
                       if isinstance(v, np.ndarray)}, "cuda")
    cases = (
        ("dropout", CONFIG, expect(attention_dropout_fwd=12,
                                   attention_dropout_bwd=12)),
        ("dropout-free", CONFIG, expect(attention_fwd=12, attention_bwd=12)),
        ("LN flags, dropout", flagged, expect(
            attention_dropout_fwd=12, attention_dropout_bwd=12,
            layer_norm_fwd=5, layer_norm_bwd=5, dropout_residual_ln_fwd=24,
            dropout_residual_ln_bwd=24)),
        ("LN flags, dropout-free", flagged, expect(
            attention_fwd=12, attention_bwd=12, layer_norm_fwd=29,
            layer_norm_bwd=29)))
    for mode, config, want in cases:
        model = build_model(task_cfg, "float32", config)
        init = {k: v.clone() for k, v in model.state_dict().items()}
        res = {}
        for route in ("kernel", "twin"):
            model.load_state_dict(init)
            model.train("dropout-free" not in mode)
            state, step = new_step(model, task_cfg, 1e-4)
            reset_launches()
            with twins() if route == "twin" else contextlib.nullcontext():
                loss = float(step(state, batch)["loss"])
            res[route] = (loss, {k: v.clone()
                                 for k, v in model.state_dict().items()},
                          dict(LAUNCHES))
        counts = res["kernel"][2]
        if counts != want:
            raise RuntimeError(f"{mode} kernel step launched {counts}, "
                               f"expected {want}")
        (lk, pk, _), (lt, pt, _) = res["kernel"], res["twin"]
        diff = max(float((pk[n] - pt[n]).abs().max()) for n in pk)
        upd = max(float((pk[n] - init[n]).abs().max()) for n in pk)
        print(f"fp32 step ({mode}), 64 rows, kernels vs twins: loss "
              f"{lk:.6f} vs {lt:.6f}, params max abs diff {diff:.3e} "
              f"(largest update {upd:.3e}, tol {STEP_TOL:g} of it), "
              f"kernel launches {counts}", flush=True)
        if not (abs(lk - lt) <= 1e-5 * abs(lt) and diff <= STEP_TOL * upd
                and np.isfinite(lk)):
            raise RuntimeError(f"{mode} step disagrees with the twins")
        del model, init, res
        torch.cuda.empty_cache()


def step_rates(step, state, batch, routes, power, what):
    """pairs/s of the train step under two named routes in ab_turns, with
    the peak memory of each; returns {name: (median pairs/s, median
    ms/step)}."""
    import torch

    n = int(batch["question"].shape[0])
    (name_a, route_a), (name_b, route_b) = routes
    runs = {name_a: [], name_b: []}
    for name, route in ab_turns(name_a, route_a, name_b, route_b):
        with route():
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: step(state, batch), iters=10, warmup=2)
            runs[name].append((n / (ms / 1e3), ms,
                               torch.cuda.max_memory_allocated() / 2**30))
    out = {}
    for name, rs in runs.items():
        rate = float(np.median([r for r, _, _ in rs]))
        ms = float(np.median([m for _, m, _ in rs]))
        out[name] = (rate, ms)
        print(f"train step b{n} bf16 {what} {name}: median {rate:.1f} "
              f"pairs/s ({ms:.2f} ms/step; runs "
              f"{', '.join(f'{r:.1f}' for r, _, _ in rs)}), peak "
              f"{max(m for _, _, m in rs):.2f} GiB [{power}]", flush=True)
    return out


def train_throughput(task_cfg, batch_np, power, profile, flagged):
    """Phase 10: pairs/s of the b256 bf16 train step with the kernels and
    with the twins (LayerNorm kernels off), then with the LayerNorm kernels
    on and off; peak memory; with ``profile`` the device time by kernel of
    the step without and with the LayerNorm kernels."""
    from volta_tpu_torch.eval_step import to_device
    from volta_tpu_torch.optimization import warmup_linear_schedule

    model = build_model(task_cfg, "bfloat16", flagged).train()
    state, step = new_step(model, task_cfg,
                           warmup_linear_schedule(1e-4, 10, 1000))
    batch = to_device({k: v for k, v in batch_np.items()
                       if isinstance(v, np.ndarray)}, "cuda")
    off = lambda: ln_kernels_off(model)
    with off():
        rates = step_rates(step, state, batch,
                           (("kernels", contextlib.nullcontext),
                            ("twins", twins)), power, "LN kernels off,")
    rates.update(step_rates(step, state, batch,
                            (("LN kernels on", contextlib.nullcontext),
                             ("LN kernels off", off)), power, "kernels,"))
    if profile:
        with off():
            profile_step(step, state, batch, rates["kernels"][1],
                         "LN kernels off")
        profile_step(step, state, batch, rates["LN kernels on"][1],
                     "LN kernels on")
    return rates


def profile_step(step, state, batch, step_ms, what, steps=3):
    """Device time of the train step by kernel (torch.profiler) over
    ``steps`` steps after the timing runs, and the device's idle share
    against the unprofiled ``step_ms`` (the profiler slows the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(steps):
            step(state, batch)
        torch.cuda.synchronize()
        wall = (time.time() - t0) / steps * 1e3
    rows = []
    for evt in prof.key_averages():
        dev = getattr(evt, "device_time_total", None)
        if dev is None:
            dev = getattr(evt, "cuda_time_total", 0)
        if dev and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev / steps / 1e3, evt.count // steps, evt.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    print(f"profile ({what}): {wall:.3f} ms/step on the host clock while "
          f"profiled, {total:.3f} ms of device time per step; idle share "
          f"{max(0.0, 1 - total / step_ms):.3f} of the unprofiled "
          f"{step_ms:.3f} ms/step", flush=True)
    families = {}
    for ms, _, key in rows:
        fam = next((f for f, words in KERNEL_FAMILIES
                    if any(w in key for w in words)), "other")
        families[fam] = families.get(fam, 0.0) + ms
    for fam, ms in sorted(families.items(), key=lambda x: -x[1]):
        print(f"  family {fam}: {ms:.3f} ms {100 * ms / total:.1f}%",
              flush=True)
    for ms, count, key in rows[:40]:
        print(f"  {ms:8.3f} ms {100 * ms / total:5.1f}% x{count:<4d} "
              f"{key[:110]}", flush=True)


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from volta_tpu_torch.ops import _build, attention_cuda

    power = card_line()
    print(power, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.time()
    with phase("2 build"):
        _build.load()
        print(f"kernels built ({_build.library_path().name})", flush=True)
        for line in _build.build_log().splitlines():
            if "registers" in line or "spill" in line:
                print("ptxas:", line.strip(), flush=True)

    results = {}
    with phase("3 kernel 1"):
        results["attention_fwd"] = check_kernel(attention_cuda)
    with phase("4 kernels 2-4"):
        results.update(check_train_kernels())
    with phase("5 kernels 10-13"):
        results.update(check_ln_kernels())
    with tempfile.TemporaryDirectory() as root:
        with phase("dataroot"):
            data_dir, yml = make_dataroot(root)
        flagged = write_config(root, "ctrl_uniter_base_ln_kernels.json",
                               use_pallas_layernorm=True,
                               use_fused_residual_ln=True)
        with phase("6 eval slice"):
            run_slice(root, data_dir, yml, power, CONFIG, "base",
                      {"attention_fwd": 12},
                      lambda m: (("kernels", contextlib.nullcontext),
                                 ("twins", twins)), exact_twins=True)
        with phase("7 eval slice, LN kernels"):
            _, eval_rates = run_slice(
                root, data_dir, yml, power, flagged, "ln_kernels",
                {"attention_fwd": 12, "layer_norm_fwd": 29},
                lambda m: (("LN kernels on", contextlib.nullcontext),
                           ("LN kernels off", lambda: ln_kernels_off(m))),
                exact_twins=False)
        with phase("8 train slice"):
            launches, data = run_train(root, data_dir, yml, flagged)
        from volta_tpu_torch.task_utils import load_task_config

        task_cfg = load_task_config(yml)
        batch = next(iter(data["train_loader"]))
        with phase("9 fp32 steps"):
            compare_steps(task_cfg, batch, flagged)
        with phase("10 train throughput"):
            rates = train_throughput(task_cfg, batch, power,
                                     "--profile" in argv, flagged)
    print(f"LN kernels on vs off [{power}]: eval b256 "
          f"{eval_rates[(256, 'LN kernels on')]:.1f} vs "
          f"{eval_rates[(256, 'LN kernels off')]:.1f}, b1024 "
          f"{eval_rates[(1024, 'LN kernels on')]:.1f} vs "
          f"{eval_rates[(1024, 'LN kernels off')]:.1f}, train b256 "
          f"{rates['LN kernels on'][0]:.1f} vs "
          f"{rates['LN kernels off'][0]:.1f} pairs/s", flush=True)
    print(f"chip_smoke: {time.time() - t_start:.1f} s after the card check",
          flush=True)

    foreign = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("volta_tpu", "jax", "jaxlib", "flax"))
    if foreign:
        raise RuntimeError(f"the port imported {foreign[:5]}")
    # launches: rows 1-4 from the train runs without the LayerNorm flags,
    # rows 10-13 from the run with them
    counts = {**{k: launches["dropout"][k] for k in
                 ("attention_fwd", "attention_dropout_fwd",
                  "attention_dropout_bwd")},
              "attention_bwd": launches["dropout_free"]["attention_bwd"],
              **{k: launches["flagged"][k] for k in
                 ("layer_norm_fwd", "layer_norm_bwd",
                  "dropout_residual_ln_fwd", "dropout_residual_ln_bwd")}}
    rows = [{"name": name, "route": "cuda", "source": CSRC + src,
             "replaces": replaces, "launches": counts[name],
             "max_abs_err": results[name]["max_abs_err"],
             "ms": results[name]["ms"],
             "plain_ms": results[name]["plain_ms"],
             "bound_ms": results[name]["bound"][0],
             "bound_by": results[name]["bound"][1],
             "library_ms": results[name]["library_ms"]}
            for name, (src, replaces) in KERNELS.items()]
    print(power, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
