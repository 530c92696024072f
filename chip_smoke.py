#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a host with a card, nvcc and PyTorch built
for CUDA. Phases, each of which raises (and so exits non-zero) on failure:

1. card: its name and power limit as nvidia-smi gives them; TF32 off;
2. build: the CUDA kernels of ``volta_tpu_torch/ops/csrc`` through first
   use, with the build seconds and ptxas' register report;
3. kernel vs plain twin on the card, numpy inputs with a random padding
   mask: (a) B=256, L=60, H=12, D=64 bf16 (the serving shape), (b) the same
   in fp32, (c) B=3, Lq=5, Lk=563 bf16 (the longest task sequence);
   tolerances bf16 2e-2 (two bf16 ulps at |x| ~ 2), fp32 1e-5; times at (a);
4. slice: a synthetic VQA dataroot at full feature width (2048 dims, 36
   boxes, 3129 labels, 1024 val questions) through ``python -m
   volta_tpu_torch.eval_task``'s ``main()`` with ctrl_uniter_base in bf16 and
   random weights from a seed; the kernel must run 12 times per batch, all
   logits must be finite and every question must get one answer; one batch
   is compared with the same model on the plain twin (logits within 5e-2);
   eval throughput at b256 and b1024 with the kernel and with the twin;
5. the kernels' JSON line, then ``{"ok": true, "device": ...}`` last.

It exits non-zero without a result where CUDA is absent, or where the
package is missing beside it.
"""

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


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def check_kernel(attention_cuda):
    """Phase 3: the kernel against its twin at three shapes; the times of
    both at the serving shape."""
    import torch

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
        report[tag] = err
        if tag == "a":
            ms = cuda_ms(lambda: attention_cuda.attention_fwd(
                q, k, v, bias, d ** -0.5, h), iters=100)
            plain_ms = cuda_ms(lambda: attention_cuda.attention_fwd_ref(
                q, k, v, bias, d ** -0.5, h), iters=100)
            ms2 = cuda_ms(lambda: attention_cuda.attention_fwd(
                q, k, v, bias, d ** -0.5, h), iters=100)
            report["ms"], report["plain_ms"] = (ms + ms2) / 2, plain_ms
            print(f"kernel (a) time {report['ms']:.4f} ms (runs {ms:.4f}, "
                  f"{ms2:.4f}), plain twin {plain_ms:.4f} ms", flush=True)
    return report


def make_dataroot(root):
    data = os.path.join(root, "vqa")
    subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "make_synth_data.py"),
         "vqa", "--out", data, "--images", "256", "--questions", "1200",
         "--boxes", "36", "--feat_dim", "2048", "--num_labels", "3129",
         "--seed", "0"],
        check=True, cwd=REPO, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO))
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
""")
    return data, yml


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


def run_slice(attention_cuda, power):
    """Phase 4: the eval CLI on synthetic VQA at full width."""
    import torch

    from volta_tpu_torch import eval_task
    from volta_tpu_torch.eval_step import make_task_eval_step, to_device

    with tempfile.TemporaryDirectory() as root:
        t0 = time.time()
        data_dir, yml = make_dataroot(root)
        print(f"synthetic VQA dataroot in {time.time() - t0:.1f} s",
              flush=True)
        argv = ["--config_file", os.path.join(REPO, "configs",
                                              "ctrl_uniter_base.json"),
                "--tasks_config_file", yml, "--task", "1",
                "--vocab_file", os.path.join(data_dir, "vocab.txt"),
                "--output_dir", os.path.join(root, "results"),
                "--num_workers", "4", "--compute_dtype", "bfloat16",
                "--device", "cuda", "--seed", "0"]

        attention_cuda.LAUNCHES = 0
        t0 = time.time()
        summary = eval_task.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = attention_cuda.LAUNCHES

        args = eval_task.parse_args(argv)
        model, task_cfg, task, data = eval_task.setup(args)
        n_q = len(data["dataset"])
        n_batches = -(-n_q // 256)
        print(f"eval_task.main: {summary['n']} questions in {n_batches} "
              f"batches, {wall:.1f} s wall (build, data and model set-up "
              f"included), loss {summary['loss']:.4f} score "
              f"{summary['score']:.4f}, kernel launches {launches}",
              flush=True)
        if launches != 12 * n_batches:
            raise RuntimeError(f"attention kernel ran {launches} times, "
                               f"expected 12 x {n_batches} batches")
        if summary["nonfinite_batches"]:
            raise RuntimeError("non-finite logits in "
                               f"{summary['nonfinite_batches']} batches")
        with open(summary["out_file"]) as f:
            results = json.load(f)
        qids = sorted(r["question_id"] for r in results)
        want = sorted(int(e["question_id"]) for e in data["dataset"].entries)
        if qids != want or summary["n"] != n_q:
            raise RuntimeError(f"{len(results)} answers for {n_q} questions")

        step = make_task_eval_step(model, task_cfg, task)
        batches = list(data["loader"])
        one = to_device(batches[0], "cuda")
        kernel_logits = step(one)["prediction"].float()
        kernel_fn = attention_cuda.attention_fwd
        before = attention_cuda.LAUNCHES
        attention_cuda.attention_fwd = attention_cuda.attention_fwd_ref
        try:
            plain_logits = step(one)["prediction"].float()
        finally:
            attention_cuda.attention_fwd = kernel_fn
        diff = float((kernel_logits - plain_logits).abs().max())
        print(f"logits b256 kernel vs plain twin: max abs diff {diff:.3e} "
              f"(tol {LOGIT_TOL:g}), |logits| max "
              f"{float(kernel_logits.abs().max()):.3f}", flush=True)
        if attention_cuda.LAUNCHES != before or not diff <= LOGIT_TOL \
                or not bool(torch.isfinite(kernel_logits).all()):
            raise RuntimeError("kernel model disagrees with the plain twin")

        rates = {}
        for bsz, batch in ((256, one),
                           (1024, to_device(concat_batches(batches[:4]),
                                            "cuda"))):
            runs = {"kernel": [], "plain": []}
            for name in ("kernel", "plain", "plain", "kernel"):
                if name == "plain":
                    attention_cuda.attention_fwd = \
                        attention_cuda.attention_fwd_ref
                try:
                    runs[name].append(throughput(step, batch, iters=10))
                finally:
                    attention_cuda.attention_fwd = kernel_fn
            for name, rs in runs.items():
                rate = sum(r for r, _ in rs) / len(rs)
                mem = max(m for _, m in rs)
                rates[(bsz, name)] = rate
                print(f"eval forward b{bsz} {name}: {rate:.1f} pairs/s "
                      f"(runs {rs[0][0]:.1f}, {rs[1][0]:.1f}), peak "
                      f"{mem:.2f} GiB [{power}]", flush=True)
        print(f"eval end to end (eval_task.main, b256, 1024 questions): "
              f"{summary['n'] / wall:.1f} pairs/s [{power}]", flush=True)
    return launches


def main():
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

    t0 = time.time()
    _build.load()
    print(f"kernels built in {time.time() - t0:.1f} s "
          f"({_build.library_path().name})", flush=True)
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip(), flush=True)

    kern = check_kernel(attention_cuda)
    launches = run_slice(attention_cuda, power)

    jax_mods = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "flax"))
    if jax_mods:
        raise RuntimeError(f"the port imported {jax_mods[:5]}")
    print(power, flush=True)
    print(json.dumps({"kernels": [{
        "name": "attention_fwd", "route": "cuda",
        "source": "volta_tpu_torch/ops/csrc/attention_fwd.cu",
        "replaces": "volta_tpu/ops/pallas_attention.py:670",
        "launches": launches, "max_abs_err": kern["a"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
