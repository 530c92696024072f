#!/usr/bin/env python3
"""Drive the PyTorch port's serving and fine-tuning paths once on one
NVIDIA GPU.

    python3 chip_smoke.py [--profile]

From the root of a checkout, on a host with a card, nvcc and PyTorch built
for CUDA. Phases, each of which raises (and so exits non-zero) on failure:

1. card: its name and power limit as nvidia-smi gives them; TF32 off;
2. build: the CUDA kernels of ``volta_tpu_torch/ops/csrc`` through first
   use, with the build seconds and ptxas' register report;
3. kernel 1 (attention forward) vs its plain twin on the card, numpy inputs
   with a random padding mask: (a) B=256, L=60, H=12, D=64 bf16 (the
   serving shape), (b) the same in fp32, (c) B=3, Lq=5, Lk=563 bf16 (the
   longest task sequence); tolerances bf16 2e-2 (two bf16 ulps at |x| ~ 2),
   fp32 1e-5; times at (a);
4. kernels 2-4 (attention backward, dropout attention forward and
   backward) vs their twins at the serving shape in bf16 and fp32 and at
   odd shapes (Lq != Lk, Lq < 8, D = 16 and 128): dq/dk/dv/db and the
   dropout output within two bf16 ulps of the largest value (fp32 1e-5
   relative), the dropout mask bit-equal to the twin's, its keep fraction
   0.9 +- 0.005 at b256; times of each kernel and twin at (a);
5. eval slice: a synthetic VQA dataroot at full feature width (2048 dims,
   36 boxes, 3129 labels, 1200 train and 1024 val questions) through
   ``python -m volta_tpu_torch.eval_task``'s ``main()`` with
   ctrl_uniter_base in bf16 and random weights from a seed; kernel 1 must
   run 12 times per batch, all logits must be finite and every question
   must get one answer; one batch is compared with the same model on the
   plain twin (logits within 5e-2); eval throughput at b256 and b1024;
6. train slice: ``python -m volta_tpu_torch.train_task``'s ``main()``, 2
   epochs at b256 in bf16 with the config's dropout: kernels 3 and 4 must
   run exactly 12 times per step and kernel 1 12 times per validation
   batch, losses finite and falling, one VAL line per epoch; then 1 epoch
   of the same config with its dropout rates set to 0, which must run
   kernel 2 12 times per step;
7. one fp32 train step at full width (64 rows) with the kernels and with
   the twins from the same weights and seed, with dropout and without: the
   losses within 1e-5 relative, every parameter within 2% of the step's
   largest update;
8. train-step throughput at b256 bf16, inputs on the card (forward,
   backward, clip, AdamW), with the kernels and with the twins, and the
   peak memory of each; with ``--profile`` the device time of a step by
   kernel;
9. the kernels' JSON line, then ``{"ok": true, "device": ...}`` last.

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
STEP_TOL = 0.02
RATE = 0.1
SERVING = (256, 60, 60, 12, 64)
ODD = [(2, 9, 33, 4, 16), (3, 5, 37, 2, 64), (2, 17, 70, 2, 128)]
CONFIG = os.path.join(REPO, "configs", "ctrl_uniter_base.json")
CSRC = "volta_tpu_torch/ops/csrc/"
PALLAS = "volta_tpu/ops/pallas_attention.py"
# the profile's kernel families, first match wins: the int64 ops are the
# hash dropout's mask draws (the only int64 arithmetic of the step)
KERNEL_FAMILIES = (
    ("attention kernels", ("attention_",)),
    ("hash dropout (int64 ops)", ("<long", "long>", "arange")),
    ("matmuls", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("LayerNorm fwd+bwd", ("layer_norm", "GammaBeta")),
    ("AdamW + clip", ("multi_tensor_apply",)),
    ("gelu fwd+bwd", ("Gelu",)),
    ("casts and copies", ("copy",)),
    ("reductions", ("reduce_kernel",)),
)


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
    """Phase 3: kernel 1 against its twin at three shapes; the times of
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
    """Phase 4: kernels 2-4 against their twins; their times at (a)."""
    import torch

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
    shape = (q.shape[0], h, q.shape[1], k.shape[1])
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
        report[name].update(ms=(ms + ms2) / 2, plain_ms=plain_ms)
        print(f"{name} (a) time {(ms + ms2) / 2:.4f} ms (runs {ms:.4f}, "
              f"{ms2:.4f}), plain twin {plain_ms:.4f} ms (mask draw "
              "included)", flush=True)
    return report


@contextlib.contextmanager
def twins():
    """The four kernels' plain twins in their wrappers' places: the
    autograd Functions look their wrappers up at call time, so the card
    runs the twins (the dropout twins with the kernels' hash mask). No
    kernel may launch meanwhile."""
    from volta_tpu_torch.ops import LAUNCHES
    from volta_tpu_torch.ops import attention_cuda as ac
    from volta_tpu_torch.ops import attention_dropout_cuda as adc

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

    saved = (ac.attention_fwd, ac.attention_bwd, adc.attention_dropout_fwd,
             adc.attention_dropout_bwd)
    before = dict(LAUNCHES)
    ac.attention_fwd, ac.attention_bwd = ac.attention_fwd_ref, \
        ac.attention_bwd_ref
    adc.attention_dropout_fwd, adc.attention_dropout_bwd = dropout_fwd, \
        dropout_bwd
    try:
        yield
    finally:
        (ac.attention_fwd, ac.attention_bwd, adc.attention_dropout_fwd,
         adc.attention_dropout_bwd) = saved
    if LAUNCHES != before:
        raise RuntimeError("a kernel launched while the twins were in place")


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
  lr: 0.0001
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


def run_slice(root, data_dir, yml, power):
    """Phase 5: the eval CLI on synthetic VQA at full width."""
    import torch

    from volta_tpu_torch import eval_task
    from volta_tpu_torch.eval_step import make_task_eval_step, to_device
    from volta_tpu_torch.ops import LAUNCHES, attention_cuda, reset_launches

    argv = ["--config_file", CONFIG, "--tasks_config_file", yml, "--task", "1",
            "--vocab_file", os.path.join(data_dir, "vocab.txt"),
            "--output_dir", os.path.join(root, "results"),
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
    print(f"eval_task.main: {summary['n']} questions in {n_batches} "
          f"batches, {wall:.1f} s wall (data and model set-up included), "
          f"loss {summary['loss']:.4f} score {summary['score']:.4f}, "
          f"kernel launches {launches}", flush=True)
    if launches != dict(launches, attention_fwd=12 * n_batches) \
            or sum(launches.values()) != 12 * n_batches:
        raise RuntimeError(f"eval launches {launches}, expected kernel 1 "
                           f"12 x {n_batches} batches and nothing else")
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
    before = dict(LAUNCHES)
    attention_cuda.attention_fwd = attention_cuda.attention_fwd_ref
    try:
        plain_logits = step(one)["prediction"].float()
    finally:
        attention_cuda.attention_fwd = kernel_fn
    diff = float((kernel_logits - plain_logits).abs().max())
    print(f"logits b256 kernel vs plain twin: max abs diff {diff:.3e} "
          f"(tol {LOGIT_TOL:g}), |logits| max "
          f"{float(kernel_logits.abs().max()):.3f}", flush=True)
    if LAUNCHES != before or not diff <= LOGIT_TOL \
            or not bool(torch.isfinite(kernel_logits).all()):
        raise RuntimeError("kernel model disagrees with the plain twin")

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
            print(f"eval forward b{bsz} {name}: {rate:.1f} pairs/s "
                  f"(runs {rs[0][0]:.1f}, {rs[1][0]:.1f}), peak "
                  f"{mem:.2f} GiB [{power}]", flush=True)
    print(f"eval end to end (eval_task.main, b256, 1024 questions): "
          f"{summary['n'] / wall:.1f} pairs/s [{power}]", flush=True)
    return launches


def train_argv(root, data_dir, yml, config, epochs, tag):
    return ["--config_file", config, "--tasks_config_file", yml,
            "--task", "1", "--vocab_file", os.path.join(data_dir, "vocab.txt"),
            "--output_dir", os.path.join(root, f"save_{tag}"),
            "--logdir", os.path.join(root, f"logs_{tag}"),
            "--num_train_epochs", str(epochs), "--num_workers", "4",
            "--compute_dtype", "bfloat16", "--clip_grad_norm", "1.0",
            "--device", "cuda", "--seed", "0"]


def run_train(root, data_dir, yml, power):
    """Phase 6: the train CLI at full width, with the config's dropout and
    with its dropout rates set to 0. Returns the launches of each run."""
    import torch

    from volta_tpu.config import VoltaConfig
    from volta_tpu_torch import train_task
    from volta_tpu_torch.ops import LAUNCHES, reset_launches
    from volta_tpu_torch.task_utils import load_dataset, load_task_config

    cfg = VoltaConfig.from_json_file(CONFIG)
    free = os.path.join(root, "ctrl_uniter_base_dropout_free.json")
    with open(free, "w") as f:
        f.write(cfg.to_json_string().replace(
            '"attention_probs_dropout_prob": 0.1',
            '"attention_probs_dropout_prob": 0.0').replace(
            '"hidden_dropout_prob": 0.1', '"hidden_dropout_prob": 0.0'))
    free_cfg = VoltaConfig.from_json_file(free)
    if free_cfg.attention_probs_dropout_prob or free_cfg.hidden_dropout_prob:
        raise RuntimeError("the dropout-free config still drops")

    out = {}
    for tag, config, epochs in (("dropout", CONFIG, 2),
                                ("dropout_free", free, 1)):
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
        val = 12 * epochs * n_val
        want = ({"attention_dropout_fwd": 12 * steps,
                 "attention_dropout_bwd": 12 * steps,
                 "attention_fwd": val, "attention_bwd": 0}
                if tag == "dropout" else
                {"attention_dropout_fwd": 0, "attention_dropout_bwd": 0,
                 "attention_fwd": 12 * steps + val,
                 "attention_bwd": 12 * steps})
        if launches != want:
            raise RuntimeError(f"{tag} launches {launches}, expected {want}")
        out[tag] = launches
    return out, data


def build_model(task_cfg, dtype, seed=0):
    """ctrl_uniter_base with a VQA head on the card, random weights from
    ``seed``."""
    import torch

    from volta_tpu.config import VoltaConfig
    from volta_tpu_torch import VoltaForVLTasks
    from volta_tpu_torch.models.layers import init_weights

    cfg = VoltaConfig.from_json_file(CONFIG)
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


def compare_steps(task_cfg, batch_np):
    """Phase 7: one fp32 step with the kernels and with the twins."""
    import torch

    from volta_tpu_torch.eval_step import to_device
    from volta_tpu_torch.ops import LAUNCHES, reset_launches

    model = build_model(task_cfg, "float32")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = to_device({k: v[:64] for k, v in batch_np.items()
                       if isinstance(v, np.ndarray)}, "cuda")
    for mode, kernels in (("dropout", ("attention_dropout_fwd",
                                       "attention_dropout_bwd")),
                          ("dropout-free", ("attention_fwd",
                                            "attention_bwd"))):
        res = {}
        for route in ("kernel", "twin"):
            model.load_state_dict(init)
            model.train(mode == "dropout")
            state, step = new_step(model, task_cfg, 1e-4)
            reset_launches()
            with twins() if route == "twin" else contextlib.nullcontext():
                loss = float(step(state, batch)["loss"])
            res[route] = (loss, {k: v.clone()
                                 for k, v in model.state_dict().items()},
                          dict(LAUNCHES))
        counts = res["kernel"][2]
        if [counts[k] for k in kernels] != [12, 12] \
                or sum(counts.values()) != 24:
            raise RuntimeError(f"{mode} kernel step launched {counts}")
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


def train_throughput(task_cfg, batch_np, power, profile):
    """Phase 8: pairs/s of the b256 bf16 train step with the kernels and
    with the twins (order kernel, twin, twin, kernel); peak memory."""
    import torch

    from volta_tpu_torch.eval_step import to_device
    from volta_tpu_torch.optimization import warmup_linear_schedule

    model = build_model(task_cfg, "bfloat16").train()
    state, step = new_step(model, task_cfg,
                           warmup_linear_schedule(1e-4, 10, 1000))
    batch = to_device({k: v for k, v in batch_np.items()
                       if isinstance(v, np.ndarray)}, "cuda")
    n = int(batch["question"].shape[0])
    runs = {"kernel": [], "twin": []}
    for route in ("kernel", "twin", "twin", "kernel"):
        with twins() if route == "twin" else contextlib.nullcontext():
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: step(state, batch), iters=10, warmup=2)
            runs[route].append((n / (ms / 1e3), ms,
                                torch.cuda.max_memory_allocated() / 2**30))
    rates = {}
    for route, rs in runs.items():
        rates[route] = sum(r for r, _, _ in rs) / len(rs)
        print(f"train step b{n} bf16 {route}s: {rates[route]:.1f} pairs/s "
              f"({(rs[0][1] + rs[1][1]) / 2:.2f} ms/step; runs "
              f"{rs[0][0]:.1f}, {rs[1][0]:.1f}), peak "
              f"{max(m for _, _, m in rs):.2f} GiB [{power}]", flush=True)
    if profile:
        profile_step(step, state, batch,
                     sum(ms for _, ms, _ in runs["kernel"]) / 2)
    return rates


def profile_step(step, state, batch, step_ms, steps=3):
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
    print(f"profile: {wall:.3f} ms/step on the host clock while profiled, "
          f"{total:.3f} ms of device time per step; idle share "
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

    t0 = time.time()
    _build.load()
    print(f"kernels built in {time.time() - t0:.1f} s "
          f"({_build.library_path().name})", flush=True)
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip(), flush=True)

    kern = check_kernel(attention_cuda)
    train_kern = check_train_kernels()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.time()
        data_dir, yml = make_dataroot(root)
        print(f"synthetic VQA dataroot in {time.time() - t0:.1f} s",
              flush=True)
        run_slice(root, data_dir, yml, power)
        launches, data = run_train(root, data_dir, yml, power)
        from volta_tpu_torch.task_utils import load_task_config

        task_cfg = load_task_config(yml)
        batch = next(iter(data["train_loader"]))
        compare_steps(task_cfg, batch)
        train_throughput(task_cfg, batch, power, "--profile" in argv)

    jax_mods = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "flax"))
    if jax_mods:
        raise RuntimeError(f"the port imported {jax_mods[:5]}")
    drop, free = launches["dropout"], launches["dropout_free"]
    rows = [("attention_fwd", "attention_fwd.cu", 670, drop, kern["a"],
             kern["ms"], kern["plain_ms"])]
    for name, src, line, counts in (
            ("attention_bwd", "attention_bwd.cu", 683, free),
            ("attention_dropout_fwd", "attention_dropout.cu", 510, drop),
            ("attention_dropout_bwd", "attention_dropout.cu", 530, drop)):
        r = train_kern[name]
        rows.append((name, src, line, counts, r["max_abs_err"], r["ms"],
                     r["plain_ms"]))
    print(power, flush=True)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": CSRC + src,
        "replaces": f"{PALLAS}:{line}", "launches": counts[name],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        for name, src, line, counts, err, ms, plain_ms in rows]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
