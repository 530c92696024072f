#!/usr/bin/env python3
"""Compare two checkouts of the repo on one NVIDIA GPU, in turns: the
dropout attention forwards of the port (Queue 2 rows 3, 5 and 9), the fused
dropout + residual + LayerNorm kernels (rows 12 and 13), the keep-mask
kernel (row 14) and the probes' matmul kernels (rows 15 and 16) by device
time, and the b256 bf16 train step by wall time and by device time per
kernel family.

    python3 chip_ab.py --other DIR [--what kernels|steps|both]

From the root of a checkout, with DIR the root of another one (a parent
commit unpacked by ``git archive`` into a directory that ``.gitignore``
lists). Each turn is a process in one of the two checkouts, in the order
other, this, this, other, so that drift in the card's or the host's speed
falls on both sides alike. A turn imports ``chip_smoke`` and
``volta_tpu_torch`` of its own checkout, so it builds and runs that
checkout's kernels, and measures with chip_smoke's functions:

- kernels: rows 3, 9 and 5 at B=256, L=60, H=12, D=64 in bf16 and fp32 by
  ``kernel_ms`` (the card held busy while the host enqueues, 100 calls),
  and row 3 also with its keep mask written (``return_mask``); rows 12
  and 13 at n=15360, d=768 in bf16 and fp32 and row 14 at that shape by
  ``kernel_ms``; rows 15 and 16 at the probes' shapes (n=15360, h=768,
  f=3072: row 15, row 16's first leg with the gelu and its bias-only
  second leg) by ``kernel_ms`` over 20 calls;
- steps: ctrl_uniter_base's b256 bf16 train step (forward, backward, clip,
  AdamW; random weights from seed 0, one batch of chip_smoke's synthetic
  VQA data) with the config's dropout, with ``fuse_hidden_dropout``,
  head-major and with the LayerNorm kernels (``use_pallas_layernorm`` and
  ``use_fused_residual_ln``): three ``cuda_ms`` readings of 10 steps each
  and the peak device memory over them, then ``profile_device``'s device
  time by kernel family over 3 steps.

Every result line starts with the turn's side (``other`` or ``this``); the
card's name and power limit come first.
"""

import argparse
import os
import subprocess
import sys


def measure_kernels(cs, side):
    import torch

    from volta_tpu_torch.ops import attention_dropout_cuda as adc
    from volta_tpu_torch.ops import matmul as mm
    from volta_tpu_torch.ops import attention_head_major_cuda as ahm
    from volta_tpu_torch.ops import attention_hidden_mask_cuda as ahc

    b, lq, lk, h, d = cs.SERVING
    scale = d ** -0.5
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, bias = cs.attention_inputs(b, lq, lk, h, d, dt, 100)
        hq, hk, hv = (cs.head_major(x, h) for x in (q, k, v))
        calls = {
            "row 3": lambda: adc.attention_dropout_fwd(
                q, k, v, bias, scale, h, cs.RATE, 1000),
            "row 3 with its mask": lambda: adc.attention_dropout_fwd(
                q, k, v, bias, scale, h, cs.RATE, 1000, return_mask=True),
            "row 9": lambda: ahc.attention_dropout_hidden_masks_fwd(
                hq, hk, hv, bias, scale, cs.RATE, 7, cs.RATE, 8, 9),
            "row 5": lambda: ahm.attention_dropout_head_major_fwd(
                hq, hk, hv, bias, scale, cs.RATE, 7)}
        for name, fn in calls.items():
            print(f"{side} kernel {name} {str(dt)[6:]}: "
                  f"{cs.kernel_ms(fn):.4f} ms", flush=True)
    from volta_tpu_torch.ops import dropout_mask as dm
    from volta_tpu_torch.ops import fused_residual as fr

    n, d = cs.TRAIN_ROWS
    for dt in ("bfloat16", "float32"):
        x, o, g, w, b = cs.ln_inputs(n, d, dt, seed=n + d)
        _, od, mean, rstd = fr.dropout_residual_ln_fwd(o, x, w, b, 7,
                                                       cs.RATE, cs.EPS)
        calls = {"row 12": lambda: fr.dropout_residual_ln_fwd(
                     o, x, w, b, 7, cs.RATE, cs.EPS),
                 "row 13": lambda: fr.dropout_residual_ln_bwd(
                     g, od, x, w, mean, rstd, 7, cs.RATE)}
        for name, fn in calls.items():
            print(f"{side} kernel {name} n={n} d={d} {dt}: "
                  f"{cs.kernel_ms(fn):.4f} ms", flush=True)
        del x, o, g, od
    ms = cs.kernel_ms(lambda: dm.keep_mask((n, d), cs.RATE, 17, "cuda"))
    print(f"{side} kernel row 14 n={n} d={d}: {ms:.4f} ms", flush=True)
    n, h, f = cs.PROBE
    g, a = cs.matmul_inputs([(n, h), (n, f)], seed=1)
    x, w, b = cs.matmul_inputs([(n, h), (h, f), (1, f)], seed=2)
    x2, w2, b2 = cs.matmul_inputs([(n, f), (f, h), (1, h)], seed=3)
    calls = {"row 15": lambda: mm.wgrad(g, a),
             "row 16 gelu": lambda: mm.matmul_bias_act(x, w, b, True),
             "row 16 leg 2": lambda: mm.matmul_bias_act(x2, w2, b2, False)}
    for name, fn in calls.items():
        print(f"{side} kernel {name} n={n} h={h} f={f}: "
              f"{cs.kernel_ms(fn, iters=20):.4f} ms", flush=True)


def measure_steps(cs, side):
    import tempfile

    import numpy as np
    import torch

    from volta_tpu_torch import train_task
    from volta_tpu_torch.config import VoltaConfig
    from volta_tpu_torch.eval_step import to_device
    from volta_tpu_torch.optimization import warmup_linear_schedule
    from volta_tpu_torch.task_utils import load_dataset, load_task_config

    with tempfile.TemporaryDirectory() as root:
        data_dir, yml = cs.make_dataroot(root)
        configs = {
            "default": cs.CONFIG,
            "fuse_hidden_dropout": cs.write_config(
                root, "fuse.json", fuse_hidden_dropout=True),
            "head-major": cs.write_config(root, "hm.json",
                                          attn_natural_layout=False),
            "LN flags": cs.write_config(root, "ln.json",
                                        use_pallas_layernorm=True,
                                        use_fused_residual_ln=True)}
        task_cfg = load_task_config(yml)
        argv = cs.train_argv(root, data_dir, yml, cs.CONFIG, 1, "ab")
        data = load_dataset(train_task.parse_args(argv),
                            VoltaConfig.from_json_file(cs.CONFIG), task_cfg,
                            "1")
        batch = to_device({k: v for k, v in
                           next(iter(data["train_loader"])).items()
                           if isinstance(v, np.ndarray)}, "cuda")
        for name, config in configs.items():
            model = cs.build_model(task_cfg, "bfloat16", config).train()
            state, step = cs.new_step(model, task_cfg,
                                      warmup_linear_schedule(1e-4, 10, 1000))
            torch.cuda.reset_peak_memory_stats()
            ms = [cs.cuda_ms(lambda: step(state, batch), iters=10, warmup=2)
                  for _ in range(3)]
            print(f"{side} step {name}: wall ms a step "
                  f"{', '.join(f'{m:.3f}' for m in ms)} (median "
                  f"{float(np.median(ms)):.3f}), peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
                  flush=True)
            cs.profile_device(lambda: step(state, batch),
                              float(np.median(ms)), f"{side} step {name}")
            del model, state, step


def measure(side, what):
    """One turn, in the checkout that is the working directory."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if what in ("kernels", "both"):
        measure_kernels(cs, side)
    if what in ("steps", "both"):
        measure_steps(cs, side)


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--other", help="the root of the other checkout")
    p.add_argument("--what", choices=("kernels", "steps", "both"),
                   default="both")
    p.add_argument("--measure", choices=("other", "this"),
                   help=argparse.SUPPRESS)  # one turn, in its checkout
    args = p.parse_args(argv)
    if args.measure:
        measure(args.measure, args.what)
        return 0
    if not args.other or not os.path.isfile(
            os.path.join(args.other, "chip_smoke.py")):
        p.error("--other must be the root of another checkout")
    here = os.path.dirname(os.path.abspath(__file__))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    for side in ("other", "this", "this", "other"):
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--measure", side, "--what", args.what],
                       cwd=here if side == "this" else args.other,
                       check=True, timeout=1800)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
