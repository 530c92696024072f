"""Export a fine-tuned task model to a serving artifact (``torch.export``).

The port of ``tools/export_model.py``, with its flags. It builds the model
from a config and a checkpoint and writes a saved program that a serving
process loads with ``volta_tpu_torch.export.load_exported`` (or
``torch.export.load`` after importing ``volta_tpu_torch.ops.library``)
without the model code. The default artifact is parameterized (called as
``(params, *batch)``, the weights shipped apart); ``--bake_weights`` keeps
them in the file. ``--use_pallas`` keeps the CUDA kernels in it, as ops,
and pins ``--platforms cuda`` when none is given; without it the artifact
is portable (aten ops only).

    python -m volta_tpu_torch.tools.export_model \\
        --config_file configs/ctrl_uniter_base.json \\
        --tasks_config_file config_tasks/ctrl_test_tasks.yml --task 1 \\
        --from_pretrained <ckpt> --out vqa_serving.pt2 --batch_size b \\
        --use_pallas [--check] [--bench 20]

The model is traced on ``--device`` (``cuda`` by default; ``cpu`` for
tests, where a kernel artifact runs the kernels' twins).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

INPUTS = ("input_ids", "image_feat", "image_loc", "token_type_ids",
          "attention_mask", "image_attention_mask")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config_file", required=True)
    p.add_argument("--tasks_config_file", required=True)
    p.add_argument("--task", required=True)
    p.add_argument("--from_pretrained", default="",
                   help="a checkpoint of any format checkpoint.py reads; "
                        "without it the weights are random from seed 0")
    p.add_argument("--out", required=True)
    p.add_argument("--batch_size", default="32",
                   help="int, or a symbol like 'b' for a batch-polymorphic "
                        "artifact")
    p.add_argument("--seq_len", type=int, default=0,
                   help="default: the task's max_seq_length")
    p.add_argument("--platforms", nargs="*", default=None,
                   help="target platforms (default: the device's); a "
                        "--use_pallas artifact takes cuda alone")
    p.add_argument("--bake_weights", action="store_true",
                   help="keep the weights in the file (a self-contained "
                        "single-file artifact); default is a "
                        "parameterized artifact called as (params, *batch)")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--use_pallas", action="store_true",
                   help="keep the CUDA kernels in the artifact, as the ops "
                        "of volta_tpu_torch.ops.library (cuda serving)")
    p.add_argument("--quantize", default=None,
                   choices=["int8", "int8_static"],
                   help="weight+activation int8 dense layers through K9 "
                        "(serving only; see volta_tpu_torch/ops/int8_dense"
                        ".py). int8_static calibrates static activation "
                        "scales. With --check, also prints the logit "
                        "deviation and top-1 agreement against the "
                        "unquantized forward on a random batch")
    p.add_argument("--calibrate_batches", type=int, default=2,
                   help="int8_static: number of random calibration "
                        "batches (seeds disjoint from the --check batch)")
    p.add_argument("--calib_npz", default="",
                   help="int8_static: npz of real eval batches for "
                        "calibration and the --check comparison (keys "
                        "input_ids/image_feat/image_loc/token_type_ids/"
                        "attention_mask/image_attention_mask, each with a "
                        "leading batch-of-batches axis); the last batch is "
                        "held out of calibration for --check")
    p.add_argument("--check", action="store_true",
                   help="reload the artifact and run a zero batch")
    p.add_argument("--bench", type=int, default=0,
                   help="with --check: time N calls of the loaded artifact "
                        "and print samples/sec")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """Export; returns {exported, path, params, model, task, zeros,
    export_s, loaded, load_s, check, bench}: ``params`` what the artifact
    is called with ahead of the batch (None when baked), ``model`` the
    live float model, ``loaded`` the artifact --check loaded, ``check``
    its numbers and ``bench`` the samples/sec of --bench."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("export_model: --device cuda but CUDA is not "
                         "available (pass --device cpu)")
    from .. import export as vexport
    from ..checkpoint import from_pretrained
    from ..config import VoltaConfig
    from ..models import VoltaForVLTasks
    from ..models.layers import init_weights
    from ..ops.int8_dense import calibrate_activation_scales, \
        quantize_variables
    from ..task_utils import load_task_config, task_key

    cfg = VoltaConfig.from_json_file(args.config_file)
    cfg.compute_dtype = args.compute_dtype
    cfg.use_pallas = bool(args.use_pallas)
    if args.use_pallas and not args.platforms:
        # an artifact with the kernels' ops serves on the card; an explicit
        # empty --platforms list gets the same default
        args.platforms = ["cuda"]
    task_cfg = load_task_config(args.tasks_config_file)
    task = task_key(args.task)
    tc = task_cfg[task]
    if tc.get("fusion_method"):
        cfg.fusion_method = tc["fusion_method"]
    seq_len = args.seq_len or int(tc["max_seq_length"])
    region_len = int(tc["max_region_num"]) + \
        (1 if cfg.add_global_imgfeat else 0)

    model = VoltaForVLTasks(cfg, task_cfg, (task,))
    init_weights(model, torch.Generator().manual_seed(0))
    if args.from_pretrained:
        report = from_pretrained(cfg, model, args.from_pretrained)
        print(f"loaded {len(report['loaded'])} tensors")
    model.to(device).eval()
    bs = int(args.batch_size) if args.batch_size.isdigit() \
        else args.batch_size
    specs = vexport.eval_arg_specs(cfg, bs if isinstance(bs, int) else 2,
                                   seq_len, region_len)
    zeros = [torch.zeros(shape, dtype=dt, device=device)
             for shape, dt in specs]

    def rand_batch(seed):
        rng = np.random.RandomState(seed)
        b = [z.clone() for z in zeros]
        b[0] = torch.from_numpy(rng.randint(
            1, cfg.vocab_size, tuple(b[0].shape)).astype(np.int32))
        b[1] = torch.from_numpy(
            (rng.randn(*b[1].shape) * 0.5).astype(np.float32))
        b[2] = torch.from_numpy(rng.rand(*b[2].shape).astype(np.float32))
        b[4] = torch.ones_like(b[4])
        b[5] = torch.ones_like(b[5])
        return [t.to(device) for t in b]

    calib_batches = None
    if args.calib_npz:
        z = np.load(args.calib_npz)
        missing = [k for k in INPUTS if k not in z]
        if missing:
            raise SystemExit(f"--calib_npz missing arrays: {missing}")
        arrs = [z[k] for k in INPUTS]
        calib_batches = [[torch.from_numpy(a[i]).to(device) for a in arrs]
                         for i in range(arrs[0].shape[0])]
        print(f"calibrating on {len(calib_batches)} real batches "
              f"from {args.calib_npz}")

    def forward(m, b):
        return m(b[0], b[1], b[2], task, b[3], b[4], b[5])

    act_scales = None
    if args.quantize == "int8_static":
        # the last npz batch is the --check comparison batch: a check on a
        # calibrated batch could never see out-of-range clipping
        cal = (calib_batches[:-1] if len(calib_batches) > 1
               else calib_batches) if calib_batches is not None \
            else [rand_batch(s + 1) for s in range(args.calibrate_batches)]
        act_scales = calibrate_activation_scales(
            model, [(b[0], b[1], b[2], task, b[3], b[4], b[5])
                    for b in cal])
        print(f"calibrated {len(act_scales)} activation scales "
              f"on {len(cal)} batches")

    t0 = time.perf_counter()
    exported = vexport.export_task_forward(
        cfg, task_cfg, task, model.state_dict(), bs, seq_len, region_len,
        platforms=args.platforms, bake_weights=args.bake_weights,
        quantize=args.quantize, act_scales=act_scales)
    vexport.save_exported(exported, args.out)
    export_s = time.perf_counter() - t0
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 2**20:.1f} MiB, "
          f"platforms={exported.platforms}) in {export_s:.1f} s")

    params = None
    if not args.bake_weights:
        params = model.state_dict()
        if args.quantize:
            params = quantize_variables(
                model, residual_dtype=vexport.quantize_residual_dtype(cfg),
                act_scales=act_scales)
    out = {"exported": exported, "path": args.out, "params": params,
           "model": model, "task": task, "zeros": zeros,
           "export_s": export_s, "loaded": None, "load_s": None,
           "check": None, "bench": None}
    if not args.check:
        return out
    t0 = time.perf_counter()
    back = out["loaded"] = vexport.load_exported(args.out)
    out["load_s"] = time.perf_counter() - t0
    lead = () if params is None else (params,)
    with torch.no_grad():
        logits = back.call(*lead, *zeros).float()
    check = {"shape": tuple(logits.shape),
             "mean_abs": abs(float(logits.mean()))}
    print(f"check OK: output {check['shape']} {logits.dtype}, "
          f"|mean|={check['mean_abs']:.4f}")
    if args.quantize:
        # a real held-out batch (the last npz batch), else seed 0, disjoint
        # from the calibration seeds (1..N)
        rand = calib_batches[-1] if calib_batches is not None \
            else rand_batch(0)
        with torch.no_grad():
            qlog = back.call(*lead, *rand).float()
            flog = forward(model, rand).float()
        dev = (qlog - flog).abs()
        agree = float((qlog.argmax(-1) == flog.argmax(-1)).float().mean())
        check.update(max_dlogit=float(dev.max()),
                     mean_dlogit=float(dev.mean()), top1=agree)
        print(f"int8 vs {args.compute_dtype}: max|dlogit|="
              f"{check['max_dlogit']:.4f} mean={check['mean_dlogit']:.5f} "
              f"top1-agreement={agree:.3f}")
    out["check"] = check
    if args.bench:
        with torch.no_grad():
            back.call(*lead, *zeros)
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(args.bench):
                o = back.call(*lead, *zeros)
            float(o.float().ravel()[0])
            dt = (time.perf_counter() - t0) / args.bench
        out["bench"] = zeros[0].shape[0] / dt
        print(f"serving bench: {dt * 1000:.2f} ms/call, "
              f"{out['bench']:.0f} samples/sec")
    return out


if __name__ == "__main__":
    main()
