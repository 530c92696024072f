"""Fine-tune a model of the port on one task, validating every epoch.

Counterpart of the root ``train_task.py`` (its flags :25-98 and its loop
:100-312) for every task type of the port's ``VoltaForVLTasks``:

    python -m volta_tpu_torch.train_task --config_file configs/ctrl_uniter_base.json \\
        --tasks_config_file config_tasks/ctrl_trainval_tasks.yml --task 1 \\
        --output_dir save --logdir logs

Weights random from ``--seed``, or from ``--from_pretrained``: a published
VOLTA ``.bin``, an HF BERT ``.bin`` or the port's own checkpoint
(``checkpoint.from_pretrained``); AdamW (``correct_bias=False``) behind the
global-norm clip with the warmup-linear schedule; dropout at the config's
rates through the CUDA kernels on the card. It writes the JAX CLI's
``<logdir>/<run>/out.txt`` lines (``VAL epoch N TASK1 loss … score …``),
``<output_dir>/<run>/command.txt``, and ``torch.save``s the model,
optimizer and dropout-generator state to
``<output_dir>/<run>/ckpt/train_state.pt`` every epoch and to ``best/``
when the val score improves (``eval_task --from_pretrained`` reads
either). A run resumes from ``--resume_file`` (the reference's
``pytorch_ckpt_latest.tar`` or a port ``train_state.pt`` or its
directory), else from its own ``ckpt/train_state.pt`` where one exists.
``--device`` defaults to ``cuda`` and never falls back to the CPU. Flags of
features not ported yet raise; the JAX-only ``--prng_impl`` and
``--no_pallas`` do not exist here.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    # Model
    p.add_argument("--from_pretrained", default="", type=str,
                   help="a VOLTA-format .bin, an HF BERT .bin (detected by "
                   "its layer names), the port's own state dict or "
                   "train_state.pt (or its directory), or an http(s) URL "
                   "of one already placed in the cache; Flax msgpack "
                   "bundles and Orbax directories raise (ROADMAP.md Queue "
                   "1 item 12), and so does a RoBERTa model (item 6)")
    p.add_argument("--bert_model", default="bert-base-uncased", type=str)
    p.add_argument("--config_file", default="configs/ctrl_uniter_base.json",
                   type=str)
    p.add_argument("--resume_file", default="", type=str,
                   help="the reference's pytorch_ckpt_latest.tar (weights, "
                   "AdamW moments, global_step, epoch_id) or the port's "
                   "train_state.pt or its directory; without it a run "
                   "resumes from <output_dir>/<run>/ckpt/train_state.pt "
                   "where that exists")
    # Output
    p.add_argument("--output_dir", default="save", type=str)
    p.add_argument("--logdir", default="logs", type=str)
    p.add_argument("--save_name", default="", type=str)
    # Task
    p.add_argument("--tasks_config_file",
                   default="config_tasks/ctrl_trainval_tasks.yml", type=str)
    p.add_argument("--task", default="1", type=str)
    # Text
    p.add_argument("--do_lower_case", action="store_true", default=True)
    p.add_argument("--vocab_file", default="", type=str,
                   help="local vocab.txt for the self-contained tokenizer")
    # Training
    p.add_argument("--num_train_epochs", default=20, type=int)
    p.add_argument("--gradient_accumulation_steps", dest="grad_acc_steps",
                   type=int, default=1)
    p.add_argument("--drop_last", action="store_true")
    p.add_argument("--eval_period", default=1, type=int,
                   help="evaluate every N epochs")
    # Scheduler
    p.add_argument("--lr_scheduler", default="warmup_linear", type=str)
    p.add_argument("--warmup_proportion", default=0.1, type=float)
    p.add_argument("--warmup_steps", default=None, type=float)
    # Seed / workers
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--in_memory", default=False, type=bool)
    p.add_argument("--num_worker_procs", type=int, default=0,
                   help="forked decode processes (multi-core hosts)")
    p.add_argument("--device_store", action="store_true")
    # Optimization
    p.add_argument("--optim", default="AdamW", type=str)
    p.add_argument("--adam_epsilon", default=1e-6, type=float)
    p.add_argument("--adam_betas", default=(0.9, 0.999), nargs="+",
                   type=float)
    p.add_argument("--adam_correct_bias", default=False, action="store_true")
    p.add_argument("--optimizer_state_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--weight_decay", default=0.01, type=float)
    p.add_argument("--clip_grad_norm", default=0.0, type=float)
    p.add_argument("--skip_disconnected_params", action="store_true")
    # Compute
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--profile_steps", default=0, type=int)
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd anomaly detection")
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--device", default="cuda", type=str)
    return p.parse_args(argv)


def refuse_unported(args):
    """Raise NotImplementedError for each flag whose feature the port does
    not have yet, naming the ROADMAP.md item that owns it."""
    unported = [
        (args.device_store, "--device_store", "Queue 1 item 5"),
        (args.grad_acc_steps > 1, "--gradient_accumulation_steps > 1",
         "Queue 1 item 5"),
        (args.optim.lower() == "radam", "--optim RAdam", "Queue 1 item 8"),
        (args.optimizer_state_dtype != "float32",
         "--optimizer_state_dtype bfloat16", "Queue 1 item 8"),
        (args.skip_disconnected_params, "--skip_disconnected_params",
         "Queue 1 item 8"),
        (args.profile_steps, "--profile_steps", "Queue 1 item 11"),
        (args.distributed, "--distributed", "Queue 1 item 9"),
    ]
    for given, flag, item in unported:
        if given:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP.md {item})")


def _fetch(pending, keys):
    """The window's device scalars in one transfer: [(tag, v0, v1, ...)]."""
    if not pending:
        return []
    flat = torch.stack([m[k].float() for _, m in pending
                        for k in keys]).cpu().tolist()
    n = len(keys)
    return [(tag,) + tuple(flat[i * n:(i + 1) * n])
            for i, (tag, _) in enumerate(pending)]


def main(argv=None):
    """Train; returns {best_score, steps, train_losses, val_scores,
    run_dir, log_dir}."""
    args = parse_args(argv)
    refuse_unported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_task: --device cuda but CUDA is not available "
                         "(pass --device cpu to run on the CPU)")
    from .checkpoint import TRAIN_STATE, from_pretrained, resume, \
        save_train_state
    from .config import VoltaConfig
    from .eval_step import make_task_eval_step
    from .models import VoltaForVLTasks
    from .models.layers import init_weights
    from .optimization import SCHEDULES, build_optimizer
    from .task_utils import load_dataset, load_task_config, task_key
    from .train_step import create_train_state, make_task_train_step
    from .train_utils import (MetricsLogger, check_fixed_layers,
                              save_command, set_seed)

    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    set_seed(args.seed)
    cfg = VoltaConfig.from_json_file(args.config_file)
    if "roberta" in args.bert_model:
        cfg.model = "roberta"
    cfg.compute_dtype = args.compute_dtype
    check_fixed_layers(cfg.fixed_layers)
    task_cfg = load_task_config(args.tasks_config_file)
    task = task_key(args.task)
    tc = task_cfg[task]
    if tc.get("fusion_method"):
        # per-task pooling override (reference: train_task.py:144-146)
        cfg.fusion_method = tc["fusion_method"]
    if tc.get("embed_clf"):
        raise NotImplementedError(
            "embed_clf (classifier init from answer embeddings) is not "
            "ported yet (ROADMAP.md Queue 1 item 5)")

    run_name = (f"{tc['name']}_{os.path.basename(args.config_file)}-"
                f"{args.save_name or 'base'}")
    output_dir = os.path.join(args.output_dir, run_name)
    log_dir = os.path.join(args.logdir, run_name)
    tb = MetricsLogger(log_dir)
    save_command(output_dir, args, cfg)
    ckpt_dir = os.path.join(output_dir, "ckpt")

    data = load_dataset(args, cfg, task_cfg, args.task)
    train_loader = data["train_loader"]
    val_loader = data.get("val_loader")
    if "num_labels" not in tc and hasattr(data["train_dataset"],
                                          "num_labels"):
        tc["num_labels"] = data["train_dataset"].num_labels

    model = VoltaForVLTasks(cfg, task_cfg, (task,))
    init_weights(model, torch.Generator().manual_seed(args.seed))
    if args.from_pretrained:
        report = from_pretrained(cfg, model, args.from_pretrained)
        logger.info("loaded %d tensors, %d left at init",
                    len(report["loaded"]), len(report["skipped"]))
    model.to(device)
    logger.info("parameters: %d",
                sum(p.numel() for p in model.parameters()))

    steps_per_epoch = len(train_loader) // args.grad_acc_steps
    total_steps = max(1, steps_per_epoch * args.num_train_epochs)
    warmup = int(args.warmup_steps) if args.warmup_steps is not None else \
        int(total_steps * args.warmup_proportion)
    sched = SCHEDULES[args.lr_scheduler](float(tc["lr"]), warmup, total_steps)
    optimizer = build_optimizer(
        "adamw", sched, model, weight_decay=args.weight_decay,
        clip_norm=args.clip_grad_norm or None,
        grad_accum_steps=args.grad_acc_steps, betas=tuple(args.adam_betas),
        eps=args.adam_epsilon, correct_bias=args.adam_correct_bias)
    state = create_train_state(model, optimizer, args.seed + 1)
    train_step = make_task_train_step(model, optimizer, task_cfg, task)
    eval_step = make_task_eval_step(model, task_cfg, task)

    best_score, start_epoch = -1.0, 0
    src = args.resume_file or (ckpt_dir if os.path.exists(
        os.path.join(ckpt_dir, TRAIN_STATE)) else "")
    if src:
        info = resume(cfg, state, src, steps_per_epoch)
        start_epoch, best_score = info["start_epoch"], info["best_score"]
        if info["hyperparams"]:
            logger.info("tar optimizer hyperparams (verify CLI flags "
                        "match): %s", info["hyperparams"])
        logger.info("resumed from %s at step %d (epoch %d)", src,
                    info["global_step"], start_epoch)
    train_losses, val_scores, pending = [], [], []

    def flush(epoch):
        for gs, loss, score in _fetch(pending, ("loss", "score")):
            tb.step_train(epoch, gs, loss, score, optimizer.lr(gs - 1), task)
            train_losses.append(loss)
        pending.clear()

    for epoch in range(start_epoch, args.num_train_epochs):
        train_loader.set_epoch(epoch)
        model.train()
        for batch in train_loader:
            pending.append((state.step + 1, train_step(state, batch)))
            # metrics come to the host in windows, one transfer each
            if len(pending) >= tb.period:
                flush(epoch)

        if val_loader is not None and (epoch + 1) % args.eval_period == 0:
            model.eval()
            # keep only the scalars of each batch, fetched in one transfer
            outs = [(out["batch_size"], {k: out[k] for k in ("loss", "score")})
                    for out in map(eval_step, val_loader)]
            for bsz, loss, score in _fetch(outs, ("loss", "score")):
                tb.step_val(loss, score, bsz, task)
            score = tb.show_val(epoch, state.step, task)
            val_scores.append(score)
            if score > best_score:
                best_score = score
                save_train_state(os.path.join(output_dir, "best"), state,
                                 epoch, best_score)
        save_train_state(ckpt_dir, state, epoch, best_score)
    flush(args.num_train_epochs - 1)
    tb.close()
    logger.info("done; best val score %.4f", best_score)
    return {"best_score": best_score, "steps": state.step,
            "train_losses": train_losses, "val_scores": val_scores,
            "run_dir": output_dir, "log_dir": log_dir}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s")
    main()
