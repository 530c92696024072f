"""Pretrain a model of the port on Conceptual Captions (MLM + masked-region
+ ITM), validating every epoch.

Counterpart of the root ``train_concap.py`` (its flags :19-131 and its loop
:134-311):

    python -m volta_tpu_torch.train_concap --config_file configs/ctrl_uniter_base.json \\
        --annotations_path datasets/conceptual_caption/annotations \\
        --features_path datasets/conceptual_caption/imgfeats/volta \\
        --train_batch_size 256 --max_seq_length 38 --objective 1 \\
        --in_memory True --output_dir save --logdir logs

The data: ``training_feat_part_<rank>.lmdb`` or ``training_feat_all.lmdb``
(and ``validation_*``) under ``--features_path``, ``caption_train.json`` /
``caption_valid.json`` under ``--annotations_path``
(``data.datasets.concap.make_concap_loader``); ``--in_memory True`` packs
the training set once into host arrays (bf16 values under bf16 compute, as
JAX's packed store). Weights random from ``--seed``, or from
``--from_pretrained`` (a VOLTA or HF BERT ``.bin``, or the port's own
checkpoint); AdamW (``correct_bias=False``, betas 0.9 / 0.98 unless given)
behind the global-norm clip with the warmup-linear schedule over the
epochs' micro-steps, as the JAX CLI counts them; dropout through the CUDA
kernels on the card, and the NCE negatives' scores through K8. It writes
``<logdir>/<run>/out.txt`` (the JAX CLI's ``CC masked_t … masked_v … itm
…`` line every 20 steps, and the last window's at the end, which the JAX
CLI drops), ``<output_dir>/<run>/command.txt``, and ``torch.save``s the
train state to ``<output_dir>/<run>/ckpt/train_state.pt`` after every
epoch and on SIGTERM (then it stops). A run resumes from ``--resume_file``
(the reference's ``pytorch_ckpt_latest.tar`` of a pretraining run, or a
port ``train_state.pt`` or its directory), else from its own
``ckpt/train_state.pt`` where one exists. ``train_task --from_pretrained``
of that checkpoint loads the trunk and leaves the ``cls`` heads out.
``--device`` defaults to ``cuda`` and never falls back to the CPU.
``--nce_shared_negatives`` takes JAX's opt-in shared-negative NCE.
``--optimizer_state_dtype bfloat16`` stores AdamW's moments in bf16,
``--skip_disconnected_params`` drops the whole update of a parameter whose
gradient is all zero, and ``--trunk_lr_scale s`` scales the update of every
parameter that ``--from_pretrained`` loaded from a reference or HF ``.bin``
(it exits without ``--from_pretrained``, or with the port's own checkpoint,
whose report names no reference tensors). ``--profile_steps N`` and
``--debug_nans`` act as ``train_task``'s (a trace of global steps 20 to
20 + N into ``<logdir>/<run>/``; ``FloatingPointError`` at the first op
output that holds a NaN). ``--distributed`` runs under ``torchrun`` as
``train_task``'s does: rank r of W reads ``training_feat_part_<r>.lmdb``
where it exists (else shard r of ``training_feat_all.lmdb``) and shard r
of the validation set, at ``--train_batch_size`` / K / W; the NCE
negatives come from the global batch. The JAX-only ``--prng_impl`` does
not exist here.
"""

from __future__ import annotations

import argparse
import itertools
import logging
import os
import signal

import numpy as np
import torch

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    # Model
    p.add_argument("--from_pretrained", default="", type=str)
    p.add_argument("--bert_model", default="bert-base-uncased", type=str)
    p.add_argument("--config_file", default="configs/ctrl_uniter_base.json",
                   type=str)
    p.add_argument("--resume_file", default="", type=str)
    # Data
    p.add_argument("--annotations_path",
                   default="datasets/conceptual_caption/annotations",
                   type=str)
    p.add_argument("--features_path",
                   default="datasets/conceptual_caption/imgfeats/volta",
                   type=str)
    # Output
    p.add_argument("--output_dir", default="save", type=str)
    p.add_argument("--logdir", default="logs", type=str)
    p.add_argument("--save_name", default="", type=str)
    # Text
    p.add_argument("--do_lower_case", action="store_true", default=True)
    p.add_argument("--vocab_file", default="", type=str)
    p.add_argument("--max_seq_length", default=36, type=int)
    # Training
    p.add_argument("--train_batch_size", default=512, type=int)
    p.add_argument("--learning_rate", default=1e-4, type=float)
    p.add_argument("--num_train_epochs", default=10, type=int)
    p.add_argument("--start_epoch", default=0, type=int)
    p.add_argument("--gradient_accumulation_steps", dest="grad_acc_steps",
                   type=int, default=1)
    p.add_argument("--max_region_num", default=36, type=int)
    # 0 = all losses; 1 = no MLM/MRM on mismatched pairs; 2 = no ITM
    # (reference: train_concap.py:279-295)
    p.add_argument("--objective", default=0, type=int)
    # Scheduler
    p.add_argument("--warmup_proportion", default=0.1, type=float)
    p.add_argument("--warmup_steps", default=None, type=float)
    # Seed / workers
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--num_worker_procs", type=int, default=0)
    p.add_argument("--in_memory", default=False, type=bool)
    # Optimization
    p.add_argument("--adam_epsilon", default=1e-6, type=float)
    p.add_argument("--optimizer_state_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--adam_betas", default=(0.9, 0.98), nargs="+",
                   type=float)
    p.add_argument("--skip_disconnected_params", action="store_true")
    p.add_argument("--trunk_lr_scale", default=1.0, type=float)
    p.add_argument("--weight_decay", default=0.01, type=float)
    p.add_argument("--clip_grad_norm", default=0.0, type=float)
    # Compute
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--no_pallas", action="store_true")
    p.add_argument("--profile_steps", default=0, type=int,
                   help="capture a torch.profiler trace over N steps "
                   "from global step 20, into <logdir>/<run>/")
    p.add_argument("--debug_nans", action="store_true",
                   help="raise FloatingPointError at the first op output, "
                   "forward or backward, that holds a NaN (slow)")
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--nce_shared_negatives", action="store_true",
                   help="JAX's opt-in NCE scheme: one shared set of "
                   "cross-batch negatives a step (not the reference's "
                   "per-query sampling; volta_tpu_torch/losses.py)")
    p.add_argument("--steps_per_epoch", default=0, type=int,
                   help="cap steps per epoch (debug)")
    p.add_argument("--device", default="cuda", type=str)
    return p.parse_args(argv)


def main(argv=None):
    """Pretrain; returns {steps, train_losses (masked_t, masked_v, itm a
    step), val_losses (one an epoch), run_dir, log_dir, pretrained (the
    ``from_pretrained`` report or None), profile_trace (the
    ``--profile_steps`` trace's path, or None)}."""
    from .train_task import debug_nans, run_device

    args = parse_args(argv)
    with debug_nans(args.debug_nans), run_device("train_concap",
                                                 args) as device:
        return _train(args, device)


def _train(args, device):
    from .train_task import _fetch, log_pretrained, state_dtype
    from .utils.profiling import ProfileSteps

    from . import losses
    from .checkpoint import TRAIN_STATE, from_pretrained, resume, \
        save_train_state
    from .config import VoltaConfig
    from .data.datasets.concap import make_concap_loader
    from .models import VoltaForVLPreTraining
    from .models.layers import init_weights
    from .optimization import build_optimizer, flax_paths, \
        lr_scales_from_loaded, warmup_linear_schedule
    from .parallel import broadcast_state, min_across, per_rank_batch, \
        shard_args
    from .task_utils import make_tokenizer
    from .train_step import create_train_state, make_pretrain_eval_step, \
        make_pretrain_step
    from .train_utils import MetricsLogger, save_command, set_seed

    set_seed(args.seed)
    cfg = VoltaConfig.from_json_file(args.config_file)
    cfg.compute_dtype = args.compute_dtype
    cfg.objective = args.objective
    if args.no_pallas:
        cfg.use_pallas = False

    run_name = f"{os.path.basename(args.config_file)}-" \
        f"{args.save_name or 'pretrained'}"
    output_dir = os.path.join(args.output_dir, run_name)
    log_dir = os.path.join(args.logdir, run_name)
    tb = MetricsLogger(log_dir)
    save_command(output_dir, args, cfg)
    ckpt_dir = os.path.join(output_dir, "ckpt")

    tokenizer = make_tokenizer(args.bert_model, args.do_lower_case,
                               args.vocab_file)
    bf16 = args.compute_dtype == "bfloat16"
    batch_size = per_rank_batch(args.train_batch_size, args.grad_acc_steps)
    common = dict(seq_len=args.max_seq_length,
                  region_len=args.max_region_num, batch_size=batch_size,
                  objective=args.objective, num_locs=cfg.num_locs,
                  add_global_imgfeat=cfg.add_global_imgfeat, seed=args.seed,
                  **shard_args())
    train_ds, train_loader = make_concap_loader(
        args.features_path, args.annotations_path, tokenizer,
        split="train", num_workers=args.num_workers,
        num_procs=args.num_worker_procs, packed=args.in_memory,
        feat_dtype="bfloat16" if bf16 else "float32", **common)
    try:
        _, val_loader = make_concap_loader(
            args.features_path, args.annotations_path, tokenizer,
            split="valid", num_workers=2, **common)
    except (FileNotFoundError, ValueError):
        val_loader = None

    model = VoltaForVLPreTraining(cfg)
    init_weights(model, torch.Generator().manual_seed(args.seed))
    report, lr_scales = None, None
    if args.trunk_lr_scale != 1.0 and not args.from_pretrained:
        raise SystemExit("--trunk_lr_scale scales the params loaded from "
                         "--from_pretrained, which was not given")
    if args.from_pretrained:
        report = from_pretrained(cfg, model, args.from_pretrained)
        log_pretrained(report)
        if args.trunk_lr_scale != 1.0:
            # the reference's intended rule (train_concap.py:213-224, dead
            # as shipped; volta_tpu/optimization.py:248-274): the
            # parameters that came from the checkpoint train at
            # trunk_lr_scale * lr. The importer names them by Flax path;
            # the port's own checkpoint is read module by module, by port
            # name, as JAX reads its own bundles without a list
            paths = {".".join(p) for p in flax_paths(model).values()}
            if not set(report["loaded"]) <= paths:
                raise SystemExit(
                    "--trunk_lr_scale needs a torch .bin checkpoint (the "
                    "importer must enumerate which params were loaded); "
                    f"got {args.from_pretrained}, the port's own format")
            lr_scales = lr_scales_from_loaded(model, report["loaded"],
                                              args.trunk_lr_scale)
    model.to(device)
    logger.info("parameters: %d",
                sum(p.numel() for p in model.parameters()))

    # the batches every rank has, so that the ranks' steps pair up
    steps_per_epoch = min_across(len(train_loader))
    n_val = min_across(len(val_loader)) if val_loader is not None else 0
    if args.steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.steps_per_epoch)
    total = max(1, steps_per_epoch * args.num_train_epochs)
    warmup = int(args.warmup_steps) if args.warmup_steps else \
        int(total * args.warmup_proportion)
    optimizer = build_optimizer(
        "adamw", warmup_linear_schedule(args.learning_rate, warmup, total),
        model, weight_decay=args.weight_decay,
        clip_norm=args.clip_grad_norm or None,
        grad_accum_steps=args.grad_acc_steps, betas=tuple(args.adam_betas),
        eps=args.adam_epsilon, state_dtype=state_dtype(args),
        lr_scales=lr_scales,
        skip_disconnected_params=args.skip_disconnected_params)
    state = create_train_state(model, optimizer, args.seed + 1)

    start_epoch = args.start_epoch
    src = args.resume_file or (ckpt_dir if os.path.exists(
        os.path.join(ckpt_dir, TRAIN_STATE)) else "")
    if src:
        info = resume(cfg, state, src, steps_per_epoch, steps_per_epoch)
        start_epoch = info["start_epoch"]
        if info["hyperparams"]:
            logger.info("tar optimizer hyperparams (verify CLI flags "
                        "match): %s", info["hyperparams"])
        logger.info("resumed from %s at step %d (epoch %d)", src,
                    info["global_step"], start_epoch)
    broadcast_state(state)

    step_fn = make_pretrain_step(model, optimizer, cfg,
                                 objective=args.objective)
    eval_fn = make_pretrain_eval_step(model, cfg)

    # preemption: checkpoint on SIGTERM and stop; the next launch resumes
    preempted = {"flag": False}

    def on_sigterm(signum, frame):
        preempted["flag"] = True

    old_handler = signal.signal(signal.SIGTERM, on_sigterm)
    shared = losses._NCE_SHARED_NEGATIVES[0]
    losses._NCE_SHARED_NEGATIVES[0] = args.nce_shared_negatives
    keys = ("masked_t", "masked_v", "itm")
    train_losses, val_losses, pending = [], [], []
    profiler = ProfileSteps(args.profile_steps, log_dir)

    def flush(epoch):
        for gs, mt, mv, itm in _fetch(pending, keys):
            # the lr of the update this micro-step went into
            tb.step_train_cc(epoch, gs, mt, mv, itm,
                             optimizer.lr((gs - 1) // args.grad_acc_steps))
            train_losses.append((mt, mv, itm))
        pending.clear()
        tb.show_train_cc(epoch, state.step)

    try:
        epoch = start_epoch
        for epoch in range(start_epoch, args.num_train_epochs):
            train_ds.set_epoch(epoch)
            train_loader.set_epoch(epoch)
            model.train()
            for batch in itertools.islice(train_loader, steps_per_epoch):
                with profiler.step(state.step):
                    out = step_fn(state, batch)
                profiler.done(state.step, out["loss"])
                pending.append((state.step, out))
                if preempted["flag"]:
                    flush(epoch)
                    save_train_state(ckpt_dir, state, epoch, -1.0)
                    logger.info("preempted: checkpointed at step %d",
                                state.step)
                    profiler.close()
                    return _result(state, train_losses, val_losses,
                                   output_dir, log_dir, report,
                                   profiler.path)
                if len(pending) >= tb.period:
                    flush(epoch)
            if val_loader is not None:
                outs = [(0, eval_fn(batch))
                        for batch in itertools.islice(val_loader, n_val)]
                vals = [v for _, v in _fetch(outs, ("loss",))]
                val_losses.append(float(np.mean(vals)) if vals
                                  else float("nan"))
                logger.info("epoch %d val loss %.4f", epoch, val_losses[-1])
            save_train_state(ckpt_dir, state, epoch, -1.0)
        if pending:
            flush(epoch)
    finally:
        profiler.close()
        losses._NCE_SHARED_NEGATIVES[0] = shared
        signal.signal(signal.SIGTERM, old_handler)
        tb.close()
    return _result(state, train_losses, val_losses, output_dir, log_dir,
                   report, profiler.path)


def _result(state, train_losses, val_losses, run_dir, log_dir, report,
            trace):
    return {"steps": state.step, "train_losses": train_losses,
            "val_losses": val_losses, "run_dir": run_dir,
            "log_dir": log_dir, "pretrained": report, "profile_trace": trace}


if __name__ == "__main__":
    from .train_task import log_level

    logging.basicConfig(level=log_level(),
                        format="%(asctime)s %(message)s")
    main()
