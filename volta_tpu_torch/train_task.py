"""Fine-tune a model of the port on one task, validating every epoch.

Counterpart of the root ``train_task.py`` (its flags :25-98 and its loop
:100-312) for every task type of the port's ``VoltaForVLTasks``:

    python -m volta_tpu_torch.train_task --config_file configs/ctrl_uniter_base.json \\
        --tasks_config_file config_tasks/ctrl_trainval_tasks.yml --task 1 \\
        --output_dir save --logdir logs

Weights random from ``--seed``, or from ``--from_pretrained``: a published
VOLTA ``.bin``, an HF BERT ``.bin`` or the port's own checkpoint
(``checkpoint.from_pretrained``); AdamW (``correct_bias=False``) or, with
``--optim RAdam``, RAdam (another name falls back to AdamW, as in JAX),
behind the global-norm clip with the warmup-linear schedule; with
``--optimizer_state_dtype bfloat16`` AdamW's moments stored in bf16;
``--skip_disconnected_params`` drops the whole update (decay included) of a
parameter whose gradient is all zero; dropout at the config's
rates through the CUDA kernels on the card. It writes the JAX CLI's
``<logdir>/<run>/out.txt`` lines (``VAL epoch N TASK1 loss … score …``),
``<output_dir>/<run>/command.txt``, and ``torch.save``s the model,
optimizer and dropout-generator state to
``<output_dir>/<run>/ckpt/train_state.pt`` every epoch and to ``best/``
when the val score improves (``eval_task --from_pretrained`` reads
either). A run resumes from ``--resume_file`` (the reference's
``pytorch_ckpt_latest.tar`` or a port ``train_state.pt`` or its
directory), else from its own ``ckpt/train_state.pt`` where one exists.
``--device`` defaults to ``cuda`` and never falls back to the CPU.
``--no_pallas`` sets the config's ``use_pallas`` false (the attention then
runs the plain composition, as JAX's does); ``--gradient_accumulation_steps
K`` updates once every K micro-batches of the task batch / K with their
mean gradient (``optimization.AdamW``; the step and the logs count
micro-steps, as JAX's); the config's ``fixed_layers`` zero their
parameters' gradients (``train_utils.apply_freeze``); a task's
``embed_clf`` sets its classifier from the answers' word embeddings;
``--device_store`` keeps the training set's packed features on the card
and ships row indices and sparse targets (``train_step
.materialize_store_batch``). ``--profile_steps N`` records a
``torch.profiler`` trace of global steps 20 to 20 + N into
``<logdir>/<run>/`` (``utils.profiling``), and ``--debug_nans`` raises
``FloatingPointError`` at the first op output, forward or backward, that
holds a NaN. The JAX-only ``--prng_impl`` does not exist here.

``--distributed`` trains one model on W processes, one a GPU, each on its
1/W of the global batch (``parallel``), as the JAX CLI's mesh does over
its ``data`` axis:

    torchrun --standalone --nproc_per_node 4 -m volta_tpu_torch.train_task \
        --distributed --config_file ... --tasks_config_file ... --task 1

Rank r runs on ``cuda:<LOCAL_RANK>`` (NCCL; gloo with ``--device cpu``)
and reads loader shard r of W at the task batch / K / W; each step equals
the one-GPU step over the ranks' concatenated batches, up to the order of
summation. Rank 0's weights and optimizer state go to every rank after
they are loaded or resumed; each epoch every rank takes the batches that
all of them have, and the validation sums over the ranks, so every rank
sees the same score. Rank 0 alone logs, writes ``command.txt``, the
checkpoints and the profile.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
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
    p.add_argument("--no_pallas", action="store_true")
    p.add_argument("--profile_steps", default=0, type=int,
                   help="capture a torch.profiler trace over N steps "
                   "from global step 20, into <logdir>/<run>/")
    p.add_argument("--debug_nans", action="store_true",
                   help="raise FloatingPointError at the first op output, "
                   "forward or backward, that holds a NaN (slow)")
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--device", default="cuda", type=str)
    return p.parse_args(argv)


def state_dtype(args):
    """The moments' stored dtype of ``--optimizer_state_dtype``: None
    (the parameters' float32) or ``torch.bfloat16``."""
    return None if args.optimizer_state_dtype == "float32" \
        else torch.bfloat16


def log_pretrained(report):
    """Log ``from_pretrained``'s report: the tensors loaded, and the
    modules (``clf_TASK1``, ``cls``, ...) left at init and not read."""
    def modules(names):
        return sorted({n.split(".", 1)[0] for n in names})

    logger.info("loaded %d tensors, %d left at init %s, %d unused %s",
                len(report["loaded"]), len(report["skipped"]),
                modules(report["skipped"]), len(report["unused"]),
                modules(report["unused"]))


def _fetch(pending, keys):
    """The window's device scalars in one transfer: [(tag, v0, v1, ...)]."""
    if not pending:
        return []
    flat = torch.stack([m[k].float() for _, m in pending
                        for k in keys]).cpu().tolist()
    n = len(keys)
    return [(tag,) + tuple(flat[i * n:(i + 1) * n])
            for i, (tag, _) in enumerate(pending)]


@contextlib.contextmanager
def debug_nans(on: bool):
    """``--debug_nans``: ``profiling.enable_nan_debugging`` for the run."""
    from .utils.profiling import enable_nan_debugging

    mode = enable_nan_debugging() if on else None
    try:
        yield
    finally:
        if mode is not None:
            mode.__exit__(None, None, None)


@contextlib.contextmanager
def run_device(name: str, args):
    """The run's device: ``--device``, which never falls back to the CPU;
    with ``--distributed`` the rank's, in the process group that
    ``torchrun`` describes, left when the run ends."""
    import torch.distributed as dist

    from .parallel import init_distributed

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{name}: --device cuda but CUDA is not available "
                         "(pass --device cpu to run on the CPU)")
    if not args.distributed:
        yield device
        return
    device = init_distributed(device)
    try:
        yield device
    finally:
        dist.destroy_process_group()


def log_level() -> int:
    """INFO on rank 0 (or without ``torchrun``), WARNING on the others."""
    return logging.INFO if os.environ.get("RANK", "0") == "0" \
        else logging.WARNING


def main(argv=None):
    """Train; returns {best_score, steps, train_losses, val_scores,
    run_dir, log_dir, profile_trace (the ``--profile_steps`` trace's path,
    or None)}."""
    args = parse_args(argv)
    with debug_nans(args.debug_nans), run_device("train_task", args) as dev:
        return _train(args, dev)


def _train(args, device):
    from .checkpoint import TRAIN_STATE, from_pretrained, resume, \
        save_train_state
    from .config import VoltaConfig
    from .eval_step import make_task_eval_step
    from .models import VoltaForVLTasks
    from .models.layers import init_weights
    from .optimization import SCHEDULES, build_optimizer
    from .parallel import broadcast_state, min_across
    from .task_utils import load_dataset, load_task_config, task_key
    from .train_step import create_train_state, make_task_train_step, \
        store_to_device
    from .train_utils import (MetricsLogger, apply_freeze,
                              init_classifier_from_answers, save_command,
                              set_seed)

    from .utils.profiling import ProfileSteps

    set_seed(args.seed)
    cfg = VoltaConfig.from_json_file(args.config_file)
    if "roberta" in args.bert_model:
        cfg.model = "roberta"
    cfg.compute_dtype = args.compute_dtype
    if args.no_pallas:
        cfg.use_pallas = False
    task_cfg = load_task_config(args.tasks_config_file)
    task = task_key(args.task)
    tc = task_cfg[task]
    if tc.get("fusion_method"):
        # per-task pooling override (reference: train_task.py:144-146)
        cfg.fusion_method = tc["fusion_method"]

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
        log_pretrained(report)
    if tc.get("embed_clf"):
        # the classifier from the answers' word embeddings (reference:
        # train_task.py:182-202)
        init_classifier_from_answers(model, task, data["train_dataset"])
    model.to(device)
    logger.info("parameters: %d",
                sum(p.numel() for p in model.parameters()))

    # the batches every rank has, so that the ranks' steps pair up
    n_train = min_across(len(train_loader))
    n_val = min_across(len(val_loader)) if val_loader is not None else 0
    steps_per_epoch = n_train // args.grad_acc_steps
    total_steps = max(1, steps_per_epoch * args.num_train_epochs)
    warmup = int(args.warmup_steps) if args.warmup_steps is not None else \
        int(total_steps * args.warmup_proportion)
    sched = SCHEDULES[args.lr_scheduler](float(tc["lr"]), warmup, total_steps)
    # unknown names fall back to AdamW, as in the JAX CLI
    opt_name = {"adamw": "adamw", "radam": "radam"}.get(
        args.optim.lower(), "adamw")
    optimizer = build_optimizer(
        opt_name, sched, model, weight_decay=args.weight_decay,
        clip_norm=args.clip_grad_norm or None,
        grad_accum_steps=args.grad_acc_steps, betas=tuple(args.adam_betas),
        eps=args.adam_epsilon, correct_bias=args.adam_correct_bias,
        state_dtype=state_dtype(args),
        skip_disconnected_params=args.skip_disconnected_params)
    apply_freeze(optimizer, model, cfg.fixed_layers)
    state = create_train_state(model, optimizer, args.seed + 1)

    store = None
    train_ds = data["train_dataset"]
    if args.device_store and hasattr(train_ds, "enable_device_store"):
        # the packed features on the card; batches carry row indices and
        # sparse targets (train_step.materialize_store_batch)
        train_ds.enable_device_store(feat_dtype="float32")
        store = store_to_device(
            train_ds.device_store_arrays(), device,
            torch.bfloat16 if args.compute_dtype == "bfloat16"
            else torch.float32)
        logger.info("device-resident feature store: %.2f GiB on the card",
                    sum(t.numel() * t.element_size()
                        for t in store.values()) / 2**30)
    train_step = make_task_train_step(model, optimizer, task_cfg, task,
                                      store=store)
    eval_step = make_task_eval_step(model, task_cfg, task)

    best_score, start_epoch = -1.0, 0
    src = args.resume_file or (ckpt_dir if os.path.exists(
        os.path.join(ckpt_dir, TRAIN_STATE)) else "")
    if src:
        info = resume(cfg, state, src, steps_per_epoch, n_train)
        start_epoch, best_score = info["start_epoch"], info["best_score"]
        if info["hyperparams"]:
            logger.info("tar optimizer hyperparams (verify CLI flags "
                        "match): %s", info["hyperparams"])
        logger.info("resumed from %s at step %d (epoch %d)", src,
                    info["global_step"], start_epoch)
    broadcast_state(state)
    train_losses, val_scores, pending = [], [], []
    profiler = ProfileSteps(args.profile_steps, log_dir)

    def flush(epoch):
        for gs, loss, score in _fetch(pending, ("loss", "score")):
            # the lr of the update this micro-step went into
            tb.step_train(epoch, gs, loss, score,
                          optimizer.lr((gs - 1) // args.grad_acc_steps), task)
            train_losses.append(loss)
        pending.clear()

    for epoch in range(start_epoch, args.num_train_epochs):
        train_loader.set_epoch(epoch)
        model.train()
        for batch in itertools.islice(train_loader, n_train):
            with profiler.step(state.step):
                out = train_step(state, batch)
            profiler.done(state.step, out["loss"])
            pending.append((state.step, out))
            # metrics come to the host in windows, one transfer each
            if len(pending) >= tb.period:
                flush(epoch)

        if val_loader is not None and (epoch + 1) % args.eval_period == 0:
            model.eval()
            # keep only the scalars of each batch, fetched in one transfer
            outs = [(out["batch_size"], {k: out[k] for k in ("loss", "score")})
                    for out in map(eval_step,
                                   itertools.islice(val_loader, n_val))]
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
    profiler.close()
    tb.close()
    logger.info("done; best val score %.4f", best_score)
    return {"best_score": best_score, "steps": state.step,
            "train_losses": train_losses, "val_scores": val_scores,
            "run_dir": output_dir, "log_dir": log_dir,
            "profile_trace": profiler.path}


if __name__ == "__main__":
    logging.basicConfig(level=log_level(),
                        format="%(asctime)s %(message)s")
    main()
