"""Training utilities: the metrics logger, seeding, the run's command,
layer freezing and the classifier's init from answer embeddings.

JAX-free counterpart of ``volta_tpu/train_utils.py`` (MetricsLogger :26-146,
its pretraining lines ``step_train_cc`` / ``show_train_cc`` :89-110,
freeze_mask / apply_freeze :186-207, save_command :226-235, set_seed
:238-241, init_classifier_from_answers :244-277), text output only: the
``out.txt`` train, ``CC masked_t … masked_v … itm …`` and ``VAL epoch N
TASK1 loss … score …`` lines.
"""

from __future__ import annotations

import json
import logging
import os
import random
import time
from collections import defaultdict
from typing import Any, Dict, Optional

import numpy as np

from .parallel import is_rank0

logger = logging.getLogger(__name__)


class MetricsLogger:
    """Per-task running loss/score accumulators with plain-text output
    (reference: volta/train_utils.py:18-247). In a process group only
    rank 0 prints and writes ``out.txt``; every rank keeps the sums, so
    ``show_val`` returns the same score on each."""

    def __init__(self, log_dir: Optional[str] = None,
                 txt_name: str = "out.txt", period: int = 20):
        self.period = period
        self.log_dir = log_dir
        self._txt = None
        if log_dir and is_rank0():
            os.makedirs(log_dir, exist_ok=True)
            self._txt = open(os.path.join(log_dir, txt_name), "a")
        self._acc = defaultdict(lambda: defaultdict(float))
        self._cnt = defaultdict(int)
        self._val = defaultdict(lambda: defaultdict(float))
        self._val_cnt = defaultdict(int)

    def step_train(self, epoch: int, step: int, loss: float, score: float,
                   lr: float, task: str):
        a = self._acc[task]
        a["loss"] += loss
        a["score"] += score
        self._cnt[task] += 1
        if self._cnt[task] % self.period == 0:
            self.show_train(epoch, step, task)

    def show_train(self, epoch: int, step: int, task: str):
        n = max(self._cnt[task], 1)
        a = self._acc[task]
        self._emit(f"[{time.strftime('%X')}] epoch {epoch} step {step} "
                   f"{task} loss {a['loss']/n:.4f} score {a['score']/n:.4f}")
        self._acc[task] = defaultdict(float)
        self._cnt[task] = 0

    def step_train_cc(self, epoch: int, step: int, masked_t: float,
                      masked_v: float, itm: float, lr: float,
                      task: str = "TASK0"):
        """Accumulate one pretraining step's three losses
        (volta_tpu/train_utils.py:89-101); ``show_train_cc`` prints them."""
        a = self._acc[task]
        a["masked_t"] += masked_t
        a["masked_v"] += masked_v
        a["itm"] += itm
        self._cnt[task] += 1

    def show_train_cc(self, epoch: int, step: int, task: str = "TASK0"):
        """The window's mean losses as the JAX CLI's ``CC`` line
        (volta_tpu/train_utils.py:103-110)."""
        n = max(self._cnt[task], 1)
        a = self._acc[task]
        self._emit(f"[{time.strftime('%X')}] epoch {epoch} step {step} CC "
                   f"masked_t {a['masked_t']/n:.4f} "
                   f"masked_v {a['masked_v']/n:.4f} itm {a['itm']/n:.4f}")
        self._acc[task] = defaultdict(float)
        self._cnt[task] = 0

    def step_val(self, loss: float, score: float, batch_size: int,
                 task: str):
        v = self._val[task]
        v["loss"] += loss
        v["score"] += score
        v["n"] += batch_size
        self._val_cnt[task] += 1

    def show_val(self, epoch: int, step: int, task: str) -> float:
        v = self._val[task]
        n = max(v["n"], 1)
        nb = max(self._val_cnt[task], 1)
        score = v["score"] / n
        self._emit(f"[{time.strftime('%X')}] VAL epoch {epoch} {task} "
                   f"loss {v['loss']/nb:.4f} score {score*100:.2f}")
        self._val[task] = defaultdict(float)
        self._val_cnt[task] = 0
        return score

    def _emit(self, msg: str):
        if not is_rank0():
            return
        print(msg, flush=True)
        if self._txt is not None:
            self._txt.write(msg + "\n")
            self._txt.flush()

    def close(self):
        if self._txt is not None:
            self._txt.close()


def save_command(output_dir: str, args, config=None):
    """Dump CLI args + model config next to the run
    (reference: train_task.py:158-162); rank 0 alone in a process group."""
    if not is_rank0():
        return
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "command.txt"), "w") as f:
        f.write(json.dumps(vars(args), indent=2, default=str) + "\n")
        if config is not None:
            f.write(config.to_json_string())


def set_seed(seed: int):
    np.random.seed(seed)
    random.seed(seed)


def freeze_mask(model, fixed_layers: Any) -> Dict[str, bool]:
    """True where the parameter trains: no entry of ``fixed_layers`` is a
    substring of its Flax path joined by dots (volta_tpu/train_utils.py
    :186-195; reference: volta/train_utils.py:250-255)."""
    from .optimization import flax_paths

    fixed = list(fixed_layers or [])
    return {name: not any(f in ".".join(path) for f in fixed)
            for name, path in flax_paths(model).items()}


def apply_freeze(optimizer, model, fixed_layers: Any):
    """Zero the gradients of the frozen parameters before the optimizer's
    chain, as the JAX package's ``apply_freeze`` chains
    ``optax.masked(optax.set_to_zero())`` ahead of it: a frozen parameter
    still takes weight decay and its momentum. The reference sets
    ``requires_grad=False`` instead (ROADMAP.md Queue 3)."""
    if fixed_layers:
        trainable = freeze_mask(model, fixed_layers)
        optimizer.frozen = {i for i, n in enumerate(optimizer.names)
                            if not trainable[n]}
    return optimizer


def init_classifier_from_answers(model, task: str, dataset) -> bool:
    """Set the task classifier's last projection (``clf_<task>.dense2``)
    from the mean word embedding of each answer's tokens, ``[UNK]``'s row
    for an answer with none, answers in ``sorted(ans2label.items())``
    order (volta_tpu/train_utils.py:244-277; reference: train_task.py
    :182-202). A warning and nothing else where the head is no
    ``SimpleClassifier`` or the widths differ. Returns whether it set."""
    import torch

    table = model.bert.embeddings.word_embeddings.weight.detach()
    tok = dataset._tokenizer
    rows = []
    for answer, _label in sorted(dataset.ans2label.items()):
        ids = tok.convert_tokens_to_ids(tok.tokenize(answer)) or \
            tok.convert_tokens_to_ids([tok.unk_token])
        rows.append(table[torch.as_tensor(ids, device=table.device)].mean(0))
    means = torch.stack(rows)  # [num_labels, hidden]
    dense2 = getattr(getattr(model, f"clf_{task}", None), "dense2", None)
    if dense2 is None:
        logger.warning("embed_clf: no SimpleClassifier head for %s", task)
        return False
    if dense2.weight.shape != means.shape:
        logger.warning("embed_clf: classifier kernel %s != answer "
                       "embeddings %s; skipping init",
                       tuple(dense2.weight.shape[::-1]),
                       tuple(means.shape[::-1]))
        return False
    with torch.no_grad():
        dense2.weight.copy_(means)
    logger.info("initialised %s classifier from %d answer embeddings", task,
                means.shape[0])
    return True
