"""Training utilities: the metrics logger, seeding and the run's command.

JAX-free counterpart of ``volta_tpu/train_utils.py`` (MetricsLogger :26-146,
save_command :226-235, set_seed :238-241), text output only: the ``out.txt``
train and ``VAL epoch N TASK1 loss … score …`` lines. Layer freezing
(``fixed_layers``) is not ported yet.
"""

from __future__ import annotations

import json
import os
import random
import time
from collections import defaultdict
from typing import Any, Dict, Optional

import numpy as np


class MetricsLogger:
    """Per-task running loss/score accumulators with plain-text output
    (reference: volta/train_utils.py:18-247)."""

    def __init__(self, log_dir: Optional[str] = None,
                 txt_name: str = "out.txt", period: int = 20):
        self.period = period
        self.log_dir = log_dir
        self._txt = None
        if log_dir:
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
        print(msg, flush=True)
        if self._txt is not None:
            self._txt.write(msg + "\n")
            self._txt.flush()

    def close(self):
        if self._txt is not None:
            self._txt.close()


def save_command(output_dir: str, args, config=None):
    """Dump CLI args + model config next to the run
    (reference: train_task.py:158-162)."""
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "command.txt"), "w") as f:
        f.write(json.dumps(vars(args), indent=2, default=str) + "\n")
        if config is not None:
            f.write(config.to_json_string())


def set_seed(seed: int):
    np.random.seed(seed)
    random.seed(seed)


def check_fixed_layers(fixed_layers: Any):
    """Freezing is not ported yet: a non-empty ``fixed_layers`` raises."""
    if fixed_layers:
        raise NotImplementedError(
            "fixed_layers (layer freezing) is not ported yet (ROADMAP.md "
            "Queue 1 item 5)")
