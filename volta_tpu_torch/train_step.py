"""The fine-tuning step: counterpart of ``make_task_train_step``
(volta_tpu/parallel/train_step.py:24-47,97-138) on one device, no mesh.

A step moves the batch to the model's device, runs the forward in the
model's mode (training mode: every dropout site, seeded from one step seed
drawn from the state's ``torch.Generator``), the task loss, the backward,
and the optimizer (clip + AdamW). Its metrics stay on the device: nothing in
the step waits for the card. The device-store path
(``materialize_store_batch``) is not ported yet (ROADMAP.md Queue 1 item 5).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch
from torch import nn

from .eval_step import to_device
from .task_utils import process_batch, task_loss_and_score


@dataclasses.dataclass
class TrainState:
    """Updates made, the model, its optimizer, and the generator of the
    per-step dropout seeds."""
    step: int
    model: nn.Module
    optimizer: Any
    generator: torch.Generator

    def next_dropout_seed(self) -> int:
        """A uint32 drawn on the host from the state's generator."""
        return int(torch.randint(0, 2**32, (), generator=self.generator,
                                 dtype=torch.int64))


def create_train_state(model, optimizer, seed: int) -> TrainState:
    return TrainState(step=0, model=model, optimizer=optimizer,
                      generator=torch.Generator().manual_seed(seed))


def _widen_wire(batch: Dict) -> Dict:
    """Widen narrow wire dtypes (int8/int16 ids and masks) to int32, so every
    op downstream sees the dense path's dtypes
    (volta_tpu/parallel/train_step.py:36-47)."""
    def w(x):
        if isinstance(x, np.ndarray) and x.dtype in (np.int8, np.int16):
            return x.astype(np.int32)
        if isinstance(x, torch.Tensor) and x.dtype in (torch.int8,
                                                       torch.int16):
            return x.to(torch.int32)
        return x

    return {k: w(v) for k, v in batch.items()}


def make_task_train_step(model, optimizer, task_cfg: Dict, task_id: str
                         ) -> Callable:
    """``step(state, batch) -> {loss, score}`` for one task: process_batch
    -> forward -> ``task_loss_and_score`` -> backward -> clip -> AdamW.
    ``score`` is the batch's mean soft score; both are device tensors.
    ``state.step`` counts the updates."""
    tc = task_cfg[task_id]
    ttype, loss_name = tc["type"], tc.get("loss", "BCEWithLogitLoss")
    device = next(model.parameters()).device

    def step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        batch = to_device(_widen_wire(batch), device)
        inputs, info = process_batch(tc, batch)
        pred = model(inputs["input_ids"], inputs["image_feat"],
                     inputs["image_loc"], task_id, inputs["token_type_ids"],
                     inputs["attention_mask"],
                     inputs["image_attention_mask"],
                     dropout_seed=state.next_dropout_seed())
        loss, score = task_loss_and_score(ttype, pred, batch, info,
                                          loss_name)
        loss.backward()
        optimizer.step()
        optimizer.zero_grad()
        state.step += 1
        return {"loss": loss.detach(),
                "score": score.detach() / info["batch_size"]}

    return step
