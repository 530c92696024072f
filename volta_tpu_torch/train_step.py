"""The fine-tuning step: counterpart of ``make_task_train_step``
(volta_tpu/parallel/train_step.py:24-138) on one device, no mesh.

A step moves the batch to the model's device, runs the forward in the
model's mode (training mode: every dropout site, seeded from one step seed
drawn from the state's ``torch.Generator``), the task loss, the backward,
and the optimizer (clip + AdamW, or a fold into the accumulated mean). Its
metrics stay on the device: nothing in the step waits for the card. With a
``store`` (the dataset's packed features as tensors on the card) a batch
carries row indices and sparse targets, and ``materialize_store_batch``
expands it on the device into the dense batch's layout.
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
    """Steps taken (micro-steps under gradient accumulation, as JAX's
    ``state.step`` counts them; the optimizer counts the updates), the
    model, its optimizer, and the generator of the per-step dropout
    seeds."""
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


def store_to_device(arrays: Dict[str, np.ndarray], device,
                    feat_dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A dataset's ``device_store_arrays()`` as tensors on ``device``, the
    region features in ``feat_dtype`` (bf16 under bf16 compute, where the
    model's first product rounds them to bf16 anyway)."""
    def tensor(v):
        v = np.ascontiguousarray(v)
        if v.dtype.name == "bfloat16":  # ml_dtypes' bf16 (a packed cache)
            return torch.from_numpy(v.view(np.uint16)).view(torch.bfloat16)
        return torch.from_numpy(v)

    out = {k: tensor(v).to(device) for k, v in arrays.items()}
    out["feat"] = out["feat"].to(feat_dtype)
    return out


def materialize_store_batch(store: Dict[str, torch.Tensor], batch: Dict,
                            num_labels: int) -> Dict:
    """Expand a device-store batch into the dense batch's layout on the
    device (volta_tpu/parallel/train_step.py:51-96): the region features,
    boxes and masks gathered by ``store_rows``, an image set's rows (NLVR2's
    [b, 2]) concatenated on the region axis, and the sparse targets
    scattered into [b, num_labels] by their max over repeated labels."""
    batch = _widen_wire(batch)
    rows = batch["store_rows"].long()
    full = {k: v for k, v in batch.items()
            if k not in ("store_rows", "target_labels", "target_scores")}
    for name, key in (("features", "feat"), ("spatials", "loc"),
                      ("image_mask", "mask")):
        got = store[key][rows.reshape(-1)]
        # [b, m] rows: each sample's m images side by side on the region
        # axis, the dense [b, m*R] layout the nlvr process splits back
        full[name] = got.reshape(rows.shape[0], -1, *got.shape[2:])
    if "target_labels" in batch:
        labels, scores = batch["target_labels"].long(), \
            batch["target_scores"]
        b, k = labels.shape
        valid = labels >= 0
        flat = (torch.arange(b, device=labels.device)[:, None] * num_labels
                + torch.where(valid, labels, 0)).reshape(-1)
        target = torch.zeros(b * num_labels, dtype=torch.float32,
                             device=labels.device)
        target.scatter_reduce_(0, flat, torch.where(
            valid, scores, 0.0).reshape(-1).float(), reduce="amax")
        full["target"] = target.view(b, num_labels)
    return full


def make_task_train_step(model, optimizer, task_cfg: Dict, task_id: str,
                         store: Dict[str, torch.Tensor] = None) -> Callable:
    """``step(state, batch) -> {loss, score}`` for one task: process_batch
    -> forward -> ``task_loss_and_score`` -> backward -> the optimizer's
    micro-step. ``score`` is the batch's mean soft score; both are device
    tensors. ``state.step`` counts the calls. With ``store`` the batch is a
    device-store batch (``materialize_store_batch``)."""
    tc = task_cfg[task_id]
    ttype, loss_name = tc["type"], tc.get("loss", "BCEWithLogitLoss")
    num_labels = tc.get("num_labels", 0)
    device = next(model.parameters()).device

    def step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        batch = to_device(_widen_wire(batch), device)
        if store is not None:
            batch = materialize_store_batch(store, batch, num_labels)
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
