"""The eval step: counterpart of ``make_task_eval_step``
(volta_tpu/parallel/train_step.py:159-178)."""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from .task_utils import process_batch, task_loss_and_score


def to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """Numeric arrays of a loader batch as tensors on ``device``; other
    fields (string ids) are left on the host."""
    out = {}
    for key, val in batch.items():
        if isinstance(val, np.ndarray) and val.dtype.kind in "biuf":
            val = torch.from_numpy(val).to(device, non_blocking=True)
        out[key] = val
    return out


def make_task_eval_step(model, task_cfg: Dict, task_id: str) -> Callable:
    """``step(batch) -> {loss, score, batch_size, prediction, info}``: the
    batch goes to the model's device and through the model under
    ``torch.inference_mode()``; loss and score stay on the device; ``info``
    is ``process_batch``'s (the sizes ``collect_results`` reads)."""
    tc = task_cfg[task_id]
    ttype, loss_name = tc["type"], tc.get("loss", "BCEWithLogitLoss")
    device = next(model.parameters()).device

    def step(batch):
        with torch.inference_mode():
            batch = to_device(batch, device)
            inputs, info = process_batch(tc, batch)
            pred = model(inputs["input_ids"], inputs["image_feat"],
                         inputs["image_loc"], task_id,
                         inputs["token_type_ids"], inputs["attention_mask"],
                         inputs["image_attention_mask"])
            loss, score = task_loss_and_score(ttype, pred, batch, info,
                                              loss_name)
        return {"loss": loss, "score": score,
                "batch_size": info["batch_size"], "prediction": pred,
                "info": info}

    return step
