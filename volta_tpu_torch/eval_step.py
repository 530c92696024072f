"""The eval step: counterpart of ``make_task_eval_step``
(volta_tpu/parallel/train_step.py:159-178), and the eval CLI's attention-
map step (eval_task.py:169-178)."""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from .parallel import current_group, step_context, sum_across
from .task_utils import process_batch, task_loss_and_score


def host_tensor(val: np.ndarray) -> torch.Tensor:
    """A numeric array as a host tensor without a copy; uint16 arrays, the
    bfloat16 bit patterns that numpy holds without ``ml_dtypes`` (a packed
    Conceptual Captions store's), as ``torch.bfloat16``."""
    if val.dtype == np.uint16:
        return torch.from_numpy(val.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(val)


def to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """Numeric arrays of a loader batch as tensors on ``device``; other
    fields (string ids) are left on the host. uint16 arrays are bfloat16
    bit patterns (``host_tensor``)."""
    out = {}
    for key, val in batch.items():
        if isinstance(val, np.ndarray) and val.dtype.kind in "biuf":
            val = host_tensor(val).to(device, non_blocking=True)
        out[key] = val
    return out


def make_task_eval_step(model, task_cfg: Dict, task_id: str) -> Callable:
    """``step(batch) -> {loss, score, batch_size, prediction, info}``: the
    batch goes to the model's device and through the model under
    ``torch.inference_mode()``; loss and score stay on the device; ``info``
    is ``process_batch``'s (the sizes ``collect_results`` reads). Inside a
    data-parallel group loss, score and batch size are the global batch's
    (the ranks' loss shares and scores summed; the ranks' batches are of
    one size), the prediction the rank's."""
    tc = task_cfg[task_id]
    ttype, loss_name = tc["type"], tc.get("loss", "BCEWithLogitLoss")
    device = next(model.parameters()).device

    def step(batch):
        with torch.inference_mode(), step_context():
            batch = to_device(batch, device)
            inputs, info = process_batch(tc, batch)
            pred = model(inputs["input_ids"], inputs["image_feat"],
                         inputs["image_loc"], task_id,
                         inputs["token_type_ids"], inputs["attention_mask"],
                         inputs["image_attention_mask"])
            loss, score = task_loss_and_score(ttype, pred, batch, info,
                                              loss_name)
            bsz, g = info["batch_size"], current_group()
            if g is not None:
                loss, score = sum_across(torch.stack([loss.float(),
                                                      score.float()]))
                bsz *= g.world
        return {"loss": loss, "score": score, "batch_size": bsz,
                "prediction": pred, "info": info}

    return step


def make_attn_step(model, task_cfg: Dict, task_id: str) -> Callable:
    """``step(batch) -> probs``: the model's ``extras["probs"]`` for the
    batch, one (t_data, v_data) an attention sublayer, from a forward with
    ``output_probs`` under ``torch.inference_mode()``."""
    tc = task_cfg[task_id]
    device = next(model.parameters()).device

    def step(batch):
        with torch.inference_mode():
            inputs, _ = process_batch(tc, to_device(batch, device))
            _, extras = model(inputs["input_ids"], inputs["image_feat"],
                              inputs["image_loc"], task_id,
                              inputs["token_type_ids"],
                              inputs["attention_mask"],
                              inputs["image_attention_mask"],
                              output_probs=True)
        return extras["probs"]

    return step
