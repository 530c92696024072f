"""The fine-tuning and pretraining steps: counterparts of
``make_task_train_step`` and ``make_pretrain_step`` /
``make_pretrain_eval_step`` (volta_tpu/parallel/train_step.py:24-138,
182-329) on one device, or on one of W ranks of a data-parallel group.

A step moves the batch to the model's device, runs the forward in the
model's mode (training mode: every dropout site, seeded from one step seed
drawn from the state's ``torch.Generator``), the task loss, the backward,
and the optimizer (clip + AdamW, or a fold into the accumulated mean). Its
metrics stay on the device: nothing in the step waits for the card. With a
``store`` (the dataset's packed features as tensors on the card) a batch
carries row indices and sparse targets, and ``materialize_store_batch``
expands it on the device into the dense batch's layout
(``materialize_cc_store_batch`` for Conceptual Captions).

In a process group (``parallel.init_distributed``) each rank runs the same
step on its 1/W of the global batch inside ``parallel.step_context``: the
losses are the rank's shares of the global batch's, the gradients that
exist are summed over the ranks after the backward (on every micro-step
of accumulation, as JAX sums them over its mesh inside ``MultiSteps``),
and the clip and the optimizer then run alike on every rank. The metrics
are the global batch's. Without a group every collective is the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch
from torch import nn

from .eval_step import host_tensor, to_device
from .losses import pretraining_losses
# the regression targets without the global image row
# (volta_tpu/parallel/train_step.py:322-329)
from .losses import strip_global_rows as _strip_global
from .parallel import all_reduce_grads, current_group, step_context, \
    sum_across
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
        return host_tensor(v)

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
        with step_context():
            batch = to_device(_widen_wire(batch), device)
            if store is not None:
                batch = materialize_store_batch(store, batch, num_labels)
            inputs, info = process_batch(tc, batch)
            pred = model(inputs["input_ids"], inputs["image_feat"],
                         inputs["image_loc"], task_id,
                         inputs["token_type_ids"], inputs["attention_mask"],
                         inputs["image_attention_mask"],
                         dropout_seed=state.next_dropout_seed())
            loss, score = task_loss_and_score(ttype, pred, batch, info,
                                              loss_name)
            loss.backward()
            all_reduce_grads(model.parameters())
            optimizer.step()
            optimizer.zero_grad()
            state.step += 1
            return _task_metrics(loss, score, info["batch_size"])

    return step


def _task_metrics(loss, score, batch_size: int) -> Dict[str, torch.Tensor]:
    """{loss, score (the mean score a row)} of the global batch: inside a
    group the ranks' loss shares, summed scores and rows summed over the
    ranks (one all-reduce of three scalars)."""
    loss, score = loss.detach(), score.detach()
    if current_group() is None:
        return {"loss": loss, "score": score / batch_size}
    total = sum_across(torch.stack([
        loss.float(), score.float(),
        torch.full((), float(batch_size), device=loss.device)]))
    return {"loss": total[0], "score": total[1] / total[2]}


# -------------------------------------------------------------- pretraining
def materialize_cc_store_batch(store: Dict[str, torch.Tensor], batch: Dict,
                               cfg) -> Dict:
    """Expand a Conceptual Captions device-store batch on the device
    (volta_tpu/parallel/train_step.py:182-231): the features and targets
    gathered by ``store_rows``, the host-drawn region masks applied, the
    overlap co-mask and the global mean feature (over the regions that no
    masked region overlaps) computed here; the layout of
    ``ConceptCapDataset._get_packed_batch``. Arrays pruned from the store
    (``device_store_arrays(targets=...)``) stay out of the batch."""
    batch = _widen_wire(batch)
    rows = batch["store_rows"].long()
    do_r, zero = batch["mrm_mask"].bool(), batch["mrm_zero"].bool()
    feat = store["feat"][rows]
    feat = feat * (~zero[:, :, None]).to(feat.dtype)
    nb = store["nb"][rows]
    R = feat.shape[1]
    valid_r = torch.arange(R, device=feat.device)[None, :] < nb[:, None]
    masked_lbl = (do_r[:, :, None] & store["ovl"][rows]).any(1)
    loc = store["loc"][rows]
    image_mask = valid_r.to(torch.int32)

    full = {k: v for k, v in batch.items()
            if k not in ("store_rows", "mrm_mask", "mrm_zero")}
    full["image_label"] = torch.where(do_r, 1, -1).to(torch.int32)
    for out_key, store_key in (("image_cls", "cls"), ("obj_labels", "obj_l"),
                               ("obj_confs", "obj_c"),
                               ("attr_labels", "attr_l"),
                               ("attr_confs", "attr_c")):
        if store_key in store:
            full[out_key] = store[store_key][rows]
    full["image_id"] = batch["store_rows"]
    if cfg.add_global_imgfeat:
        b = feat.shape[0]
        count = (valid_r & ~masked_lbl).sum(1).clamp(min=1)[:, None]
        g_feat = (feat.float().sum(1) / count).to(feat.dtype)[:, None]
        g_loc = torch.tensor([[[0, 0, 1, 1] + [1] * (cfg.num_locs - 4)]],
                             dtype=torch.float32,
                             device=feat.device).expand(b, 1, -1)
        g_mask = torch.ones((b, 1), dtype=torch.int32, device=feat.device)
        order = ((g_feat, feat), (g_loc, loc), (g_mask, image_mask)) \
            if cfg.add_global_imgfeat == "first" else \
            ((feat, g_feat), (loc, g_loc), (image_mask, g_mask))
        full["image_feat"] = torch.cat(order[0], 1)
        full["image_loc"] = torch.cat(order[1], 1)
        full["image_mask"] = torch.cat(order[2], 1)
    else:
        full["image_feat"], full["image_loc"] = feat, loc
        full["image_mask"] = image_mask
    return full


def _pretrain_batch(batch, device, store, cfg):
    batch = to_device(_widen_wire(batch), device)
    if store is not None:
        return materialize_cc_store_batch(store, batch, cfg)
    return batch


def _pretrain_losses(model, cfg, batch, lm_labels, image_label, generator,
                     dropout_seed=None):
    out = model(batch["input_ids"], batch["image_feat"], batch["image_loc"],
                batch["segment_ids"], batch["input_mask"],
                batch["image_mask"], dropout_seed=dropout_seed)
    return pretraining_losses(
        cfg, out, masked_lm_labels=lm_labels, image_label=image_label,
        image_cls=batch.get("image_cls"),
        image_feat=_strip_global(cfg, batch["image_feat"]),
        obj_labels=batch.get("obj_labels"), obj_confs=batch.get("obj_confs"),
        attr_labels=batch.get("attr_labels"),
        attr_confs=batch.get("attr_confs"),
        next_sentence_label=batch["is_match"], generator=generator)


def _nce_generator(cfg, device, seed: int):
    """The NCE negatives' generator on ``device`` (only where a positive
    weight asks for NCE)."""
    if cfg.visual_target_weights.get("2", 0) <= 0:
        return None
    return torch.Generator(device).manual_seed(seed)


def _metrics(device, **terms) -> Dict[str, torch.Tensor]:
    """Each term as a detached float32 tensor on ``device`` (a term that is
    absent is the float 0.0), summed over the ranks of a group (one
    all-reduce): the global batch's."""
    out = {k: v.detach().float() if isinstance(v, torch.Tensor)
           else torch.tensor(float(v), device=device)
           for k, v in terms.items()}
    if current_group() is None:
        return out
    return dict(zip(out, sum_across(torch.stack(list(out.values())))))


def make_pretrain_step(model, optimizer, cfg, objective: int = 0,
                       store: Dict[str, torch.Tensor] = None) -> Callable:
    """``step(state, batch) -> {loss, masked_t, masked_v, itm}``: the
    Conceptual Captions step, MLM + masked-region + ITM losses
    (volta_tpu/parallel/train_step.py:234-290; reference:
    train_concap.py:269-311) -> backward -> the optimizer's micro-step.
    Objective 1 ignores the MLM and region labels of mismatched pairs;
    objective 2 multiplies the ITM loss by 0 (its head takes zero
    gradients, and weight decay). Two uint32 seeds a step come from the
    state's generator: the forward's dropout sites', then the NCE
    negatives'. With ``store`` a batch is a device-store batch
    (``materialize_cc_store_batch``)."""
    device = next(model.parameters()).device

    def step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        with step_context():
            batch = _pretrain_batch(batch, device, store, cfg)
            dropout_seed = state.next_dropout_seed()
            generator = _nce_generator(cfg, device,
                                       state.next_dropout_seed())
            lm_labels, image_label = batch["lm_label_ids"], \
                batch["image_label"]
            if objective == 1:
                keep = (batch["is_match"] == 0)[:, None]
                lm_labels = torch.where(keep, lm_labels, -1)
                image_label = torch.where(keep, image_label, -1)
            mlm, mrm, itm = _pretrain_losses(model, cfg, batch, lm_labels,
                                             image_label, generator,
                                             dropout_seed)
            if objective == 2:
                itm = itm * 0.0
            loss = mlm + mrm + itm
            loss.backward()
            all_reduce_grads(model.parameters())
            optimizer.step()
            optimizer.zero_grad()
            state.step += 1
            return _metrics(device, loss=loss, masked_t=mlm, masked_v=mrm,
                            itm=itm)

    return step


def make_pretrain_eval_step(model, cfg) -> Callable:
    """``step(batch) -> {loss, masked_t, masked_v, itm}``, deterministic
    (volta_tpu/parallel/train_step.py:293-319): the model in eval mode
    under ``torch.inference_mode()`` (its mode is restored after), every
    label as the batch gives it, the NCE negatives drawn from a generator
    seeded 0, as JAX's from ``PRNGKey(0)``. Inside a group, the global
    batch's losses."""
    device = next(model.parameters()).device

    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode(), step_context():
                batch = to_device(_widen_wire(batch), device)
                mlm, mrm, itm = _pretrain_losses(
                    model, cfg, batch, batch["lm_label_ids"],
                    batch["image_label"], _nce_generator(cfg, device, 0))
                return _metrics(device, loss=mlm + mrm + itm, masked_t=mlm,
                                masked_v=mrm, itm=itm)
        finally:
            model.train(was_training)

    return step
