"""Task configs, eval datasets, batch reshapes and the VQA loss and score.

JAX-free counterpart of ``volta_tpu/task_utils.py`` (task_utils.py:27-165,
173-236, 272-293), which imports JAX at the top and so cannot be imported
here. The datasets, readers and loader are ``volta_tpu.data``'s own. Only
the ``normal`` process and the VL-classifier loss are ported so far.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Tuple

import torch
import yaml

from .losses import binary_cross_entropy_with_logits


def load_task_config(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        return yaml.safe_load(f)


def task_key(task_id: str) -> str:
    return task_id if task_id.startswith("TASK") else "TASK" + task_id


def make_tokenizer(bert_model: str, do_lower_case: bool = True,
                   vocab_file: str = None):
    if "roberta" in bert_model:
        from volta_tpu.data.bpe import RobertaTokenizer

        return RobertaTokenizer.from_pretrained(vocab_file or bert_model)
    from volta_tpu.data.tokenization import BertTokenizer

    if vocab_file:
        return BertTokenizer(vocab_file, do_lower_case)
    return BertTokenizer.from_pretrained(bert_model, do_lower_case)


def _build_dataset(registry, cfg, tc, tokenizer, split_key, ann_key,
                   readers, bert_model):
    name = tc["name"]
    extra = {}
    if "num_labels" in tc and "num_labels" in inspect.signature(
            registry[name].__init__).parameters:
        # answer-space size from the task yml, for datasets that take it
        # directly (VisMadLibs) rather than from answer pickles
        extra["num_labels"] = tc["num_labels"]
    return registry[name](
        task=name,
        **extra,
        dataroot=tc["dataroot"],
        annotations_jsonpath=tc.get(ann_key, ""),
        split=tc[split_key],
        image_features_reader=readers[0],
        gt_image_features_reader=readers[1],
        tokenizer=tokenizer,
        bert_model=bert_model,
        padding_index=0,
        max_seq_length=tc["max_seq_length"],
        max_region_num=tc["max_region_num"],
        num_locs=cfg.num_locs,
        add_global_imgfeat=cfg.add_global_imgfeat,
        append_mask_sep=(cfg.fusion_method == "vl-bert_vqa"),
    )


def _make_readers(cfg, tc, in_memory=False):
    from volta_tpu.data.features_reader import ImageFeaturesReader

    out = []
    for key in ("features_h5path1", "features_h5path2"):
        path = tc.get(key, "")
        out.append(ImageFeaturesReader(
            path, num_locs=cfg.num_locs,
            add_global_imgfeat=cfg.add_global_imgfeat,
            feature_size=cfg.v_feature_size, in_memory=in_memory)
            if path else None)
    return out


def load_dataset(args, cfg, task_cfg: Dict[str, Any], task_id: str,
                 split: str = "trainval"):
    """Train/val datasets + loaders for one task, one host
    (volta_tpu/task_utils.py:96-141; reference: volta/task_utils.py:290-371).
    The train loader shuffles from ``args.seed`` and drops the last partial
    batch; so does the val loader, as in the JAX CLI."""
    from volta_tpu.data.datasets import DatasetMapTrain
    from volta_tpu.data.loader import DataLoader

    tokenizer = make_tokenizer(args.bert_model, args.do_lower_case,
                               getattr(args, "vocab_file", None))
    task = task_key(task_id)
    tc = task_cfg[task]
    readers = _make_readers(cfg, tc, getattr(args, "in_memory", False))
    batch_size = tc["batch_size"] // args.grad_acc_steps
    packed = getattr(args, "in_memory", False)
    feat_dtype = "bfloat16" if getattr(cfg, "compute_dtype", "") == \
        "bfloat16" else "float32"
    out = {"task": task, "batch_size": batch_size}
    for name, shuffle, workers in (
            ("train", True, args.num_workers), ("val", False, 2)):
        if name not in split:
            continue
        ds = _build_dataset(DatasetMapTrain, cfg, tc, tokenizer,
                            f"{name}_split", f"{name}_annotations_jsonpath",
                            readers, args.bert_model)
        if packed and hasattr(ds, "enable_packed"):
            ds.enable_packed(feat_dtype=feat_dtype)
        out[f"{name}_dataset"] = ds
        out[f"{name}_loader"] = DataLoader(
            ds, batch_size, shuffle=shuffle, seed=args.seed, drop_last=True,
            num_workers=workers,
            num_procs=getattr(args, "num_worker_procs", 0) if shuffle else 0)
    return out


def load_dataset_eval(args, cfg, task_cfg: Dict[str, Any], task_id: str):
    """Eval-split dataset + loader (reference: volta/task_utils.py:374-426)."""
    from volta_tpu.data.datasets import DatasetMapEval
    from volta_tpu.data.loader import DataLoader

    tokenizer = make_tokenizer(args.bert_model, args.do_lower_case,
                               getattr(args, "vocab_file", None))
    task = task_key(task_id)
    tc = dict(task_cfg[task])
    if getattr(args, "split", ""):
        tc["val_split"] = args.split
    readers = _make_readers(cfg, tc, getattr(args, "in_memory", False))
    batch_size = tc.get("eval_batch_size", getattr(args, "batch_size", 32))
    ds = _build_dataset(DatasetMapEval, cfg, tc, tokenizer, "val_split",
                        "val_annotations_jsonpath", readers, args.bert_model)
    loader = DataLoader(ds, batch_size, shuffle=False, drop_last=False,
                        num_workers=args.num_workers)
    return {"task": task, "batch_size": batch_size, "dataset": ds,
            "loader": loader}


def process_batch(task_cfg: Dict[str, Any], batch: Dict[str, Any]
                  ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The task's ``process`` reshape; returns (model_inputs, info). Only
    ``normal`` (no reshape) is ported."""
    process = task_cfg.get("process", "normal")
    if process != "normal":
        raise NotImplementedError(
            f"process {process!r} is not ported yet (ROADMAP.md Queue 1, "
            "eval path)")
    feats = batch["features"]
    info = {"batch_size": feats.shape[0], "num_options": 1}
    inputs = dict(input_ids=batch["question"], image_feat=feats,
                  image_loc=batch["spatials"],
                  token_type_ids=batch["segment_ids"],
                  attention_mask=batch["input_mask"],
                  image_attention_mask=batch["image_mask"])
    return inputs, info


def soft_score_with_logits(logits, targets):
    """One-hot(argmax) . soft targets (reference:
    volta/task_utils.py:429-434 compute_score_with_logits)."""
    pred = torch.argmax(logits, dim=1)
    return torch.gather(targets, 1, pred[:, None])[:, 0]


def task_loss_and_score(task_type: str, prediction, batch, info,
                        loss_name: str = "BCEWithLogitLoss"):
    """Loss and batch score (reference: volta/task_utils.py:238-279); the
    VL-classifier branch only."""
    if task_type not in ("VL-classifier", "VL-classifier-GQA"):
        raise NotImplementedError(
            f"task type {task_type!r} is not ported yet (ROADMAP.md Queue 1, "
            "eval path)")
    target = batch["target"]
    loss = binary_cross_entropy_with_logits(prediction, target) \
        * target.shape[1]
    score = torch.sum(soft_score_with_logits(prediction, target))
    return loss, score
