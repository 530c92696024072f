"""Task configs, datasets, batch reshapes and every task type's loss and
score.

JAX-free counterpart of ``volta_tpu/task_utils.py`` (task_utils.py:27-232,
272-329), which imports JAX at the top and so cannot be imported here. The
datasets, readers and loader are the port's copies in ``data/``. All five
processes (``normal``, ``expand``, ``retrieval``, ``nlvr``, ``dialog``)
and the losses and scores of every head type are ported.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Tuple

import torch
import yaml

from .losses import binary_cross_entropy_with_logits
from .parallel import current_group


def load_task_config(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        return yaml.safe_load(f)


def task_key(task_id: str) -> str:
    return task_id if task_id.startswith("TASK") else "TASK" + task_id


def make_tokenizer(bert_model: str, do_lower_case: bool = True,
                   vocab_file: str = None):
    if "roberta" in bert_model:
        from .data.bpe import RobertaTokenizer

        return RobertaTokenizer.from_pretrained(vocab_file or bert_model)
    from .data.tokenization import BertTokenizer

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
    from .data.features_reader import ImageFeaturesReader

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
    """Train/val datasets + loaders for one task
    (volta_tpu/task_utils.py:96-141; reference: volta/task_utils.py:290-371).
    The train loader shuffles from ``args.seed`` and drops the last partial
    batch; so does the val loader, as in the JAX CLI. In a process group
    both read the rank's shard at the task batch / K / W
    (``parallel.per_rank_batch``, ``parallel.shard_args``)."""
    from .data.datasets import DatasetMapTrain
    from .data.loader import DataLoader
    from .parallel import per_rank_batch, shard_args

    tokenizer = make_tokenizer(args.bert_model, args.do_lower_case,
                               getattr(args, "vocab_file", None))
    task = task_key(task_id)
    tc = task_cfg[task]
    readers = _make_readers(cfg, tc, getattr(args, "in_memory", False))
    batch_size = per_rank_batch(tc["batch_size"], args.grad_acc_steps)
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
            num_procs=getattr(args, "num_worker_procs", 0) if shuffle else 0,
            **shard_args())
    return out


def load_dataset_eval(args, cfg, task_cfg: Dict[str, Any], task_id: str):
    """Eval-split dataset + loader (reference: volta/task_utils.py:374-426)."""
    from .data.datasets import DatasetMapEval
    from .data.loader import DataLoader

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


def _flat2(x):
    return x.reshape((-1,) + tuple(x.shape[2:]))


def process_batch(task_cfg: Dict[str, Any], batch: Dict[str, Any]
                  ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The task's ``process`` reshape (volta_tpu/task_utils.py:169-232) on
    a batch of tensors; returns (model_inputs, info), where info carries the
    sizes the loss needs (``batch_size``, ``num_options``)."""
    process = task_cfg.get("process", "normal")
    feats, spatials = batch["features"], batch["spatials"]
    image_mask = batch["image_mask"]
    question = batch["question"]
    input_mask, segment_ids = batch["input_mask"], batch["segment_ids"]
    info = {"batch_size": feats.shape[0], "num_options": 1}

    if process == "expand":
        # one image tiled over the question options (VCR)
        # reference: volta/task_utils.py:185-208
        num_options = question.shape[1]

        def tile(x):
            return x[:, None].expand((x.shape[0], num_options)
                                     + tuple(x.shape[1:])).reshape(
                (-1,) + tuple(x.shape[1:]))
        feats, spatials, image_mask = map(tile, (feats, spatials,
                                                 image_mask))
        question, input_mask, segment_ids = map(
            _flat2, (question, input_mask, segment_ids))
        info["num_options"] = num_options
    elif process == "retrieval":
        # flatten the 4-way pos/neg dim (reference: volta/task_utils.py:210-218)
        info["num_options"] = question.shape[1]
        feats, spatials, image_mask, question, input_mask, segment_ids = map(
            _flat2, (feats, spatials, image_mask, question, input_mask,
                     segment_ids))
    elif process == "nlvr":
        # split 2x36 regions into two images, duplicate the sentence
        # (reference: volta/task_utils.py:220-232); the two images of a pair
        # stay consecutive rows, which the binary head reads as one row
        b = feats.shape[0]
        feats = feats.reshape(b * 2, feats.shape[1] // 2, feats.shape[2])
        spatials = spatials.reshape(b * 2, spatials.shape[1] // 2,
                                    spatials.shape[2])
        image_mask = image_mask.reshape(b * 2, image_mask.shape[1] // 2)
        question, input_mask, segment_ids = (
            torch.repeat_interleave(x, 2, dim=0)
            for x in (question, input_mask, segment_ids))
    elif process == "dialog":
        # rounds x options expansion (reference: volta/task_utils.py:149-183)
        nround, num_options = question.shape[1], question.shape[2]
        b = feats.shape[0]

        def tile(x):
            return x[:, None, None].expand(
                (b, nround, num_options) + tuple(x.shape[1:])).reshape(
                (-1,) + tuple(x.shape[1:]))
        feats, spatials, image_mask = map(tile, (feats, spatials,
                                                 image_mask))
        question = question.reshape(-1, question.shape[-1])
        input_mask = input_mask.reshape(-1, input_mask.shape[-1])
        segment_ids = segment_ids.reshape(-1, segment_ids.shape[-1])
        info["num_options"] = num_options
        info["batch_size"] = b * nround

    inputs = dict(input_ids=question, image_feat=feats, image_loc=spatials,
                  token_type_ids=segment_ids, attention_mask=input_mask,
                  image_attention_mask=image_mask)
    return inputs, info


def process_row_index(task_cfg: Dict[str, Any], batch: Dict[str, Any]
                      ) -> Dict[str, Any]:
    """Per-row provenance of a process-expanded model batch, a copy of the
    JAX package's (volta_tpu/task_utils.py:239-268): for every row of the
    batch ``process_batch`` makes, the index of its host-batch entry
    (``row_qid_index``, into the batch's ``question_id``), its option
    (``row_option``: answer choice, retrieval way, NLVR2 image) and its
    dialog round (``row_round``). numpy in and out."""
    import numpy as np

    process = task_cfg.get("process", "normal")
    b = np.asarray(batch["features"]).shape[0]
    q = np.asarray(batch["question"])
    if process in ("expand", "retrieval"):
        no = q.shape[1]
        r = np.arange(b * no)
        return {"row_qid_index": r // no, "row_option": r % no}
    if process == "nlvr":
        r = np.arange(b * 2)
        return {"row_qid_index": r // 2, "row_option": r % 2}
    if process == "dialog":
        nround, no = q.shape[1], q.shape[2]
        r = np.arange(b * nround * no)
        return {"row_qid_index": r // (nround * no),
                "row_round": (r // no) % nround,
                "row_option": r % no}
    return {"row_qid_index": np.arange(b)}


def soft_score_with_logits(logits, targets):
    """One-hot(argmax) . soft targets (reference:
    volta/task_utils.py:429-434 compute_score_with_logits)."""
    pred = torch.argmax(logits, dim=1)
    return torch.gather(targets, 1, pred[:, None])[:, 0]


def cross_entropy(logits, labels):
    """Per-row cross entropy, the log-softmax in float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None])[:, 0]


def task_loss_and_score(task_type: str, prediction, batch, info,
                        loss_name: str = "BCEWithLogitLoss"):
    """Training loss and batch score per task type
    (volta_tpu/task_utils.py:279-329; reference:
    volta/task_utils.py:238-279). An unknown type raises ``ValueError``.
    Inside a data-parallel group of W ranks the loss is the rank's share
    of the global batch's, its batch mean over W: the ranks' batches are
    of one size (``parallel.per_rank_batch``, the loaders drop a partial
    batch), so the mean of their means is the global batch's mean.
    ``score`` stays the rank's sum."""
    target = batch["target"]
    bsz = info["batch_size"]
    if task_type in ("VL-classifier", "VL-classifier-GQA"):
        loss = binary_cross_entropy_with_logits(prediction, target) \
            * target.shape[1]
        score = torch.sum(soft_score_with_logits(prediction, target))
    elif task_type == "VL-logit":
        logit = prediction.reshape(bsz, info["num_options"])
        # dialog process delivers [b, rounds] labels; flatten to match the
        # rounds-expanded rows (reference: volta/task_utils.py:155)
        tgt = target.reshape(-1).long()
        loss = torch.mean(cross_entropy(logit, tgt))
        score = torch.sum(torch.argmax(logit, dim=1) == tgt)
    elif task_type == "V-logit":
        loss = binary_cross_entropy_with_logits(prediction, target) \
            * target.shape[1]
        sel = torch.argmax(prediction[..., 0], dim=1)
        picked = torch.gather(target[..., 0], 1, sel[:, None])
        score = torch.sum(picked > 0.5)
    elif task_type == "V-logit-mc":
        # gather candidate boxes among the 101.. trailing region slots
        # (reference: volta/task_utils.py:261-269)
        mc = batch["multi_choice_ids"].long()
        logit = torch.gather(prediction[:, 101:, 0], 1, mc)[..., None]
        loss = binary_cross_entropy_with_logits(logit, target) \
            * target.shape[1]
        score = torch.sum(torch.argmax(logit[..., 0], dim=1)
                          == torch.argmax(target[..., 0], dim=1))
    elif task_type == "VL-binary-classifier":
        loss = binary_cross_entropy_with_logits(prediction, target)
        score = torch.sum(soft_score_with_logits(prediction, target))
    elif task_type == "VL-tri-classifier":
        if loss_name == "CrossEntropyLoss":
            loss = torch.mean(cross_entropy(prediction, target))
            score = torch.sum(torch.argmax(prediction, dim=1)
                              == target.long())
        else:
            loss = binary_cross_entropy_with_logits(prediction, target)
            score = torch.sum(soft_score_with_logits(prediction, target))
    else:
        raise ValueError(f"Undefined task type: {task_type}")
    g = current_group()
    if g is not None and g.world > 1:
        loss = loss / g.world
    return loss, score
