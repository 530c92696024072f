"""Shared dataset machinery: fixed-shape padding, tokenised entries, caching.

Every dataset emits dict samples with statically shaped numpy arrays (text
padded to max_seq_length, regions to max_region_num [+global]) so each train
step has one XLA signature. Field names follow the reference batch layout
(reference: volta/task_utils.py:140-146).

The port's copy of ``volta_tpu/data/datasets/base.py``, which uses numpy
and the standard library only; the port keeps its own so that it imports
nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import List, Optional

import numpy as np


def pad_tokens(token_ids: List[int], max_len: int, pad: int = 0):
    """Truncate/pad to max_len; returns (tokens, input_mask, segment_ids)."""
    ids = list(token_ids)[:max_len]
    mask = [1] * len(ids)
    seg = [0] * len(ids)
    short = max_len - len(ids)
    return (np.array(ids + [pad] * short, np.int32),
            np.array(mask + [0] * short, np.int32),
            np.array(seg + [0] * short, np.int32))


def encode_question(tokenizer, text: str, max_len: int, pad: int = 0,
                    text_pair: Optional[str] = None):
    """[CLS] text [SEP] (pair [SEP]) truncated to max_len, padded."""
    ids = tokenizer.encode(text, add_special_tokens=False) \
        if hasattr(tokenizer, "encode") else tokenizer(text)
    ids = list(ids)[: max_len - 2]
    out = [tokenizer.cls_id] + ids + [tokenizer.sep_id] \
        if hasattr(tokenizer, "cls_id") else \
        tokenizer.build_inputs_with_special_tokens(ids)
    if text_pair is not None:
        pair = tokenizer.encode(text_pair, add_special_tokens=False)
        out = out[: max_len - 1 - len(pair[: max_len // 2])]
        out = out + list(pair[: max_len // 2]) + [tokenizer.sep_id]
    return pad_tokens(out, max_len, pad)


def narrow_wire_text(tokens, mask, seg):
    """Narrow the per-step wire dtypes for device-store batches: token ids
    to int16 when the vocab fits (BERT's 30,522 does; RoBERTa's 50,265
    stays int32), 0/1 masks and segment ids to int8. The device step widens
    everything back to int32 before any compute
    (parallel.train_step._widen_wire) so numerics are untouched — the
    narrow dtypes exist only to cross the host->device link, the store
    mode's one remaining per-step cost."""
    tok = (tokens.astype(np.int16)
           if tokens.size and int(tokens.max()) < 2 ** 15
           else tokens.astype(np.int32))
    return tok, mask.astype(np.int8), seg.astype(np.int8)


def pad_regions(features, num_boxes: int, boxes, max_regions: int,
                num_locs: int, feature_size: int = 2048):
    """Fixed-shape region padding (reference: vqa_dataset.py:245-261)."""
    n = min(int(num_boxes), max_regions)
    feat = np.zeros((max_regions, feature_size), np.float32)
    loc = np.zeros((max_regions, num_locs), np.float32)
    mask = np.zeros((max_regions,), np.int32)
    feat[:n] = features[:n]
    loc[:n] = boxes[:n]
    mask[:n] = 1
    return feat, loc, mask


def append_mask_sep(tokenizer, question, input_mask, segment_ids):
    """Insert [MASK][CLS] at the end of the live text for VL-BERT VQA
    (reference: vqa_dataset.py:265-270). Output length grows by 2."""
    pos = int(input_mask.sum())
    extra_tok = np.array([tokenizer.mask_id, tokenizer.cls_id], np.int32)
    extra_one = np.array([1, 1], np.int32)
    q = np.concatenate([question[:pos], extra_tok, question[pos:]])
    m = np.concatenate([input_mask[:pos], extra_one, input_mask[pos:]])
    s = np.concatenate([segment_ids[:pos], extra_one, segment_ids[pos:]])
    return q, m, s


class VLDataset:
    """Base class: holds the feature reader and shape config."""

    def __init__(self, image_features_reader, tokenizer, padding_index=0,
                 max_seq_length=16, max_region_num=36, num_locs=5,
                 add_global_imgfeat=None, append_mask_sep=False,
                 gt_image_features_reader=None):
        self._reader = image_features_reader
        self._gt_reader = gt_image_features_reader
        self._tokenizer = tokenizer
        self._pad = padding_index
        self._max_seq_length = max_seq_length
        self._max_region_num = max_region_num + int(
            add_global_imgfeat is not None)
        self._num_locs = num_locs
        self._add_global_imgfeat = add_global_imgfeat
        self._append_mask_sep = append_mask_sep

    @property
    def feature_size(self):
        return getattr(self._reader, "feature_size", 2048)

    def _image(self, image_id):
        feats, num_boxes, boxes, _ = self._reader[image_id]
        return pad_regions(feats, num_boxes, boxes, self._max_region_num,
                           self._num_locs, self.feature_size)

    def _text(self, text, text_pair=None):
        q, m, s = encode_question(self._tokenizer, text, self._max_seq_length,
                                  self._pad, text_pair)
        if self._append_mask_sep:
            q, m, s = append_mask_sep(self._tokenizer, q, m, s)
        return q, m, s

    def __len__(self):
        return len(self.entries)


def cache_pickle(path: str, builder):
    """Build-or-load tokenised entries (reference: vqa_dataset.py:180-187)."""
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    entries = builder()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(entries, f)
    return entries


def cached_entries(dataroot, task, split, bert_model, max_seq_length,
                   builder):
    """Tokenised-entry cache under ``dataroot/cache`` keyed by task, split,
    tokenizer family and sequence length (the reference caches most
    datasets this way, e.g. retrieval_dataset.py:123-139). Falls back to
    in-memory building when the dataroot is read-only."""
    suffix = "_roberta" if "roberta" in (bert_model or "") else ""
    path = os.path.join(dataroot, "cache",
                        f"{task}_{split}{suffix}_{max_seq_length}.pkl")
    try:
        return cache_pickle(path, builder)
    except OSError:
        return builder()


def read_jsonlines(path: str):
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)
