"""SNLI-VE visual entailment (3-way classification).

reference: volta/datasets/visual_entailment_dataset.py: jsonl annotations
with Flickr30k image ids; label = majority of annotator_labels mapped over
{contradiction, neutral, entailment}; soft targets over the 3 classes.

The port's copy of ``volta_tpu/data/datasets/visual_entailment.py``, which uses numpy
and the standard library only; the port keeps its own so that it imports
nothing of the JAX package.
"""

from __future__ import annotations

import os
from collections import Counter

import numpy as np

from .base import VLDataset, cached_entries, read_jsonlines

LABEL_MAP = {"contradiction": 0, "neutral": 1, "entailment": 2}


class VisualEntailmentDataset(VLDataset):
    def __init__(self, task, dataroot, annotations_jsonpath, split,
                 image_features_reader, gt_image_features_reader, tokenizer,
                 bert_model="bert-base-uncased", padding_index=0,
                 max_seq_length=16, max_region_num=36, num_locs=5,
                 add_global_imgfeat=None, append_mask_sep=False):
        super().__init__(image_features_reader, tokenizer, padding_index,
                         max_seq_length, max_region_num, num_locs,
                         add_global_imgfeat, append_mask_sep,
                         gt_image_features_reader)
        self.split = split
        self.num_labels = 3
        path = annotations_jsonpath or os.path.join(
            dataroot, f"snli_ve_{split}.jsonl")

        def build():
            entries = []
            for count, ann in enumerate(read_jsonlines(path)):
                labels, scores = self._soft_labels(ann)
                q, m, s = self._text(str(ann["sentence2"]))
                entries.append(dict(
                    question_id=count,
                    image_id=int(ann["Flickr30K_ID"]),
                    labels=labels, scores=scores,
                    q_tokens=q, q_mask=m, q_seg=s))
            return entries

        self.entries = cached_entries(dataroot, task, split, bert_model,
                                      max_seq_length, build)

    @staticmethod
    def _soft_labels(ann):
        votes = [LABEL_MAP[l] for l in ann.get("annotator_labels", [])
                 if l in LABEL_MAP]
        if not votes:
            gold = LABEL_MAP.get(ann.get("gold_label"))
            return ([gold], [1.0]) if gold is not None else ([], [])
        counts = Counter(votes)
        total = sum(counts.values())
        labels = sorted(counts)
        return labels, [counts[l] / total for l in labels]

    def __getitem__(self, index):
        e = self.entries[index]
        feat, loc, vmask = self._image(e["image_id"])
        target = np.zeros((3,), np.float32)
        if e["labels"]:
            target[np.asarray(e["labels"])] = np.asarray(e["scores"],
                                                         np.float32)
        return {
            "features": feat, "spatials": loc, "image_mask": vmask,
            "question": e["q_tokens"], "target": target,
            "input_mask": e["q_mask"], "segment_ids": e["q_seg"],
            "question_id": np.int64(e["question_id"]),
        }
