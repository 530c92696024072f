"""Visual Genome dense-caption region grounding.

reference: volta/datasets/refer_dense_caption.py (shipped unregistered).
Each region phrase becomes a V-logit grounding item with IoU targets
against the region's box; the last 10k/5k images form val/test.

The port's copy of ``volta_tpu/data/datasets/dense_caption.py``, which uses numpy
and the standard library only; the port keeps its own so that it imports
nothing of the JAX package.
"""

from __future__ import annotations

import json

import numpy as np

from .base import VLDataset
from .refer_expression import boxes_iou


class ReferDenseCaptionDataset(VLDataset):
    def __init__(self, task, dataroot, annotations_jsonpath, split,
                 image_features_reader, gt_image_features_reader, tokenizer,
                 bert_model="bert-base-uncased", padding_index=0,
                 max_seq_length=20, max_region_num=36, num_locs=5,
                 add_global_imgfeat=None, append_mask_sep=False):
        super().__init__(image_features_reader, tokenizer, padding_index,
                         max_seq_length, max_region_num, num_locs,
                         add_global_imgfeat, append_mask_sep,
                         gt_image_features_reader)
        self.split = split
        self.num_labels = 1
        anns = json.load(open(annotations_jsonpath))
        if split == "train":
            anns = anns[:-10000]
        elif split == "val":
            anns = anns[-10000:-5000]
        elif split == "test":
            anns = anns[-5000:]
        self.entries = []
        for img in anns:
            for region in img["regions"]:
                q, m, s = self._text(region["phrase"])
                self.entries.append(dict(
                    question_id=region["region_id"],
                    image_id=img["id"],
                    ref_box=[region["x"], region["y"],
                             region["x"] + region["width"],
                             region["y"] + region["height"]],
                    q_tokens=q, q_mask=m, q_seg=s))

    def __getitem__(self, index):
        e = self.entries[index]
        feats, num_boxes, boxes, boxes_ori = self._reader[e["image_id"]]
        n = min(int(num_boxes), self._max_region_num)
        fs = self.feature_size
        feat = np.zeros((self._max_region_num, fs), np.float32)
        loc = np.zeros((self._max_region_num, self._num_locs), np.float32)
        vmask = np.zeros((self._max_region_num,), np.int32)
        target = np.zeros((self._max_region_num, 1), np.float32)
        feat[:n] = feats[:n]
        loc[:n] = boxes[:n]
        vmask[:n] = 1
        target[:n, 0] = boxes_iou(
            np.asarray(boxes_ori[:n, :4], np.float32),
            np.asarray([e["ref_box"]], np.float32))[:, 0]
        return {
            "features": feat, "spatials": loc, "image_mask": vmask,
            "question": e["q_tokens"], "target": target,
            "input_mask": e["q_mask"], "segment_ids": e["q_seg"],
            "question_id": np.int64(e["question_id"]),
        }


class VisMadLibsDataset(VLDataset):
    """Visual Madlibs fill-in-the-blank as soft-target classification
    (reference: volta/datasets/vismadlibs_dataset.py, unregistered)."""

    def __init__(self, task, dataroot, annotations_jsonpath, split,
                 image_features_reader, gt_image_features_reader, tokenizer,
                 bert_model="bert-base-uncased", padding_index=0,
                 max_seq_length=20, max_region_num=36, num_locs=5,
                 add_global_imgfeat=None, append_mask_sep=False,
                 num_labels: int = 3129):
        super().__init__(image_features_reader, tokenizer, padding_index,
                         max_seq_length, max_region_num, num_locs,
                         add_global_imgfeat, append_mask_sep,
                         gt_image_features_reader)
        self.split = split
        self.num_labels = num_labels
        anns = json.load(open(annotations_jsonpath))
        self.entries = []
        for item in anns:
            q, m, s = self._text(item["question"])
            self.entries.append(dict(
                question_id=item.get("question_id", len(self.entries)),
                image_id=item["image_id"],
                labels=item.get("labels"), scores=item.get("scores"),
                q_tokens=q, q_mask=m, q_seg=s))

    def __getitem__(self, index):
        e = self.entries[index]
        feat, loc, vmask = self._image(e["image_id"])
        target = np.zeros((self.num_labels,), np.float32)
        if e["labels"]:
            target[np.asarray(e["labels"])] = np.asarray(e["scores"],
                                                         np.float32)
        return {
            "features": feat, "spatials": loc, "image_mask": vmask,
            "question": e["q_tokens"], "target": target,
            "input_mask": e["q_mask"], "segment_ids": e["q_seg"],
            "question_id": np.int64(e["question_id"]),
        }
