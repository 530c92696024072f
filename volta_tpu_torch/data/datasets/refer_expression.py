"""Referring-expression grounding (RefCOCO / RefCOCO+ / RefCOCOg).

reference: volta/datasets/refer_expression_dataset.py and the REFER API
(tools/refer/refer.py). Targets are per-region IoU against the referent's
ground-truth box (+1 pixel convention); the V-logit head scores each region
(reference: refer_expression_dataset.py:225-261).

The REFER annotations (refs(<splitBy>).p pickle + instances.json) are read
directly — see volta_tpu/tools/refer.py for the full API.

The port's copy of ``volta_tpu/data/datasets/refer_expression.py``, which uses numpy
and the standard library only; the port keeps its own so that it imports
nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

from .base import VLDataset


def boxes_iou(anchors: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Pairwise IoU with the reference's +1 pixel area convention
    (reference: refer_expression_dataset.py:21-58)."""
    anchors = anchors.astype(np.float32)
    gt = gt.astype(np.float32)
    a_area = ((anchors[:, 2] - anchors[:, 0] + 1)
              * (anchors[:, 3] - anchors[:, 1] + 1))[:, None]
    g_area = ((gt[:, 2] - gt[:, 0] + 1) * (gt[:, 3] - gt[:, 1] + 1))[None, :]
    iw = np.minimum(anchors[:, None, 2], gt[None, :, 2]) - \
        np.maximum(anchors[:, None, 0], gt[None, :, 0]) + 1
    ih = np.minimum(anchors[:, None, 3], gt[None, :, 3]) - \
        np.maximum(anchors[:, None, 1], gt[None, :, 1]) + 1
    iw = np.maximum(iw, 0)
    ih = np.maximum(ih, 0)
    return iw * ih / (a_area + g_area - iw * ih)


class ReferExpressionDataset(VLDataset):
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
        split_by = "umd" if task == "refcocog" else "unc"
        def build():
            entries = self._load_refer(dataroot, task, split_by, split)
            for e in entries:
                e["q_tokens"], e["q_mask"], e["q_seg"] = \
                    self._text(e["caption"])
            return entries

        from .base import cached_entries

        self.entries = cached_entries(dataroot, task, split, bert_model,
                                      max_seq_length, build)

    @staticmethod
    def _load_refer(dataroot, dataset, split_by, split):
        """Minimal REFER read: refs pickle + instances.json ann boxes."""
        base = os.path.join(dataroot, dataset)
        if not os.path.isdir(base):
            base = dataroot
        refs_path = os.path.join(base, f"refs({split_by}).p")
        with open(refs_path, "rb") as f:
            refs = pickle.load(f)
        with open(os.path.join(base, "instances.json")) as f:
            instances = json.load(f)
        ann_box = {a["id"]: a["bbox"] for a in instances["annotations"]}
        want = "train" if split == "mteval" else split
        entries = []
        for ref in refs:
            if ref.get("split") != want:
                continue
            box = ann_box[ref["ann_id"]]  # [x, y, w, h]
            ref_box = [box[0], box[1], box[0] + box[2], box[1] + box[3]]
            for sent, sent_id in zip(ref["sentences"], ref["sent_ids"]):
                entries.append(dict(caption=sent["raw"], sent_id=sent_id,
                                    image_id=ref["image_id"],
                                    ref_box=ref_box, ref_id=ref["ref_id"]))
        return entries

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
            np.asarray(boxes_ori[:n, :4]),
            np.asarray([e["ref_box"]], np.float32))[:, 0]
        return {
            "features": feat, "spatials": loc, "image_mask": vmask,
            "question": e["q_tokens"], "target": target,
            "input_mask": e["q_mask"], "segment_ids": e["q_seg"],
            "question_id": np.int64(e["image_id"]),
        }
