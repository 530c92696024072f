"""Pointing / grounding datasets with detector+GT region merging.

reference: volta/datasets/visual7w_pointing_dataset.py,
guesswhat_pointing_dataset.py, flickr_grounding_dataset.py. Shared pattern:
detector regions are concatenated with ground-truth candidate boxes (GT
reader, global row skipped); targets are IoU against the referent box,
zeroed below 0.5; V-logit-mc items carry the candidate indices that the
loss gathers at the trailing GT slots (reference:
volta/task_utils.py:261-269).

The port's copy of ``volta_tpu/data/datasets/pointing.py``, which uses numpy
and the standard library only; the port keeps its own so that it imports
nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import xml.etree.ElementTree as ET

import numpy as np

from .base import VLDataset
from .refer_expression import boxes_iou


def merge_det_gt(det_reader, gt_reader, image_id, max_regions, num_locs,
                 feature_size):
    """Concatenate detector regions with GT boxes (minus its global row).

    Returns padded (features, locations, mask, boxes_ori, mix_num).
    reference: visual7w_pointing_dataset.py:243-292.
    """
    feats, n, boxes, boxes_ori = det_reader[image_id]
    feats, boxes, boxes_ori = feats[:n], boxes[:n], boxes_ori[:n]
    if gt_reader is not None:
        g_feats, g_n, g_boxes, g_boxes_ori = gt_reader[image_id]
        feats = np.concatenate([feats, g_feats[1:g_n]], 0)
        boxes = np.concatenate([boxes, g_boxes[1:g_n]], 0)
        boxes_ori = np.concatenate([boxes_ori, g_boxes_ori[1:g_n]], 0)
        n = min(int(n + g_n - 1), max_regions)
    else:
        n = min(int(n), max_regions)
    feat = np.zeros((max_regions, feature_size), np.float32)
    loc = np.zeros((max_regions, num_locs), np.float32)
    mask = np.zeros((max_regions,), np.int32)
    feat[:n] = feats[:n]
    loc[:n] = boxes[:n]
    mask[:n] = 1
    return feat, loc, mask, boxes_ori, n


class _PointingBase(VLDataset):
    num_labels = 1

    def _iou_target(self, boxes_ori, ref_box, n, threshold=True):
        t = np.zeros((self._max_region_num, 1), np.float32)
        k = min(n, boxes_ori.shape[0])
        vals = boxes_iou(np.asarray(boxes_ori[:k, :4], np.float32),
                         np.asarray([ref_box], np.float32))[:, 0]
        if threshold:
            vals = np.where(vals < 0.5, 0.0, vals)
        t[:k, 0] = vals
        return t

    def _item(self, e, mc=None, threshold=True):
        feat, loc, vmask, boxes_ori, n = merge_det_gt(
            self._reader, self._gt_reader, e["image_id"],
            self._max_region_num, self._num_locs, self.feature_size)
        target = self._iou_target(boxes_ori, e["ref_box"], n, threshold)
        out = {
            "features": feat, "spatials": loc, "image_mask": vmask,
            "question": e["q_tokens"], "target": target,
            "input_mask": e["q_mask"], "segment_ids": e["q_seg"],
            "question_id": np.int64(e["question_id"]),
        }
        if mc is not None:
            out["multi_choice_ids"] = mc
            # targets gathered at the candidate slots for the mc loss
            det_off = 101  # fixed detector slot count (reference FIXME)
            idx = np.clip(det_off + mc, 0, self._max_region_num - 1)
            out["target"] = target[idx]
        return out


class Visual7wPointingDataset(_PointingBase):
    """Visual7w 'which' pointing (reference: visual7w_pointing_dataset.py).
    dataset.json: images with qa_pairs carrying 4 multiple_choices + answer
    box ids; candidate index = position in the image's sorted box-id union."""

    MC = 4

    def __init__(self, task, dataroot, annotations_jsonpath, split,
                 image_features_reader, gt_image_features_reader, tokenizer,
                 bert_model="bert-base-uncased", padding_index=0,
                 max_seq_length=20, max_region_num=120, num_locs=5,
                 add_global_imgfeat=None, append_mask_sep=False):
        super().__init__(image_features_reader, tokenizer, padding_index,
                         max_seq_length, max_region_num, num_locs,
                         add_global_imgfeat, append_mask_sep,
                         gt_image_features_reader)
        self.split = split

        def build():
            data = json.load(open(os.path.join(dataroot, "dataset.json")))
            boxes_dict = {b["box_id"]: [b["x"], b["y"], b["x"] + b["width"],
                                        b["y"] + b["height"]]
                          for b in data["boxes"]}
            entries = []
            for img in data["images"]:
                if img["split"] != split:
                    continue
                union = sorted({b for qa in img["qa_pairs"]
                                for b in qa["multiple_choices"]
                                + [qa["answer"]]})
                for qa in img["qa_pairs"]:
                    cand = sorted(qa["multiple_choices"] + [qa["answer"]])
                    mc_idx = [union.index(b) for b in cand]
                    q, m, s = self._text(qa["question"])
                    entries.append(dict(
                        question_id=qa["qa_id"], image_id=img["image_id"],
                        ref_box=boxes_dict[qa["answer"]],
                        mc_idx=np.asarray(mc_idx, np.int32),
                        q_tokens=q, q_mask=m, q_seg=s))
            return entries

        from .base import cached_entries

        self.entries = cached_entries(dataroot, task, split, bert_model,
                                      max_seq_length, build)

    def __getitem__(self, index):
        e = self.entries[index]
        return self._item(e, mc=e["mc_idx"])


class GuessWhatPointingDataset(_PointingBase):
    """GuessWhat guesser as pointing (reference:
    guesswhat_pointing_dataset.py): the full dialog is the text; candidates
    are the scene objects; referent is the dialog's target object."""

    def __init__(self, task, dataroot, annotations_jsonpath, split,
                 image_features_reader, gt_image_features_reader, tokenizer,
                 bert_model="bert-base-uncased", padding_index=0,
                 max_seq_length=100, max_region_num=120, num_locs=5,
                 add_global_imgfeat=None, append_mask_sep=False):
        super().__init__(image_features_reader, tokenizer, padding_index,
                         max_seq_length, max_region_num, num_locs,
                         add_global_imgfeat, append_mask_sep,
                         gt_image_features_reader)
        self.split = split
        path = annotations_jsonpath or os.path.join(
            dataroot, f"guesswhat.{split}.jsonl")
        bbox_list_p = os.path.join(dataroot, "cache", "image_bbox_list.pkl")
        boxes_dict_p = os.path.join(dataroot, "cache", "bboxes_dict.pkl")
        all_images = pickle.load(open(bbox_list_p, "rb")) \
            if os.path.exists(bbox_list_p) else None
        boxes_dict = pickle.load(open(boxes_dict_p, "rb")) \
            if os.path.exists(boxes_dict_p) else None
        from .base import cached_entries, read_jsonlines

        def build():
            entries = []
            for ann in read_jsonlines(path):
                dialog = " ".join(
                    f"{q['question']} {q['answer']}" for q in ann["qas"])
                obj_ids = sorted(o["id"] for o in ann["objects"])
                if all_images is not None:
                    union = sorted(
                        set(all_images[ann["image"]["id"]]["bboxes"]))
                    mc_idx = [union.index(o) for o in obj_ids]
                else:
                    mc_idx = list(range(len(obj_ids)))
                if boxes_dict is not None:
                    ref = boxes_dict[ann["object_id"]]
                else:
                    obj = next(o for o in ann["objects"]
                               if o["id"] == ann["object_id"])
                    bb = obj["bbox"]
                    ref = [bb[0], bb[1], bb[0] + bb[2], bb[1] + bb[3]]
                q, m, s = self._text(dialog)
                entries.append(dict(
                    question_id=ann["id"], image_id=ann["image"]["id"],
                    ref_box=ref, mc_idx=np.asarray(mc_idx, np.int32),
                    q_tokens=q, q_mask=m, q_seg=s))
            max_mc = max((len(e["mc_idx"]) for e in entries), default=1)
            for e in entries:
                pad = max_mc - len(e["mc_idx"])
                if pad:
                    e["mc_idx"] = np.concatenate(
                        [e["mc_idx"], np.zeros((pad,), np.int32)])
            return entries

        self.entries = cached_entries(dataroot, task, split, bert_model,
                                      max_seq_length, build)
        self._max_mc = max((len(e["mc_idx"]) for e in self.entries),
                           default=1)

    def __getitem__(self, index):
        e = self.entries[index]
        return self._item(e, mc=e["mc_idx"])


def parse_flickr_sentence(line: str):
    """Parse a Flickr30k Entities sentence line into plain words and
    [/EN#id/type phrase] spans (reference:
    flickr_grounding_dataset.py:60-133)."""
    words, phrases = [], []
    cur, cur_id = None, None
    for token in line.split():
        if token.startswith("["):
            parts = token.split("/")
            cur_id = parts[1][3:]
            cur = []
        elif cur is not None:
            word = token.rstrip("]")
            cur.append(word)
            words.append(word)
            if token.endswith("]"):
                phrases.append({"phrase": " ".join(cur),
                                "phrase_id": cur_id})
                cur, cur_id = None, None
        else:
            words.append(token)
    return {"sentence": " ".join(words), "phrases": phrases}


def parse_flickr_annotation(path: str):
    """Flickr30k Entities box XML -> {phrase_id: [x1,y1,x2,y2], ...}
    (reference: flickr_grounding_dataset.py:136-183)."""
    root = ET.parse(path).getroot()
    boxes = {}
    for obj in root.findall("object"):
        for name in obj.findall("name"):
            bnd = obj.findall("bndbox")
            if bnd:
                box = [int(bnd[0].find(t).text) - 1
                       for t in ("xmin", "ymin", "xmax", "ymax")]
                boxes.setdefault(name.text, []).append(box)
    return boxes


class FlickrGroundingDataset(_PointingBase):
    """Phrase grounding on Flickr30k Entities
    (reference: flickr_grounding_dataset.py). V-logit with IoU targets,
    thresholded at 0.5 for training."""

    def __init__(self, task, dataroot, annotations_jsonpath, split,
                 image_features_reader, gt_image_features_reader, tokenizer,
                 bert_model="bert-base-uncased", padding_index=0,
                 max_seq_length=24, max_region_num=120, num_locs=5,
                 add_global_imgfeat=None, append_mask_sep=False):
        super().__init__(image_features_reader, tokenizer, padding_index,
                         max_seq_length, max_region_num, num_locs,
                         add_global_imgfeat, append_mask_sep,
                         gt_image_features_reader if split == "train"
                         else None)
        self.split = split

        def build():
            with open(os.path.join(dataroot, f"{split}.txt")) as f:
                images = f.read().splitlines()
            entries = []
            for img in images:
                ann = parse_flickr_annotation(
                    os.path.join(dataroot, "Annotations", img + ".xml"))
                with open(os.path.join(dataroot, "Sentences",
                                       img + ".txt")) as f:
                    for line in f:
                        sent = parse_flickr_sentence(line.strip())
                        for ph in sent["phrases"]:
                            if str(ph["phrase_id"]) in ann:
                                q, m, s = self._text(ph["phrase"])
                                entries.append(dict(
                                    question_id=int(ph["phrase_id"]),
                                    image_id=int(img),
                                    ref_box=ann[str(ph["phrase_id"])][0],
                                    q_tokens=q, q_mask=m, q_seg=s))
            return entries

        from .base import cached_entries

        self.entries = cached_entries(dataroot, task, split, bert_model,
                                      max_seq_length, build)

    def __getitem__(self, index):
        e = self.entries[index]
        return self._item(e, threshold=self.split == "train")
