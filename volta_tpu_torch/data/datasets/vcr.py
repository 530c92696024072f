"""VCR Q->A and QA->R multiple-choice datasets.

reference: volta/datasets/vcr_dataset.py. Each item carries 4 text options
([CLS] context [SEP] option [SEP]); the image (detector + GT features
merged) is tiled over the options by the ``expand`` process at step time
(reference: volta/task_utils.py:185-208). Detection-tag references inside
the text (lists of region indices) are expanded to object names, with
'person' replaced by a random unisex name
(reference: vcr_dataset.py:292-319).

The port's copy of ``volta_tpu/data/datasets/vcr.py``, which uses numpy
and the standard library only; the port keeps its own so that it imports
nothing of the JAX package.
"""

from __future__ import annotations

import csv
import json
import os
import random

import numpy as np

from .base import (VLDataset, cached_entries, narrow_wire_text,
                   pad_tokens, read_jsonlines)


def _conv_id(img_id: str) -> int:
    return int(img_id.split("-")[1])


class VCRDataset(VLDataset):
    def __init__(self, task, dataroot, annotations_jsonpath, split,
                 image_features_reader, gt_image_features_reader, tokenizer,
                 bert_model="bert-base-uncased", padding_index=0,
                 max_seq_length=40, max_region_num=100, num_locs=5,
                 add_global_imgfeat=None, append_mask_sep=False, seed=0):
        super().__init__(image_features_reader, tokenizer, padding_index,
                         max_seq_length, max_region_num, num_locs,
                         add_global_imgfeat, append_mask_sep,
                         gt_image_features_reader)
        self.split = split
        self.task = task
        self.num_labels = 1
        self.dataroot = dataroot
        self._rng = random.Random(seed)
        self._names = []
        names_csv = os.path.join(dataroot, "unisex_names_table.csv")
        if os.path.exists(names_csv):
            with open(names_csv) as f:
                for row in csv.reader(f):
                    if row and row[1] != "name":
                        self._names.append(row[1])
        if not self._names:
            self._names = ["Casey", "Riley", "Jordan", "Taylor"]

        def build():
            self.entries = []
            for ann in read_jsonlines(annotations_jsonpath):
                label_key = "answer_label" if task == "VCR_Q-A" else \
                    "rationale_label"
                target = 0 if split == "test" else ann[label_key]
                if task == "VCR_Q-A":
                    context = ann["question"]
                    options = ann["answer_choices"]
                else:
                    right = ann["answer_choices"][ann.get("answer_label", 0)] \
                        if split != "test" else ann["answer_choices"][0]
                    context = ann["question"] + right
                    options = ann["rationale_choices"]
                self.entries.append(dict(
                    context=context, options=options, target=target,
                    metadata_fn=ann["metadata_fn"],
                    img_id=_conv_id(ann["img_id"]),
                    anno_id=int(ann["annot_id"].split("-")[1])))
            self._tokenize_all()
            return self.entries

        self.entries = cached_entries(dataroot, task, split, bert_model,
                                      max_seq_length, build)

    # ---------------------------------------------------------- tokenizing
    def _names_for(self, metadata_fn):
        path = os.path.join(self.dataroot, "vcr1images", metadata_fn)
        det_names = []
        if os.path.exists(path):
            det_names = json.load(open(path)).get("names", [])
        return [self._rng.choice(self._names) if n == "person" else n
                for n in det_names]

    def _expand_tags(self, mixed_tokens, names):
        """str tokens pass through; list tokens become the referenced object
        names (reference: vcr_dataset.py:302-319)."""
        out = []
        for w in mixed_tokens:
            if isinstance(w, str):
                out.extend(self._tokenizer.tokenize(w))
            else:
                for idx in w:
                    name = names[idx] if idx < len(names) else "object"
                    out.extend(self._tokenizer.tokenize(name))
        return out

    def _tokenize_all(self):
        tok = self._tokenizer
        for e in self.entries:
            names = self._names_for(e["metadata_fn"])
            ctx = self._expand_tags(e["context"], names)
            ids, masks, segs = [], [], []
            for opt in e["options"]:
                opt_toks = self._expand_tags(opt, names)
                a, b = list(ctx), list(opt_toks)
                while len(a) + len(b) > self._max_seq_length - 3:
                    (a if len(a) > len(b) else b).pop()
                seq = [tok.cls_id] + tok.convert_tokens_to_ids(a) + \
                    [tok.sep_id] + tok.convert_tokens_to_ids(b) + [tok.sep_id]
                q, m, s = pad_tokens(seq, self._max_seq_length, self._pad)
                s[len(a) + 2:len(a) + 2 + len(b) + 1] = 1
                ids.append(q), masks.append(m), segs.append(s)
            e["q_tokens"] = np.stack(ids)
            e["q_mask"] = np.stack(masks)
            e["q_seg"] = np.stack(segs)

    # ------------------------------------------------------------- getitem
    def _merged_image(self, img_query):
        """Blend detector + GT features (reference: vcr_dataset.py:361-395)."""
        feats, num_boxes, boxes, _ = self._reader[img_query]
        feats = np.array(feats[:num_boxes])  # frombuffer views are read-only
        boxes = boxes[:num_boxes]
        gt_feats, gt_n, gt_boxes, _ = self._gt_reader[img_query]
        feats[0] = (feats[0] * num_boxes + gt_feats[0] * gt_n) / \
            (num_boxes + gt_n)
        gt_feats, gt_boxes = gt_feats[1:gt_n], gt_boxes[1:gt_n]
        gt_n = min(self._max_region_num - 1, gt_n - 1)
        gt_feats, gt_boxes = gt_feats[:gt_n], gt_boxes[:gt_n]
        keep = min(self._max_region_num - gt_n, int(num_boxes))
        mix_feats = np.concatenate([feats[:keep], gt_feats], 0)
        mix_boxes = np.concatenate([boxes[:keep], gt_boxes], 0)
        n = keep + gt_n
        fs = self.feature_size
        feat = np.zeros((self._max_region_num, fs), np.float32)
        loc = np.zeros((self._max_region_num, self._num_locs), np.float32)
        mask = np.zeros((self._max_region_num,), np.int32)
        feat[:n] = mix_feats[:n]
        loc[:n] = mix_boxes[:n]
        mask[:n] = 1
        return feat, loc, mask

    def __getitem__(self, index):
        e = self.entries[index]
        img_query = e["metadata_fn"][:-5] + ".jpg"
        if self._gt_reader is not None:
            feat, loc, vmask = self._merged_image(img_query)
        else:
            feat, loc, vmask = self._image(img_query)
        return {
            "features": feat, "spatials": loc, "image_mask": vmask,
            "question": e["q_tokens"], "target": np.int32(e["target"]),
            "input_mask": e["q_mask"], "segment_ids": e["q_seg"],
            "question_id": np.int64(e["anno_id"]),
        }

    # ------------------------------------------------- device-resident mode
    def enable_device_store(self, feat_dtype="float32", cache: bool = True):
        """The det+GT merge is deterministic per image, so the merged
        regions pack once into HBM-resident arrays; batches then ship only
        a row index + the 4 tokenised options (~20 KB) instead of the dense
        merged features (~38 MB/step over a slow host link). The ``expand``
        option tiling runs on device after the gather (reference:
        volta/task_utils.py:185-208, vcr_dataset.py:361-395)."""
        from ..packed import pack_features

        queries, seen = [], set()
        for e in self.entries:
            q = e["metadata_fn"][:-5] + ".jpg"
            if q not in seen:
                seen.add(q)
                queries.append(q)
        self._pf = pack_features(_MergedRegionReader(self), queries,
                                 self._max_region_num, self._num_locs,
                                 cache=cache, dtype=feat_dtype)
        self._img_row = np.array(
            [self._pf.row(e["metadata_fn"][:-5] + ".jpg")
             for e in self.entries], np.int64)
        self._q_tokens = np.stack([e["q_tokens"] for e in self.entries])
        self._q_mask = np.stack([e["q_mask"] for e in self.entries])
        self._q_seg = np.stack([e["q_seg"] for e in self.entries])
        self._target = np.array([e["target"] for e in self.entries],
                                np.int32)
        self._qid = np.array([e["anno_id"] for e in self.entries], np.int64)
        self._q_tokens, self._q_mask, self._q_seg = narrow_wire_text(
            self._q_tokens, self._q_mask, self._q_seg)
        self.get_batch = self._get_store_batch  # consumed by DataLoader

    def device_store_arrays(self):
        return {"feat": np.asarray(self._pf.feat),
                "loc": np.asarray(self._pf.loc),
                "mask": np.asarray(self._pf.mask)}

    def _get_store_batch(self, idx):
        return {
            "store_rows": self._img_row[idx].astype(np.int32),
            "question": self._q_tokens[idx],
            "target": self._target[idx],
            "input_mask": self._q_mask[idx],
            "segment_ids": self._q_seg[idx],
            "question_id": self._qid[idx],
        }


class _MergedRegionReader:
    """pack_features adapter emitting VCR's deterministic det+GT merge (or
    the plain detector regions when no GT reader is configured)."""

    def __init__(self, ds: VCRDataset):
        self._ds = ds
        self.feature_size = ds.feature_size
        self.add_global_imgfeat = ds._add_global_imgfeat
        self.env = ds._reader.env  # cache-dir anchor for pack_features

    def __getitem__(self, query):
        if self._ds._gt_reader is not None:
            feat, loc, mask = self._ds._merged_image(query)
        else:
            feat, loc, mask = self._ds._image(query)
        return feat, int(mask.sum()), loc, None
