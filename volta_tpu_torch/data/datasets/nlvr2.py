"""NLVR2: one sentence vs an image *pair*.

reference: volta/datasets/nlvr2_dataset.py. The two images are concatenated
into a single 2*max_region region axis with per-image segment ids; the
``nlvr`` process splits them back into two rows at step time
(reference: nlvr2_dataset.py:192-206, volta/task_utils.py:220-232).

The port's copy of ``volta_tpu/data/datasets/nlvr2.py``, which uses numpy
and the standard library only; the port keeps its own so that it imports
nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from .base import (VLDataset, cached_entries, narrow_wire_text,
                   read_jsonlines)
import os


class NLVR2Dataset(VLDataset):
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
        self.num_labels = 2
        path = annotations_jsonpath or os.path.join(dataroot,
                                                    f"{split}.json")

        def build():
            entries = []
            for count, ann in enumerate(read_jsonlines(path)):
                base = "-".join(ann["identifier"].split("-")[:-1])
                q, m, s = self._text(str(ann["sentence"]))
                entries.append(dict(
                    question_id=count,
                    image_id_0=base + "-img0",
                    image_id_1=base + "-img1",
                    label=0 if str(ann["label"]) == "False" else 1,
                    q_tokens=q, q_mask=m, q_seg=s))
            return entries

        self.entries = cached_entries(dataroot, task, split, bert_model,
                                      max_seq_length, build)

    # ------------------------------------------------- device-resident mode
    def enable_device_store(self, feat_dtype="float32", cache: bool = True):
        """Per-image features pack once into HBM-resident arrays; batches
        ship an [b, 2] row-index pair + the sentence tokens (~10 KB) and
        the device gathers + concatenates the pair on the region axis
        (parallel.train_step.materialize_store_batch), reproducing the
        dense 2R layout the ``nlvr`` process splits back (reference:
        volta/datasets/nlvr2_dataset.py:192-206)."""
        from ..packed import pack_features

        ids = sorted({e[k] for e in self.entries
                      for k in ("image_id_0", "image_id_1")})
        self._pf = pack_features(self._reader, ids, self._max_region_num,
                                 self._num_locs, cache=cache,
                                 dtype=feat_dtype)
        self._img_rows = np.array(
            [[self._pf.row(e["image_id_0"]), self._pf.row(e["image_id_1"])]
             for e in self.entries], np.int64)
        self._q_tokens = np.stack([e["q_tokens"] for e in self.entries])
        self._q_mask = np.stack([e["q_mask"] for e in self.entries])
        self._q_seg = np.stack([e["q_seg"] for e in self.entries])
        tgt = np.zeros((len(self.entries), 2), np.float32)
        tgt[np.arange(len(self.entries)),
            [e["label"] for e in self.entries]] = 1.0
        self._target = tgt
        self._qid = np.array([e["question_id"] for e in self.entries],
                             np.int64)
        self._q_tokens, self._q_mask, self._q_seg = narrow_wire_text(
            self._q_tokens, self._q_mask, self._q_seg)
        self.get_batch = self._get_store_batch  # consumed by DataLoader

    def device_store_arrays(self):
        return {"feat": np.asarray(self._pf.feat),
                "loc": np.asarray(self._pf.loc),
                "mask": np.asarray(self._pf.mask)}

    def _get_store_batch(self, idx):
        return {
            "store_rows": self._img_rows[idx].astype(np.int32),
            "question": self._q_tokens[idx],
            "target": self._target[idx],
            "input_mask": self._q_mask[idx],
            "segment_ids": self._q_seg[idx],
            "question_id": self._qid[idx],
        }

    def __getitem__(self, index):
        e = self.entries[index]
        f0, l0, m0 = self._image(e["image_id_0"])
        f1, l1, m1 = self._image(e["image_id_1"])
        # concatenated pair on the region axis (reference:
        # nlvr2_dataset.py:192-206)
        feat = np.concatenate([f0, f1], axis=0)
        loc = np.concatenate([l0, l1], axis=0)
        vmask = np.concatenate([m0, m1], axis=0)
        target = np.zeros((2,), np.float32)
        target[e["label"]] = 1.0
        return {
            "features": feat, "spatials": loc, "image_mask": vmask,
            "question": e["q_tokens"], "target": target,
            "input_mask": e["q_mask"], "segment_ids": e["q_seg"],
            "question_id": np.int64(e["question_id"]),
        }
