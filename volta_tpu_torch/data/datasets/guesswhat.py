"""GuessWhat?! oracle task: yes/no/NA per dialog question.

reference: volta/datasets/guesswhat_dataset.py:28-55. Each qa turn of each
dialog becomes one 3-way classification item.

The port's copy of ``volta_tpu/data/datasets/guesswhat.py``, which uses numpy
and the standard library only; the port keeps its own so that it imports
nothing of the JAX package.
"""

from __future__ import annotations

import os

import numpy as np

from .base import VLDataset, cached_entries, read_jsonlines

LABEL_MAP = {"Yes": 0, "No": 1, "N/A": 2}


class GuessWhatDataset(VLDataset):
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
            dataroot, f"guesswhat.{split}.jsonl")

        def build():
            entries = []
            for ann in read_jsonlines(path):
                for q in ann["qas"]:
                    qt, m, s = self._text(q["question"])
                    entries.append(dict(
                        question_id=q["id"], image_id=ann["image"]["id"],
                        label=LABEL_MAP[str(q["answer"])],
                        q_tokens=qt, q_mask=m, q_seg=s))
            return entries

        self.entries = cached_entries(dataroot, task, split, bert_model,
                                      max_seq_length, build)

    def __getitem__(self, index):
        e = self.entries[index]
        feat, loc, vmask = self._image(e["image_id"])
        target = np.zeros((3,), np.float32)
        target[e["label"]] = 1.0
        return {
            "features": feat, "spatials": loc, "image_mask": vmask,
            "question": e["q_tokens"], "target": target,
            "input_mask": e["q_mask"], "segment_ids": e["q_seg"],
            "question_id": np.int64(e["question_id"]),
        }
