"""VisDial v1.0 dialog dataset (``dialog`` process).

reference: volta/datasets/visdial_dataset.py (shipped unregistered in the
reference; wired into the registry here). Each item carries all 10 dialog
rounds x max_num_option answer candidates; texts are
[CLS] q [SEP] a [SEP] history+caption [SEP]. The positive candidate is
always option 0 (target 0 per round), negatives sampled from the 100
answer options.

The port's copy of ``volta_tpu/data/datasets/visdial.py``, which uses numpy
and the standard library only; the port keeps its own so that it imports
nothing of the JAX package.
"""

from __future__ import annotations

import json

import numpy as np

from .base import VLDataset


class VisDialDataset(VLDataset):
    NUM_ROUNDS = 10

    def __init__(self, task, dataroot, annotations_jsonpath, split,
                 image_features_reader, gt_image_features_reader, tokenizer,
                 bert_model="bert-base-uncased", padding_index=0,
                 max_seq_length=50, max_region_num=36, num_locs=5,
                 add_global_imgfeat=None, append_mask_sep=False, seed=0,
                 max_round_history=3, max_num_option=4):
        super().__init__(image_features_reader, tokenizer, padding_index,
                         max_seq_length, max_region_num, num_locs,
                         add_global_imgfeat, append_mask_sep,
                         gt_image_features_reader)
        self.split = split
        self.num_labels = 1
        self.max_round_history = max_round_history
        self.max_num_option = max_num_option
        self._rng = np.random.RandomState(seed)

        data = json.load(open(annotations_jsonpath))["data"]
        tok = self._tokenizer
        enc = lambda t: tok.convert_tokens_to_ids(tok.tokenize(t))
        self._questions = [enc(q) for q in data["questions"]]
        self._answers = [enc(a) for a in data["answers"]]
        self.entries = []
        self._captions = []
        for i, dialog in enumerate(data["dialogs"]):
            self._captions.append(enc(dialog["caption"]))
            self.entries.append({"image_id": dialog["image_id"],
                                 "dialog": dialog["dialog"], "caption": i})
        self.ans_option = 100  # options per round (reference visdial_dataset.py:80)

    def _round_options(self, rnd_entry):
        # All candidates index into this round's answer_options list
        # (reference visdial_dataset.py:218-232): gt_index first, then
        # random non-gt option slots.
        cands = [rnd_entry["gt_index"]]
        perm = self._rng.permutation(
            min(self.ans_option, len(rnd_entry["answer_options"])))
        for p in perm:
            if len(cands) >= self.max_num_option:
                break
            if p != rnd_entry["gt_index"]:
                cands.append(int(p))
        # a round with fewer than max_num_option answer_options (short or
        # malformed annotation) pads by cycling the gathered candidates so
        # the fixed option shape holds
        base = len(cands)
        while len(cands) < self.max_num_option:
            cands.append(cands[len(cands) % base])
        return cands

    def _encode_round(self, caption, dialog, rnd, answer_tokens):
        tok = self._tokenizer
        ques = self._questions[dialog[rnd]["question"]]
        fact = []
        for j in range(max(0, rnd - self.max_round_history), rnd):
            fq = self._questions[dialog[j]["question"]]
            fa = self._answers[dialog[j]["answer"]]
            fact += ([tok.sep_id] if fact else []) + fq + [tok.sep_id] + fa
        history = (fact + [tok.sep_id] + caption) if fact else list(caption)
        budget = self._max_seq_length - len(ques) - len(answer_tokens) - 4
        history = history[: max(budget, 0)]
        tokens = [tok.cls_id] + ques + [tok.sep_id] + answer_tokens + \
            [tok.sep_id] + history + [tok.sep_id]
        segs = [0] * (len(ques) + 2) + [1] * (len(answer_tokens) + 1) + \
            [0] * (len(history) + 1)
        tokens = tokens[: self._max_seq_length]
        segs = segs[: self._max_seq_length]
        mask = [1] * len(tokens)
        pad = self._max_seq_length - len(tokens)
        return (np.array(tokens + [0] * pad, np.int32),
                np.array(mask + [0] * pad, np.int32),
                np.array(segs + [0] * pad, np.int32))

    def __getitem__(self, index):
        e = self.entries[index]
        feat, loc, vmask = self._image(e["image_id"])
        caption = self._captions[e["caption"]]
        ids, masks, segs = [], [], []
        for rnd in range(self.NUM_ROUNDS):
            rnd_ids, rnd_m, rnd_s = [], [], []
            for ans_idx in self._round_options(e["dialog"][rnd]):
                a_toks = self._answers[
                    e["dialog"][rnd]["answer_options"][ans_idx]]
                q, m, s = self._encode_round(caption, e["dialog"], rnd,
                                             a_toks)
                rnd_ids.append(q), rnd_m.append(m), rnd_s.append(s)
            ids.append(np.stack(rnd_ids))
            masks.append(np.stack(rnd_m))
            segs.append(np.stack(rnd_s))
        return {
            "features": feat, "spatials": loc, "image_mask": vmask,
            "question": np.stack(ids),          # [10, opts, L]
            "target": np.zeros((self.NUM_ROUNDS,), np.int32),
            "input_mask": np.stack(masks),
            "segment_ids": np.stack(segs),
            "question_id": np.int64(e["image_id"]),
        }
