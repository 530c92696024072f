"""Soft-target QA classification datasets: VQA v2, GQA, VisualGenome QA.

reference: volta/datasets/vqa_dataset.py, gqa_dataset.py,
visual_genome_dataset.py. All three share the pattern: questions json +
precomputed (labels, scores) targets scattered into a num_labels-dim soft
target vector (reference: vqa_dataset.py:273-281).

The port's copy of ``volta_tpu/data/datasets/qa.py``, which uses numpy
and the standard library only; the port keeps its own so that it imports
nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import pickle
import numpy as np

from .base import VLDataset, cache_pickle, narrow_wire_text


def _load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


class SoftTargetQADataset(VLDataset):
    """Common core; subclasses provide entry loading."""

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
        self.task = task
        self.dataroot = dataroot
        self.ans2label, self.label2ans = self._load_answer_space(dataroot)
        self.num_labels = len(self.ans2label)
        # tokenised entries are cached like the reference
        # (reference: vqa_dataset.py:180-187)
        suffix = "_roberta" if "roberta" in (bert_model or "") else ""
        cache_path = os.path.join(
            dataroot, "cache",
            f"{task}_{split}{suffix}_{max_seq_length}.pkl")

        def build():
            entries = self._load_entries(dataroot, annotations_jsonpath,
                                         split)
            for e in entries:
                e["q_tokens"], e["q_mask"], e["q_seg"] = \
                    self._text(e["question"])
            return entries

        try:
            self.entries = cache_pickle(cache_path, build)
        except OSError:
            self.entries = build()

    # ------------------------------------------------------ packed batches
    def _packed_qid(self, index, entry):
        qid = entry["question_id"]
        return int(qid) if isinstance(qid, (int, np.integer)) else index

    def enable_packed(self, cache: bool = True, feat_dtype="float32"):
        """Switch to vectorised batch assembly: features packed into one
        gatherable array (decoded once, disk-memoised), tokenised entries
        stacked into matrices, soft targets scattered batch-wide. Produces
        samples identical to __getitem__ (tested) at ~40x the rate;
        ``feat_dtype='bfloat16'`` halves the gather bytes for bf16-compute
        runs (the device step casts features to bf16 regardless)."""
        from ..packed import pack_features, scatter_targets

        ids = sorted({e["image_id"] for e in self.entries})
        self._pf = pack_features(self._reader, ids, self._max_region_num,
                                 self._num_locs, cache=cache,
                                 dtype=feat_dtype)
        self._img_row = np.array(
            [self._pf.row(e["image_id"]) for e in self.entries], np.int64)
        self._q_tokens = np.stack([e["q_tokens"] for e in self.entries])
        self._q_mask = np.stack([e["q_mask"] for e in self.entries])
        self._q_seg = np.stack([e["q_seg"] for e in self.entries])
        self._qid = np.array([self._packed_qid(i, e)
                              for i, e in enumerate(self.entries)], np.int64)
        labels, scores, counts = [], [], []
        for e in self.entries:
            ls = e.get("labels") or []
            labels.extend(int(x) for x in ls)
            scores.extend(float(s) for s in (e.get("scores") or []))
            counts.append(len(ls))
        self._t_labels = np.asarray(labels, np.int64)
        self._t_scores = np.asarray(scores, np.float32)
        self._t_counts = np.asarray(counts, np.int64)
        self._scatter = scatter_targets
        self.get_batch = self._get_packed_batch  # consumed by DataLoader

    def _get_packed_batch(self, idx):
        rows = self._img_row[idx]
        return {
            "features": np.asarray(self._pf.feat[rows]),
            "spatials": np.asarray(self._pf.loc[rows]),
            "image_mask": np.asarray(self._pf.mask[rows]),
            "question": self._q_tokens[idx],
            "target": self._scatter(self._t_labels, self._t_scores,
                                    self._t_counts, idx, self.num_labels),
            "input_mask": self._q_mask[idx],
            "segment_ids": self._q_seg[idx],
            "question_id": self._qid[idx],
        }

    # ------------------------------------------------- device-resident mode
    def enable_device_store(self, **packed_kwargs):
        """Batches carry only row indices + tokens + sparse targets; the
        packed feature arrays live in device HBM (see
        parallel.train_step.materialize_store_batch). Use when the
        host->device link, not decode, limits the input pipeline."""
        if not hasattr(self, "_pf"):
            self.enable_packed(**packed_kwargs)
        K = max(int(self._t_counts.max()) if len(self._t_counts) else 1, 1)
        self._t_offsets = np.concatenate([[0], np.cumsum(self._t_counts)])
        self._dense_k = K
        self._narrow_wire()
        self.get_batch = self._get_store_batch

    def _narrow_wire(self):
        """Pre-narrow the per-step wire arrays (see base.narrow_wire_text);
        sparse target labels fit int16 for every answer space here."""
        self._w_tokens, self._w_mask, self._w_seg = narrow_wire_text(
            self._q_tokens, self._q_mask, self._q_seg)
        self._lab_dt = (np.int16 if getattr(self, "num_labels", 2 ** 15)
                        < 2 ** 15 else np.int32)

    def device_store_arrays(self):
        return {"feat": np.asarray(self._pf.feat),
                "loc": np.asarray(self._pf.loc),
                "mask": np.asarray(self._pf.mask)}

    def _get_store_batch(self, idx):
        b, K = len(idx), self._dense_k
        labels = np.full((b, K), -1, self._lab_dt)
        scores = np.zeros((b, K), np.float32)
        for j, i in enumerate(idx):
            o, c = self._t_offsets[i], self._t_counts[i]
            labels[j, :c] = self._t_labels[o: o + c]
            scores[j, :c] = self._t_scores[o: o + c]
        return {
            "store_rows": self._img_row[idx].astype(np.int32),
            "target_labels": labels,
            "target_scores": scores,
            "question": self._w_tokens[idx],
            "input_mask": self._w_mask[idx],
            "segment_ids": self._w_seg[idx],
            "question_id": self._qid[idx],
        }

    # subclass hooks ------------------------------------------------------
    def _load_answer_space(self, dataroot):
        ans2label = _load_pickle(
            os.path.join(dataroot, "trainval_ans2label.pkl"))
        label2ans = _load_pickle(
            os.path.join(dataroot, "trainval_label2ans.pkl"))
        return ans2label, label2ans

    def _load_entries(self, dataroot, annotations_jsonpath, split):
        raise NotImplementedError

    # ----------------------------------------------------------------- get
    def __getitem__(self, index):
        e = self.entries[index]
        feat, loc, vmask = self._image(e["image_id"])
        target = np.zeros((self.num_labels,), np.float32)
        labels = e.get("labels")
        if labels is not None and len(labels):
            target[np.asarray(labels, np.int64)] = np.asarray(
                e["scores"], np.float32)
        qid = e["question_id"]
        if not isinstance(qid, (int, np.integer)):
            # string ids (GQA) ride as the entry index; prediction dumps map
            # back through dataset.entries
            qid = index
        return {
            "features": feat, "spatials": loc, "image_mask": vmask,
            "question": e["q_tokens"], "target": target,
            "input_mask": e["q_mask"], "segment_ids": e["q_seg"],
            "question_id": np.int64(qid),
        }


class VQAClassificationDataset(SoftTargetQADataset):
    """VQA v2 (reference: volta/datasets/vqa_dataset.py:120-300).

    File layout: v2_OpenEnded_mscoco_<split>2014_questions.json +
    cache/<split>_target.pkl with per-question (labels, scores).
    """

    def _load_entries(self, dataroot, annotations_jsonpath, split):
        def load_split(name, year="2014"):
            qpath = os.path.join(
                dataroot, f"v2_OpenEnded_mscoco_{name}{year}_questions.json")
            qs = sorted(json.load(open(qpath))["questions"],
                        key=lambda x: x["question_id"])
            if "test" in name:
                return [dict(question_id=q["question_id"],
                             image_id=q["image_id"],
                             question=q["question"],
                             labels=None, scores=None) for q in qs]
            apath = os.path.join(dataroot, "cache", f"{name}_target.pkl")
            ans = sorted(_load_pickle(apath), key=lambda x: x["question_id"])
            assert len(qs) == len(ans)
            out = []
            for q, a in zip(qs, ans):
                assert q["question_id"] == a["question_id"]
                out.append(dict(question_id=q["question_id"],
                                image_id=q["image_id"],
                                question=q["question"],
                                labels=a["labels"], scores=a["scores"]))
            return out

        if split in ("train", "val"):
            return load_split(split)
        if split == "trainval":
            return load_split("train") + load_split("val")[:-3000]
        if split == "minval":
            return load_split("val")[-3000:]
        if split == "test":
            return load_split("test", "2015")
        raise ValueError(f"unknown VQA split {split}")


class GQAClassificationDataset(SoftTargetQADataset):
    """GQA (reference: volta/datasets/gqa_dataset.py): questions json dict
    keyed by qid with {imageId, question, answer}; targets from
    cache/<split>_target.pkl."""

    def _load_entries(self, dataroot, annotations_jsonpath, split):
        qpath = os.path.join(dataroot, f"{split}_questions.json")
        if not os.path.exists(qpath):
            qpath = annotations_jsonpath
        questions = json.load(open(qpath))
        if isinstance(questions, dict):
            items = [dict(question_id=qid, image_id=v["imageId"],
                          question=v["question"],
                          answer=v.get("answer")) for qid, v in
                     sorted(questions.items())]
        else:
            items = questions
        tpath = os.path.join(dataroot, "cache", f"{split}_target.pkl")
        if os.path.exists(tpath):
            targets = {t["question_id"]: t for t in _load_pickle(tpath)}
        else:
            targets = {}
        out = []
        for it in items:
            t = targets.get(it["question_id"], {})
            labels = t.get("labels")
            if labels is None and it.get("answer") is not None and \
                    it["answer"] in self.ans2label:
                labels, scores = [self.ans2label[it["answer"]]], [1.0]
            else:
                scores = t.get("scores")
            out.append(dict(question_id=it["question_id"],
                            image_id=it["image_id"],
                            question=it["question"],
                            labels=labels, scores=scores))
        return out

    def __getitem__(self, index):
        item = super().__getitem__(index)
        # GQA question ids are strings; keep an integer surrogate for
        # collation and map back at prediction-dump time
        e = self.entries[index]
        item["question_id"] = np.int64(index)
        return item

    def _packed_qid(self, index, entry):
        return index


class GenomeQAClassificationDataset(SoftTargetQADataset):
    """VisualGenome QA (reference: volta/datasets/visual_genome_dataset.py):
    question_answers.json with per-image qas lists."""

    def _load_entries(self, dataroot, annotations_jsonpath, split):
        path = annotations_jsonpath or os.path.join(
            dataroot, "question_answers.json")
        data = json.load(open(path))
        out = []
        for img in data:
            for qa in img.get("qas", []):
                ans = str(qa.get("answer", "")).strip().strip(".").lower()
                labels = [self.ans2label[ans]] if ans in self.ans2label \
                    else None
                out.append(dict(question_id=qa["qa_id"],
                                image_id=qa["image_id"],
                                question=qa["question"],
                                labels=labels,
                                scores=[1.0] if labels else None))
        return out
