"""Image-text retrieval datasets (COCO / Flickr30k).

reference: volta/datasets/retrieval_dataset.py. Train items are 4-way
(positive, random-caption, random-image, hard-negative caption from the
precomputed pool); val items pair one caption against a 500-image half of
the gallery (reference: retrieval_dataset.py:160-254, 277-417).

The port's copy of ``volta_tpu/data/datasets/retrieval.py``, which uses numpy
and the standard library only; the port keeps its own so that it imports
nothing of the JAX package.
"""

from __future__ import annotations

import os
import pickle
import random
import numpy as np

from .base import VLDataset, cached_entries, read_jsonlines


def _image_id(ann, task):
    if task == "RetrievalCOCO":
        return ann["id"]
    return int(ann["img_path"].split(".")[0])  # RetrievalFlickr30k


def _load_annotations(path, task):
    entries, imgid2entry = [], {}
    count = 0
    for ann in read_jsonlines(path):
        image_id = _image_id(ann, task)
        imgid2entry[image_id] = []
        for sent in ann["sentences"]:
            entries.append({"caption": sent, "image_id": image_id})
            imgid2entry[image_id].append(count)
            count += 1
    return entries, imgid2entry


class RetrievalDataset(VLDataset):
    def __init__(self, task, dataroot, annotations_jsonpath, split,
                 image_features_reader, gt_image_features_reader, tokenizer,
                 bert_model="bert-base-uncased", padding_index=0,
                 max_seq_length=20, max_region_num=36, num_locs=5,
                 add_global_imgfeat=None, append_mask_sep=False, seed=0):
        super().__init__(image_features_reader, tokenizer, padding_index,
                         max_seq_length, max_region_num, num_locs,
                         add_global_imgfeat, append_mask_sep,
                         gt_image_features_reader)
        self.task, self.split = task, split
        self.num_labels = 1

        def build():
            entries, imgid2entry = _load_annotations(
                annotations_jsonpath, task)
            for e in entries:
                e["q_tokens"], e["q_mask"], e["q_seg"] = \
                    self._text(e["caption"])
            return entries, imgid2entry

        self.entries, self.imgid2entry = cached_entries(
            dataroot, task, split, bert_model, max_seq_length, build)
        self.image_id_list = list(self.imgid2entry)
        self._rng = random.Random(seed)

        # hard-negative pool built by scripts/generate_pool.py
        # (reference: retrieval_dataset.py:78-81)
        self.train_hard_pool = None
        pool_path = os.path.join(dataroot, "hard_negative.pkl")
        if split == "train" and os.path.exists(pool_path):
            with open(pool_path, "rb") as f:
                info = pickle.load(f)
            self.train_hard_pool = info["train_hard_pool"]
            self.train_image_list = info["train_image_list"]
            self.train_imgid2pool = {
                image_id: i for i, image_id in
                enumerate(self.train_image_list)}

    def _rand_other_image(self, image_id):
        while True:
            other = self._rng.choice(self.image_id_list)
            if other != image_id:
                return other

    def __getitem__(self, index):
        e = self.entries[index]
        image_id = e["image_id"]
        feat1, loc1, m1 = self._image(image_id)

        # 2: random wrong caption on the true image
        e2 = self.entries[self._rng.choice(
            self.imgid2entry[self._rand_other_image(image_id)])]
        # 3: random wrong image under the true caption
        feat3, loc3, m3 = self._image(self._rand_other_image(image_id))
        # 4: hard-negative caption (pool) or another random one
        if self.train_hard_pool is not None:
            pool = self.train_hard_pool[self.train_imgid2pool[image_id]]
            img4 = self.train_image_list[
                int(pool[self._rng.randint(1, len(pool) - 1)])]
        else:
            img4 = self._rand_other_image(image_id)
        e4 = self.entries[self._rng.choice(self.imgid2entry[img4])]

        features = np.stack([feat1, feat1, feat3, feat1])
        spatials = np.stack([loc1, loc1, loc3, loc1])
        image_mask = np.stack([m1, m1, m3, m1])
        question = np.stack([e["q_tokens"], e2["q_tokens"], e["q_tokens"],
                             e4["q_tokens"]])
        input_mask = np.stack([e["q_mask"], e2["q_mask"], e["q_mask"],
                               e4["q_mask"]])
        segment_ids = np.stack([e["q_seg"], e2["q_seg"], e["q_seg"],
                                e4["q_seg"]])
        return {
            "features": features, "spatials": spatials,
            "image_mask": image_mask, "question": question,
            "target": np.int32(0), "input_mask": input_mask,
            "segment_ids": segment_ids, "question_id": np.int64(image_id),
        }


class RetrievalDatasetVal(VLDataset):
    """Preloads the whole gallery; each item is one caption x a 500-image
    half (reference: retrieval_dataset.py:277-417)."""

    def __init__(self, task, dataroot, annotations_jsonpath, split,
                 image_features_reader, gt_image_features_reader, tokenizer,
                 bert_model="bert-base-uncased", padding_index=0,
                 max_seq_length=20, max_region_num=36, num_locs=5,
                 add_global_imgfeat=None, append_mask_sep=False,
                 gallery_chunk=500):
        super().__init__(image_features_reader, tokenizer, padding_index,
                         max_seq_length, max_region_num, num_locs,
                         add_global_imgfeat, append_mask_sep,
                         gt_image_features_reader)
        self.num_labels = 1
        self.gallery_chunk = gallery_chunk
        image_ids, self.entries = [], []
        for ann in read_jsonlines(annotations_jsonpath):
            image_id = _image_id(ann, task)
            image_ids.append(image_id)
            for sent in ann["sentences"]:
                self.entries.append({"caption": sent, "image_id": image_id})
        self._image_ids = image_ids
        for e in self.entries:
            e["q_tokens"], e["q_mask"], e["q_seg"] = self._text(e["caption"])

        n = len(image_ids)
        self.num_images = n
        self.num_chunks = max(1, (n + gallery_chunk - 1) // gallery_chunk)
        padded = self.num_chunks * gallery_chunk
        fs = self.feature_size
        self.features_all = np.zeros((padded, self._max_region_num, fs),
                                     np.float32)
        self.spatials_all = np.zeros((padded, self._max_region_num,
                                      self._num_locs), np.float32)
        self.image_mask_all = np.zeros((padded, self._max_region_num),
                                       np.int32)
        for i, image_id in enumerate(image_ids):
            f, l, m = self._image(image_id)
            self.features_all[i] = f
            self.spatials_all[i] = l
            self.image_mask_all[i] = m

    def __len__(self):
        return len(self.entries) * self.num_chunks

    def gallery(self, chunk_idx):
        """(features, spatials, image_mask) arrays for one gallery chunk —
        constant across captions, so callers can cache them device-side
        instead of re-shipping them per caption (the reference re-sends the
        chunk for every caption, eval_retrieval.py:172-177)."""
        lo = chunk_idx * self.gallery_chunk
        hi = lo + self.gallery_chunk
        return (self.features_all[lo:hi], self.spatials_all[lo:hi],
                self.image_mask_all[lo:hi])

    def caption(self, caption_idx):
        """(q_tokens, q_mask, q_seg) for one caption."""
        e = self.entries[caption_idx]
        return e["q_tokens"], e["q_mask"], e["q_seg"]

    def target_row(self, caption_idx, chunk_idx):
        lo = chunk_idx * self.gallery_chunk
        hi = lo + self.gallery_chunk
        e = self.entries[caption_idx]
        target = np.array(
            [1.0 if iid == e["image_id"] else 0.0
             for iid in self._image_ids[lo:hi]], np.float32)
        pad = self.gallery_chunk - target.shape[0]
        if pad:
            target = np.concatenate([target, np.zeros((pad,), np.float32)])
        return target

    def __getitem__(self, index):
        caption_idx, chunk_idx = divmod(index, self.num_chunks)
        feats, spats, imask = self.gallery(chunk_idx)
        q_tokens, q_mask, q_seg = self.caption(caption_idx)
        return {
            "features": feats,
            "spatials": spats,
            "image_mask": imask,
            "question": q_tokens, "input_mask": q_mask,
            "segment_ids": q_seg,
            "target": self.target_row(caption_idx, chunk_idx),
            "caption_idx": np.int64(caption_idx),
            "image_idx": np.int64(chunk_idx),
        }
