"""Conceptual Captions pretraining dataset: ITM / MLM / MRM masking.

reference: volta/datasets/concept_cap_dataset.py. The reference streams
tensorpack LMDB shards through a ZMQ worker pipeline with local-window
shuffling; here the same shards are *randomly accessible* through the
native LMDB reader, so a map-style dataset + the threaded loader gives true
global shuffling and per-host sharding without worker processes.

Record layout per image (13 fields, reference:
concept_cap_dataset.py:429-431): features [N,2048], cls_prob [N,1601],
obj_labels/confs, attr_labels/confs, attr_scores [N,401], boxes [N,4],
num_boxes, h, w, image_id, caption.

Masking semantics preserved exactly (reference:
concept_cap_dataset.py:506-668): 50% random-caption ITM negatives (skipped
for objective 2), 15% MLM with 80/10/10, 15% region masking zeroing the
feature 90% of the time and recording regions overlapping a masked one at
IoU > 0.4 in ``masked_label`` (used to exclude them from the global mean
feature).

The port's copy of ``volta_tpu/data/datasets/concap.py``: the same records
through the port's ``lmdbx``, its msgpack codec (``serialization``) and
``boxes_iou``, the same numpy streams, so the per-sample, packed and
device-store batches equal JAX's for the same seed, epoch and indices. It
needs no ``ml_dtypes``: a packed store's ``bfloat16`` arrays, its batches'
and its ``.npy`` cache hold the bf16 bit patterns as uint16, the bytes of
JAX's ml_dtypes arrays and of its cache, under the same tag;
``eval_step.to_device`` views them as ``torch.bfloat16``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from .. import lmdbx
from .. import serialization
from .refer_expression import boxes_iou


def _store_dtype(name) -> str:
    """'float32' or 'bfloat16', the packed arrays' element type by name."""
    name = "float32" if name in (None, np.float32) else str(name)
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"packed dtype must be float32 or bfloat16, got "
                         f"{name}")
    return name


class ConceptCapDataset:
    def __init__(self, lmdb_path: str, caption_path: Optional[str],
                 tokenizer, seq_len: int = 36, region_len: int = 36,
                 split: str = "Train", visualization: bool = False,
                 objective: int = 0, num_locs: int = 5,
                 add_global_imgfeat: Optional[str] = None, seed: int = 0):
        self.env = lmdbx.Env(lmdb_path)
        keys = self.env.get(b"__keys__")
        if keys is not None:
            self.keys = serialization.loads(keys)
        else:
            self.keys = [k for k in self.env.keys() if k != b"__keys__"]
        self.tokenizer = tokenizer
        self.seq_len = seq_len
        self.region_len = region_len
        self.visualization = visualization
        self.objective = objective
        self.num_locs = num_locs
        self.add_global_imgfeat = add_global_imgfeat
        self.seed = seed
        self.epoch = 0
        self.feat_dtype = "float32"
        if caption_path and os.path.exists(caption_path):
            with open(caption_path) as f:
                self.captions = list(json.load(f).values())
        else:
            self.captions = None

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.keys)

    def _record(self, i: int):
        key = self.keys[i]
        return serialization.loads(self.env.get(
            key if isinstance(key, bytes) else str(key).encode()))

    # ------------------------------------------------------------- masking
    def _random_cap(self, rng, caption):
        if self.visualization or self.objective == 2 or self.captions is None:
            return caption, 0
        if rng.rand() > 0.5:
            return self.captions[rng.randint(len(self.captions))], 1
        return caption, 0

    def _random_word(self, rng, tokens):
        labels = np.full((len(tokens),), -1, np.int64)
        out = list(tokens)
        for i, tok in enumerate(tokens):
            prob = rng.rand()
            if prob < 0.15 and not self.visualization:
                prob /= 0.15
                if prob < 0.8:
                    out[i] = self.tokenizer.mask_id
                elif prob < 0.9:
                    out[i] = int(rng.randint(len(self.tokenizer)))
                labels[i] = tok
        return out, labels

    def _random_region(self, rng, feats, num_boxes, overlaps):
        labels = np.full((self.region_len,), -1, np.int64)
        masked = np.zeros((num_boxes,), bool)
        for i in range(num_boxes):
            prob = rng.rand()
            if prob < 0.15 and not self.visualization:
                prob /= 0.15
                if prob < 0.9:
                    feats[i] = 0
                masked |= overlaps[i] > 0.4
                labels[i] = 1
        return feats, labels, masked

    # ------------------------------------------------------------- access
    def __getitem__(self, index):
        (feats_wp, cls_wp, obj_labels, obj_confs, attr_labels, attr_confs,
         attr_scores, boxes_wp, num_boxes, image_h, image_w, image_id,
         caption) = self._record(index)
        if isinstance(caption, bytes):
            caption = caption.decode("utf-8")
        num_boxes = int(num_boxes)
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + self.epoch * 7919 + index) % (2**31))

        R = self.region_len
        image_feat = np.zeros((R, feats_wp.shape[-1]), np.float32)
        image_cls = np.zeros((R, 1601), np.float32)
        image_attrs = np.zeros((R, 401), np.float32)
        image_loc = np.zeros((R, self.num_locs), np.float32)
        image_feat[:num_boxes] = feats_wp
        image_cls[:num_boxes] = cls_wp
        image_attrs[:num_boxes] = attr_scores
        image_loc[:num_boxes, :4] = boxes_wp

        def pad_i64(x, fill=0):
            out = np.full((R,), fill, np.int64)
            out[:num_boxes] = np.asarray(x[:num_boxes]).reshape(-1)
            return out

        def pad_f32(x):
            out = np.zeros((R,), np.float32)
            out[:num_boxes] = np.asarray(x[:num_boxes]).reshape(-1)
            return out

        obj_labels = pad_i64(obj_labels)
        attr_labels = pad_i64(attr_labels)
        obj_confs = pad_f32(obj_confs)
        attr_confs = pad_f32(attr_confs)

        if self.num_locs == 5:
            image_loc[:, 4] = ((image_loc[:, 3] - image_loc[:, 1])
                               * (image_loc[:, 2] - image_loc[:, 0])
                               / (float(image_w) * float(image_h)))
        image_loc[:, [0, 2]] /= float(image_w)
        image_loc[:, [1, 3]] /= float(image_h)

        overlaps = np.asarray(
            boxes_iou(np.asarray(boxes_wp, np.float32),
                      np.asarray(boxes_wp, np.float32)))

        caption, is_match = self._random_cap(rng, caption)
        tokens = self.tokenizer.encode(caption, add_special_tokens=False)
        tokens = list(tokens)[: self.seq_len - 2]
        tokens, token_labels = self._random_word(rng, tokens)

        input_ids = [self.tokenizer.cls_id] + tokens + [self.tokenizer.sep_id]
        lm_labels = np.concatenate([[-1], token_labels, [-1]])
        pad = self.seq_len - len(input_ids)
        input_mask = np.array([1] * len(input_ids) + [0] * pad, np.int32)
        segment_ids = np.zeros((self.seq_len,), np.int32)
        input_ids = np.array(input_ids + [0] * pad, np.int32)
        lm_labels = np.concatenate([lm_labels, [-1] * pad]).astype(np.int64)

        image_feat, image_label, masked = self._random_region(
            rng, image_feat, num_boxes, overlaps)
        image_mask = np.zeros((R,), np.int32)
        image_mask[:num_boxes] = 1
        masked_label = np.zeros((R,), bool)
        masked_label[:num_boxes] = masked[:num_boxes] if masked.shape[0] >= \
            num_boxes else False

        out = {
            "input_ids": input_ids,
            "input_mask": input_mask,
            "segment_ids": segment_ids,
            "lm_label_ids": lm_labels,
            "is_match": np.int32(is_match),
            "image_feat": image_feat,
            "image_loc": image_loc,
            "image_cls": image_cls,
            "obj_labels": obj_labels,
            "obj_confs": obj_confs,
            "attr_labels": attr_labels,
            "attr_confs": attr_confs,
            "image_attrs": image_attrs,
            "image_label": image_label,
            "image_mask": image_mask,
            "image_id": np.int64(index),
        }
        if self.add_global_imgfeat:
            # global mean excludes overlap-masked regions
            # (reference: concept_cap_dataset.py:237-243)
            count = max(int((~masked_label[:num_boxes]).sum()), 1)
            g_feat = image_feat.sum(0, keepdims=True) / count
            g_loc = np.array([[0, 0, 1, 1] + [1] * (self.num_locs - 4)],
                             np.float32)
            if self.add_global_imgfeat == "first":
                out["image_feat"] = np.concatenate([g_feat, image_feat])
                out["image_loc"] = np.concatenate([g_loc, image_loc])
                out["image_mask"] = np.concatenate([[1], image_mask]).astype(
                    np.int32)
            else:
                out["image_feat"] = np.concatenate([image_feat, g_feat])
                out["image_loc"] = np.concatenate([image_loc, g_loc])
                out["image_mask"] = np.concatenate([image_mask, [1]]).astype(
                    np.int32)
        return out

    # ------------------------------------------------------ packed batches
    def enable_packed(self, cache: bool = True, feat_dtype="float32",
                      target_dtype=None):
        """Vectorised batch assembly: all records decoded once into
        contiguous arrays (disk-memoised), per-batch ITM/MLM/MRM masking
        re-expressed as whole-batch numpy ops. Distribution-identical to
        the per-sample path (same marginal probabilities per reference:
        concept_cap_dataset.py:506-668) but drawn from one vectorised RNG
        stream per batch rather than one per sample.

        ``feat_dtype``/``target_dtype`` 'bfloat16' hold the features /
        cls soft targets as bf16 bit patterns (uint16), the values a
        bf16-compute step reads; the batches carry them as such.
        ``image_attrs`` is omitted — nothing in the pretraining losses
        consumes it (reference passes it around unused too).
        """
        from .. import packed as packmod

        fdt = _store_dtype(feat_dtype)
        tdt = _store_dtype(target_dtype or feat_dtype)
        self.feat_dtype = fdt
        n = len(self.keys)
        R = self.region_len
        L2 = self.seq_len - 2
        tag = (f"ccv1:{n}:{R}:{self.seq_len}:{self.num_locs}:"
               f"{fdt}:{tdt}:{len(self.tokenizer)}")
        cdir = packmod._cache_dir(self.env.path, tag)
        names = ("feat", "cls", "loc", "nb", "obj_l", "obj_c", "attr_l",
                 "attr_c", "ovl", "cap_toks", "cap_lens")
        # bf16 arrays: their uint16 bit patterns, here and on disk
        bf16 = {nm for nm, dt in (("feat", fdt), ("cls", tdt))
                if dt == "bfloat16"}
        arrs = None
        if cache and os.path.isdir(cdir):
            try:
                arrs = {nm: np.load(os.path.join(cdir, nm + ".npy"))
                        for nm in names}
            except OSError:
                arrs = None
        if arrs is None:
            D = np.asarray(self._record(0)[0]).shape[-1]
            arrs = {
                "feat": np.zeros((n, R, D), np.uint16 if "feat" in bf16
                                 else np.float32),
                "cls": np.zeros((n, R, 1601), np.uint16 if "cls" in bf16
                                else np.float32),
                "loc": np.zeros((n, R, self.num_locs), np.float32),
                "nb": np.zeros((n,), np.int32),
                "obj_l": np.zeros((n, R), np.int64),
                "obj_c": np.zeros((n, R), np.float32),
                "attr_l": np.zeros((n, R), np.int64),
                "attr_c": np.zeros((n, R), np.float32),
                "ovl": np.zeros((n, R, R), bool),
                "cap_toks": np.zeros((n, L2), np.int32),
                "cap_lens": np.zeros((n,), np.int32),
            }
            for i in range(n):
                (feats, cls_p, obj_l, obj_c, attr_l, attr_c, _attr_s,
                 boxes, nb, h, w, _iid, caption) = self._record(i)
                if isinstance(caption, bytes):
                    caption = caption.decode("utf-8")
                nb = min(int(nb), R)
                arrs["nb"][i] = nb
                for nm, val in (("feat", feats), ("cls", cls_p)):
                    val = np.asarray(val[:nb], np.float32)
                    arrs[nm][i, :nb] = (packmod.bf16_bits(val) if nm in bf16
                                        else val)
                loc = np.zeros((nb, self.num_locs), np.float32)
                loc[:, :4] = boxes[:nb]
                if self.num_locs == 5:
                    loc[:, 4] = ((loc[:, 3] - loc[:, 1])
                                 * (loc[:, 2] - loc[:, 0])
                                 / (float(w) * float(h)))
                loc[:, [0, 2]] /= float(w)
                loc[:, [1, 3]] /= float(h)
                arrs["loc"][i, :nb] = loc
                arrs["obj_l"][i, :nb] = np.asarray(obj_l[:nb]).reshape(-1)
                arrs["obj_c"][i, :nb] = np.asarray(obj_c[:nb]).reshape(-1)
                arrs["attr_l"][i, :nb] = np.asarray(attr_l[:nb]).reshape(-1)
                arrs["attr_c"][i, :nb] = np.asarray(attr_c[:nb]).reshape(-1)
                iou = np.asarray(boxes_iou(np.asarray(boxes[:nb], np.float32),
                                           np.asarray(boxes[:nb],
                                                      np.float32)))
                arrs["ovl"][i, :nb, :nb] = iou > 0.4
                toks = list(self.tokenizer.encode(
                    caption, add_special_tokens=False))[:L2]
                arrs["cap_toks"][i, :len(toks)] = toks
                arrs["cap_lens"][i] = len(toks)
            if cache:
                try:
                    os.makedirs(cdir, exist_ok=True)
                    for nm in names:
                        np.save(os.path.join(cdir, nm + ".npy"), arrs[nm])
                except OSError:
                    pass
        self._p = arrs
        # negative-caption pool from the caption json (reference samples
        # ITM negatives from the full caption list)
        if self.captions is not None:
            pool_toks = np.zeros((len(self.captions), L2), np.int32)
            pool_lens = np.zeros((len(self.captions),), np.int32)
            for i, cap in enumerate(self.captions):
                toks = list(self.tokenizer.encode(
                    cap, add_special_tokens=False))[:L2]
                pool_toks[i, :len(toks)] = toks
                pool_lens[i] = len(toks)
            self._pool_toks, self._pool_lens = pool_toks, pool_lens
        else:
            self._pool_toks = self._pool_lens = None
        self.get_batch = self._get_packed_batch

    def _host_masking(self, idx):
        """Shared host-side randomness for the packed and device-store
        paths: ITM caption swap, MLM token masking, MRM mask draws —
        identical RNG stream so the two paths produce identical batches."""
        idx = np.asarray(idx, np.int64)
        b = len(idx)
        R, L2, S = self.region_len, self.seq_len - 2, self.seq_len
        p = self._p
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + self.epoch * 7919
             + int(idx[0]) * 31 + b) % (2**31))

        # ---- ITM negative captions (reference: random_cap)
        swap_ok = (not self.visualization and self.objective != 2
                   and self._pool_toks is not None)
        if swap_ok:
            swap = rng.rand(b) > 0.5
            neg = rng.randint(0, len(self._pool_toks), b)
            toks = np.where(swap[:, None], self._pool_toks[neg],
                            p["cap_toks"][idx])
            lens = np.where(swap, self._pool_lens[neg], p["cap_lens"][idx])
            is_match = swap.astype(np.int32)
        else:
            toks = p["cap_toks"][idx]
            lens = p["cap_lens"][idx]
            is_match = np.zeros((b,), np.int32)

        # ---- MLM masking (reference: random_word, 15% / 80-10-10)
        pos = np.arange(L2)[None, :]
        valid_t = pos < lens[:, None]
        pr = rng.rand(b, L2)
        do_t = (pr < 0.15) & valid_t & (not self.visualization)
        p2 = pr / 0.15
        out = np.where(do_t & (p2 < 0.8), self.tokenizer.mask_id, toks)
        rand_words = rng.randint(0, len(self.tokenizer), (b, L2))
        out = np.where(do_t & (p2 >= 0.8) & (p2 < 0.9), rand_words, out)
        lm_inner = np.where(do_t, toks, -1)

        input_ids = np.zeros((b, S), np.int32)
        input_ids[:, 0] = self.tokenizer.cls_id
        input_ids[:, 1:1 + L2] = np.where(valid_t, out, 0)
        input_ids[np.arange(b), lens + 1] = self.tokenizer.sep_id
        input_mask = (np.arange(S)[None, :] < (lens + 2)[:, None]).astype(
            np.int32)
        lm_labels = np.full((b, S), -1, np.int64)
        lm_labels[:, 1:1 + L2] = np.where(valid_t, lm_inner, -1)

        # ---- MRM masking (reference: random_region, 15% / 90% zeroed)
        nb = p["nb"][idx]
        valid_r = np.arange(R)[None, :] < nb[:, None]
        prr = rng.rand(b, R)
        do_r = (prr < 0.15) & valid_r & (not self.visualization)
        zero = do_r & (prr / 0.15 < 0.9)
        return dict(idx=idx, input_ids=input_ids, input_mask=input_mask,
                    lm_labels=lm_labels, is_match=is_match, do_r=do_r,
                    zero=zero, valid_r=valid_r)

    def _get_packed_batch(self, idx):
        from .. import packed as packmod

        h = self._host_masking(idx)
        idx = h["idx"]
        b = len(idx)
        S = self.seq_len
        p = self._p
        input_ids, input_mask = h["input_ids"], h["input_mask"]
        lm_labels, is_match = h["lm_labels"], h["is_match"]
        do_r, zero, valid_r = h["do_r"], h["zero"], h["valid_r"]
        bf16 = self.feat_dtype == "bfloat16"
        feat = np.asarray(p["feat"][idx])
        keep = ~zero[:, :, None]
        # a zeroed region is x * 0: +-0 by the sign of x, on the bits too
        feat = np.where(keep, feat, feat & np.uint16(0x8000)) if bf16 \
            else feat * keep.astype(feat.dtype)
        image_label = np.where(do_r, 1, -1).astype(np.int64)
        ovl = p["ovl"][idx]
        masked_lbl = (do_r[:, :, None] & ovl).any(axis=1)

        loc = np.asarray(p["loc"][idx])
        image_mask = valid_r.astype(np.int32)
        out_batch = {
            "input_ids": input_ids,
            "input_mask": input_mask,
            "segment_ids": np.zeros((b, S), np.int32),
            "lm_label_ids": lm_labels,
            "is_match": is_match,
            "image_feat": feat,
            "image_loc": loc,
            "image_cls": p["cls"][idx],
            "obj_labels": p["obj_l"][idx],
            "obj_confs": p["obj_c"][idx],
            "attr_labels": p["attr_l"][idx],
            "attr_confs": p["attr_c"][idx],
            "image_label": image_label,
            "image_mask": image_mask,
            "image_id": idx.astype(np.int64),
        }
        if self.add_global_imgfeat:
            count = np.maximum(
                (valid_r & ~masked_lbl).sum(1), 1)[:, None]
            g_feat = (packmod.from_bf16_bits(feat) if bf16
                      else feat).astype(np.float32).sum(1) / count
            g_feat = (packmod.bf16_bits(g_feat) if bf16
                      else g_feat.astype(np.float32))[:, None]
            g_loc = np.tile(np.array(
                [[[0, 0, 1, 1] + [1] * (self.num_locs - 4)]], np.float32),
                (b, 1, 1))
            g_mask = np.ones((b, 1), np.int32)
            order = ((g_feat, feat), (g_loc, loc), (g_mask, image_mask)) \
                if self.add_global_imgfeat == "first" else \
                ((feat, g_feat), (loc, g_loc), (image_mask, g_mask))
            out_batch["image_feat"] = np.concatenate(order[0], 1)
            out_batch["image_loc"] = np.concatenate(order[1], 1)
            out_batch["image_mask"] = np.concatenate(order[2], 1)
        return out_batch

    # ------------------------------------------------- device-resident mode
    def enable_device_store(self, **packed_kwargs):
        """Region features / soft targets / overlap matrices live in device
        memory; per-step host->device traffic shrinks to token ids and mask
        draws (~100 KB instead of ~135 MB at b512). Feature zeroing, the
        overlap co-mask, and the global mean run in the step on the device
        (train_step.materialize_cc_store_batch)."""
        if not hasattr(self, "_p"):
            self.enable_packed(**packed_kwargs)
        # wire dtype for token/label ids, decided once (same vocab-fits
        # criterion as base.narrow_wire_text; mask ids/random words are all
        # < len(tokenizer))
        self._tok_dt = (np.int16 if len(self.tokenizer) < 2 ** 15
                        else np.int32)
        self.get_batch = self._get_store_batch

    def device_store_arrays(self, targets=None):
        """``targets`` (criterion ixs, e.g. cfg.visual_target_weights keys)
        prunes per-objective arrays: the [n, r, 1601] soft-target ``cls``
        alone is 4.3 GiB f32 at 20k images — resident only for the KL/xent
        objectives that read it, which is what lets NCE (which only needs
        the features) coexist with its [b,r,·] score blocks in memory."""
        p = self._p
        t = None if targets is None else {str(x) for x in targets}
        need = lambda *ixs: t is None or t.intersection(ixs)  # noqa: E731
        out = {"feat": np.asarray(p["feat"]),
               "loc": np.asarray(p["loc"]),
               "nb": np.asarray(p["nb"], np.int32),
               "ovl": np.asarray(p["ovl"])}
        if need("0", "6"):
            out["cls"] = np.asarray(p["cls"])
        if need("3"):
            out["obj_l"] = np.asarray(p["obj_l"], np.int32)
            out["obj_c"] = np.asarray(p["obj_c"])
        if need("4"):
            out["attr_l"] = np.asarray(p["attr_l"], np.int32)
            out["attr_c"] = np.asarray(p["attr_c"])
        return out

    def _get_store_batch(self, idx):
        h = self._host_masking(idx)
        # narrow wire dtypes (the step widens back to int32 —
        # train_step._widen_wire): token/label ids fit int16 for BERT
        # vocabs, masks/segments/is_match are 0/1
        tok_dt = self._tok_dt
        return {
            "store_rows": h["idx"].astype(np.int32),
            "input_ids": h["input_ids"].astype(tok_dt),
            "input_mask": h["input_mask"].astype(np.int8),
            "segment_ids": np.zeros(h["input_ids"].shape, np.int8),
            "lm_label_ids": h["lm_labels"].astype(tok_dt),
            "is_match": h["is_match"].astype(np.int8),
            "mrm_mask": h["do_r"],
            "mrm_zero": h["zero"],
        }


def make_concap_loader(features_path: str, annotations_path: str, tokenizer,
                       *, split: str = "train", seq_len: int = 36,
                       region_len: int = 36, batch_size: int = 512,
                       num_workers: int = 8, objective: int = 0,
                       num_locs: int = 5, add_global_imgfeat=None,
                       seed: int = 0, num_shards: int = 1,
                       shard_index: int = 0, num_procs: int = 0,
                       packed: bool = False, feat_dtype: str = "float32"):
    """Build the CC dataset + loader (reference: ConceptCapLoaderTrain/Val,
    concept_cap_dataset.py:178-330). Per-rank LMDB shards are honoured when
    present, otherwise all hosts stride over the single environment."""
    from ..loader import DataLoader

    if split == "train":
        shard = os.path.join(features_path,
                             f"training_feat_part_{shard_index}.lmdb")
        whole = os.path.join(features_path, "training_feat_all.lmdb")
        caption = os.path.join(annotations_path, "caption_train.json")
    else:
        shard = os.path.join(features_path,
                             f"validation_feat_part_{shard_index}.lmdb")
        whole = os.path.join(features_path, "validation_feat_all.lmdb")
        caption = os.path.join(annotations_path, "caption_valid.json")
    if os.path.exists(shard):
        lmdb_path, eff_shards, eff_index = shard, 1, 0
    else:
        lmdb_path, eff_shards, eff_index = whole, num_shards, shard_index
    if not os.path.exists(lmdb_path) and os.path.exists(features_path) \
            and features_path.endswith(".lmdb"):
        lmdb_path, eff_shards, eff_index = features_path, num_shards, \
            shard_index

    ds = ConceptCapDataset(
        lmdb_path, caption, tokenizer, seq_len=seq_len,
        region_len=region_len, split=split, objective=objective,
        num_locs=num_locs, add_global_imgfeat=add_global_imgfeat, seed=seed)
    if packed:
        ds.enable_packed(feat_dtype=feat_dtype)
    loader = DataLoader(ds, batch_size, shuffle=(split == "train"),
                        seed=seed, drop_last=True, num_workers=num_workers,
                        num_shards=eff_shards, shard_index=eff_index,
                        num_procs=num_procs)
    return ds, loader
