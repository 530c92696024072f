"""Region-feature reader over LMDB.

reference: volta/datasets/_image_features_reader.py:16-189. Records are
pickled dicts per image id with base64-encoded float32 ``features``
[N, feature_size] and ``boxes`` [N, 4]; this reader normalises boxes to
[0, 1], computes the 5th location channel (normalised area) when
``num_locs == 5``, and prepends/appends the mean global feature per
``add_global_imgfeat``. An optional in-memory cache mirrors the reference's
``in_memory`` mode; key->index is a dict (the reference's list.index scan is
O(n) per lookup).

The port's copy of ``volta_tpu/data/features_reader.py``, which uses
numpy and the standard library only; the port keeps its own so that it
imports nothing of the JAX package.
"""

from __future__ import annotations

import base64
import pickle
from typing import Optional

import numpy as np

from . import lmdbx


class ImageFeaturesReader:
    def __init__(self, features_path: str, num_locs: int = 5,
                 add_global_imgfeat: Optional[str] = None,
                 feature_size: int = 2048, in_memory: bool = False):
        self.env = lmdbx.Env(features_path)
        self.num_locs = num_locs
        self.add_global_imgfeat = add_global_imgfeat
        self.feature_size = feature_size
        self._in_memory = in_memory
        self._cache = {}
        keys_rec = self.env.get(b"keys")
        if keys_rec is not None:
            self._image_ids = pickle.loads(keys_rec)
        else:
            self._image_ids = [k for k in self.env.keys() if k != b"keys"]

    def __len__(self):
        return len(self._image_ids)

    def keys(self):
        return self._image_ids

    def __contains__(self, image_id):
        return str(image_id).encode() in set(self._image_ids)

    def __getitem__(self, image_id):
        key = str(image_id).encode()
        if self._in_memory and key in self._cache:
            return self._cache[key]
        raw = self.env.get(key)
        if raw is None:
            raise KeyError(image_id)
        item = pickle.loads(raw)
        out = self._decode(item)
        if self._in_memory:
            self._cache[key] = out
        return out

    def _decode(self, item):
        image_h = int(item["img_h"])
        image_w = int(item["img_w"])
        feats = item["features"]
        boxes = item["boxes"]
        if isinstance(feats, (bytes, str)):
            feats = np.frombuffer(base64.b64decode(feats), dtype=np.float32)
        feats = np.asarray(feats, np.float32).reshape(-1, self.feature_size)
        if isinstance(boxes, (bytes, str)):
            boxes = np.frombuffer(base64.b64decode(boxes), dtype=np.float32)
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)

        n = feats.shape[0]
        loc = np.zeros((n, self.num_locs), np.float32)
        loc[:, :4] = boxes
        if self.num_locs >= 5:
            loc[:, 4] = ((loc[:, 3] - loc[:, 1]) * (loc[:, 2] - loc[:, 0])
                         / (float(image_w) * float(image_h)))
        loc_ori = loc.copy()
        loc[:, [0, 2]] /= float(image_w)
        loc[:, [1, 3]] /= float(image_h)

        num_boxes = n
        if self.add_global_imgfeat in ("first", "last"):
            g_feat = feats.mean(0, keepdims=True)
            g_loc = np.array([[0, 0, 1, 1] + [1] * (self.num_locs - 4)],
                             np.float32)
            g_loc_ori = np.array(
                [[0, 0, image_w, image_h]
                 + [image_w * image_h] * (self.num_locs - 4)], np.float32)
            num_boxes += 1
            if self.add_global_imgfeat == "first":
                feats = np.concatenate([g_feat, feats], 0)
                loc = np.concatenate([g_loc, loc], 0)
                loc_ori = np.concatenate([g_loc_ori, loc_ori], 0)
            else:
                feats = np.concatenate([feats, g_feat], 0)
                loc = np.concatenate([loc, g_loc], 0)
                loc_ori = np.concatenate([loc_ori, g_loc_ori], 0)

        return feats, num_boxes, loc, loc_ori
