"""The port's copies of the task datasets against the JAX package's, on the
CPU.

Each dataset of ``DatasetMapTrain`` / ``DatasetMapEval`` other than the QA
ones (``test_torch_port_data.py`` holds those) is built on both sides over
files in the reference's on-disk formats, written by
``tools/make_synth_data.py``'s generators at a tiny size (GuessWhat
pointing by ``tests/test_datasets_extra.py``'s writer, the retrieval
hard-negative pool here), each side in its own copy of the dataroot so
neither reads the other's cache. Every item and the loader's batches in
order are compared exactly: the port's modules are copies of numpy code.
"""

import argparse
import importlib.util
import json
import os
import pickle

import numpy as np
import pytest

import fixtures
from volta_tpu.data import features_reader as jax_fr
from volta_tpu.data import loader as jax_loader
from volta_tpu.data import tokenization as jax_tok
from volta_tpu.data.datasets import DatasetMapEval as JaxEval
from volta_tpu.data.datasets import DatasetMapTrain as JaxTrain
from volta_tpu.data.datasets.refer_expression import boxes_iou as jax_iou
from volta_tpu_torch.data import features_reader, loader, tokenization
from volta_tpu_torch.data.datasets import DatasetMapEval, DatasetMapTrain
from volta_tpu_torch.data.datasets.refer_expression import boxes_iou

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT = 16
STORE = [1000000 + i for i in range(4)]  # the ``vqa`` store's image ids


def _synth():
    spec = importlib.util.spec_from_file_location(
        "make_synth_data", os.path.join(REPO, "tools", "make_synth_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SYNTH = _synth()


def _gen(name, root, **kw):
    args = dict(out=root, images=len(STORE), boxes=5, feat_dim=FEAT, seed=0,
                questions=8, sentences=2)
    args.update(kw)
    getattr(SYNTH, f"gen_{name}")(argparse.Namespace(**args))


def _store(root):
    fixtures.make_features_lmdb(root, STORE, num_boxes=5,
                                feature_size=FEAT, name="features.lmdb")


def _hard_pool(root):
    ids = [int(json.loads(l)["img_path"].split(".")[0]) for l in open(
        os.path.join(root, "all_data_final_test_set0_2014.jsonline"))]
    rng = np.random.RandomState(1)
    with open(os.path.join(root, "hard_negative.pkl"), "wb") as f:
        pickle.dump({"train_hard_pool": rng.randint(0, len(ids),
                                                    (len(ids), 3)),
                     "train_image_list": ids}, f)


def _guesswhat_pointing(root):
    with open(os.path.join(root, "guesswhat.train.jsonl"), "w") as f:
        for i in range(3):
            f.write(json.dumps({
                "id": i, "image": {"id": STORE[i]}, "object_id": 2,
                "qas": [{"id": 1, "question": "is it red ?",
                         "answer": "Yes"}],
                "objects": [{"id": 1, "bbox": [0, 0, 30, 30]},
                            {"id": 2, "bbox": [50, 50, 30, 40]}],
            }) + "\n")
    _store(root)
    fixtures.make_features_lmdb(root, STORE, num_boxes=3,
                                feature_size=FEAT, name="gt.lmdb")


# name -> (writer, registry key, annotations file, split, det store, gt
# store, max_seq_length, max_region_num, extra constructor arguments)
RET = "all_data_final_test_set0_2014.jsonline"
CASES = {
    "NLVR2": (lambda r: _gen("nlvr2", r), "NLVR2", "", "train",
              "features.lmdb", None, 14, 6, {}),
    "RetrievalFlickr30k": (lambda r: (_store(r), _gen("retrieval", r)),
                           "RetrievalFlickr30k", RET, "train",
                           "features.lmdb", None, 16, 6, {}),
    "RetrievalFlickr30k_pool": (
        lambda r: (_store(r), _gen("retrieval", r), _hard_pool(r)),
        "RetrievalFlickr30k", RET, "train", "features.lmdb", None, 16, 6,
        {}),
    "RetrievalFlickr30k_val": (lambda r: (_store(r), _gen("retrieval", r)),
                          "RetrievalFlickr30k", RET, "val", "features.lmdb",
                          None, 16, 6, {"gallery_chunk": 3}),
    "refcoco+": (lambda r: _gen("refcoco", r, refs_per_image=2), "refcoco+",
                 "", "train", "refcoco+_feat.lmdb", None, 10, 7, {}),
    "VisualEntailment": (lambda r: (_store(r), _gen("snli_ve", r)),
                         "VisualEntailment", "snli_ve_train.jsonl", "train",
                         "features.lmdb", None, 14, 6, {}),
    "GuessWhat": (lambda r: (_store(r), _gen("guesswhat", r)), "GuessWhat",
                  "guesswhat.train.jsonl", "train", "features.lmdb", None,
                  12, 6, {}),
    "VCR_Q-A": (lambda r: _gen("vcr", r), "VCR_Q-A",
                "annotations/train.jsonl", "train", "vcr_feat.lmdb",
                "vcr_gt_feat.lmdb", 20, 12, {}),
    "VCR_QA-R": (lambda r: _gen("vcr", r), "VCR_QA-R",
                 "annotations/train.jsonl", "train", "vcr_feat.lmdb",
                 "vcr_gt_feat.lmdb", 24, 12, {}),
    "Visual7w": (lambda r: _gen("visual7w", r, qa_per_image=2), "Visual7w",
                 "", "train", "v7w_feat.lmdb", "v7w_gt_feat.lmdb", 10, 110,
                 {}),
    "GuessWhatPointing": (_guesswhat_pointing, "GuessWhatPointing",
                          "guesswhat.train.jsonl", "train", "features.lmdb",
                          "gt.lmdb", 16, 110, {}),
    "FlickrGrounding": (lambda r: _gen("flickr_grounding", r),
                        "FlickrGrounding", "", "train", "flickr_feat.lmdb",
                        "flickr_gt_feat.lmdb", 12, 42, {}),
    "VisualDialog": (lambda r: (_store(r), _gen("visdial", r, questions=20)),
                     "VisualDialog", "visdial_1.0_train.json", "train",
                     "features.lmdb", None, 24, 6, {}),
    "ReferDenseCaption": (lambda r: (_store(r), _gen("dense_caption", r)),
                          "ReferDenseCaption", "region_descriptions.json",
                          "test", "features.lmdb", None, 10, 6, {}),
    "VisMadLibs": (lambda r: (_store(r), _gen("madlibs", r, num_labels=7)),
                   "VisMadLibs", "madlibs_train.json", "train",
                   "features.lmdb", None, 10, 6, {"num_labels": 7}),
}


def _build(tmp_path, case):
    """The case's dataset on the port's side and on JAX's."""
    write, key, ann, split, det, gt, max_seq, max_region, extra = \
        CASES[case]
    registry = (DatasetMapEval, JaxEval) if split == "val" else \
        (DatasetMapTrain, JaxTrain)
    out = []
    for side, reg, fr, tok in (("port", registry[0], features_reader,
                                tokenization),
                               ("jax", registry[1], jax_fr, jax_tok)):
        root = str(tmp_path / side)
        os.makedirs(root)
        write(root)
        vocab = os.path.join(root, "vocab.txt")
        if not os.path.exists(vocab):
            vocab = fixtures.make_vocab(root)

        def reader(name):
            return None if name is None else fr.ImageFeaturesReader(
                os.path.join(root, name), num_locs=5,
                add_global_imgfeat="first", feature_size=FEAT)

        out.append(reg[key](
            task=key, dataroot=root,
            annotations_jsonpath=os.path.join(root, ann) if ann else "",
            split=split, image_features_reader=reader(det),
            gt_image_features_reader=reader(gt),
            tokenizer=tok.BertTokenizer(vocab),
            bert_model="bert-base-uncased", padding_index=0,
            max_seq_length=max_seq, max_region_num=max_region, num_locs=5,
            add_global_imgfeat="first", append_mask_sep=False, **extra))
    return out


def _assert_items_equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, (what, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


@pytest.mark.parametrize("case", list(CASES))
def test_items_and_batches_are_equal(tmp_path, case):
    port, ref = _build(tmp_path, case)
    assert type(port).__name__ == type(ref).__name__
    assert type(port).__module__.startswith("volta_tpu_torch.")
    n = len(ref)
    assert len(port) == n and n >= 2, n
    assert getattr(port, "num_labels", None) == getattr(ref, "num_labels",
                                                        None)
    for i in range(n):
        _assert_items_equal(port[i], ref[i], f"{case}[{i}]")
    # the loader's batches in order (random draws of an item, as the
    # retrieval negatives', continue in step on both sides)
    batch = 2
    kw = dict(shuffle=True, seed=7, drop_last=True, num_workers=0)
    got = list(loader.DataLoader(port, batch, **kw))
    want = list(jax_loader.DataLoader(ref, batch, **kw))
    assert len(got) == len(want) == n // batch
    for j, (a, b) in enumerate(zip(got, want)):
        _assert_items_equal(a, b, f"{case} batch {j}")


def test_boxes_iou_is_jax_s():
    rng = np.random.RandomState(0)
    a = rng.rand(7, 4).astype(np.float32) * 100
    a[:, 2:] += a[:, :2]
    g = rng.rand(3, 4).astype(np.float32) * 100
    g[:, 2:] += g[:, :2]
    got, want = boxes_iou(a, g), jax_iou(a, g)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
