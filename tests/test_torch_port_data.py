"""The port's copy of the VQA data layer against the JAX package's, on the
synthetic fixtures of ``tests/fixtures.py``.

Both sides read the same files; everything is compared exactly (token ids,
feature and location arrays, dataset items, the loader's batches in order),
since the port's modules are copies of numpy code.
"""

import os

import numpy as np
import pytest

import fixtures
from volta_tpu.data import bpe as jax_bpe
from volta_tpu.data import features_reader as jax_fr
from volta_tpu.data import loader as jax_loader
from volta_tpu.data import tokenization as jax_tok
from volta_tpu.data.datasets import DatasetMapTrain as JaxDatasets
from volta_tpu_torch.data import bpe, features_reader, loader, tokenization
from volta_tpu_torch.data.datasets import DatasetMapEval, DatasetMapTrain

IDS = [10, 11, 12, 13]
TEXTS = ["what color is the dog ?", "Two cats play in the red ball!",
         "a man, a woman; RUN", "unknownword runs", "  Naïve café  "]


def _root(tmp_path, name):
    root = str(tmp_path / name)
    os.makedirs(root)
    fixtures.make_features_lmdb(root, IDS, num_boxes=5, feature_size=32)
    fixtures.make_vqa_annotations(root, IDS, n_questions=14, num_labels=9)
    return root


@pytest.fixture
def roots(tmp_path):
    """Two identical dataroots, so neither side reads the other's cache."""
    return _root(tmp_path, "port"), _root(tmp_path, "jax")


def test_bert_tokenizers_give_equal_ids(tmp_path):
    vocab = fixtures.make_vocab(str(tmp_path))
    port = tokenization.BertTokenizer(vocab)
    ref = jax_tok.BertTokenizer(vocab)
    assert len(port) == len(ref)
    for text in TEXTS:
        assert port.tokenize(text) == ref.tokenize(text)
        assert port.encode(text) == ref.encode(text)
        assert port.encode(text, TEXTS[0]) == ref.encode(text, TEXTS[0])
    assert (port.cls_id, port.sep_id, port.mask_id, port.pad_id) == \
        (ref.cls_id, ref.sep_id, ref.mask_id, ref.pad_id)


def test_roberta_tokenizers_give_equal_ids(tmp_path):
    d = fixtures.make_roberta_vocab(str(tmp_path))
    port = bpe.RobertaTokenizer.from_pretrained(d)
    ref = jax_bpe.RobertaTokenizer.from_pretrained(d)
    for text in TEXTS:
        assert port.tokenize(text) == ref.tokenize(text)
        assert port.encode(text) == ref.encode(text)
    assert (port.cls_id, port.sep_id) == (ref.cls_id, ref.sep_id)


@pytest.mark.parametrize("glob_feat", [None, "first", "last"])
@pytest.mark.parametrize("in_memory", [False, True])
def test_feature_readers_give_equal_arrays(roots, glob_feat, in_memory):
    path = os.path.join(roots[0], "feat.lmdb")
    port = features_reader.ImageFeaturesReader(
        path, num_locs=5, add_global_imgfeat=glob_feat, feature_size=32,
        in_memory=in_memory)
    ref = jax_fr.ImageFeaturesReader(
        path, num_locs=5, add_global_imgfeat=glob_feat, feature_size=32,
        in_memory=in_memory)
    assert len(port) == len(ref) == len(IDS)
    assert list(port.keys()) == list(ref.keys())
    for iid in IDS * 2:  # twice: the in-memory cache answers the second
        got, want = port[iid], ref[iid]
        assert got[1] == want[1]
        for a, b in zip(got[:1] + got[2:], want[:1] + want[2:]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError):
        port[99]


def _datasets(roots, glob_feat="first"):
    vocab = fixtures.make_vocab(roots[0])
    out = []
    for root, registry, fr, tok in (
            (roots[0], DatasetMapTrain, features_reader, tokenization),
            (roots[1], JaxDatasets, jax_fr, jax_tok)):
        reader = fr.ImageFeaturesReader(
            os.path.join(root, "feat.lmdb"), num_locs=5,
            add_global_imgfeat=glob_feat, feature_size=32)
        out.append(registry["VQA"](
            task="VQA", dataroot=root, annotations_jsonpath="",
            split="train", image_features_reader=reader,
            gt_image_features_reader=None,
            tokenizer=tok.BertTokenizer(vocab), bert_model="bert-base-uncased",
            padding_index=0, max_seq_length=12, max_region_num=6, num_locs=5,
            add_global_imgfeat=glob_feat, append_mask_sep=False))
    return out


def _assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("glob_feat", [None, "first"])
def test_vqa_items_are_equal(roots, glob_feat):
    port, ref = _datasets(roots, glob_feat)
    assert len(port) == len(ref) == 14
    assert port.num_labels == ref.num_labels == 9
    assert port.ans2label == ref.ans2label
    assert port.label2ans == ref.label2ans
    for i in range(len(ref)):
        _assert_items_equal(port[i], ref[i])
    # the packed store assembles the same batches
    port.enable_packed(cache=False)
    ref.enable_packed(cache=False)
    idx = np.array([3, 0, 7, 13])
    _assert_items_equal(port.get_batch(idx), ref.get_batch(idx))


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batch_order_is_equal(roots, workers):
    port_ds, ref_ds = _datasets(roots)
    for epoch in (0, 1):
        port = loader.DataLoader(port_ds, 4, shuffle=True, seed=7,
                                 drop_last=True, num_workers=workers)
        ref = jax_loader.DataLoader(ref_ds, 4, shuffle=True, seed=7,
                                    drop_last=True, num_workers=workers)
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port) == 3
        for a, b in zip(got, want):
            _assert_items_equal(a, b)
    # unshuffled, keeping the last partial batch
    port = loader.DataLoader(port_ds, 4, num_workers=workers)
    ref = jax_loader.DataLoader(ref_ds, 4, num_workers=workers)
    assert [b["question_id"].tolist() for b in port] == \
        [b["question_id"].tolist() for b in ref]


def test_other_tasks_are_not_ported():
    assert sorted(DatasetMapTrain) == ["GQA", "GenomeQA", "VQA"]
    assert sorted(DatasetMapEval) == sorted(DatasetMapTrain)
    for registry in (DatasetMapTrain, DatasetMapEval):
        with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
            registry["NLVR2"]
