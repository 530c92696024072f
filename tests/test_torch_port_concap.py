"""The port's Conceptual Captions data layer and pretraining CLI against the
JAX package on the CPU.

* The codec: ``volta_tpu_torch.data.serialization`` carries its own
  msgpack encoder and decoder (the card's host need not have ``msgpack``):
  ``dumps`` byte-equal to ``volta_tpu.data.serialization.dumps`` and each
  side's ``loads`` reading the other's bytes, on the records of
  ``tests/fixtures.make_concap_lmdb`` and on every type the format has;
  the port's fixture writer below (no JAX package, the port's ``dumps`` of
  the same records) writes the same LMDB bytes as that fixture.
* ``ConceptCapDataset``: the per-sample items, the packed batches (float32
  and bf16; the bf16 values and the ``.npy`` cache's bit patterns, which
  each package reads from the other's cache) and the device-store batches
  equal to JAX's for the same seed, epoch and indices; the port's
  ``materialize_cc_store_batch`` equal to the packed batch and to JAX's;
  ``make_concap_loader``'s shard and ``*_all.lmdb`` path rules.
* ``python -m volta_tpu_torch.train_concap``: one epoch on the CPU (KL and
  NCE, ``--in_memory``), a resume from its checkpoint, ``train_task
  --from_pretrained`` of that checkpoint (the trunk loaded, the ``cls``
  heads left out, the task head at init), the refused flags naming their
  ROADMAP item, and in a subprocess no ``volta_tpu``, ``jax``, ``jaxlib``,
  ``flax`` or ``msgpack`` module loaded.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import fixtures
from volta_tpu import zoo
from volta_tpu.data import lmdbx as jax_lmdbx
from volta_tpu.data import serialization as jser
from volta_tpu.data.datasets.concap import ConceptCapDataset as JaxCC
from volta_tpu.data.tokenization import BertTokenizer as JaxTokenizer
from volta_tpu.parallel.train_step import \
    materialize_cc_store_batch as jax_materialize
from volta_tpu_torch import train_concap, train_task
from volta_tpu_torch.config import VoltaConfig
from volta_tpu_torch.data import serialization as pser
from volta_tpu_torch.data.datasets.concap import ConceptCapDataset, \
    make_concap_loader
from volta_tpu_torch.data.packed import from_bf16_bits
from volta_tpu_torch.data.tokenization import BertTokenizer
from volta_tpu_torch.train_step import materialize_cc_store_batch, \
    store_to_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, REG = 14, 5


# the port's copy of fixtures.make_concap_lmdb, written without the JAX
# package (the subprocess below runs it)
WRITER = '''
import json, os
import numpy as np
from volta_tpu_torch.data import lmdbx, serialization

WORDS = ["a", "the", "dog", "cat", "red", "ball", "is", "on", "in", "man",
         "woman", "what", "color", "there", "two", "##s", "play", "run"]


def write_concap_lmdb(tmpdir, n=16, num_boxes=5, feature_size=32, seed=3,
                      split="train"):
    rng = np.random.RandomState(seed)
    items, keys, captions = [], [], {}
    for i in range(n):
        key = serialization.tensorpack_key(i)
        keys.append(key)
        feats = rng.randn(num_boxes, feature_size).astype(np.float32)
        cls_prob = np.abs(rng.rand(num_boxes, 1601)).astype(np.float32)
        cls_prob /= cls_prob.sum(-1, keepdims=True)
        attr_scores = np.abs(rng.rand(num_boxes, 401)).astype(np.float32)
        x1 = rng.rand(num_boxes, 1) * 300
        y1 = rng.rand(num_boxes, 1) * 200
        boxes = np.concatenate(
            [x1, y1, x1 + 50, y1 + 40], 1).astype(np.float32)
        caption = "a red ball on the %s" % WORDS[i % 6]
        rec = [feats, cls_prob,
               rng.randint(0, 1600, (num_boxes,)).astype(np.int64),
               rng.rand(num_boxes).astype(np.float32),
               rng.randint(0, 400, (num_boxes,)).astype(np.int64),
               rng.rand(num_boxes).astype(np.float32),
               attr_scores, boxes, num_boxes, 480, 640, i, caption]
        items.append((key, serialization.dumps(rec)))
        captions[str(i)] = caption
    items.append((b"__keys__", serialization.dumps(keys)))
    name = "training_feat_all.lmdb" if split == "train" else \\
        "validation_feat_all.lmdb"
    feats_dir = os.path.join(tmpdir, "imgfeats")
    os.makedirs(feats_dir, exist_ok=True)
    lmdbx.write(os.path.join(feats_dir, name), items)
    ann_dir = os.path.join(tmpdir, "annotations")
    os.makedirs(ann_dir, exist_ok=True)
    cap_name = "caption_train.json" if split == "train" else \\
        "caption_valid.json"
    with open(os.path.join(ann_dir, cap_name), "w") as f:
        json.dump(captions, f)
    return feats_dir, ann_dir


def write_vocab(path):
    from volta_tpu_torch.data.tokenization import write_tiny_vocab

    write_tiny_vocab(path, WORDS)
    return path
'''
_NS = {}
exec(compile(WRITER, "port_concap_writer", "exec"), _NS)


@pytest.fixture(scope="module")
def cc(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("cc"))
    feats, ann = fixtures.make_concap_lmdb(tmp, n=16, feature_size=32)
    fixtures.make_concap_lmdb(tmp, n=8, feature_size=32, split="valid")
    vocab = fixtures.make_vocab(tmp)
    return dict(tmp=tmp, feats=feats, ann=ann, vocab=vocab,
                lmdb=os.path.join(feats, "training_feat_all.lmdb"),
                captions=os.path.join(ann, "caption_train.json"))


# ----------------------------------------------------------------- codec
def test_codec_byte_equal_on_the_records(cc):
    env = jax_lmdbx.Env(cc["lmdb"])
    n = 0
    for key, raw in env.items():
        mine = pser.loads(raw)
        theirs = jser.loads(raw)
        # decoded strings are bytes (raw=True): re-encoded as bin, alike
        assert pser.dumps(mine) == jser.dumps(theirs)
        assert _same(mine, theirs) and _same(jser.loads(pser.dumps(mine)),
                                             theirs)
        n += 1
    assert n == 17  # 16 records and __keys__


def _same(a, b):
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and np.array_equal(a, b)
                and not a.flags.writeable)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and (a == b or a != a)


def test_codec_every_type():
    rng = np.random.RandomState(0)
    obj = [None, True, False, 0, 127, 128, 255, 256, 65535, 65536,
           2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33, -128, -129, -32768,
           -32769, -2**31, -2**31 - 1, -2**63, 1.5, -0.0, float("inf"),
           "", "x" * 31, "y" * 32, "z" * 255, "w" * 256, "é" * 40000,
           b"", b"b" * 255, b"c" * 256, b"d" * 70000, bytearray(b"ef"),
           [], list(range(15)), list(range(16)), list(range(70000)),
           (1, 2), {}, {b"k": 1, "s": [1, 2]},
           {str(i): i for i in range(16)},
           np.float64(2.5), np.float32(1.5), np.int64(-7), np.uint8(3),
           np.bool_(True), rng.randn(3, 4).astype(np.float32),
           rng.randint(0, 9, (5,)).astype(np.int64), np.zeros((0, 3)),
           np.arange(6, dtype=np.int16).reshape(2, 3).T]
    raw = jser.dumps(obj)
    assert pser.dumps(obj) == raw
    assert _same(pser.loads(raw), jser.loads(raw))
    with pytest.raises(ValueError, match="map key"):
        pser.loads(b"\x81\x01\x02")  # an int key: msgpack's strict keys
    with pytest.raises(ValueError, match="truncated"):
        pser.loads(raw[:-1])
    with pytest.raises(TypeError):
        pser.dumps(object())
    assert pser.tensorpack_key(12) == jser.tensorpack_key(12) == b"00000012"


def test_port_writer_writes_the_fixture_bytes(cc, tmp_path):
    feats, ann = _NS["write_concap_lmdb"](str(tmp_path), n=16,
                                          feature_size=32)
    for sub in ("imgfeats/training_feat_all.lmdb",
                "annotations/caption_train.json"):
        with open(os.path.join(str(tmp_path), sub), "rb") as f, \
                open(os.path.join(cc["tmp"], sub), "rb") as g:
            assert f.read() == g.read(), sub


# --------------------------------------------------------------- dataset
def _pair(cc, **kw):
    args = (cc["lmdb"], cc["captions"])
    common = dict(seq_len=SEQ, region_len=REG, seed=3, **kw)
    return (ConceptCapDataset(*args, BertTokenizer(cc["vocab"]), **common),
            JaxCC(*args, JaxTokenizer(cc["vocab"]), **common))


def _float32(x):
    """A batch field as a numpy array, bf16 (the port's uint16 bit
    patterns, JAX's ml_dtypes array) widened to float32."""
    x = np.asarray(x)
    if x.dtype == np.uint16:
        return from_bf16_bits(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _equal_batches(got, want):
    """Field for field equal; JAX's bf16 arrays are the port's uint16 bit
    patterns, bit for bit."""
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        if v.dtype.name == "bfloat16":
            v = v.view(np.uint16)
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("glob,objective", [("first", 0), ("last", 1),
                                            (None, 2)])
def test_items_equal_jax(cc, glob, objective):
    port, jax_ds = _pair(cc, add_global_imgfeat=glob, objective=objective)
    assert len(port) == len(jax_ds) == 16
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jax_ds.set_epoch(epoch)
        for i in range(16):
            _equal_batches(port[i], jax_ds[i])
    if objective == 2:  # no ITM negatives
        assert all(int(port[i]["is_match"]) == 0 for i in range(16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("glob", ["first", "last"])
def test_packed_and_store_batches_equal_jax(cc, dtype, glob):
    port, jax_ds = _pair(cc, add_global_imgfeat=glob)
    port.enable_packed(cache=False, feat_dtype=dtype)
    jax_ds.enable_packed(cache=False, feat_dtype=dtype)
    idx = [[0, 3, 5, 7], [15, 2, 9, 1, 4, 8]]
    for epoch in (0, 2):
        port.set_epoch(epoch)
        jax_ds.set_epoch(epoch)
        for chunk in idx:
            _equal_batches(port.get_batch(np.array(chunk)),
                           jax_ds.get_batch(np.array(chunk)))
    packed = port.get_batch(np.array(idx[1]))
    port.enable_device_store()
    jax_ds.enable_device_store()
    store_b = port.get_batch(np.array(idx[1]))
    _equal_batches(store_b, jax_ds.get_batch(np.array(idx[1])))
    # the store expanded on the device: the packed batch (labels as int32)
    cfg = VoltaConfig(add_global_imgfeat=glob)
    store = store_to_device(port.device_store_arrays(), "cpu",
                            getattr(torch, dtype))
    full = materialize_cc_store_batch(
        store, {k: torch.from_numpy(v) for k, v in store_b.items()}, cfg)
    for k, v in packed.items():
        np.testing.assert_array_equal(full[k].float().numpy(),
                                      _float32(v).astype(np.float32),
                                      err_msg=k)
    import jax.numpy as jnp

    jfull = jax_materialize(
        {k: jnp.asarray(v) for k, v in jax_ds.device_store_arrays().items()},
        {k: jnp.asarray(v) for k, v in store_b.items()}, cfg)
    assert set(jfull) == set(full)
    for k in jfull:
        np.testing.assert_array_equal(
            full[k].float().numpy(), np.asarray(jfull[k], np.float32),
            err_msg=k)
    # pruned per objective: NCE alone needs no soft targets
    assert "cls" not in port.device_store_arrays(targets=["2"])
    assert set(port.device_store_arrays(targets=["3"])) >= {"obj_l",
                                                            "obj_c"}


def test_store_step_equals_dense_step(cc):
    """``make_pretrain_step`` with the device store (``store=``) takes the
    step the packed batch takes: the same losses and parameters, bit for
    bit (the CPU; float32)."""
    from volta_tpu_torch.models import VoltaForVLPreTraining
    from volta_tpu_torch.models.layers import init_weights
    from volta_tpu_torch.optimization import build_optimizer
    from volta_tpu_torch.train_step import create_train_state, \
        make_pretrain_step

    cfg = VoltaConfig.from_dict(zoo.single_stream(
        "uniter", depth=1, hidden_size=32, num_attention_heads=2,
        intermediate_size=32, pooler_size=32, v_pooler_size=32,
        vocab_size=23, max_position_embeddings=32, v_feature_size=32,
        v_hidden_size=32, v_num_attention_heads=2, v_intermediate_size=32,
        clf_hidden_size=16, compute_dtype="float32").to_dict())
    port, _ = _pair(cc, add_global_imgfeat=cfg.add_global_imgfeat,
                    objective=1)
    port.enable_packed(cache=False)
    idx = np.array([3, 1, 4, 15, 9])
    dense = port.get_batch(idx)
    port.enable_device_store()
    wire = port.get_batch(idx)
    store = store_to_device(port.device_store_arrays(), "cpu")
    out = {}
    for name, batch, kw in (("dense", dense, {}),
                            ("store", wire, {"store": store})):
        model = VoltaForVLPreTraining(cfg)
        init_weights(model, torch.Generator().manual_seed(0))
        opt = build_optimizer("adamw", 1e-3, model, clip_norm=5.0)
        state = create_train_state(model.train(), opt, seed=4)
        m = make_pretrain_step(model, opt, cfg, objective=1, **kw)(state,
                                                                    batch)
        out[name] = (m, model.state_dict())
    (md, pd), (ms, ps) = out["dense"], out["store"]
    assert all(torch.equal(md[k], ms[k]) for k in md)
    assert all(torch.equal(pd[k], ps[k]) for k in pd)


def test_packed_cache_shared_with_jax(cc, tmp_path):
    """The bf16 cache under the same tag: the port reads JAX's, JAX the
    port's, and both give the batches of an uncached store."""
    import shutil

    for writer in ("port", "jax"):
        lmdb = str(tmp_path / writer / "training_feat_all.lmdb")
        os.makedirs(os.path.dirname(lmdb))
        shutil.copy(cc["lmdb"], lmdb)
        common = dict(seq_len=SEQ, region_len=REG, seed=3,
                      add_global_imgfeat="first")
        port = ConceptCapDataset(lmdb, cc["captions"],
                                 BertTokenizer(cc["vocab"]), **common)
        jax_ds = JaxCC(lmdb, cc["captions"], JaxTokenizer(cc["vocab"]),
                       **common)
        first, second = (port, jax_ds) if writer == "port" else (jax_ds,
                                                                 port)
        first.enable_packed(feat_dtype="bfloat16")
        caches = [d for d in os.listdir(os.path.dirname(lmdb))
                  if ".packed-" in d]
        assert len(caches) == 1
        mtime = os.path.getmtime(os.path.join(os.path.dirname(lmdb),
                                              caches[0], "feat.npy"))
        second.enable_packed(feat_dtype="bfloat16")
        assert os.path.getmtime(os.path.join(
            os.path.dirname(lmdb), caches[0], "feat.npy")) == mtime
        np.testing.assert_array_equal(
            port._p["feat"], np.asarray(jax_ds._p["feat"]).view(np.uint16))
        _equal_batches(port.get_batch(np.arange(4)),
                       jax_ds.get_batch(np.arange(4)))


def test_loader_path_rules(tmp_path):
    feats, ann = fixtures.make_concap_shards(str(tmp_path), n_per_shard=8,
                                             shards=2)
    vocab = fixtures.make_vocab(str(tmp_path))
    tok = BertTokenizer(vocab)
    kw = dict(seq_len=SEQ, region_len=REG, batch_size=4, num_workers=0)
    ds, loader = make_concap_loader(feats, ann, tok, shard_index=1,
                                    num_shards=2, **kw)
    assert ds.env.path.endswith("training_feat_part_1.lmdb")
    assert (loader.num_shards, loader.shard_index) == (1, 0)
    assert len(loader) == 2
    # no shard of that index: the whole environment, strided
    whole = fixtures.make_concap_lmdb(str(tmp_path / "w"), n=12)[0]
    ds, loader = make_concap_loader(whole, ann, tok, shard_index=3,
                                    num_shards=4, **kw)
    assert ds.env.path.endswith("training_feat_all.lmdb")
    assert (loader.num_shards, loader.shard_index) == (4, 3)
    # a path that is the environment itself
    lmdb = os.path.join(whole, "training_feat_all.lmdb")
    ds, _ = make_concap_loader(lmdb, ann, tok, **kw)
    assert ds.env.path == lmdb
    with pytest.raises((FileNotFoundError, ValueError, OSError)):
        make_concap_loader(str(tmp_path / "none"), ann, tok, split="valid",
                           **kw)


def test_bf16_bits_as_ml_dtypes_rounds():
    """``packed.bf16_bits`` rounds as ``astype(ml_dtypes.bfloat16)`` (ties
    to even, float64 through float32, NaN made quiet), ``from_bf16_bits``
    widens back exactly, and ``to_device`` views uint16 bits as the bf16
    tensor torch rounds to."""
    import ml_dtypes

    from volta_tpu_torch.data.packed import bf16_bits
    from volta_tpu_torch.eval_step import to_device

    rng = np.random.RandomState(0)
    x = (rng.randn(20000) * 3.0 ** rng.randint(-40, 40, 20000)).astype(
        np.float32)
    x[:6] = [np.nan, -np.inf, np.inf, -0.0, 1e-40, 3.3895314e38]
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(bf16_bits(x), want)
    x64 = rng.randn(1000) * 1.2345
    np.testing.assert_array_equal(
        bf16_bits(x64), x64.astype(ml_dtypes.bfloat16).view(np.uint16))
    np.testing.assert_array_equal(
        from_bf16_bits(want), x.astype(ml_dtypes.bfloat16).astype(np.float32))
    got = to_device({"f": want[6:]}, "cpu")["f"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.from_numpy(x[6:]).to(torch.bfloat16))


def test_bf16_store_through_forked_loader(cc):
    """The packed bf16 store through the loader's forked worker processes
    gives the batches the threaded loader gives (the workers run numpy
    alone)."""
    tok = BertTokenizer(cc["vocab"])
    got = {}
    for procs in (0, 2):
        _, loader = make_concap_loader(
            cc["feats"], cc["ann"], tok, seq_len=SEQ, region_len=REG,
            batch_size=4, num_workers=1, num_procs=procs, packed=True,
            feat_dtype="bfloat16", add_global_imgfeat="first")
        got[procs] = list(loader)
    assert len(got[0]) == len(got[2]) == 4
    for a, b in zip(got[0], got[2]):
        assert a["image_feat"].dtype == a["image_cls"].dtype == np.uint16
        _equal_batches(b, a)


# ------------------------------------------------------------------- CLI
@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """2048-d features (the NCE and regression targets' width), a small
    ctrl_uniter with KL and NCE, and a VQA task on the same features."""
    tmp = str(tmp_path_factory.mktemp("cc_cli"))
    feats, ann = _NS["write_concap_lmdb"](tmp, n=16, feature_size=2048)
    _NS["write_concap_lmdb"](tmp, n=8, feature_size=2048, split="valid")
    vocab = _NS["write_vocab"](os.path.join(tmp, "vocab.txt"))
    cfg = zoo.single_stream(
        "uniter", depth=2, hidden_size=48, num_attention_heads=4,
        intermediate_size=64, pooler_size=48, v_pooler_size=48,
        vocab_size=23, max_position_embeddings=64, v_feature_size=2048,
        v_hidden_size=48, v_num_attention_heads=4, v_intermediate_size=64,
        clf_hidden_size=32, visual_target_weights={"0": 1.0, "2": 1.0})
    model_cfg = os.path.join(tmp, "model.json")
    with open(model_cfg, "w") as f:
        f.write(cfg.to_json_string())
    base = ["--config_file", model_cfg, "--annotations_path", ann,
            "--features_path", feats, "--vocab_file", vocab,
            "--output_dir", os.path.join(tmp, "save"), "--logdir",
            os.path.join(tmp, "logs"), "--train_batch_size", "4",
            "--max_seq_length", str(SEQ), "--max_region_num", str(REG),
            "--num_workers", "0", "--compute_dtype", "float32",
            "--objective", "1", "--clip_grad_norm", "5.0",
            "--in_memory", "True", "--device", "cpu"]
    return dict(tmp=tmp, base=base, model_cfg=model_cfg, vocab=vocab)


def test_cli_trains_resumes_and_feeds_train_task(cli):
    out = train_concap.main(cli["base"] + ["--num_train_epochs", "1"])
    assert out["steps"] == 4 and len(out["train_losses"]) == 4
    assert all(np.isfinite(v) for row in out["train_losses"] for v in row)
    assert len(out["val_losses"]) == 1 and np.isfinite(out["val_losses"][0])
    with open(os.path.join(out["log_dir"], "out.txt")) as f:
        lines = [ln for ln in f if " CC masked_t " in ln]
    assert len(lines) == 1 and "masked_v" in lines[0] and "itm" in lines[0]
    ckpt = os.path.join(out["run_dir"], "ckpt", "train_state.pt")
    saved = torch.load(ckpt, weights_only=True)
    assert saved["step"] == 4
    assert any(k.startswith("cls.") for k in saved["model"])

    # a second run resumes from the checkpoint and trains one more epoch
    again = train_concap.main(cli["base"] + ["--num_train_epochs", "2"])
    assert again["steps"] == 8 and len(again["train_losses"]) == 4

    # train_task from the pretraining checkpoint: the trunk, not the heads
    tmp = cli["tmp"]
    ids = [10, 11, 12, 13]
    feat = fixtures.make_features_lmdb(tmp, ids, feature_size=2048)
    fixtures.make_vqa_annotations(tmp, ids, n_questions=8, num_labels=9)
    yml = os.path.join(tmp, "tasks.yml")
    with open(yml, "w") as f:
        f.write(f"""TASK1:
  name: VQA
  type: VL-classifier
  num_labels: 9
  loss: BCEWithLogitLoss
  process: normal
  dataroot: {tmp}
  features_h5path1: {feat}
  features_h5path2: ''
  train_annotations_jsonpath: ''
  val_annotations_jsonpath: ''
  max_seq_length: 12
  max_region_num: 6
  batch_size: 4
  eval_batch_size: 4
  train_split: train
  val_split: train
  lr: 0.001
""")
    from volta_tpu_torch import checkpoint as ck
    from volta_tpu_torch.models import VoltaForVLTasks
    from volta_tpu_torch.task_utils import load_task_config

    pcfg = VoltaConfig.from_json_file(cli["model_cfg"])
    model = VoltaForVLTasks(pcfg, load_task_config(yml), ("TASK1",))
    report = ck.from_pretrained(pcfg, model, os.path.dirname(ckpt))
    assert report["loaded"] and all(k.startswith("bert.")
                                     for k in report["loaded"])
    assert {k.split(".")[0] for k in report["skipped"]} == {"clf_TASK1"}
    assert {k.split(".")[0] for k in report["unused"]} == {"cls"}
    trunk = {k: v for k, v in again_state(ckpt).items()
             if k.startswith("bert.")}
    for k, v in trunk.items():
        assert torch.equal(model.state_dict()[k], v), k
    run = train_task.main([
        "--config_file", cli["model_cfg"], "--tasks_config_file", yml,
        "--task", "1", "--vocab_file", cli["vocab"], "--num_workers", "0",
        "--compute_dtype", "float32", "--device", "cpu",
        "--from_pretrained", ckpt, "--num_train_epochs", "1",
        "--output_dir", os.path.join(tmp, "task_save"), "--logdir",
        os.path.join(tmp, "task_logs")])
    assert run["steps"] == 2 and np.isfinite(run["train_losses"]).all()


def test_cli_checkpoints_on_sigterm_and_resumes(cli, monkeypatch, tmp_path):
    """SIGTERM during a step: the CLI saves its train state after that
    step and stops; the next launch resumes from it, at the start of the
    same epoch, as the JAX CLI does (train_concap.py:260-310)."""
    import signal

    from volta_tpu_torch import train_step

    real = train_step.make_pretrain_step

    def make(*args, **kw):
        step = real(*args, **kw)

        def signalled(state, batch):
            out = step(state, batch)
            if state.step == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return signalled

    argv = cli["base"] + ["--output_dir", str(tmp_path / "save"),
                          "--logdir", str(tmp_path / "logs"),
                          "--num_train_epochs", "1"]
    monkeypatch.setattr(train_step, "make_pretrain_step", make)
    before = signal.getsignal(signal.SIGTERM)
    out = train_concap.main(argv)
    assert out["steps"] == 2 and out["val_losses"] == []
    ckpt = os.path.join(out["run_dir"], "ckpt", "train_state.pt")
    assert torch.load(ckpt, weights_only=True)["step"] == 2
    assert signal.getsignal(signal.SIGTERM) is before  # restored
    monkeypatch.setattr(train_step, "make_pretrain_step", real)
    again = train_concap.main(argv)
    assert again["steps"] == 6 and len(again["val_losses"]) == 1


def again_state(ckpt):
    return torch.load(ckpt, weights_only=True)["model"]


@pytest.mark.parametrize("flag,item", [
    (["--optimizer_state_dtype", "bfloat16"], "item 8"),
    (["--skip_disconnected_params"], "item 8"),
    (["--trunk_lr_scale", "0.1"], "item 8"),
    (["--from_pretrained", "flax"], "item 12")])
def test_cli_refuses_unported_flags(cli, flag, item, tmp_path):
    """--from_pretrained of the JAX package's own Flax msgpack save raises,
    naming its item (12; --profile_steps, ported since:
    tests/test_torch_port_profiling.py; --distributed:
    tests/test_torch_port_distributed_cli.py); the
    optimizer flags (item 8), ported since, run two steps: bf16 moments in
    the saved state; skip_disconnected; and --trunk_lr_scale 0.1 from a
    reference ``.bin``, whose loaded parameters move 0.1x as far as
    without the flag (the first update's lr is 0 under warmup, so both
    runs take their second on the same gradients) and whose others move
    alike. Without --from_pretrained, or from the port's own checkpoint,
    it exits."""
    if flag[0] == "--from_pretrained":
        (tmp_path / "flax").mkdir()
        (tmp_path / "flax" / "flax_model.msgpack").write_bytes(b"")
        flag = [flag[0], str(tmp_path / "flax")]
    if item != "item 8":
        with pytest.raises(NotImplementedError, match=item):
            train_concap.main(cli["base"] + flag)
        return

    def run(tag, *extra):
        out = train_concap.main(cli["base"] + [
            "--output_dir", str(tmp_path / tag), "--num_train_epochs", "1",
            "--steps_per_epoch", "2", "--warmup_steps", "1", *extra])
        assert out["steps"] == 2
        assert all(np.isfinite(v) for row in out["train_losses"]
                   for v in row)
        ckpt = os.path.join(out["run_dir"], "ckpt")
        return torch.load(os.path.join(ckpt, "train_state.pt"),
                          weights_only=True), ckpt

    if flag[0] != "--trunk_lr_scale":
        saved = run("flag", *flag)[0]
        mu = saved["optimizer"]["mu"]["bert.encoder.ff_1.out_dense.weight"]
        assert mu.dtype == (torch.bfloat16 if "bfloat16" in flag
                            else torch.float32)
        return
    from volta_tpu_torch import VoltaForVLPreTraining
    from volta_tpu_torch import checkpoint as ck
    from volta_tpu_torch.models.layers import init_weights

    cfg = VoltaConfig.from_json_file(cli["model_cfg"])
    cfg.compute_dtype = "float32"
    src = VoltaForVLPreTraining(cfg)
    init_weights(src, torch.Generator().manual_seed(5))
    # the trunk alone, as a task checkpoint's weights would be
    sd = {k: v for k, v in ck.export_reference_state_dict(cfg, src)[0]
          .items() if not k.startswith("cls.")}
    path = str(tmp_path / "pretrained.bin")
    torch.save(sd, path)
    with pytest.raises(SystemExit, match="was not given"):
        train_concap.main(cli["base"] + flag)
    scaled = run("scaled", "--from_pretrained", path, *flag)[0]["model"]
    plain, own = run("plain", "--from_pretrained", path)
    with pytest.raises(SystemExit, match="own format"):
        train_concap.main(cli["base"] + [
            "--output_dir", str(tmp_path / "own"), "--from_pretrained", own,
            *flag])
    plain = plain["model"]
    loaded = src.state_dict()
    moved = 0
    for name, p in scaled.items():
        if name in loaded and not name.startswith("cls."):
            d_s, d_p = p - loaded[name], plain[name] - loaded[name]
            torch.testing.assert_close(d_s, 0.1 * d_p, rtol=1e-3,
                                       atol=1e-7)
            moved += bool(d_p.abs().max() > 0)
        else:
            assert torch.equal(p, plain[name]), name
    assert moved > 10


def test_cli_needs_a_card_unless_told(cli, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in cli["base"] if a not in ("--device", "cpu")]
    with pytest.raises(SystemExit, match="CUDA is not available"):
        train_concap.main(argv)
    with pytest.raises(SystemExit):  # the JAX-only flag does not exist
        train_concap.parse_args(cli["base"] + ["--prng_impl", "rbg"])


def test_cli_imports_no_jax_and_no_msgpack(tmp_path):
    """The port's writer and ``train_concap.main`` in a subprocess: no
    ``volta_tpu``, ``jax``, ``jaxlib``, ``flax`` or ``msgpack`` module."""
    cfg = zoo.single_stream(
        "uniter", depth=1, hidden_size=32, num_attention_heads=2,
        intermediate_size=32, pooler_size=32, v_pooler_size=32,
        vocab_size=23, max_position_embeddings=32, v_feature_size=32,
        v_hidden_size=32, v_num_attention_heads=2, v_intermediate_size=32,
        clf_hidden_size=16)
    model_cfg = str(tmp_path / "model.json")
    with open(model_cfg, "w") as f:
        f.write(cfg.to_json_string())
    tmp = str(tmp_path)
    code = (WRITER + "\nimport sys\n"
            "from volta_tpu_torch import train_concap\n"
            f"feats, ann = write_concap_lmdb({tmp!r}, n=8)\n"
            f"vocab = write_vocab({tmp!r} + '/vocab.txt')\n"
            "out = train_concap.main(['--config_file', "
            f"{model_cfg!r}, '--annotations_path', ann, "
            "'--features_path', feats, '--vocab_file', vocab, "
            f"'--output_dir', {tmp!r} + '/save', '--logdir', "
            f"{tmp!r} + '/logs', '--train_batch_size', '4', "
            "'--max_seq_length', '12', '--max_region_num', '5', "
            "'--num_train_epochs', '1', '--num_workers', '0', "
            "'--in_memory', 'True', '--device', 'cpu'])\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('volta_tpu', 'jax', 'jaxlib', 'flax', 'msgpack'))\n"
            "print(json.dumps({'steps': out['steps'], 'bad': bad}))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "steps": 2, "bad": []}
