"""The port's retrieval CLI (``python -m volta_tpu_torch.eval_retrieval``)
against the root ``eval_retrieval.py`` on the CPU, on ``tests/fixtures.py``
retrieval data (8 images in gallery chunks of 3, 16 captions of distinct
words): both CLIs read one reference ``.bin`` that the port's exporter
wrote (a VL-logit task model and the pretraining heads on one trunk), in
float32, JAX with ``--no_pallas`` and the port on its plain route, plain,
``--zero_shot`` and ``--quantize int8``. The score matrices agree within
1e-5 (int8: 1e-3) and the metrics and result files are equal; the
gallery chunks go to the device once; ``--max_captions`` and a tail block
padded with the last caption."""

import json
import os
import sys
import types
from unittest import mock

import numpy as np
import pytest
import torch

import fixtures
from volta_tpu import zoo
from volta_tpu_torch import VoltaForVLPreTraining, VoltaForVLTasks
from volta_tpu_torch import checkpoint as ck
from volta_tpu_torch import eval_retrieval as port_cli
from volta_tpu_torch.config import VoltaConfig
from volta_tpu_torch.models.layers import init_weights

IDS = list(range(60, 68))
CHUNK = 3


def _cfg():
    return zoo.single_stream(
        "uniter", depth=2, hidden_size=48, num_attention_heads=4,
        intermediate_size=64, pooler_size=48, v_pooler_size=48,
        vocab_size=23, max_position_embeddings=64, v_feature_size=32,
        v_hidden_size=48, v_num_attention_heads=4, v_intermediate_size=64,
        clf_hidden_size=32)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("port_retrieval"))
    feat = fixtures.make_features_lmdb(tmp, IDS, feature_size=32)
    rng = np.random.RandomState(0)
    ann = os.path.join(tmp, "ann.jsonl")
    with open(ann, "w") as f:
        for iid in IDS:
            sents = [" ".join(fixtures.WORDS[int(j)] for j in
                              rng.randint(0, 15, rng.randint(3, 8)))
                     for _ in range(2)]
            f.write(json.dumps({"img_path": f"{iid}.jpg",
                                "sentences": sents}) + "\n")
    vocab = fixtures.make_vocab(tmp)
    cfg = _cfg()
    cfg_path = os.path.join(tmp, "model.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json_string())
    yml = os.path.join(tmp, "tasks.yml")
    with open(yml, "w") as f:
        f.write(f"""TASK8:
  name: RetrievalFlickr30k
  type: VL-logit
  num_labels: 1
  loss: CrossEntropyLoss
  process: retrieval
  dataroot: {tmp}
  features_h5path1: {feat}
  features_h5path2: ''
  train_annotations_jsonpath: {ann}
  val_annotations_jsonpath: {ann}
  max_seq_length: 10
  max_region_num: 6
  batch_size: 4
  train_split: train
  val_split: train
  lr: 0.0001
  num_epoch: 1
""")
    # one .bin: a task model and the pretraining heads on the same trunk
    pcfg = VoltaConfig.from_dict(cfg.to_dict())
    task_cfg = {"TASK8": {"type": "VL-logit", "num_labels": 1}}
    task = VoltaForVLTasks(pcfg, task_cfg, ("TASK8",))
    init_weights(task, torch.Generator().manual_seed(1))
    pre = VoltaForVLPreTraining(pcfg)
    init_weights(pre, torch.Generator().manual_seed(2))
    pre.bert.load_state_dict(task.bert.state_dict())
    sd = ck.export_reference_state_dict(pcfg, pre)[0]
    sd.update(ck.export_reference_state_dict(pcfg, task)[0])
    path = os.path.join(tmp, "weights.bin")
    torch.save(sd, path)
    base = ["--config_file", cfg_path, "--tasks_config_file", yml,
            "--task", "8", "--vocab_file", vocab, "--num_workers", "0",
            "--compute_dtype", "float32", "--no_pallas",
            "--from_pretrained", path]
    return dict(tmp=tmp, base=base)


def _chunked(module):
    orig = module.RetrievalDatasetVal.__init__

    def patched(self, *a, **kw):
        kw["gallery_chunk"] = CHUNK
        return orig(self, *a, **kw)

    return mock.patch.object(module.RetrievalDatasetVal, "__init__", patched)


def _jax_run(base, out, flags):
    """The root CLI; its score matrix caught where it is ranked."""
    import eval_retrieval
    from volta_tpu.data.datasets import retrieval as rmod

    seen = []

    def argsort(a, *args, **kw):
        if not seen and np.ndim(a) == 2 and kw.get("axis") == 1:
            seen.append(-np.asarray(a))
        return np.argsort(a, *args, **kw)

    proxy = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np)
                                     if not k.startswith("__")})
    proxy.argsort = argsort
    argv = ["eval_retrieval.py"] + base + ["--output_dir", out] + flags
    with _chunked(rmod), mock.patch.object(sys, "argv", argv), \
            mock.patch.object(eval_retrieval, "np", proxy):
        eval_retrieval.main()
    return seen[0]


def _files(out):
    (run,) = os.listdir(out)
    with open(os.path.join(out, run, "train_result.json")) as f:
        result = json.load(f)
    with open(os.path.join(out, run, "train_metrics.json")) as f:
        return result, json.load(f)


@pytest.mark.parametrize("mode", ["plain", "zero_shot", "int8"])
def test_scores_metrics_and_files_match_jax(data, mode):
    from volta_tpu_torch.data.datasets import retrieval as pmod

    flags = {"plain": [], "zero_shot": ["--zero_shot"],
             "int8": ["--quantize", "int8"]}[mode]
    jout = os.path.join(data["tmp"], "jax_" + mode)
    pout = os.path.join(data["tmp"], "port_" + mode)
    jscores = _jax_run(data["base"], jout, flags)
    with _chunked(pmod):
        got = port_cli.main(data["base"] + ["--output_dir", pout,
                                            "--device", "cpu"] + flags)
    assert got["score_matrix"].shape == jscores.shape == (16, 8)
    tol = 1e-3 if mode == "int8" else 1e-5
    np.testing.assert_allclose(got["score_matrix"], jscores, rtol=0,
                               atol=tol * np.abs(jscores).max())
    assert _files(pout) == _files(jout)
    assert got["dispatches"] == 4 * 3  # 16 captions / 4, 3 chunks


def test_int8_routes_every_dense_and_max_captions(data, monkeypatch):
    """With ``--quantize int8`` every Dense of the forward runs K9's two
    functions once (on the CPU their twins), counted by a spy; the gallery
    is put on the device once a chunk; ``--max_captions 6`` with 4 a
    dispatch pads the tail with the last caption and scores 6 rows."""
    from volta_tpu_torch.data.datasets import retrieval as pmod
    from volta_tpu_torch.ops import int8_dense

    calls = {"quantize": 0, "matmul": 0}
    real_q, real_m = int8_dense.int8_quantize, int8_dense.int8_matmul

    def quantize(*a, **kw):
        calls["quantize"] += 1
        return real_q(*a, **kw)

    def matmul(*a, **kw):
        calls["matmul"] += 1
        return real_m(*a, **kw)

    monkeypatch.setattr(int8_dense, "int8_quantize", quantize)
    monkeypatch.setattr(int8_dense, "int8_matmul", matmul)
    out = os.path.join(data["tmp"], "port_max")
    with _chunked(pmod):
        got = port_cli.main(data["base"] + [
            "--output_dir", out, "--device", "cpu", "--quantize", "int8",
            "--max_captions", "6"])
    assert got["score_matrix"].shape == (6, 8)
    assert got["dispatches"] == 2 * 3
    forwards = got["dispatches"] + 1  # and the warm-up
    # ctrl_uniter's Dense: 2 embedding, 6 a layer, 2 poolers, the head
    n_dense = 2 + 6 * 2 + 2 + 1
    assert calls == {"quantize": n_dense * forwards,
                     "matmul": n_dense * forwards}
    block = got["captions"](4)
    assert torch.equal(block[0][2], block[0][3]) \
        and torch.equal(block[0][1], block[0][2])
    assert len(got["gallery"]) == 3
    with pytest.raises(SystemExit, match="CUDA is not available"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        port_cli.main(data["base"] + ["--output_dir", out])
