"""The port's eval CLI (``python -m volta_tpu_torch.eval_task``) against the
JAX eval step on the CPU, on the synthetic VQA fixtures."""

import argparse
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from volta_tpu import zoo
from volta_tpu.models import VoltaForVLTasks as JaxVLTasks
from volta_tpu.parallel import make_task_eval_step
from volta_tpu.task_utils import (load_dataset_eval, load_task_config,
                                  process_batch)
from volta_tpu_torch import eval_task as port_eval
from volta_tpu_torch.convert import state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("port_eval"))
    ids = [10, 11, 12]
    feat = fixtures.make_features_lmdb(tmp, ids, feature_size=32)
    fixtures.make_vqa_annotations(tmp, ids, n_questions=10, num_labels=9)
    vocab = fixtures.make_vocab(tmp)
    cfg = zoo.single_stream(
        "uniter", depth=2, hidden_size=64, num_attention_heads=4,
        intermediate_size=128, pooler_size=64, v_pooler_size=64,
        vocab_size=23, max_position_embeddings=64, v_feature_size=32,
        v_hidden_size=64, v_num_attention_heads=4, v_intermediate_size=128,
        clf_hidden_size=32)
    model_cfg = os.path.join(tmp, "model.json")
    with open(model_cfg, "w") as f:
        f.write(cfg.to_json_string())
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
""")
    return dict(tmp=tmp, vocab=vocab, model_cfg=model_cfg, yml=yml, cfg=cfg)


def _jax_eval(w, task="1"):
    """The JAX eval step over the eval loader, with the Flax init of the
    root eval_task.py (PRNGKey(0) on the first batch)."""
    import eval_task as jax_cli

    args = argparse.Namespace(bert_model="bert-base-uncased",
                              do_lower_case=True, vocab_file=w["vocab"],
                              split="", in_memory=False, num_workers=0,
                              batch_size=4)
    cfg = w["cfg"]
    key = "TASK" + task
    task_cfg = load_task_config(w["yml"])
    tc = task_cfg[key]
    data = load_dataset_eval(args, cfg, task_cfg, task)
    model = JaxVLTasks(cfg, task_cfg, (key,))
    inputs, _ = process_batch(tc, next(iter(data["loader"])))
    variables = jax.jit(lambda r: model.init(
        r, np.asarray(inputs["input_ids"]), np.asarray(inputs["image_feat"]),
        np.asarray(inputs["image_loc"]), key,
        np.asarray(inputs["token_type_ids"]),
        np.asarray(inputs["attention_mask"]),
        np.asarray(inputs["image_attention_mask"])))(jax.random.PRNGKey(0))
    step = make_task_eval_step(model, task_cfg, key)
    results, loss, score, n = [], 0.0, 0.0, 0
    for batch in data["loader"]:
        out = step(variables["params"], batch)
        _, info = process_batch(tc, batch)
        jax_cli.collect_results(tc["type"], out["prediction"], batch, info,
                                data["dataset"], results)
        loss += float(out["loss"])
        score += float(out["score"])
        n += int(out["batch_size"])
    return variables["params"], results, loss / n, score / n


def test_port_cli_writes_the_jax_answers(workdir):
    params, jax_results, jax_loss, jax_score = _jax_eval(workdir)
    weights = os.path.join(workdir["tmp"], "port_weights.pt")
    torch.save(state_dict_from_flax(params), weights)
    out_dir = os.path.join(workdir["tmp"], "port_results")
    summary = port_eval.main([
        "--config_file", workdir["model_cfg"],
        "--tasks_config_file", workdir["yml"], "--task", "1",
        "--vocab_file", workdir["vocab"], "--from_pretrained", weights,
        "--output_dir", out_dir, "--num_workers", "0",
        "--compute_dtype", "float32", "--device", "cpu"])
    with open(summary["out_file"]) as f:
        port_results = json.load(f)
    assert summary["out_file"].endswith("train_result.json")
    assert len(port_results) == 10 and summary["n"] == 10
    assert port_results == jax_results
    assert summary["nonfinite_batches"] == 0
    np.testing.assert_allclose(summary["loss"], jax_loss, rtol=1e-5)
    np.testing.assert_allclose(summary["score"], jax_score, rtol=1e-6)


@pytest.fixture(scope="module")
def task_workdir(workdir):
    """NLVR2 (TASK12) and refcoco+ (TASK10) dataroots in the reference's
    formats, written by ``tools/make_synth_data.py``'s generators at a tiny
    size, and a yml holding both beside TASK1."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_synth_data", os.path.join(REPO, "tools", "make_synth_data.py"))
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    tmp = workdir["tmp"]
    roots = {}
    for name, kw in (("nlvr2", dict(questions=6)),
                     ("refcoco", dict(refs_per_image=2))):
        roots[name] = os.path.join(tmp, name)
        getattr(synth, f"gen_{name}")(argparse.Namespace(
            out=roots[name], images=3, boxes=5, feat_dim=32, seed=0, **kw))
    with open(workdir["yml"]) as f:
        text = f.read()
    text += f"""TASK12:
  name: NLVR2
  type: VL-binary-classifier
  num_labels: 2
  loss: BCEWithLogitLoss
  process: nlvr
  dataroot: {roots["nlvr2"]}
  features_h5path1: {roots["nlvr2"]}/features.lmdb
  features_h5path2: ''
  train_annotations_jsonpath: ''
  val_annotations_jsonpath: ''
  max_seq_length: 14
  max_region_num: 6
  batch_size: 4
  eval_batch_size: 4
  train_split: train
  val_split: train
TASK10:
  name: refcoco+
  type: V-logit
  loss: BCEWithLogitLoss
  process: normal
  dataroot: {roots["refcoco"]}
  features_h5path1: {roots["refcoco"]}/refcoco+_feat.lmdb
  features_h5path2: ''
  train_annotations_jsonpath: ''
  val_annotations_jsonpath: ''
  max_seq_length: 10
  max_region_num: 6
  batch_size: 4
  eval_batch_size: 4
  train_split: train
  val_split: train
"""
    yml = os.path.join(tmp, "tasks_heads.yml")
    with open(yml, "w") as f:
        f.write(text)
    return dict(workdir, yml=yml)


@pytest.mark.parametrize("task,n", [("12", 6), ("10", 6)],
                         ids=["nlvr2", "refcoco+"])
def test_port_cli_writes_the_jax_task_records(task_workdir, task, n):
    """The port's eval CLI on an NLVR2 and a refcoco+ dataroot writes the
    records of the root eval_task.py's ``collect_results`` for the same
    weights."""
    w = task_workdir
    params, jax_results, jax_loss, jax_score = _jax_eval(w, task)
    weights = os.path.join(w["tmp"], f"port_weights_{task}.pt")
    torch.save(state_dict_from_flax(params), weights)
    summary = port_eval.main([
        "--config_file", w["model_cfg"], "--tasks_config_file", w["yml"],
        "--task", task, "--vocab_file", w["vocab"],
        "--from_pretrained", weights,
        "--output_dir", os.path.join(w["tmp"], f"port_results_{task}"),
        "--num_workers", "0", "--compute_dtype", "float32",
        "--device", "cpu"])
    with open(summary["out_file"]) as f:
        port_results = json.load(f)
    assert summary["out_file"].endswith("train_result.json")
    assert len(port_results) == summary["n"] == n
    keys = {"12": ["answer", "question_id"], "10": ["IOU", "id", "target"]}
    assert all(sorted(r) == keys[task] for r in port_results)
    # V-logit records carry a float IoU that JSON writes in full
    assert port_results == jax_results
    assert summary["nonfinite_batches"] == 0
    np.testing.assert_allclose(summary["loss"], jax_loss, rtol=1e-5)
    np.testing.assert_allclose(summary["score"], jax_score, rtol=1e-6)


def test_port_cli_random_init_is_seeded(workdir):
    base = ["--config_file", workdir["model_cfg"],
            "--tasks_config_file", workdir["yml"], "--task", "1",
            "--vocab_file", workdir["vocab"], "--num_workers", "0",
            "--device", "cpu", "--seed", "3"]
    a = port_eval.main(base + ["--output_dir",
                               os.path.join(workdir["tmp"], "r1")])
    b = port_eval.main(base + ["--output_dir",
                               os.path.join(workdir["tmp"], "r2")])
    assert a["loss"] == b["loss"]
    with open(a["out_file"]) as fa, open(b["out_file"]) as fb:
        assert json.load(fa) == json.load(fb)


def test_import_pulls_in_no_jax():
    code = ("import sys\n"
            "import volta_tpu_torch, volta_tpu_torch.eval_task, "
            "volta_tpu_torch.eval_step, volta_tpu_torch.convert, "
            "volta_tpu_torch.ops.attention_cuda\n"
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax'))\n"
            "assert not bad, bad\n"
            "from volta_tpu_torch.ops import _build\n"
            "assert _build.load.cache_info().currsize == 0  # nothing built\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_cuda_device_without_a_card_exits(workdir):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out_dir = os.path.join(workdir["tmp"], "cuda_results")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        port_eval.main([
            "--config_file", workdir["model_cfg"],
            "--tasks_config_file", workdir["yml"], "--task", "1",
            "--vocab_file", workdir["vocab"], "--output_dir", out_dir,
            "--num_workers", "0", "--device", "cuda"])
    assert not os.path.exists(out_dir)
