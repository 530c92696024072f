"""The port's train CLI (``python -m volta_tpu_torch.train_task``) on the
CPU, on the synthetic VQA fixtures: two epochs write the JAX CLI's val lines
and checkpoints, the port's eval CLI scores the best checkpoint exactly as
the last validation did, unported flags raise, and the port imports no
JAX."""

import os
import subprocess
import sys

import pytest

import fixtures
from volta_tpu import zoo
from volta_tpu_torch import eval_task as port_eval
from volta_tpu_torch import train_task as port_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("port_train"))
    ids = [10, 11, 12, 13]
    feat = fixtures.make_features_lmdb(tmp, ids, feature_size=32)
    fixtures.make_vqa_annotations(tmp, ids, n_questions=16, num_labels=9)
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
  lr: 0.001
""")
    base = ["--config_file", model_cfg, "--tasks_config_file", yml,
            "--task", "1", "--vocab_file", vocab, "--num_workers", "0",
            "--compute_dtype", "float32", "--device", "cpu"]
    return dict(tmp=tmp, base=base)


def test_two_epochs_validate_and_checkpoint(workdir):
    tmp = workdir["tmp"]
    out = port_train.main(workdir["base"] + [
        "--output_dir", os.path.join(tmp, "save"),
        "--logdir", os.path.join(tmp, "logs"), "--num_train_epochs", "2",
        "--clip_grad_norm", "1.0"])
    assert out["steps"] == 8  # 16 questions at batch 4, two epochs
    assert len(out["train_losses"]) == 8
    assert all(l == l and l < 1e4 for l in out["train_losses"])
    with open(os.path.join(out["log_dir"], "out.txt")) as f:
        lines = [l for l in f if " VAL epoch " in l]
    assert [l.split(" VAL ")[1].split()[:3] for l in lines] == [
        ["epoch", "0", "TASK1"], ["epoch", "1", "TASK1"]]
    assert len(out["val_scores"]) == 2
    for d in ("ckpt", "best"):
        assert os.path.isfile(os.path.join(out["run_dir"], d,
                                           "train_state.pt"))
    assert os.path.isfile(os.path.join(out["run_dir"], "command.txt"))

    # the eval CLI reads the best checkpoint and scores the val split as
    # the validation that chose it did (16 questions: no partial batch)
    summary = port_eval.main(workdir["base"] + [
        "--from_pretrained", os.path.join(out["run_dir"], "best"),
        "--output_dir", os.path.join(tmp, "results")])
    assert summary["n"] == 16
    assert summary["score"] == pytest.approx(out["best_score"], abs=1e-9)


TASK_YML = """TASK{task}:
  name: {name}
  type: {type}
  loss: {loss}
  process: {process}
  dataroot: {root}
  features_h5path1: {feat}
  features_h5path2: ''
  train_annotations_jsonpath: {ann}
  val_annotations_jsonpath: {ann}
  max_seq_length: 12
  max_region_num: 6
  batch_size: 4
  eval_batch_size: 4
  train_split: train
  val_split: {val}
  lr: 0.001
"""


@pytest.mark.parametrize("kind", ["nlvr2", "refcoco", "retrieval"])
def test_task_heads_train_validate_and_checkpoint(workdir, kind):
    """One epoch of the NLVR2, RefCOCO+ and Flickr30k-retrieval heads on
    dataroots of ``tools/make_synth_data.py``'s formats: the VAL line and
    the checkpoints; the eval CLI scores the best NLVR2 and RefCOCO+
    checkpoint as the validation that chose it did (retrieval's eval split
    is ``RetrievalDatasetVal``'s gallery, which ``eval_retrieval.py``
    reads)."""
    import argparse
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_synth_data", os.path.join(REPO, "tools", "make_synth_data.py"))
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    tmp = workdir["tmp"]
    root = os.path.join(tmp, kind)
    getattr(synth, f"gen_{kind}")(argparse.Namespace(
        out=root, images=4, boxes=5, feat_dim=32, seed=0, questions=8,
        refs_per_image=2, sentences=2))
    task, fields = {
        "nlvr2": ("12", dict(name="NLVR2", type="VL-binary-classifier",
                             loss="BCEWithLogitLoss", process="nlvr",
                             feat=f"{root}/features.lmdb", ann="''",
                             val="train")),
        "refcoco": ("10", dict(name="refcoco+", type="V-logit",
                               loss="BCEWithLogitLoss", process="normal",
                               feat=f"{root}/refcoco+_feat.lmdb", ann="''",
                               val="train")),
        "retrieval": ("8", dict(
            name="RetrievalFlickr30k", type="VL-logit",
            loss="CrossEntropyLoss", process="retrieval",
            feat=fixtures.make_features_lmdb(
                root, [1000000 + i for i in range(4)], feature_size=32),
            ann=f"{root}/all_data_final_test_set0_2014.jsonline",
            val="val"))}[kind]
    yml = os.path.join(root, "tasks.yml")
    with open(yml, "w") as f:
        f.write(TASK_YML.format(task=task, root=root, **fields))
    base = workdir["base"][:]
    base[base.index("--tasks_config_file") + 1] = yml
    base[base.index("--task") + 1] = task
    out = port_train.main(base + [
        "--output_dir", os.path.join(root, "save"),
        "--logdir", os.path.join(root, "logs"), "--num_train_epochs", "1"])
    assert out["steps"] == 2  # 8 items at batch 4
    assert all(l == l and l < 1e4 for l in out["train_losses"])
    with open(os.path.join(out["log_dir"], "out.txt")) as f:
        lines = [l for l in f if " VAL epoch " in l]
    assert [l.split(" VAL ")[1].split()[:3] for l in lines] == [
        ["epoch", "0", f"TASK{task}"]]
    for d in ("ckpt", "best"):
        assert os.path.isfile(os.path.join(out["run_dir"], d,
                                           "train_state.pt"))
    if kind == "retrieval":
        return
    summary = port_eval.main(base + [
        "--from_pretrained", os.path.join(out["run_dir"], "best"),
        "--output_dir", os.path.join(root, "results")])
    assert summary["n"] == 8
    assert summary["score"] == pytest.approx(out["best_score"], abs=1e-9)


@pytest.mark.parametrize("flag", [
    ["--device_store"], ["--gradient_accumulation_steps", "2"],
    ["--optim", "RAdam"], ["--optimizer_state_dtype", "bfloat16"],
    ["--skip_disconnected_params"], ["--profile_steps", "3"],
    ["--distributed"]], ids=lambda f: f[0].lstrip("-"))
def test_unported_flags_raise(workdir, flag):
    out_dir = os.path.join(workdir["tmp"], "refused")
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        port_train.main(workdir["base"] + ["--output_dir", out_dir] + flag)
    assert not os.path.exists(out_dir)


def test_jax_only_flags_do_not_exist(workdir):
    for flag in (["--no_pallas"], ["--prng_impl", "rbg"]):
        with pytest.raises(SystemExit):
            port_train.parse_args(workdir["base"] + flag)


def test_cuda_device_without_a_card_exits(workdir):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        port_train.main(workdir["base"][:-1] + ["cuda"])


def test_train_modules_import_no_jax():
    code = ("import sys\n"
            "import volta_tpu_torch.train_task, volta_tpu_torch.train_step, "
            "volta_tpu_torch.optimization, volta_tpu_torch.train_utils, "
            "volta_tpu_torch.task_utils, "
            "volta_tpu_torch.ops.attention_dropout_cuda\n"
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax'))\n"
            "assert not bad, bad\n"
            "from volta_tpu_torch.ops import _build\n"
            "assert _build.load.cache_info().currsize == 0  # nothing built\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
