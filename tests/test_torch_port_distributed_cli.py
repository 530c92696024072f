"""``--distributed`` in the port's train CLIs on the CPU: ``torchrun
--standalone`` starts the ranks, which join a gloo group
(``parallel.init_distributed``).

* ``train_task`` on two ranks at tests/test_torch_port_train_cli.py's tiny
  VQA size: one epoch of the global batch (4 steps of 2 + 2 rows), the same
  losses and validation score on both ranks, rank 0 alone logging and
  writing (one VAL line in ``out.txt``, ``command.txt``, ``ckpt/`` and
  ``best/``), and a one-process run resuming from its ``train_state.pt``;
* ``python -m volta_tpu_torch.train_concap --distributed`` on one rank at
  tests/test_torch_port_concap.py's size: its checkpoint equal to the bit
  to the run without ``--distributed`` (every collective of one rank is
  exact), one thread on both sides.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from test_torch_port_concap import _NS, REG, SEQ
from test_torch_port_train_cli import workdir  # noqa: F401 (fixture)
from volta_tpu import zoo
from volta_tpu_torch import train_concap
from volta_tpu_torch import train_task as port_train

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def torchrun(nproc, args, cwd):
    """``torchrun --standalone --nproc_per_node nproc <args>``; returns
    its stdout after asserting it exited 0."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")]
                             if p]))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(nproc)] + args, cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    return proc.stdout


def test_train_task_distributed_runs_under_torchrun(workdir):  # noqa: F811
    tmp = workdir["tmp"]
    save, logs = os.path.join(tmp, "dp_save"), os.path.join(tmp, "dp_logs")
    out = os.path.join(tmp, "dp_result")
    argv = workdir["base"] + ["--distributed", "--output_dir", save,
                              "--logdir", logs, "--num_train_epochs", "1",
                              "--clip_grad_norm", "1.0"]
    stdout = torchrun(2, [os.path.join(HERE, "_torch_dp_cli.py"),
                          "train_task", out] + argv, tmp)
    r0, r1 = (json.load(open(f"{out}_{r}.json")) for r in (0, 1))
    assert r0["steps"] == r1["steps"] == 4  # 16 questions, global batch 4
    assert r0["train_losses"] == r1["train_losses"]
    assert len(r0["val_scores"]) == 1
    assert r0["val_scores"] == r1["val_scores"]
    assert r0["best_score"] == r1["best_score"]
    assert stdout.count(" VAL epoch 0 TASK1 ") == 1  # rank 0 alone prints
    (run,) = os.listdir(save)
    with open(os.path.join(logs, run, "out.txt")) as f:
        assert sum(" VAL epoch " in line for line in f) == 1
    for name in ("command.txt", os.path.join("ckpt", "train_state.pt"),
                 os.path.join("best", "train_state.pt")):
        assert os.path.isfile(os.path.join(save, run, name)), name
    saved = torch.load(os.path.join(save, run, "ckpt", "train_state.pt"),
                       weights_only=True)
    assert saved["step"] == 4 and saved["epoch"] == 0

    # one process resumes the distributed run's checkpoint and trains its
    # second epoch
    again = port_train.main(workdir["base"] + [
        "--output_dir", save, "--logdir", logs, "--num_train_epochs", "2",
        "--clip_grad_norm", "1.0"])
    assert again["steps"] == 8 and len(again["val_scores"]) == 1


@pytest.fixture
def concap_cli(tmp_path):
    tmp = str(tmp_path)
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
    return tmp, ["--config_file", model_cfg, "--annotations_path", ann,
                 "--features_path", feats, "--vocab_file", vocab,
                 "--train_batch_size", "4", "--max_seq_length", str(SEQ),
                 "--max_region_num", str(REG), "--num_workers", "0",
                 "--compute_dtype", "float32", "--objective", "1",
                 "--clip_grad_norm", "5.0", "--num_train_epochs", "1",
                 "--device", "cpu"]


def test_train_concap_distributed_at_world_size_1(concap_cli):
    tmp, base = concap_cli

    def run_dir(out):
        return os.path.join(tmp, out, "model.json-pretrained")

    stdout = torchrun(1, ["-m", "volta_tpu_torch.train_concap",
                          "--distributed", "--output_dir",
                          os.path.join(tmp, "dp"), "--logdir",
                          os.path.join(tmp, "dp_logs")] + base, tmp)
    assert " CC masked_t " in stdout
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = train_concap.main(base + [
            "--output_dir", os.path.join(tmp, "one"), "--logdir",
            os.path.join(tmp, "one_logs")])
    finally:
        torch.set_num_threads(threads)
    assert out["run_dir"] == run_dir("one") and out["steps"] == 4
    dp, one = (torch.load(os.path.join(run_dir(d), "ckpt",
                                       "train_state.pt"), weights_only=True)
               for d in ("dp", "one"))
    assert dp["step"] == one["step"] == 4
    for k, v in one["model"].items():
        assert torch.equal(dp["model"][k], v), k
    for key in ("mu", "nu"):
        for k, v in one["optimizer"][key].items():
            assert torch.equal(dp["optimizer"][key][k], v), (key, k)
