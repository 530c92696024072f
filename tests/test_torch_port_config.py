"""The port's own config against the JAX package's, and the port's
independence from the JAX package.

Every ``configs/*.json`` loads into ``volta_tpu_torch.config.VoltaConfig``
with the same field dict and the same ``sublayer_plan()`` as
``volta_tpu.config.VoltaConfig`` (compared exactly: both are plain Python
values). A subprocess imports the port and runs its eval CLI on the CPU over
the synthetic VQA fixtures with the LayerNorm flags on (config, data layer,
model and the LayerNorm twins); afterwards no ``volta_tpu``, ``jax``,
``jaxlib`` or ``flax`` module is loaded. Another writes ``chip_smoke.py``'s
synthetic VQA dataroot, with the same check, and holds it byte-equal to
``tools/make_synth_data.py``'s.
"""

import dataclasses
import glob
import json
import os
import subprocess
import sys

import pytest

import fixtures
from volta_tpu import zoo
from volta_tpu.config import VoltaConfig as JaxConfig
from volta_tpu_torch.config import VoltaConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.json")))


def test_the_repo_has_eight_configs():
    assert len(CONFIGS) == 8


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_loads_as_the_jax_one(path):
    port = VoltaConfig.from_json_file(path)
    ref = JaxConfig.from_json_file(path)
    assert port.to_dict() == ref.to_dict()
    assert port.to_json_string() == ref.to_json_string()
    assert [dataclasses.asdict(s) for s in port.sublayer_plan()] == \
        [dataclasses.asdict(s) for s in ref.sublayer_plan()]
    assert port.depth == ref.depth
    # every field, with the JAX defaults
    assert [(f.name, f.default if f.default is not dataclasses.MISSING
             else f.default_factory())
            for f in dataclasses.fields(VoltaConfig)] == \
        [(f.name, f.default if f.default is not dataclasses.MISSING
          else f.default_factory()) for f in dataclasses.fields(JaxConfig)]


def test_port_runs_without_the_jax_package(tmp_path):
    tmp = str(tmp_path)
    ids = [10, 11, 12]
    feat = fixtures.make_features_lmdb(tmp, ids, feature_size=32)
    fixtures.make_vqa_annotations(tmp, ids, n_questions=6, num_labels=9)
    vocab = fixtures.make_vocab(tmp)
    cfg = zoo.single_stream(
        "uniter", depth=1, hidden_size=64, num_attention_heads=4,
        intermediate_size=128, pooler_size=64, v_pooler_size=64,
        vocab_size=23, max_position_embeddings=64, v_feature_size=32,
        v_hidden_size=64, v_num_attention_heads=4, v_intermediate_size=128,
        clf_hidden_size=32, use_pallas_layernorm=True,
        use_fused_residual_ln=True)
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
  batch_size: 3
  eval_batch_size: 3
  train_split: train
  val_split: train
""")
    argv = ["--config_file", model_cfg, "--tasks_config_file", yml,
            "--task", "1", "--vocab_file", vocab, "--output_dir",
            os.path.join(tmp, "out"), "--num_workers", "0",
            "--device", "cpu"]
    code = ("import json, sys\n"
            "from volta_tpu_torch import eval_task\n"
            f"summary = eval_task.main({argv!r})\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('volta_tpu', 'jax', 'jaxlib', 'flax'))\n"
            "print(json.dumps({'n': summary['n'], 'bad': bad}))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"n": 6, "bad": []}


def test_smoke_dataroot_is_the_synth_tool_s_without_the_jax_package(
        tmp_path):
    """chip_smoke.py writes its synthetic VQA dataroot itself, through the
    port's LMDB writer, with no JAX package loaded; at a small size its
    files are byte-equal to ``tools/make_synth_data.py vqa``'s, which writes
    through the JAX package's writer."""
    sizes = dict(images=5, questions=40, boxes=3, feat_dim=8, num_labels=7,
                 seed=3)
    port_dir, tool_dir = str(tmp_path / "port"), str(tmp_path / "tool")
    code = ("import json, sys\n"
            "import chip_smoke\n"
            f"chip_smoke.write_synth_vqa({port_dir!r}, **{sizes!r})\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('volta_tpu', 'jax', 'jaxlib', 'flax'))\n"
            "print(json.dumps({'bad': bad}))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"bad": []}

    args = [a for k, v in sizes.items() for a in (f"--{k}", str(v))]
    subprocess.run([sys.executable,
                    os.path.join(REPO, "tools", "make_synth_data.py"), "vqa",
                    "--out", tool_dir, *args], check=True, cwd=REPO, env=env,
                   capture_output=True, timeout=300)

    def tree(root):
        out = {}
        for d, _, files in os.walk(root):
            for name in files:
                path = os.path.join(d, name)
                with open(path, "rb") as f:
                    out[os.path.relpath(path, root)] = f.read()
        return out

    port, tool = tree(port_dir), tree(tool_dir)
    assert sorted(port) == sorted(tool)
    assert "features.lmdb" in port and "vocab.txt" in port
    for name in sorted(tool):
        assert port[name] == tool[name], name
