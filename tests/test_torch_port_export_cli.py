"""The port's export CLI (``python -m volta_tpu_torch.tools.export_model``)
and its artifacts in a fresh process, on the CPU.

- The CLI end to end on the tiny config of tests/test_export.py (JAX's
  tests/test_export.py:91): a portable artifact with ``--check`` and
  ``--bench``, which holds no weights, and a baked one, which holds them; ``--use_pallas`` without ``--platforms`` (absent, or an
  empty list) pins ``cuda``, as JAX's pins ``tpu`` (:136), and its
  ``--check`` runs the kernels' twins on CPU tensors; ``int8_static`` with
  random and with ``--calib_npz`` calibration prints the deviation from
  the float forward.
- A subprocess loads and calls each artifact with ``torch.export.load``:
  a portable one with nothing of ``volta_tpu_torch`` imported, a kernel
  one (bf16 and int8) with ``volta_tpu_torch.ops.library`` imported and
  nothing of ``volta_tpu_torch.models``; the logits equal the live
  forward's to the bit (one CPU thread in both processes).
- The eager eval forward and train step, with every kernel flag, call no
  registered op, with ``ops.library`` imported: a dispatch mode sees no
  ``volta::`` op.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_export import TASK_CFG, _tiny_cfg
from volta_tpu_torch import VoltaForVLTasks
from volta_tpu_torch import export as pexport
from volta_tpu_torch.config import VoltaConfig
from volta_tpu_torch.models.layers import init_weights
from volta_tpu_torch.ops import in_kernel_export
from volta_tpu_torch.ops import int8_dense as pint8
from volta_tpu_torch.tools import export_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, R = 10, 7


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("export_cli")
    cfg_path = str(tmp / "model.json")
    with open(cfg_path, "w") as f:
        f.write(_tiny_cfg().to_json_string())
    yml = str(tmp / "tasks.yml")
    with open(yml, "w") as f:
        f.write(f"""
TASK1:
  name: VQA
  type: VL-classifier
  num_labels: 9
  loss: BCEWithLogitLoss
  process: normal
  task_id: 1
  dataroot: {tmp}
  features_h5path1: ''
  features_h5path2: ''
  train_annotations_jsonpath: ''
  val_annotations_jsonpath: ''
  max_seq_length: {L}
  max_region_num: {R}
  batch_size: 4
  train_split: train
  val_split: val
  lr: 0.0001
  num_epoch: 1
""")
    base = ["--config_file", cfg_path, "--tasks_config_file", yml,
            "--task", "1", "--device", "cpu", "--compute_dtype", "float32"]
    return dict(tmp=tmp, base=base, cfg=cfg_path)


def test_export_cli(files, capsys):
    out_path = str(files["tmp"] / "m.pt2")
    out = export_model.main(files["base"] + [
        "--out", out_path, "--batch_size", "4", "--check", "--bench", "2"])
    assert os.path.getsize(out_path) > 1000
    assert out["exported"].platforms == ("cpu",)
    assert out["check"]["shape"] == (4, 9)
    assert out["bench"] > 0 and out["export_s"] > 0 and out["load_s"] > 0
    text = capsys.readouterr().out
    assert "check OK: output (4, 9)" in text and "samples/sec" in text
    # the parameterized file holds no weights (nor the example inputs it
    # was traced with); the baked one holds them all
    baked_path = str(files["tmp"] / "baked.pt2")
    baked = export_model.main(files["base"] + [
        "--out", baked_path, "--batch_size", "4", "--bake_weights",
        "--check"])
    assert baked["params"] is None and baked["check"]["shape"] == (4, 9)
    weights = sum(t.numel() * t.element_size()
                  for t in out["model"].state_dict().values())
    assert os.path.getsize(baked_path) - os.path.getsize(out_path) > \
        0.9 * weights
    assert pexport.load_exported(out_path).program.example_inputs is None


@pytest.mark.parametrize("platform_args", [[], ["--platforms"]],
                         ids=["absent", "empty"])
def test_export_cli_use_pallas_pins_cuda(files, platform_args):
    out_path = str(files["tmp"] / "k.pt2")
    out = export_model.main(files["base"] + [
        "--out", out_path, "--batch_size", "b", "--use_pallas",
        "--check"] + platform_args)
    assert out["exported"].platforms == ("cuda",)
    assert pexport.load_exported(out_path).platforms == ("cuda",)
    assert out["check"]["shape"] == (2, 9)


def test_export_cli_int8_static(files, capsys):
    out = export_model.main(files["base"] + [
        "--out", str(files["tmp"] / "q.pt2"), "--batch_size", "4",
        "--use_pallas", "--quantize", "int8_static", "--check"])
    assert 0 < out["check"]["max_dlogit"] < 1.0
    assert 0.0 <= out["check"]["top1"] <= 1.0
    assert "calibrated" in capsys.readouterr().out
    # real batches from an npz: the last one held out for the check
    rng = np.random.RandomState(0)
    npz = str(files["tmp"] / "calib.npz")
    rg = R + 1  # the model-facing regions: the global row added
    np.savez(npz, input_ids=rng.randint(1, 23, (3, 4, L)).astype(np.int32),
             image_feat=rng.randn(3, 4, rg, 32).astype(np.float32),
             image_loc=rng.rand(3, 4, rg, 5).astype(np.float32),
             token_type_ids=np.zeros((3, 4, L), np.int32),
             attention_mask=np.ones((3, 4, L), np.int32),
             image_attention_mask=np.ones((3, 4, rg), np.int32))
    out = export_model.main(files["base"] + [
        "--out", str(files["tmp"] / "q2.pt2"), "--batch_size", "4",
        "--quantize", "int8_static", "--calib_npz", npz, "--check"])
    assert "calibrating on 3 real batches" in capsys.readouterr().out
    assert out["check"]["max_dlogit"] < 1.0
    with pytest.raises(SystemExit, match="missing"):
        np.savez(npz, input_ids=np.zeros((1, 4, L), np.int32))
        export_model.main(files["base"] + [
            "--out", str(files["tmp"] / "q3.pt2"), "--quantize",
            "int8_static", "--calib_npz", npz])


LOADER = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
if {kernels}:
    import volta_tpu_torch.ops.library
path, params_path, batch_path, want_path = sys.argv[1:5]
params = torch.load(params_path, weights_only=False)
batch = [torch.from_numpy(a) for a in np.load(batch_path).values()]
program = torch.export.load(path)
with torch.no_grad():
    got = program.module()(params, *batch)
assert torch.equal(got, torch.load(want_path)), "logits differ"
mods = sorted(m for m in sys.modules if m.startswith("volta"))
print(mods)
"""


@pytest.mark.parametrize("kind", ["portable", "kernels", "int8"])
def test_artifact_loads_without_the_model_code(files, kind):
    cfg = VoltaConfig.from_json_file(files["cfg"])
    cfg.compute_dtype = "float32" if kind == "portable" else "bfloat16"
    cfg.use_pallas = kind != "portable"
    model = VoltaForVLTasks(cfg, TASK_CFG, ("TASK1",))
    init_weights(model, torch.Generator().manual_seed(3))
    model.eval()
    quantize = "int8" if kind == "int8" else None
    exp = pexport.export_task_forward(
        cfg, TASK_CFG, "TASK1", model.state_dict(), "b", L, R,
        platforms=None if kind == "portable" else ("cuda",),
        quantize=quantize)
    tmp = files["tmp"]
    path = str(tmp / f"{kind}.pt2")
    pexport.save_exported(exp, path)
    params = model.state_dict() if quantize is None else \
        pint8.quantize_variables(
            model, residual_dtype=pexport.quantize_residual_dtype(cfg))
    rng = np.random.RandomState(1)
    batch = [torch.from_numpy(rng.randint(1, 23, (3, L)).astype(np.int32)),
             torch.from_numpy(rng.randn(3, R, 32).astype(np.float32)),
             torch.from_numpy(rng.rand(3, R, 5).astype(np.float32)),
             torch.zeros(3, L, dtype=torch.int32),
             torch.ones(3, L, dtype=torch.int32),
             torch.ones(3, R, dtype=torch.int32)]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            want = pint8.apply_quantized(
                model, params, batch[0], batch[1], batch[2], "TASK1",
                *batch[3:]) if quantize else model(
                batch[0], batch[1], batch[2], "TASK1", *batch[3:])
    finally:
        torch.set_num_threads(n)
    torch.save(params, str(tmp / f"{kind}_params.pt"))
    np.savez(str(tmp / f"{kind}_batch.npz"),
             *[b.numpy() for b in batch])
    torch.save(want, str(tmp / f"{kind}_want.pt"))
    code = LOADER.format(kernels=kind != "portable")
    proc = subprocess.run(
        [sys.executable, "-c", code, path, str(tmp / f"{kind}_params.pt"),
         str(tmp / f"{kind}_batch.npz"), str(tmp / f"{kind}_want.pt")],
        cwd=str(tmp), env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    mods = eval(proc.stdout.strip().splitlines()[-1])
    if kind == "portable":
        assert mods == []
    else:
        assert "volta_tpu_torch.ops.library" in mods
        assert not [m for m in mods if m.startswith("volta_tpu_torch.models")
                    or m.startswith("volta_tpu.")], mods


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(func.name())
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("flags", [
    {}, {"attn_natural_layout": False},
    {"use_pallas_layernorm": True, "use_fused_residual_ln": True}],
    ids=["natural", "head_major", "ln_flags"])
def test_eager_paths_call_no_registered_op(flags):
    import volta_tpu_torch.ops.library  # noqa: F401 (the ops registered)
    from volta_tpu_torch.optimization import build_optimizer
    from volta_tpu_torch.train_step import create_train_state, \
        make_task_train_step

    cfg = VoltaConfig.from_dict(dict(_tiny_cfg().to_dict(), use_pallas=True,
                                     **flags))
    tc = {"TASK1": dict(TASK_CFG["TASK1"], process="normal",
                        loss="BCEWithLogitLoss")}
    model = VoltaForVLTasks(cfg, tc, ("TASK1",))
    init_weights(model, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    batch = {"question": rng.randint(1, 23, (4, L)).astype(np.int32),
             "features": rng.randn(4, R, 32).astype(np.float32),
             "spatials": rng.rand(4, R, 5).astype(np.float32),
             "segment_ids": np.zeros((4, L), np.int32),
             "input_mask": np.ones((4, L), np.int32),
             "image_mask": np.ones((4, R), np.int32),
             "target": np.eye(9, dtype=np.float32)[[0, 3, 5, 8]]}
    opt = build_optimizer("adamw", 1e-4, model)
    state = create_train_state(model, opt, seed=1)
    step = make_task_train_step(model, opt, tc, "TASK1")
    mode = _Ops()
    with mode:
        assert not in_kernel_export()
        model.train()
        step(state, batch)
        model.eval()
        t = [torch.from_numpy(batch[k]) for k in (
            "question", "features", "spatials", "segment_ids", "input_mask",
            "image_mask")]
        with torch.inference_mode():
            model(t[0], t[1], t[2], "TASK1", *t[3:])
    assert mode.names and not [n for n in mode.names
                               if n.startswith("volta::")]
