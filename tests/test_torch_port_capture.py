"""Attention-map and hidden-state capture of the port against the JAX
package on the CPU.

``output_all_layers`` and ``output_probs`` (and the config's
``visualization``, which implies ``output_probs``) take the encoder's
general loop: every sublayer per stream, text queries then vision queries
over [text ‖ vision] keys (volta_tpu/models/encoder.py:208-358, 580-631).
On a 2-layer ctrl_uniter from one Flax init:

* the per-stream path equals the port's fused path (fp32, 1e-5), on the
  kernel route and the plain one, and under ``remat_ff`` its loss and
  gradients equal the plain step's bit for bit;
* ``extras`` (``all_t``, ``all_v`` after every sublayer; ``probs``, one
  (t_data, v_data) an attention sublayer with ``intra_attn``,
  ``inter_attn``, ``queries``, ``keys``) against JAX's ``VoltaModel``
  extras in eval mode, and in training mode with the keep bits of JAX's
  ``nn.Dropout`` draws fed in (fp32 rtol 1e-5);
* ``visualization: true`` trains and evaluates on the plain route (no
  kernel wrapper runs) with JAX's logits, and ``output_probs`` gives
  JAX's ``VoltaForVLTasks`` extras;
* ``--dump_attn``: the port's eval CLI writes the root CLI's npz keys and
  arrays for a VQA (``normal``) and an NLVR2 (``nlvr``) dataroot;
  ``process_row_index`` and ``dump_attn_maps`` equal the JAX package's
  for every process, ``expand`` among them.
"""

import argparse
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from test_torch_port_model import TASK_CFG, make_batch, small_cfg
from test_torch_port_plain_route import (KEYS, MASKS, _feed_bits,
                                         _flax_params, _jax_bernoulli_spy,
                                         _port, _torch_args, kernel_calls)  # noqa: F401
from volta_tpu import task_utils as jtu
from volta_tpu import zoo
from volta_tpu.models import VoltaForVLTasks as JaxVLTasks
from volta_tpu.models.model import VoltaModel as JaxVoltaModel
from volta_tpu_torch import VoltaForVLTasks
from volta_tpu_torch import eval_task as port_eval
from volta_tpu_torch import task_utils as ptu
from volta_tpu_torch.config import VoltaConfig
from volta_tpu_torch.convert import state_dict_from_flax
from volta_tpu_torch.models.layers import DropoutSeeds
from volta_tpu_torch.ops.attention import additive_mask

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)
DATA_KEYS = ("intra_attn", "inter_attn", "queries", "keys")


@pytest.fixture(scope="module")
def params():
    return _flax_params(small_cfg(), make_batch(0))[1]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _same_extras(got, want):
    assert len(got["all_t"]) == len(want["all_t"]) == 4
    for a, b in zip(got["all_t"] + got["all_v"],
                    want["all_t"] + want["all_v"]):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    _same_probs(got["probs"], want["probs"])


def _same_probs(got, want):
    assert len(got) == len(want) == 2
    for pairs in zip(got, want):
        for g, w in zip(*pairs):
            assert sorted(g) == sorted(w) == sorted(DATA_KEYS)
            for key in DATA_KEYS:
                assert g[key].shape == w[key].shape, key
                np.testing.assert_allclose(_np(g[key]), _np(w[key]), **TOL,
                                           err_msg=key)


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["kernels", "plain"])
def test_per_stream_path_equals_the_fused_path(params, use_pallas):
    batch = make_batch(2)
    model = _port(small_cfg(use_pallas=use_pallas), params).eval()
    args, masks = _torch_args(batch)
    with torch.no_grad():
        fused = model.bert(*args, *masks)
        streams = model.bert(*args, *masks, output_all_layers=True)
    assert len(fused) == 4 and len(streams) == 5
    for a, b in zip(fused, streams[:4]):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    np.testing.assert_allclose(_np(streams[4]["all_t"][-1]), _np(fused[0]),
                               **TOL)


def test_per_stream_remat_is_bit_equal(params):
    """The general loop under ``remat_ff``: the seed drawn outside the
    recomputed call, so the loss and every gradient equal the plain
    loop's."""
    batch = make_batch(3)
    args, masks = _torch_args(batch)
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(small_cfg(use_pallas=False),
                                  remat_ff=remat)
        model = _port(cfg, params).train()
        assert model.bert.encoder.remat is remat
        seq_t, seq_v, pt, pv, _ = model.bert(
            *args, *masks, seeds=DropoutSeeds(9), output_all_layers=True)
        loss = seq_t.square().mean() + seq_v.square().mean() + pt.sum()
        loss.backward()
        out.append((float(loss), {n: p.grad.clone()
                                  for n, p in model.named_parameters()
                                  if p.grad is not None}))
    (la, ga), (lb, gb) = out
    assert la == lb and set(ga) == set(gb)
    assert all(torch.equal(ga[n], gb[n]) for n in ga)


def _jax_extras(cfg, params, batch, deterministic=True, rngs=None):
    model = JaxVoltaModel(cfg)
    *_, extras = model.apply(
        {"params": params["bert"]},
        *[jnp.asarray(batch[k]) for k in KEYS],
        *[jnp.asarray(batch[k]) for k in MASKS],
        deterministic=deterministic, output_all_layers=True,
        output_probs=True, rngs=rngs)
    return extras


def test_capture_matches_jax_in_eval(params):
    batch = make_batch(3)
    cfg = small_cfg(use_pallas=False)
    want = _jax_extras(cfg, params, batch)
    model = _port(small_cfg(use_pallas=True), params).eval()
    args, masks = _torch_args(batch)
    with torch.no_grad():
        *_, got = model.bert(*args, *masks, output_all_layers=True,
                             output_probs=True)
    _same_extras(got, want)
    # every probability row sums to 1 over [text ‖ vision] keys
    for t_data, v_data in got["probs"]:
        for d in (t_data, v_data):
            rows = d["intra_attn"].sum(-1) + d["inter_attn"].sum(-1)
            np.testing.assert_allclose(rows.numpy(), 1.0, rtol=1e-5)


def test_capture_matches_jax_in_training_with_fed_bits(monkeypatch):
    batch = make_batch(4)
    cfg = dataclasses.replace(small_cfg(use_pallas=False),
                              hidden_dropout_prob=0.0)
    _, params = _flax_params(cfg, batch)
    bits = _jax_bernoulli_spy(monkeypatch)
    want = _jax_extras(cfg, params, batch, deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(3)})
    # the text queries' and the vision queries' draws, each sublayer
    assert [b.shape[2:] for b in bits] == [(8, 14), (6, 14)] * 2
    model = _port(cfg, params, dropout_prob=0.0).train()
    fed = _feed_bits(monkeypatch, bits)
    args, masks = _torch_args(batch)
    *_, got = model.bert(*args, *masks, seeds=DropoutSeeds(1),
                         output_all_layers=True, output_probs=True)
    assert fed == []
    _same_extras(got, want)


def test_visualization_runs_the_plain_route(params, kernel_calls):
    batch = make_batch(5)
    cfg = dataclasses.replace(small_cfg(use_pallas=True), visualization=True)
    jmodel = JaxVLTasks(cfg, TASK_CFG, ("TASK1",))
    ref, jextras = jmodel.apply(
        {"params": params}, *[jnp.asarray(batch[k]) for k in KEYS], "TASK1",
        *[jnp.asarray(batch[k]) for k in MASKS])
    model = _port(cfg, params).eval()
    args, masks = _torch_args(batch)
    with torch.no_grad():
        logits = model(*args, "TASK1", *masks)
        logits2, extras = model(*args, "TASK1", *masks, output_probs=True)
    assert isinstance(logits, torch.Tensor)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **TOL)
    assert torch.equal(logits, logits2)
    assert extras["all_t"] == [] and len(extras["probs"]) == 2
    _same_probs(extras["probs"], jextras["probs"])
    # a training step of the visualization config: the plain route too
    model.train()
    pred = model(*args, "TASK1", *masks, dropout_seed=2)
    pred.sum().backward()
    assert not any(kernel_calls.values())


@pytest.mark.parametrize("process", ["normal", "expand", "retrieval",
                                     "nlvr", "dialog"])
def test_row_index_and_dump_match_jax(tmp_path, process):
    import eval_task as jax_cli

    rng = np.random.RandomState(0)
    q = {"normal": (3, 5), "expand": (3, 4, 5), "retrieval": (3, 4, 5),
         "nlvr": (3, 5), "dialog": (3, 2, 4, 5)}[process]
    batch = {"question": rng.randint(0, 9, q),
             "features": rng.randn(3, 6, 8).astype(np.float32)}
    tc = {"process": process}
    got, want = ptu.process_row_index(tc, batch), \
        jtu.process_row_index(tc, batch)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    n = len(got["row_qid_index"])
    maps = [tuple({k: rng.rand(n, 2, 3, 4).astype(np.float32)
                   for k in DATA_KEYS} for _ in "tv") for _ in range(2)]
    maps[0][1]["inter_attn"] = None  # a flow the sublayer lacks
    qids = np.arange(3) + 100
    a = port_eval.dump_attn_maps(
        [tuple({k: None if v is None else torch.from_numpy(v)
                for k, v in d.items()} for d in pair) for pair in maps],
        qids, str(tmp_path / "port.npz"), row_index=got)
    b = jax_cli.dump_attn_maps(maps, qids, str(tmp_path / "jax.npz"),
                               row_index=want)
    assert a == b == 15
    with np.load(tmp_path / "port.npz") as p, \
            np.load(tmp_path / "jax.npz") as j:
        assert sorted(p.files) == sorted(j.files)
        for k in j.files:
            assert p[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)


@pytest.fixture(scope="module")
def dump_workdir(tmp_path_factory):
    """A VQA and an NLVR2 dataroot (tools/make_synth_data.py's formats) and
    a tiny ctrl_uniter config."""
    import importlib.util

    tmp = str(tmp_path_factory.mktemp("port_dump"))
    ids = [10, 11, 12]
    feat = fixtures.make_features_lmdb(tmp, ids, feature_size=32)
    fixtures.make_vqa_annotations(tmp, ids, n_questions=6, num_labels=9)
    vocab = fixtures.make_vocab(tmp)
    spec = importlib.util.spec_from_file_location(
        "make_synth_data", os.path.join(REPO, "tools", "make_synth_data.py"))
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    nlvr = os.path.join(tmp, "nlvr2")
    synth.gen_nlvr2(argparse.Namespace(out=nlvr, images=3, boxes=5,
                                       feat_dim=32, seed=0, questions=6))
    cfg = zoo.single_stream(
        "uniter", depth=2, hidden_size=64, num_attention_heads=4,
        intermediate_size=128, pooler_size=64, v_pooler_size=64,
        vocab_size=23, max_position_embeddings=64, v_feature_size=32,
        v_hidden_size=64, v_num_attention_heads=4, v_intermediate_size=128,
        clf_hidden_size=32)
    model_cfg = os.path.join(tmp, "model.json")
    with open(model_cfg, "w") as f:
        f.write(cfg.to_json_string())
    common = """  features_h5path2: ''
  train_annotations_jsonpath: ''
  val_annotations_jsonpath: ''
  max_region_num: 6
  batch_size: 4
  eval_batch_size: 4
  train_split: train
  val_split: train
"""
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
  max_seq_length: 12
{common}TASK12:
  name: NLVR2
  type: VL-binary-classifier
  num_labels: 2
  loss: BCEWithLogitLoss
  process: nlvr
  dataroot: {nlvr}
  features_h5path1: {nlvr}/features.lmdb
  max_seq_length: 14
{common}""")
    return dict(tmp=tmp, vocab=vocab, model_cfg=model_cfg, yml=yml, cfg=cfg)


@pytest.mark.parametrize("task", ["1", "12"], ids=["vqa", "nlvr2"])
def test_dump_attn_cli_matches_the_root_cli(dump_workdir, monkeypatch,
                                            task):
    """The root eval_task.py (its Flax init from PRNGKey(0) on the first
    batch) and the port's CLI on those weights write the same npz files:
    the same keys, float32 maps within 1e-5, the same ids and ``row_*``."""
    import eval_task as jax_cli

    w = dump_workdir
    argv = ["--config_file", w["model_cfg"], "--tasks_config_file", w["yml"],
            "--task", task, "--vocab_file", w["vocab"], "--num_workers", "0",
            "--compute_dtype", "float32", "--dump_attn", "2"]
    jax_dir, port_dir = (os.path.join(w["tmp"], f"{who}_{task}")
                         for who in ("jax", "port"))
    monkeypatch.setattr(sys, "argv", ["eval_task.py"] + argv +
                        ["--output_dir", jax_dir])
    jax_cli.main()

    # the root CLI's weights: its init, replayed
    args = argparse.Namespace(bert_model="bert-base-uncased",
                              do_lower_case=True, vocab_file=w["vocab"],
                              split="", in_memory=False, num_workers=0,
                              batch_size=64)
    task_cfg = jtu.load_task_config(w["yml"])
    key = "TASK" + task
    data = jtu.load_dataset_eval(args, w["cfg"], task_cfg, task)
    inputs, _ = jtu.process_batch(task_cfg[key], next(iter(data["loader"])))
    variables = jax.jit(lambda r: JaxVLTasks(
        w["cfg"], task_cfg, (key,)).init(
        r, np.asarray(inputs["input_ids"]), np.asarray(inputs["image_feat"]),
        np.asarray(inputs["image_loc"]), key,
        np.asarray(inputs["token_type_ids"]),
        np.asarray(inputs["attention_mask"]),
        np.asarray(inputs["image_attention_mask"])))(jax.random.PRNGKey(0))
    weights = os.path.join(w["tmp"], f"weights_{task}.pt")
    torch.save(state_dict_from_flax(variables["params"]), weights)
    port_eval.main(argv + ["--output_dir", port_dir, "--device", "cpu",
                           "--from_pretrained", weights])

    names = sorted(f for f in os.listdir(jax_dir) if f.endswith(".npz"))
    assert names == ["attn_train_0.npz", "attn_train_1.npz"]
    assert sorted(f for f in os.listdir(port_dir)
                  if f.endswith(".npz")) == names
    rows = {"1": ["row_qid_index"], "12": ["row_option", "row_qid_index"]}
    for name in names:
        with np.load(os.path.join(port_dir, name)) as p, \
                np.load(os.path.join(jax_dir, name)) as j:
            assert sorted(p.files) == sorted(j.files)
            assert sorted(k for k in j.files if k.startswith("row_")) == \
                rows[task]
            assert len([k for k in j.files if k.startswith("s")]) == 16
            for k in j.files:
                assert p[k].dtype == j[k].dtype and \
                    p[k].shape == j[k].shape, k
                if k.startswith("s"):
                    np.testing.assert_allclose(p[k], j[k], **TOL,
                                               err_msg=k)
                else:
                    np.testing.assert_array_equal(p[k], j[k], err_msg=k)


def test_visualization_config_builds():
    """The port no longer refuses ``visualization``."""
    cfg = VoltaConfig.from_dict(dataclasses.replace(
        small_cfg(), visualization=True).to_dict())
    model = VoltaForVLTasks(cfg, TASK_CFG, ("TASK1",))
    enc = model.bert.encoder
    b = make_batch(1)
    t = torch.randn(3, 8, 64)
    v = torch.randn(3, 6, 64)
    with torch.no_grad():
        out = enc.eval()(t, v, additive_mask(torch.from_numpy(
            b["input_mask"])), additive_mask(torch.from_numpy(
                b["image_mask"])), output_probs=True)
    assert len(out) == 3 and len(out[2][2]) == 2
