"""The rest of the port's train CLI against the JAX package on the CPU:
gradient accumulation, freezing, ``embed_clf`` and the device store.

* ``build_optimizer(grad_accum_steps=K)`` against optax's ``MultiSteps``
  around clip -> AdamW (volta_tpu/optimization.py:363-364) on the same
  gradients, fp32 rtol 1e-6 as tests/test_torch_port_optim.py, K 2 and 3:
  the parameters untouched between updates, one schedule tick an update,
  and a resume from ``state_dict`` between two micro-steps bit-equal to the
  uninterrupted run;
* ``train_utils.apply_freeze`` against the JAX package's with weight decay:
  the frozen gradient zeroed ahead of the chain, so a frozen parameter
  still moves by its decay; ``freeze_mask`` against JAX's on every
  parameter of a small model;
* ``init_classifier_from_answers`` against JAX's: the answers' mean word
  embeddings in ``dense2``, and both warnings' no-ops;
* ``materialize_store_batch`` against JAX's (the max over repeated labels
  among them) and against the dense batch, for VQA and NLVR2 (its [b, 2]
  rows);
* the train CLI with ``--device_store`` gives the dense run's losses, with
  ``--gradient_accumulation_steps 2`` counts micro-steps and updates as
  JAX's, and with a config's ``fixed_layers`` leaves the frozen
  parameters where their decay takes them.
"""

import argparse
import dataclasses
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import fixtures
from test_torch_port_model import TASK_CFG, make_batch, small_cfg
from test_torch_port_optim import _Toy
from test_torch_port_plain_route import _flax_params, _port
from volta_tpu import train_utils as jtu_train
from volta_tpu import zoo
from volta_tpu.optimization import SCHEDULES as JAX_SCHEDULES
from volta_tpu.optimization import build_optimizer as jax_build_optimizer
from volta_tpu.parallel.train_step import \
    materialize_store_batch as jax_materialize
from volta_tpu_torch import VoltaForVLTasks
from volta_tpu_torch import optimization as topt
from volta_tpu_torch import train_task as port_train
from volta_tpu_torch import train_utils as ptu_train
from volta_tpu_torch.config import VoltaConfig
from volta_tpu_torch.convert import load_flax_params
from volta_tpu_torch.task_utils import load_dataset, load_task_config, \
    make_tokenizer
from volta_tpu_torch.train_step import materialize_store_batch, \
    store_to_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-6, atol=1e-7)


def _toy_init(seed=0):
    rng = np.random.RandomState(seed)
    init = {"dense": {"kernel": rng.randn(6, 5).astype(np.float32),
                      "bias": rng.randn(5).astype(np.float32)},
            "out_ln": {"scale": rng.randn(5).astype(np.float32),
                       "bias": rng.randn(5).astype(np.float32)}}
    toy = _Toy()
    with torch.no_grad():
        toy.dense.weight.copy_(torch.from_numpy(init["dense"]["kernel"].T))
        toy.dense.bias.copy_(torch.from_numpy(init["dense"]["bias"]))
        toy.out_ln.weight.copy_(torch.from_numpy(init["out_ln"]["scale"]))
        toy.out_ln.bias.copy_(torch.from_numpy(init["out_ln"]["bias"]))
    return toy, init


def _set_grads(toy, grads):
    toy.dense.weight.grad = torch.from_numpy(grads["dense"]["kernel"].T
                                             .copy())
    toy.dense.bias.grad = torch.from_numpy(grads["dense"]["bias"])
    toy.out_ln.weight.grad = torch.from_numpy(grads["out_ln"]["scale"])
    toy.out_ln.bias.grad = torch.from_numpy(grads["out_ln"]["bias"])


def _toy_params(toy):
    return {"dense": {"kernel": toy.dense.weight.detach().numpy().T,
                      "bias": toy.dense.bias.detach().numpy()},
            "out_ln": {"scale": toy.out_ln.weight.detach().numpy(),
                       "bias": toy.out_ln.bias.detach().numpy()}}


def _close_trees(got, want, **tol):
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _grad_stream(init, n, seed=1):
    rng = np.random.RandomState(seed)
    return [jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32)
                         * 3, init) for _ in range(n)]


def _jax_run(tx, init, grads):
    params = jax.tree.map(jnp.asarray, init)
    state = tx.init(params)
    trail = []
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, upd)
        trail.append(jax.tree.map(np.asarray, params))
    return trail


OPT_KW = dict(weight_decay=0.5, clip_norm=1.0, betas=(0.9, 0.98), eps=1e-6)


@pytest.mark.parametrize("k", [2, 3])
def test_accumulation_matches_optax_multisteps(k):
    toy, init = _toy_init()
    grads = _grad_stream(init, 4 * k)
    sched = (2, 4 * k)
    trail = _jax_run(jax_build_optimizer(
        "adamw", JAX_SCHEDULES["warmup_linear"](1e-2, *sched), init,
        grad_accum_steps=k, **OPT_KW), init, grads)
    opt = topt.build_optimizer(
        "adamw", topt.SCHEDULES["warmup_linear"](1e-2, *sched), toy,
        grad_accum_steps=k, **OPT_KW)
    before = _toy_params(toy)
    for i, g in enumerate(grads):
        _set_grads(toy, g)
        opt.step()
        opt.zero_grad()
        assert opt.count == (i + 1) // k and opt.mini_step == (i + 1) % k
        got = _toy_params(toy)
        _close_trees(got, trail[i], **TOL)
        if (i + 1) % k:
            # between updates the parameters do not move
            _close_trees(got, before, rtol=0, atol=0)
        before = got
    assert opt.count == 4


def test_accumulation_resumes_between_micro_steps():
    """A state saved after 3 micro-steps of K 2 (one update, one gradient
    in the running mean) and loaded into a fresh optimizer continues
    bit-equal to the uninterrupted run."""
    grads = _grad_stream(_toy_init()[1], 8, seed=4)
    runs = []
    for stop in (None, 3):
        toy, _ = _toy_init()
        opt = topt.build_optimizer("adamw", 1e-2, toy, grad_accum_steps=2,
                                   **OPT_KW)
        for i, g in enumerate(grads):
            if i == stop:
                saved = {k: (v.copy() if isinstance(v, dict) else v)
                         for k, v in opt.state_dict().items()}
                weights = {n: p.detach().clone()
                           for n, p in toy.named_parameters()}
                assert saved["mini_step"] == 1 and saved["count"] == 1
                toy, _ = _toy_init(seed=9)  # other weights, then restored
                with torch.no_grad():
                    for n, p in toy.named_parameters():
                        p.copy_(weights[n])
                opt = topt.build_optimizer("adamw", 1e-2, toy,
                                           grad_accum_steps=2, **OPT_KW)
                opt.load_state_dict(saved)
            _set_grads(toy, g)
            opt.step()
            opt.zero_grad()
        runs.append((opt.state_dict(), _toy_params(toy)))
    (sa, pa), (sb, pb) = runs
    _close_trees(pa, pb, rtol=0, atol=0)
    assert sa["count"] == sb["count"] == 4
    for n in sa["acc"]:
        assert torch.equal(sa["mu"][n], sb["mu"][n])
        assert torch.equal(sa["acc"][n], sb["acc"][n])


@pytest.mark.parametrize("k", [1, 2])
def test_freezing_matches_apply_freeze_with_decay(k):
    """``fixed_layers: ["dense"]``: the dense layer's gradient is zeroed
    ahead of the chain, so it moves by AdamW's decay term (and the
    momentum it has); the LayerNorm trains."""
    toy, init = _toy_init()
    grads = _grad_stream(init, 4 * k, seed=2)
    tx = jax_build_optimizer("adamw", 1e-2, init, grad_accum_steps=k,
                             **OPT_KW)
    tx = jtu_train.apply_freeze(tx, init, ["dense"])
    trail = _jax_run(tx, init, grads)
    opt = ptu_train.apply_freeze(
        topt.build_optimizer("adamw", 1e-2, toy, grad_accum_steps=k,
                             **OPT_KW), toy, ["dense"])
    assert opt.frozen == {0, 1}  # dense.weight, dense.bias
    for g in grads:
        _set_grads(toy, g)
        opt.step()
        opt.zero_grad()
    got = _toy_params(toy)
    _close_trees(got, trail[-1], **TOL)
    # the kernel decayed and nothing else: (1 - lr wd) per update, with
    # the gradient zero from the start its momentum stays zero
    np.testing.assert_allclose(got["dense"]["kernel"],
                               init["dense"]["kernel"] * (1 - 5e-3) ** 4,
                               rtol=1e-6)
    np.testing.assert_array_equal(got["dense"]["bias"], init["dense"]["bias"])
    assert not np.allclose(got["out_ln"]["scale"], init["out_ln"]["scale"])


def test_freeze_mask_matches_jax_on_every_parameter():
    cfg = small_cfg()
    params = _flax_params(cfg, make_batch(0))[1]
    model = _port(cfg, params)
    fixed = ["embeddings", "attn_0", "ff_3.out"]
    leaf = {"kernel": "weight", "scale": "weight", "embedding": "weight",
            "bias": "bias"}
    ref = {}
    for path, val in jax.tree_util.tree_flatten_with_path(
            jtu_train.freeze_mask(params, fixed))[0]:
        names = [p.key for p in path]
        ref[".".join(names[:-1] + [leaf[names[-1]]])] = bool(val)
    got = ptu_train.freeze_mask(model, fixed)
    assert got == ref
    assert 0 < sum(not v for v in got.values()) < len(got)
    assert ptu_train.freeze_mask(model, []) == dict.fromkeys(got, True)


class _Answers:
    """The two attributes ``init_classifier_from_answers`` reads."""

    def __init__(self, tokenizer):
        self._tokenizer = tokenizer
        self.ans2label = {"red ball": 0, "dog": 1, "": 2, "two cats": 3,
                          "man": 4, "zzzz": 5}


def test_embed_clf_matches_jax(tmp_path, caplog):
    tok = make_tokenizer("bert-base-uncased", True,
                         fixtures.make_vocab(str(tmp_path)))
    tc = {"TASK1": dict(TASK_CFG["TASK1"], num_labels=6)}
    # the classifier as wide as the text: clf_hidden_size = hidden_size
    cfg = dataclasses.replace(small_cfg(), clf_hidden_size=64)
    from volta_tpu.models import VoltaForVLTasks as JaxVLTasks

    batch = make_batch(0)
    jmodel = JaxVLTasks(cfg, tc, ("TASK1",))
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), *[jnp.asarray(batch[k]) for k in
                                 ("question", "features", "spatials")],
        "TASK1")["params"])
    want = jtu_train.init_classifier_from_answers(
        jax.tree.map(np.asarray, params), "TASK1", _Answers(tok))
    model = load_flax_params(VoltaForVLTasks(
        VoltaConfig.from_dict(cfg.to_dict()), tc, ("TASK1",)), params)
    assert ptu_train.init_classifier_from_answers(model, "TASK1",
                                                  _Answers(tok))
    np.testing.assert_allclose(
        model.clf_TASK1.dense2.weight.detach().numpy(),
        np.asarray(want["clf_TASK1"]["dense2"]["kernel"]).T, **TOL)
    emb = model.bert.embeddings.word_embeddings.weight.detach()
    unk = tok.convert_tokens_to_ids([tok.unk_token])[0]
    # sorted answers: "" first, its row [UNK]'s
    assert torch.equal(model.clf_TASK1.dense2.weight[0].detach(), emb[unk])

    # the two no-ops, each with JAX's warning: a width mismatch, and a
    # head without dense2
    narrow = _port(small_cfg(), _flax_params(small_cfg(), batch)[1])
    before = narrow.clf_TASK1.dense2.weight.detach().clone()
    with caplog.at_level(logging.WARNING):
        assert not ptu_train.init_classifier_from_answers(
            narrow, "TASK1", _Answers(tok))
        assert "skipping init" in caplog.text
        assert torch.equal(narrow.clf_TASK1.dense2.weight.detach(), before)
        logit = VoltaForVLTasks(VoltaConfig.from_dict(small_cfg().to_dict()),
                                {"TASK8": {"type": "VL-logit"}}, ("TASK8",))
        assert not ptu_train.init_classifier_from_answers(
            logit, "TASK8", _Answers(tok))
        assert "no SimpleClassifier head" in caplog.text


def _store_args(vocab, grad_acc=1):
    return argparse.Namespace(bert_model="bert-base-uncased",
                              do_lower_case=True, vocab_file=vocab,
                              in_memory=False, num_workers=0, seed=0,
                              grad_acc_steps=grad_acc, num_worker_procs=0)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    import importlib.util

    tmp = str(tmp_path_factory.mktemp("port_extras"))
    ids = [10, 11, 12, 13]
    feat = fixtures.make_features_lmdb(tmp, ids, feature_size=32)
    fixtures.make_vqa_annotations(tmp, ids, n_questions=16, num_labels=9)
    vocab = fixtures.make_vocab(tmp)
    spec = importlib.util.spec_from_file_location(
        "make_synth_data", os.path.join(REPO, "tools", "make_synth_data.py"))
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    nlvr = os.path.join(tmp, "nlvr2")
    synth.gen_nlvr2(argparse.Namespace(out=nlvr, images=4, boxes=5,
                                       feat_dim=32, seed=0, questions=8))
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
  lr: 0.001
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
    base = ["--config_file", model_cfg, "--tasks_config_file", yml,
            "--vocab_file", vocab, "--num_workers", "0",
            "--compute_dtype", "float32", "--device", "cpu"]
    return dict(tmp=tmp, vocab=vocab, yml=yml, cfg=cfg, base=base)


@pytest.mark.parametrize("task", ["1", "12"], ids=["vqa", "nlvr2"])
def test_store_batches_match_jax_and_the_dense_batch(workdir, task):
    task_cfg = load_task_config(workdir["yml"])
    data = load_dataset(_store_args(workdir["vocab"]),
                        VoltaConfig.from_dict(workdir["cfg"].to_dict()),
                        task_cfg, task, split="train")
    ds, loader = data["train_dataset"], data["train_loader"]
    dense = list(loader)
    ds.enable_device_store(feat_dtype="float32")
    stored = list(loader)
    arrays = ds.device_store_arrays()
    store = store_to_device(arrays, "cpu")
    num_labels = task_cfg["TASK" + task]["num_labels"]
    # 16 questions, 8 pairs, at batch 4
    assert len(dense) == len(stored) == (4 if task == "1" else 2)
    for d, s in zip(dense, stored):
        assert "features" not in s and s["store_rows"].ndim == (
            2 if task == "12" else 1)
        got = materialize_store_batch(
            store, {k: torch.from_numpy(np.asarray(v)) for k, v in s.items()},
            num_labels)
        want = jax_materialize(arrays, {k: jnp.asarray(v)
                                        for k, v in s.items()}, num_labels)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)
        # the dense batch, field for field (the wire's narrow ints widened)
        for k in ("features", "spatials", "image_mask", "question",
                  "input_mask", "segment_ids", "target", "question_id"):
            np.testing.assert_array_equal(got[k].numpy(), d[k], err_msg=k)


def test_store_target_takes_the_max_over_repeated_labels():
    rng = np.random.RandomState(0)
    arrays = {"feat": rng.randn(5, 3, 4).astype(np.float32),
              "loc": rng.rand(5, 3, 5).astype(np.float32),
              "mask": np.ones((5, 3), np.int32)}
    batch = {"store_rows": np.array([4, 0], np.int32),
             "target_labels": np.array([[2, 2, 5, -1], [1, -1, -1, -1]],
                                       np.int16),
             "target_scores": np.array([[0.3, 0.9, 0.6, 0.0],
                                        [1.0, 0.0, 0.0, 0.0]], np.float32),
             "question": np.ones((2, 4), np.int16)}
    got = materialize_store_batch(
        store_to_device(arrays, "cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()}, 7)
    want = jax_materialize(arrays, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, 7)
    np.testing.assert_array_equal(got["target"].numpy(),
                                  np.asarray(want["target"]))
    assert float(got["target"][0, 2]) == np.float32(0.9)
    assert got["question"].dtype == torch.int32


def _losses(workdir, name, extra, task="1"):
    out = port_train.main(workdir["base"] + [
        "--task", task, "--output_dir", os.path.join(workdir["tmp"], name),
        "--logdir", os.path.join(workdir["tmp"], "logs_" + name),
        "--num_train_epochs", "1", "--clip_grad_norm", "1.0"] + extra)
    return out


@pytest.mark.parametrize("task", ["1", "12"], ids=["vqa", "nlvr2"])
def test_train_cli_device_store_gives_the_dense_losses(workdir, task):
    dense = _losses(workdir, f"dense_{task}", [], task)
    store = _losses(workdir, f"store_{task}", ["--device_store"], task)
    assert dense["steps"] == store["steps"] > 0
    assert store["train_losses"] == dense["train_losses"]
    assert store["val_scores"] == dense["val_scores"]


def test_train_cli_accumulation_counts_micro_steps(workdir):
    """K 2 on the task batch 4: micro-batches of 2, 8 micro-steps (JAX's
    ``state.step``) and 4 updates an epoch of 16 questions."""
    out = _losses(workdir, "accum", ["--gradient_accumulation_steps", "2"])
    assert out["steps"] == 8 and len(out["train_losses"]) == 8
    from volta_tpu_torch.checkpoint import TRAIN_STATE

    state = torch.load(os.path.join(out["run_dir"], "ckpt", TRAIN_STATE),
                       weights_only=True)
    assert state["step"] == 8
    assert state["optimizer"]["count"] == 4
    assert state["optimizer"]["mini_step"] == 0
    # a second epoch resumes at epoch 1 (micro-steps over the epoch's
    # micro-steps), not past it
    again = port_train.main(workdir["base"] + [
        "--task", "1", "--output_dir", os.path.join(workdir["tmp"], "accum"),
        "--logdir", os.path.join(workdir["tmp"], "logs_accum"),
        "--num_train_epochs", "2", "--clip_grad_norm", "1.0",
        "--gradient_accumulation_steps", "2"])
    assert again["steps"] == 16 and len(again["train_losses"]) == 8


def test_train_cli_freezes_fixed_layers(workdir):
    """A config with ``fixed_layers: ["embeddings"]``: after an epoch every
    embedding parameter stands where AdamW's decay alone takes it (the
    LayerNorms, undecayed, stand still); the rest trained."""
    cfg = dataclasses.replace(workdir["cfg"], fixed_layers=["embeddings"])
    path = os.path.join(workdir["tmp"], "frozen.json")
    with open(path, "w") as f:
        f.write(cfg.to_json_string())
    base = list(workdir["base"])
    base[base.index("--config_file") + 1] = path
    out = port_train.main(base + [
        "--task", "1", "--output_dir", os.path.join(workdir["tmp"], "frz"),
        "--logdir", os.path.join(workdir["tmp"], "logs_frz"),
        "--num_train_epochs", "1", "--save_name", "frozen"])
    from volta_tpu_torch.checkpoint import TRAIN_STATE
    from volta_tpu_torch.models.layers import init_weights

    start = init_weights(VoltaForVLTasks(
        VoltaConfig.from_json_file(path), load_task_config(workdir["yml"]),
        ("TASK1",)), torch.Generator().manual_seed(0)).state_dict()
    final = torch.load(os.path.join(out["run_dir"], "ckpt", TRAIN_STATE),
                       weights_only=True)["model"]
    decay = topt.no_decay_mask(VoltaForVLTasks(
        VoltaConfig.from_json_file(path), load_task_config(workdir["yml"]),
        ("TASK1",)))
    # warmup_linear over 4 steps, warmup 0: lr 1e-3 * (4 - s) / 4
    shrink = np.prod([1 - 1e-3 * (4 - s) / 4 * 0.01 for s in range(4)])
    for name in start:
        if "embeddings" in name:
            want = start[name] * np.float32(shrink) if decay[name] \
                else start[name]
            np.testing.assert_allclose(final[name].numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=name)
        elif name.endswith("query.weight"):
            assert not torch.allclose(final[name], start[name])
