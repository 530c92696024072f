"""The other five families of the port against the JAX package on the
CPU, continued (tests/test_torch_port_families.py builds the models):

* ``_attn_data`` on the dual plans against JAX's extras (None for absent
  flows, the (vt, vv) split order);
* ``fuse_dual_stream`` / ``fuse_dual_qkv`` against the unfused port and
  against JAX, as tests/test_fused_dual_stream.py holds JAX, and
  ``residual_ln_seg`` with its dropout against JAX's for the seed (hash)
  or the bits (int threshold) JAX's key draws;
* the RoBERTa position offset;
* VL-BERT's zero-feature rows, joint position ids and ``obj_downsample``
  dropout site, and the [MASK] pooler (``fusion_method: vl-bert_vqa``) on
  an ``append_mask_sep`` VQA batch that both packages' datasets make
  alike;
* checkpoints of each family: the Flax bridge round-trips every leaf; a
  reference ``.bin`` that JAX exports imports into the port with JAX's
  report, its tensors and JAX's logits; the port's export equals JAX's key
  for key, in order, and bit for bit.

Tolerances: fp32 1e-5.
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from test_torch_port_families import (B, DUAL, F, HEADS, KEYS, LT, LV,
                                      MASKS, TOL, _j, _jax_embeddings, _np,
                                      _port_embeddings, _t, flax_params,
                                      heads, jcfg, make_batch, pcfg, port)
from volta_tpu import checkpoint as jck
from volta_tpu import task_utils as jtu
from volta_tpu.models import VoltaForVLTasks as JaxVLTasks
from volta_tpu.models import layers as jlayers
from volta_tpu.models.model import VoltaModel as JaxVoltaModel
from volta_tpu_torch import VoltaForVLTasks
from volta_tpu_torch import checkpoint as ck
from volta_tpu_torch import task_utils as ptu
from volta_tpu_torch.convert import load_flax_params, state_dict_from_flax
from volta_tpu_torch.models import embeddings as pemb
from volta_tpu_torch.models.layers import DropoutSeeds, init_weights, \
    residual_ln_seg

@pytest.mark.parametrize("offset", [True, False])
def test_roberta_position_offset(offset):
    """``model: roberta`` with ``roberta_position_offset`` puts the text
    positions at 2.. (JAX's opt-in branch), without the flag at 0.."""
    family = "vilbert"
    batch = make_batch(2)
    params = flax_params(family)
    over = dict(model="roberta", roberta_position_offset=offset)
    jt, _ = _jax_embeddings(family, jcfg(family, **over), params, batch)
    tt, _ = _port_embeddings(family, port(family, **over).eval(), batch)
    np.testing.assert_allclose(_np(tt), _np(jt), **TOL)
    base, _ = _port_embeddings(family, port(family).eval(), batch)
    assert torch.equal(tt, base) != offset


def test_vl_bert_embedding_rules():
    """The zero-feature row takes the mask visual embedding (and the mask
    word embedding, with ``visual_target_weights["6"]``), the joint
    position ids skip the regions' slots, and the ``obj_downsample`` input
    [B, K, 4·2·dim + F] is a dropout site at
    ``v_attention_probs_dropout_prob``, drawn before the joint one."""
    family = "vl-bert"
    params = jax.tree.map(np.copy, flax_params(family))
    emb = params["bert"]["embeddings"]
    emb["object_mask_visual_embedding"] = np.full((1, F), 0.5, np.float32)
    emb["object_mask_word_embedding"] += 1.0
    batch = make_batch(3)
    jt, jv = _jax_embeddings(family, jcfg(family), params, batch)
    model = port(family, params=params).eval()
    tt, tv = _port_embeddings(family, model, batch)
    np.testing.assert_allclose(_np(tt), _np(jt), **TOL)
    np.testing.assert_allclose(_np(tv), _np(jv), **TOL)
    # the masked row differs from the same row with its features kept
    feats = batch["features"].copy()
    feats[0, 3] = 0.5
    _, kept = _port_embeddings(family, model, dict(batch, features=feats))
    assert not torch.equal(kept[0, 3], tv[0, 3])
    assert torch.equal(kept[1], tv[1])
    # without the mask word embedding (ctrl_vl-bert_base), no such leaf
    assert pemb.VLBertEmbeddings(pcfg(family, visual_target_weights={
        "0": 1.0})).object_mask_word_embedding is None
    # the position ids: text pads shifted past the K regions
    calls = []
    pos = model.bert.embeddings.position_embeddings
    pos.register_forward_hook(lambda m, a, out: calls.append(a[0]))
    _port_embeddings(family, model, batch)
    text_pos, obj_pos = calls
    assert text_pos[1].tolist() == [0, 1, 2, 3, 4] + [15, 16, 17]
    assert obj_pos[1].tolist() == [5] * (LV - 1) + [6]
    assert obj_pos[0].tolist() == [8] * (LV - 1) + [9]

    sites = []
    real = pemb.hash_dropout

    def spy(x, seed, rate):
        sites.append((tuple(x.shape), seed, rate))
        return real(x, seed, rate)

    pemb.hash_dropout = spy
    try:
        model.train()
        with torch.no_grad():
            model.bert.embeddings(*_t(batch, KEYS + ("segment_ids",)),
                                  seeds=DropoutSeeds(9))
    finally:
        pemb.hash_dropout = real
    seeds = DropoutSeeds(9)
    cfg = pcfg(family)
    assert sites == [((B, LV, 4 * 2 * 8 + F), seeds.next(),
                      cfg.v_attention_probs_dropout_prob),
                     ((B, LT + LV, 64), seeds.next(),
                      cfg.hidden_dropout_prob)]


# ---------------------------------------------------------------- capture
@pytest.mark.parametrize("family", DUAL)
def test_attn_data_on_dual_plans(family):
    """``output_probs`` and ``output_all_layers`` on a dual plan: every
    stream's maps, queries and keys against JAX's extras, None where a
    flow or a stream is absent."""
    batch = make_batch(8)
    params = flax_params(family)
    cfg = jcfg(family)
    *_, want = JaxVoltaModel(cfg).apply(
        {"params": params["bert"]}, *_j(batch, KEYS), *_j(batch, MASKS),
        output_all_layers=True, output_probs=True)
    model = port(family).eval()
    with torch.no_grad():
        *_, got = model.bert(*_t(batch, KEYS), *_t(batch, MASKS),
                             output_all_layers=True, output_probs=True)
    plan = [s for s in cfg.sublayer_plan() if s.kind == "attn"]
    assert len(got["probs"]) == len(want["probs"]) == len(plan)
    for a, b in zip(got["all_t"] + got["all_v"],
                    want["all_t"] + want["all_v"]):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    for spec, pair, jpair in zip(plan, got["probs"], want["probs"]):
        for d, jd in zip(pair, jpair):
            for key in ("intra_attn", "inter_attn", "queries", "keys"):
                if jd[key] is None:
                    assert d[key] is None, (spec.index, key)
                else:
                    np.testing.assert_allclose(_np(d[key]), _np(jd[key]),
                                               **TOL)
        t_data, v_data = pair
        assert (t_data["intra_attn"] is None) != spec.has_tt
        assert (v_data["inter_attn"] is None) != spec.has_vt
        if spec.has_vt and spec.has_vv:  # the (vt, vv) split, text keys first
            assert v_data["inter_attn"].shape[-1] == LT
            assert v_data["intra_attn"].shape[-1] == LV


# ------------------------------------------------------ fused dual stream
@pytest.mark.parametrize("qkv", [True, False], ids=["qkv", "tails"])
@pytest.mark.parametrize("family", ["vilbert", "lxmert"])
def test_fuse_dual_stream(family, qkv):
    """``fuse_dual_stream`` (with ``fuse_dual_qkv`` or without): the
    logits of the port with it equal the port without it and JAX with it;
    each fusable sublayer draws one seed in training."""
    batch = make_batch(9)
    over = dict(fuse_dual_stream=True, fuse_dual_qkv=qkv)
    params = flax_params(family)
    jmodel = JaxVLTasks(jcfg(family, **over), heads(family), HEADS[family])
    ref, _ = jmodel.apply({"params": params}, *_j(batch, KEYS), "TASK1",
                          *_j(batch, MASKS))
    fused, plain = port(family, **over).eval(), port(family).eval()
    with torch.no_grad():
        got = fused(*_t(batch, KEYS), "TASK1", *_t(batch, MASKS))
        base = plain(*_t(batch, KEYS), "TASK1", *_t(batch, MASKS))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(got.numpy(), base.numpy(), **TOL)
    layers = [getattr(fused.bert.encoder, n) for n in fused.bert.encoder.names]
    fusable = [m for m in layers if m.fuse_dual]
    assert fusable and all(
        m.spec.has_text and m.spec.has_vision for m in fusable)
    assert any(m.spec.share_params for m in fusable) == (family == "lxmert")
    # training: one tail seed for each fused sublayer, two unfused
    seeds = DropoutSeeds(3)
    fused.train()
    for m in fusable:
        assert m.tail_seeds(seeds, True)[1] is None
        assert None not in m.tail_seeds(seeds, False)
    fused(*_t(batch, KEYS), "TASK1", *_t(batch, MASKS),
          dropout_seed=4).sum().backward()


@pytest.mark.parametrize("hash_mask", [True, False])
def test_residual_ln_seg_matches_jax(hash_mask, monkeypatch):
    """The segmented chain with its dropout, for the seed JAX's key draws
    (hash) or the bits it draws (int threshold), against JAX's."""
    from volta_tpu_torch.models import layers as player

    rng = np.random.RandomState(10)
    lt, lv, d = 5, 7, 128
    o, res = (rng.randn(2, lt + lv, d).astype(np.float32) for _ in "or")
    w_t, b_t, w_v, b_v = (rng.randn(d).astype(np.float32) for _ in "abcd")
    key = jax.random.PRNGKey(11)
    want = jlayers.residual_ln_seg(
        jnp.asarray(o), jnp.asarray(res), *map(jnp.asarray, (w_t, b_t, w_v,
                                                            b_v)),
        lt, rate=0.1, rng=key, deterministic=False, hash_mask=hash_mask)
    if hash_mask:
        seed = int(jax.random.bits(key, (), jnp.uint32))
    else:
        bits = np.asarray(jax.random.bits(key, o.shape, jnp.uint32))
        monkeypatch.setattr(player, "seeded_bits",
                            lambda shape, s, dev: torch.from_numpy(
                                bits.astype(np.int64)))
        seed = 1
    got = residual_ln_seg(*map(torch.from_numpy, (o, res, w_t, b_t, w_v,
                                                  b_v)),
                          lt, 0.1, seed, hash_mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_vl_bert_vqa_mask_pooler(tmp_path):
    """VL-BERT VQA (``fusion_method: vl-bert_vqa``, ``add_global_imgfeat:
    last``): both packages' datasets append [MASK] [CLS] alike, and the
    port pools the hidden state at text_end - 2, the [MASK], as JAX
    does."""
    ids = [10, 11, 12]
    fixtures.make_features_lmdb(str(tmp_path), ids, feature_size=F)
    fixtures.make_vqa_annotations(str(tmp_path), ids, n_questions=4)
    tc = {"TASK1": {
        "name": "VQA", "type": "VL-classifier", "num_labels": 9,
        "loss": "BCEWithLogitLoss", "process": "normal",
        "dataroot": str(tmp_path),
        "features_h5path1": str(tmp_path / "feat.lmdb"),
        "features_h5path2": "", "train_annotations_jsonpath": "",
        "val_annotations_jsonpath": "", "max_seq_length": LT,
        "max_region_num": LV, "batch_size": B, "train_split": "train",
        "val_split": "train", "fusion_method": "vl-bert_vqa"}}
    over = dict(fusion_method="vl-bert_vqa", add_global_imgfeat="last",
                num_locs=5)
    args = argparse.Namespace(
        bert_model="bert-base-uncased", do_lower_case=True, seed=0,
        vocab_file=fixtures.make_vocab(str(tmp_path)), grad_acc_steps=1,
        num_workers=0)
    jb = next(iter(jtu.load_dataset(args, jcfg("vl-bert", **over), tc, "1",
                                    split="train")["train_loader"]))
    pb = next(iter(ptu.load_dataset(args, pcfg("vl-bert", **over), tc, "1",
                                    split="train")["train_loader"]))
    for k in KEYS + MASKS:
        np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
    q = pb["question"]
    end = (q != 0).sum(1)
    tok = ptu.make_tokenizer("bert-base-uncased", True, args.vocab_file)
    # [MASK] [CLS] after the live text, as the reference appends them
    assert q.shape == (B, LT + 2)
    assert (q[np.arange(B), end - 2] == tok.mask_id).all()
    assert (q[np.arange(B), end - 1] == tok.cls_id).all()

    cfg = jcfg("vl-bert", **over)
    task = {"TASK1": tc["TASK1"]}
    jmodel = JaxVLTasks(cfg, task, ("TASK1",))
    variables = jmodel.init(jax.random.PRNGKey(1), *_j(jb, KEYS), "TASK1",
                            *_j(jb, MASKS))
    params = jax.tree.map(np.asarray, variables["params"])
    assert "v_pooler" not in params["bert"]
    ref, _ = jmodel.apply({"params": params}, *_j(jb, KEYS), "TASK1",
                          *_j(jb, MASKS))
    model = load_flax_params(VoltaForVLTasks(pcfg("vl-bert", **over), task,
                                             ("TASK1",)), params).eval()
    with torch.no_grad():
        got = model(*_t(pb, KEYS), "TASK1", *_t(pb, MASKS))
        seq_t = model.bert(*_t(pb, KEYS), *_t(pb, MASKS))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # the pooled row is the [MASK]'s
    pooled = model.bert.t_pooler(seq_t, torch.from_numpy(end))
    want = torch.relu(model.bert.t_pooler.dense(
        seq_t[torch.arange(B), torch.from_numpy(end - 2)]))
    assert torch.equal(pooled, want)


# ------------------------------------------------------------ checkpoints
def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("family", list(HEADS))
def test_bridge_round_trips_every_leaf(family):
    params = flax_params(family)
    own = port(family).state_dict()
    n = 0
    for path, val in _leaves(params):
        leaf = {"kernel": "weight", "scale": "weight",
                "embedding": "weight"}.get(path[-1], path[-1])
        key = ".".join(path[:-1] + (leaf,))
        want = val.T if path[-1] == "kernel" else val
        np.testing.assert_array_equal(own[key].numpy(), want, err_msg=key)
        n += 1
    assert n == len(own)
    if family in DUAL:
        assert "bert.v_embeddings.feat_dense.weight" in own
        assert any(".v_query." in k for k in own)


@pytest.mark.parametrize("family", list(HEADS))
def test_reference_bin_import_and_export(family, tmp_path):
    """JAX's export of the family as a reference ``.bin`` through the
    port's ``from_pretrained``: JAX's report, the Flax tensors, JAX's
    logits; the port's export of the same weights equals JAX's."""
    cfg, params = jcfg(family), flax_params(family)
    ref_sd, jreport = jck.export_torch_state_dict(cfg, params)
    assert jreport["unexported"] == []
    path = str(tmp_path / "model.bin")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in ref_sd.items()}, path)
    model = VoltaForVLTasks(pcfg(family), heads(family), HEADS[family])
    init_weights(model, torch.Generator().manual_seed(3))
    report = ck.from_pretrained(pcfg(family), model, path)
    _, want_report = jck.import_state_dict(cfg, {"params": params}, ref_sd)
    assert report == want_report and report["skipped"] == []
    want = state_dict_from_flax(params)
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    batch = make_batch(11)
    ref, _ = JaxVLTasks(cfg, heads(family), HEADS[family]).apply(
        {"params": params}, *_j(batch, KEYS), "TASK1", *_j(batch, MASKS))
    with torch.no_grad():
        logits = model.eval()(*_t(batch, KEYS), "TASK1", *_t(batch, MASKS))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **TOL)

    sd, rep = ck.export_reference_state_dict(pcfg(family), model)
    assert rep == {"unexported": []}
    assert list(sd) == list(ref_sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), ref_sd[k], err_msg=k)


# -------------------------------------------------------------------- CLIs
@pytest.mark.parametrize("family,over,task_extra", [
    ("vilbert", {}, ""),
    ("lxmert", dict(add_global_imgfeat=None, fusion_method="text"), ""),
    ("vl-bert", dict(add_global_imgfeat="last"),
     "  fusion_method: vl-bert_vqa\n  embed_clf: true\n"),
], ids=["vilbert", "lxmert", "vl-bert_vqa"])
def test_clis_run_each_family(tmp_path, family, over, task_extra):
    """One epoch of the port's train CLI and its eval CLI on the best
    checkpoint, for a dual-stream config with the global feature first,
    LXMERT's 36-region layout without it (``fusion_method: text``), and
    VL-BERT under its yml's ``fusion_method: vl-bert_vqa`` override (the
    global feature last, [MASK] [CLS] appended, ``embed_clf``): the VAL
    line, and the eval CLI scoring the val split as that validation
    did."""
    from volta_tpu_torch import eval_task as port_eval
    from volta_tpu_torch import train_task as port_train

    tmp = str(tmp_path)
    ids = [10, 11, 12, 13]
    feat = fixtures.make_features_lmdb(tmp, ids, feature_size=F)
    fixtures.make_vqa_annotations(tmp, ids, n_questions=8, num_labels=9)
    vocab = fixtures.make_vocab(tmp)
    model_cfg = str(tmp_path / "model.json")
    with open(model_cfg, "w") as f:
        f.write(jcfg(family, vocab_size=23, **over).to_json_string())
    yml = str(tmp_path / "tasks.yml")
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
  max_seq_length: 10
  max_region_num: 8
  batch_size: 4
  eval_batch_size: 4
  train_split: train
  val_split: train
  lr: 0.001
{task_extra}""")
    base = ["--config_file", model_cfg, "--tasks_config_file", yml,
            "--task", "1", "--vocab_file", vocab, "--num_workers", "0",
            "--compute_dtype", "float32", "--device", "cpu"]
    out = port_train.main(base + [
        "--output_dir", str(tmp_path / "save"), "--logdir",
        str(tmp_path / "logs"), "--num_train_epochs", "1"])
    assert out["steps"] == 2 and all(np.isfinite(out["train_losses"]))
    assert len(out["val_scores"]) == 1
    summary = port_eval.main(base + [
        "--from_pretrained", str(tmp_path / "save" / os.path.basename(
            out["run_dir"]) / "best"),
        "--output_dir", str(tmp_path / "results")])
    assert summary["n"] == 8 and not summary["nonfinite_batches"]
    assert summary["score"] == pytest.approx(out["best_score"], abs=1e-9)


def test_single_layernorm_with_distinct_rates(monkeypatch):
    """The third tail form (encoder.py:309-312): one LayerNorm over both
    streams whose hidden rates differ drops each stream's output with its
    own rate and seed, text first, then normalises [t_o + t ‖ v_o + v]
    without a residual call. No validated plan reaches it (a single
    LayerNorm needs shared parameters, whose rates are equal), so the
    sublayer is built from a spec by hand."""
    from volta_tpu_torch.config import SublayerSpec
    from volta_tpu_torch.models import encoder as penc

    cfg = pcfg("vilbert", v_hidden_dropout_prob=0.2)
    spec = SublayerSpec(index=0, kind="ff", has_t_ff=True, has_v_ff=True,
                        single_ln=True, intermediate_size=128,
                        v_intermediate_size=128)
    layer = penc.GatedFeedForwardSublayer(cfg, spec)
    init_weights(layer, torch.Generator().manual_seed(0)).train()
    drawn = []
    real = penc.hash_dropout
    monkeypatch.setattr(penc, "hash_dropout", lambda x, s, r: (
        drawn.append((tuple(x.shape), s, r)), real(x, s, r))[1])
    rng = torch.Generator().manual_seed(1)
    t, v = torch.randn(B, LT, 64, generator=rng), \
        torch.randn(B, LV, 64, generator=rng)
    got_t, got_v = layer.streams(t, v, DropoutSeeds(6))
    seeds = DropoutSeeds(6)
    s_t, s_v = seeds.next(), seeds.next()
    assert drawn == [((B, LT, 64), s_t, 0.1), ((B, LV, 64), s_v, 0.2)]
    want = layer.out_ln(torch.cat([
        real(layer._ffn(t, False), s_t, 0.1) + t,
        real(layer._ffn(v, True), s_v, 0.2) + v], 1))
    assert torch.equal(torch.cat([got_t, got_v], 1), want)
