"""The port's pretraining slice against the JAX package on the CPU: the
seven masked-region criteria, ``cross_entropy_ignore`` and
``pretraining_losses``; ``VoltaForVLPreTraining`` of four families; the
pretrain step and its eval step; the no-decay mask; the reference export
and the resumes.

Small models from the JAX ``zoo`` (hidden 48, 4 heads of 12, vocab 23,
2048-d region features so that the regression and NCE targets have the
decoders' width): ctrl_uniter (single-stream, global row first), a
ctrl_vilbert (dual-stream, two text layers, the trunk from layer 1), the
shapes of ``configs/lxmert.json`` (criteria 3, 4 and 5, ``fusion_method:
text``, no global row) and of ``configs/vl-bert_base.json`` (criterion 6,
``fusion_method: none`` so no ITM head, the global row last, no image-head
LayerNorm). One Flax init each, bridged with ``convert.state_dict_from_flax``,
the same seed-made numpy inputs on both sides, fp32. Tolerances:

* each criterion, its gradient by the predictions, ``cross_entropy_ignore``
  and ``pretraining_losses``: rtol 1e-5 (gradients atol 1e-6). NCE dense,
  chunked (``score_chunk``) and shared, with JAX's draws fed in: the test
  draws ``neg_idx`` (and ``_nce_shared``'s indices) with ``jax.random``
  from the key JAX's ``nce_2048`` splits, which is checked first against
  ``nce_2048``'s own draw;
* the sampler: its ranges and remaps;
* the model's outputs in eval mode (both packages' plain attention route):
  rtol 1e-5 / atol 1e-5;
* one pretrain step under objectives 0, 1 and 2 (and lxmert.json's shapes
  under objective 2), attention dropout 0.1 and the pooled output's 0.1,
  with the keep bits of JAX's ``nn.Dropout`` draws (seed-made constants of
  the jitted JAX step, as tests/test_torch_port_families.py makes them) fed
  in (the attention's through
  ``ops.attention.probs_keep`` as tests/test_torch_port_plain_route.py
  does, the pooled output's through the heads' ``hash_dropout``) and JAX's
  NCE draws through ``losses.sample_negatives``: the three losses, every
  gradient and every parameter after clip + AdamW at
  tests/test_torch_port_train.py's rtol 2e-4 / atol 2e-5;
* ``make_pretrain_eval_step`` against JAX's (NCE from ``PRNGKey(0)``):
  rtol 1e-5;
* ``no_decay_mask`` against ``volta_tpu.optimization.no_decay_mask``, name
  for name; the reference export against ``volta_tpu.checkpoint
  .export_torch_state_dict``, key for key and bit for bit (the tied
  decoder aliased to the word table); the native and reference-tar
  resumes bit for bit against an uninterrupted run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_families import _bits_in_jit
from test_torch_port_plain_route import _feed_bits
from volta_tpu import checkpoint as jck
from volta_tpu import losses as jl
from volta_tpu import zoo
from volta_tpu.models import VoltaForVLPreTraining as JaxPreTraining
from volta_tpu.optimization import build_optimizer as jax_build_optimizer
from volta_tpu.optimization import no_decay_mask as jax_no_decay_mask
from volta_tpu.optimization import warmup_linear_schedule as jax_warmup
from volta_tpu.parallel.train_step import _strip_global as jax_strip
from volta_tpu.parallel.train_step import \
    make_pretrain_eval_step as jax_eval_step
from volta_tpu_torch import checkpoint as ck
from volta_tpu_torch import losses as pl
from volta_tpu_torch.config import VoltaConfig
from volta_tpu_torch.convert import load_flax_params, state_dict_from_flax
from volta_tpu_torch.models import VoltaForVLPreTraining
from volta_tpu_torch.models import heads as pheads
from volta_tpu_torch.ops import LAUNCHES
from volta_tpu_torch.optimization import build_optimizer, no_decay_mask, \
    warmup_linear_schedule
from volta_tpu_torch.train_step import create_train_state, \
    make_pretrain_eval_step, make_pretrain_step

B, LT, R, F, V = 3, 8, 5, 2048, 23
SMALL = dict(hidden_size=48, num_attention_heads=4, intermediate_size=64,
             pooler_size=48, v_pooler_size=48, vocab_size=V,
             max_position_embeddings=40, v_feature_size=F, v_hidden_size=48,
             v_num_attention_heads=4, v_intermediate_size=64,
             clf_hidden_size=32)
FAMILIES = {
    "ctrl_uniter": lambda **o: zoo.single_stream(
        "uniter", depth=2, **{**SMALL, "visual_target_weights": {"0": 1.0,
                                                                 "2": 1.0},
                              **o}),
    "ctrl_vilbert": lambda **o: zoo.vilbert(
        depth_text=2, cross_start=1,
        **{**SMALL, "visual_target_weights": {"0": 1.0}, **o}),
    "lxmert": lambda **o: zoo.lxmert(
        n_text=1, n_vision=1, n_cross=1,
        **{**SMALL, "visual_target_weights": {"3": 6.667, "4": 6.667,
                                              "5": 6.667},
           "fusion_method": "text", "add_global_imgfeat": None, **o}),
    "vl-bert": lambda **o: zoo.single_stream(
        "vl-bert", depth=2,
        **{**SMALL, "type_vocab_size": 3, "v_coordinate_embeddings_dim": 8,
           "visual_target_weights": {"6": 1.0}, "fusion_method": "none",
           "add_global_imgfeat": "last", "image_head_ln": False, **o}),
}
# gradients: sums of up to 127 float32 terms in another order, at scales
# of 0.1
CRIT_RTOL, GRAD_ATOL = 1e-5, 1e-6
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=2e-4, atol=2e-5)
LR, WD, CLIP, EPS, BETAS = 1e-4, 10.0, 1.0, 1e-3, (0.9, 0.999)


def pcfg_of(jcfg):
    return VoltaConfig.from_dict(jcfg.to_dict())


# ------------------------------------------------------------- criteria
def jax_neg_idx(key, b, r, num_negative=128):
    """JAX nce_2048's draw from ``key`` (volta_tpu/losses.py:259-283)."""
    n_across, n_inside = int(num_negative * 0.7), int(num_negative * 0.3)
    k1, k2, k3 = jax.random.split(key, 3)
    own = jnp.arange(b)[:, None, None]
    row = jax.random.randint(k1, (b, r, n_across), 0, b - 1)
    row = jnp.where(row == own, b - 1, row)
    col = jax.random.randint(k2, (b, r, n_across), 0, r)
    inside = jax.random.randint(k3, (b, r, n_inside), 0, r - 1)
    inside = jnp.where(inside == jnp.arange(r)[None, :, None], r - 1, inside)
    return np.asarray(jnp.concatenate([row * r + col, own * r + inside], -1))


def jax_shared_draws(key, b, r, num_negative=128):
    """_nce_shared's draws from ``key`` (volta_tpu/losses.py:218-229)."""
    k1, k3 = jax.random.split(key, 2)
    shared = jax.random.randint(k1, (int(num_negative * 0.7),), 0, b * r)
    inside = jax.random.randint(k3, (b, r, int(num_negative * 0.3)), 0,
                                r - 1)
    inside = jnp.where(inside == jnp.arange(r)[None, :, None], r - 1, inside)
    return np.asarray(shared), np.asarray(inside)


def crit_inputs(seed=0, b=B, r=R):
    rng = np.random.RandomState(seed)
    label = rng.choice([1, -1, 0], (b, r), p=[0.4, 0.4, 0.2])
    label[0, 0] = 1
    label[-1] = -1  # a sample with no masked region
    cls = rng.rand(b, r, 1601).astype(np.float32)
    cls[cls < 0.3] = 0.0  # 0 log 0 = 0
    cls /= cls.sum(-1, keepdims=True)
    return dict(
        label=label.astype(np.int64), image_cls=cls,
        image_feat=rng.randn(b, r, F).astype(np.float32),
        # out of range on both sides: _xent_conf clips them
        obj_labels=rng.randint(-3, 1605, (b, r)).astype(np.int64),
        obj_confs=rng.rand(b, r).astype(np.float32),
        attr_labels=rng.randint(-2, 405, (b, r)).astype(np.int64),
        attr_confs=rng.rand(b, r).astype(np.float32))


def _crit_pair(ix, inputs, pred, **kw):
    """(value, d pred) of criterion ix in both packages."""
    jkw = {k: v for k, v in kw.items() if k != "idx_shared"}

    def jfn(p):
        return jl.PRE_VIS_CRITERIONS[ix](
            p, 0.7, jnp.asarray(inputs["label"]),
            *[jnp.asarray(inputs[k]) for k in (
                "image_cls", "image_feat", "obj_labels", "obj_confs",
                "attr_labels", "attr_confs")], **jkw)

    jval, jgrad = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    pkw = {k: (torch.from_numpy(np.array(v)) if k == "neg_idx" else v)
           for k, v in kw.items() if k != "rng"}
    val = pl.PRE_VIS_CRITERIONS[ix](
        p, 0.7, torch.from_numpy(inputs["label"]),
        *[torch.from_numpy(inputs[k]) for k in (
            "image_cls", "image_feat", "obj_labels", "obj_confs",
            "attr_labels", "attr_confs")], **pkw)
    val.backward()
    return ((float(val.detach()), p.grad.numpy()),
            (float(jval), np.asarray(jgrad)))


@pytest.mark.parametrize("ix", sorted(pl.PRE_VIS_TARGETS))
def test_criterion_matches_jax(ix):
    inputs = crit_inputs(1)
    # NCE's predictions at a trained model's scale: scores of order 1
    scale = 0.05 if ix == "2" else 1.0
    pred = (np.random.RandomState(2).randn(B, R, pl.PRE_VIS_TARGETS[ix])
            * scale).astype(np.float32)
    kw = {}
    if ix == "2":
        kw["neg_idx"] = jax_neg_idx(jax.random.PRNGKey(3), B, R)
    (got, ggot), (want, gwant) = _crit_pair(ix, inputs, pred, **kw)
    np.testing.assert_allclose(got, want, rtol=CRIT_RTOL)
    np.testing.assert_allclose(ggot, gwant, rtol=CRIT_RTOL, atol=GRAD_ATOL)
    assert got > 0


def test_nce_paths_match_jax(monkeypatch):
    """NCE dense with JAX's own draw (the test's draw equals it), chunked
    through ``score_chunk`` (a last block padded), and the shared scheme."""
    inputs = crit_inputs(4, b=4, r=6)
    pred = (np.random.RandomState(5).randn(4, 6, F) * 0.05).astype(
        np.float32)
    key = jax.random.PRNGKey(11)
    idx = jax_neg_idx(key, 4, 6)
    assert idx.shape == (4, 6, 127)
    args = [jnp.asarray(pred), 1.0, jnp.asarray(inputs["label"]), None,
            jnp.asarray(inputs["image_feat"])]
    own_draw = jax.jit(lambda p, f, k: jl.nce_2048(
        p, 1.0, args[2], None, f, rng=k))
    fed_draw = jax.jit(lambda p, f, i: jl.nce_2048(
        p, 1.0, args[2], None, f, neg_idx=i))
    np.testing.assert_array_equal(
        np.asarray(own_draw(args[0], args[4], key)),
        np.asarray(fed_draw(args[0], args[4], jnp.asarray(idx))))
    dense = _crit_pair("2", inputs, pred, neg_idx=idx)
    chunked = _crit_pair("2", inputs, pred, neg_idx=idx, score_chunk=7)
    for (got, ggot), (want, gwant) in (dense, chunked):
        np.testing.assert_allclose(got, want, rtol=CRIT_RTOL)
        np.testing.assert_allclose(ggot, gwant, rtol=CRIT_RTOL,
                                   atol=GRAD_ATOL)
    np.testing.assert_allclose(chunked[0][0], dense[0][0], rtol=CRIT_RTOL)

    # the shared scheme: JAX draws inside, the port takes the same draws
    monkeypatch.setattr(jl, "_NCE_SHARED_NEGATIVES", [True])
    want = float(jax.jit(lambda p, f, k: jl.nce_2048(
        p, 1.0, args[2], None, f, rng=k))(args[0], args[4], key))
    shared, inside = jax_shared_draws(key, 4, 6)
    got = pl._nce_shared(torch.from_numpy(pred), 1.0,
                         torch.from_numpy(inputs["label"]),
                         torch.from_numpy(inputs["image_feat"]), None, 128,
                         idx_shared=torch.from_numpy(shared),
                         col_inside=torch.from_numpy(inside))
    np.testing.assert_allclose(float(got), want, rtol=CRIT_RTOL)


def test_sampler_ranges_and_remaps():
    b, r = 6, 7
    idx = pl.sample_negatives(b, r, 128, torch.Generator().manual_seed(0),
                              "cpu")
    assert idx.shape == (b, r, 127) and idx.dtype == torch.int64
    rows, cols = idx // r, idx % r
    own = torch.arange(b)[:, None, None]
    own_col = torch.arange(r)[None, :, None]
    across, inside = slice(0, 89), slice(89, 127)
    # cross-batch: never the own row; the last row only by the remap
    assert (rows[..., across] != own).all()
    assert (rows[..., across] >= 0).all() and (rows[..., across] < b).all()
    remapped = rows[:-1, :, across] == b - 1
    assert remapped.any()
    assert (cols[..., across] >= 0).all() and (cols[..., across] < r).all()
    # in-image: the own row, never the own column
    assert (rows[..., inside] == own).all()
    assert (cols[..., inside] != own_col).all()
    assert (cols[:, :-1, inside] == r - 1).any()
    # the same generator state draws the same indices
    again = pl.sample_negatives(b, r, 128,
                                torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(idx, again)
    # one image: the cross-batch rows are all row 0 (its own, remapped)
    one = pl.sample_negatives(1, r, 128, torch.Generator().manual_seed(1),
                              "cpu")
    assert (one // r == 0).all()


def test_cross_entropy_ignore_matches_jax():
    rng = np.random.RandomState(6)
    logits = rng.randn(B, LT, V).astype(np.float32)
    labels = rng.randint(-1, V, (B, LT)).astype(np.int64)
    for lab in (labels, np.full_like(labels, -1)):
        got = pl.cross_entropy_ignore(torch.from_numpy(logits),
                                      torch.from_numpy(lab))
        want = jl.cross_entropy_ignore(jnp.asarray(logits),
                                       jnp.asarray(lab))
        np.testing.assert_allclose(float(got), float(want), rtol=CRIT_RTOL)
    assert float(got) == 0.0  # no valid label: 0 / max(0, 1)


@pytest.mark.parametrize("glob", ["first", "last", None])
def test_pretraining_losses_match_jax(glob):
    jcfg = FAMILIES["ctrl_uniter"](
        add_global_imgfeat=glob,
        visual_target_weights={"0": 1.0, "1": 0.5, "3": 0.0, "5": 2.0})
    inputs = crit_inputs(7)
    rng = np.random.RandomState(8)
    rv = R + (glob is not None)
    outs = {"mlm_logits": rng.randn(B, LT, V).astype(np.float32),
            "mrm_logits": {ix: rng.randn(B, rv, pl.PRE_VIS_TARGETS[ix])
                           .astype(np.float32) for ix in ("0", "1", "5")},
            "itm_logits": rng.randn(B, 2).astype(np.float32)}
    lm = rng.randint(-1, V, (B, LT)).astype(np.int64)
    nsl = np.array([0, 1, -1], np.int64)
    kw = {k: inputs[k] for k in ("image_cls", "image_feat", "obj_labels",
                                 "obj_confs", "attr_labels", "attr_confs")}
    for itm in (outs["itm_logits"], None):
        want = jl.pretraining_losses(
            jcfg, {"mlm_logits": jnp.asarray(outs["mlm_logits"]),
                   "mrm_logits": {k: jnp.asarray(v) for k, v in
                                  outs["mrm_logits"].items()},
                   "itm_logits": None if itm is None else jnp.asarray(itm)},
            masked_lm_labels=jnp.asarray(lm),
            image_label=jnp.asarray(inputs["label"]),
            next_sentence_label=jnp.asarray(nsl),
            **{k: jnp.asarray(v) for k, v in kw.items()})
        got = pl.pretraining_losses(
            pcfg_of(jcfg), {"mlm_logits": torch.from_numpy(outs["mlm_logits"]),
                            "mrm_logits": {k: torch.from_numpy(v) for k, v
                                           in outs["mrm_logits"].items()},
                            "itm_logits": None if itm is None
                            else torch.from_numpy(itm)},
            masked_lm_labels=torch.from_numpy(lm),
            image_label=torch.from_numpy(inputs["label"]),
            next_sentence_label=torch.from_numpy(nsl),
            **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_allclose([float(x) for x in got],
                                   [float(x) for x in want], rtol=CRIT_RTOL)
    assert got[2] == 0.0  # no ITM head


# ---------------------------------------------------------------- models
def cc_batch(seed, glob, b=B, r=R, vocab=V):
    """A Conceptual Captions batch as the dataset gives it: the global row
    in the features, boxes and mask, not in the labels and targets."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, vocab, (b, LT)).astype(np.int32)
    ids[1, 6:] = 0
    rv = r + (glob is not None)
    image_mask = np.ones((b, rv), np.int32)
    image_mask[2, rv - 2:] = 0
    lm = np.where(rng.rand(b, LT) < 0.3, ids, -1).astype(np.int64)
    lm[ids == 0] = -1
    label = np.where(rng.rand(b, r) < 0.4, 1, -1).astype(np.int64)
    label[0, 1] = 1
    inputs = crit_inputs(seed + 100, b, r)
    return {"input_ids": ids, "input_mask": (ids != 0).astype(np.int32),
            "segment_ids": np.zeros((b, LT), np.int32),
            "lm_label_ids": lm, "is_match": np.array([0, 1, 0][:b], np.int32),
            # at a scale that keeps NCE's scores of order 1
            "image_feat": (rng.randn(b, rv, F) * 0.1).astype(np.float32),
            "image_loc": rng.rand(b, rv, 5).astype(np.float32),
            "image_mask": image_mask, "image_label": label,
            **{k: inputs[k] for k in ("image_cls", "obj_labels", "obj_confs",
                                      "attr_labels", "attr_confs")}}


MODEL_ARGS = ("input_ids", "image_feat", "image_loc", "segment_ids",
              "input_mask", "image_mask")


_INITS = {}


def jax_init(family, **over):
    """(JAX model, params) of ``FAMILIES[family](**over)``, the params of
    one Flax init a family (the overrides change no parameter's shape)."""
    jcfg = FAMILIES[family](**over)
    if family not in _INITS:
        base = FAMILIES[family]()
        batch = cc_batch(0, base.add_global_imgfeat)
        variables = jax.jit(lambda r: JaxPreTraining(base).init(
            r, *[jnp.asarray(batch[k]) for k in MODEL_ARGS]))(
            jax.random.PRNGKey(0))
        _INITS[family] = jax.tree.map(np.asarray, variables["params"])
    return JaxPreTraining(jcfg), _INITS[family]


def port_model(jcfg, params):
    return load_flax_params(VoltaForVLPreTraining(pcfg_of(jcfg)), params)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_model_outputs_match_jax(family):
    jcfg = FAMILIES[family](use_pallas=False)
    batch = cc_batch(9, jcfg.add_global_imgfeat)
    jmodel, params = jax_init(family, use_pallas=False)
    want = jax.jit(jmodel.apply)({"params": params},
                                 *[jnp.asarray(batch[k]) for k in MODEL_ARGS])
    model = port_model(jcfg, params).eval()
    with torch.no_grad():
        got = model(*[torch.from_numpy(batch[k]) for k in MODEL_ARGS])
    np.testing.assert_allclose(got["mlm_logits"].numpy(),
                               np.asarray(want["mlm_logits"]), **MODEL_TOL)
    assert set(got["mrm_logits"]) == set(want["mrm_logits"]) == set(
        jcfg.visual_target_weights)
    for ix, v in want["mrm_logits"].items():
        np.testing.assert_allclose(got["mrm_logits"][ix].numpy(),
                                   np.asarray(v), **MODEL_TOL, err_msg=ix)
    if family == "vl-bert":
        assert got["itm_logits"] is None is want["itm_logits"]
        assert model.cls.bi_seq_relationship is None
        assert model.cls.image_predictions.transform_ln is None
    else:
        np.testing.assert_allclose(got["itm_logits"].numpy(),
                                   np.asarray(want["itm_logits"]),
                                   **MODEL_TOL)
    # the tied decoder: the backbone's table, one parameter
    table = model.bert.embeddings.word_embeddings.weight
    assert got["extras"]["word_table"] is table
    assert sum(p is table for p in model.parameters()) == 1
    assert not any(p.shape == table.shape for n, p in
                   model.named_parameters() if n.startswith("cls."))


def test_bf16_decoder_casts_the_table():
    """In bf16 the decoder reads the table cast to bf16 and its bias cast
    to the logits' dtype (volta_tpu/models/heads.py:88-89): bf16 logits,
    within test_torch_port_model.py's bf16 limit of the float32 model's
    (which the test above holds to JAX's)."""
    _, params = jax_init("ctrl_uniter")
    batch = cc_batch(10, "first")
    args = [torch.from_numpy(batch[k]) for k in MODEL_ARGS]
    out = {}
    for dtype in ("float32", "bfloat16"):
        model = port_model(FAMILIES["ctrl_uniter"](
            use_pallas=False, compute_dtype=dtype), params).eval()
        with torch.no_grad():
            out[dtype] = model(*args)["mlm_logits"]
    assert out["bfloat16"].dtype == torch.bfloat16
    diff = (out["bfloat16"].float() - out["float32"]).abs().max()
    assert 0 < float(diff) < 5e-2


# ------------------------------------------------------------------ steps
_STEPS = {}


def _jax_step(family, jcfg, monkeypatch):
    """(step, params, bits): the JAX step's loss terms, gradients and
    parameters after one clip + AdamW update
    (volta_tpu/parallel/train_step.py:244-287, the step's loss function
    with the objective an argument), jitted once a family, and the keep
    bits its trace draws at its first call (``_bits_in_jit``)."""
    if family in _STEPS:
        return _STEPS[family]
    jmodel, params = jax_init(family, **_STEP_OVER[family])

    def loss_fn(p, jb, objective, key, nce_key):
        lm, il, im = jb["lm_label_ids"], jb["image_label"], jb["is_match"]
        keep = ((im == 0) | (objective != 1))[:, None]
        lm, il = jnp.where(keep, lm, -1), jnp.where(keep, il, -1)
        out = jmodel.apply({"params": p}, *[jb[k] for k in MODEL_ARGS],
                           deterministic=False, rngs={"dropout": key})
        mlm, mrm, itm = jl.pretraining_losses(
            jcfg, out, masked_lm_labels=lm, image_label=il,
            image_cls=jb["image_cls"],
            image_feat=jax_strip(jcfg, jb["image_feat"]),
            obj_labels=jb["obj_labels"], obj_confs=jb["obj_confs"],
            attr_labels=jb["attr_labels"], attr_confs=jb["attr_confs"],
            next_sentence_label=im, rng=nce_key)
        itm = jnp.where(objective == 2, itm * 0.0, itm)
        return mlm + mrm + itm, (mlm, mrm, itm)

    tx = jax_build_optimizer("adamw", jax_warmup(LR, 0, 4), params,
                             weight_decay=WD, clip_norm=CLIP, betas=BETAS,
                             eps=EPS)

    def step(p, jb, objective, key, nce_key):
        (loss, terms), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            p, jb, objective, key, nce_key)
        return loss, terms, grads, optax.apply_updates(
            p, tx.update(grads, tx.init(p), p)[0])

    _STEPS[family] = (jax.jit(step), params, _bits_in_jit(monkeypatch))
    return _STEPS[family]


def _fed_pooled(monkeypatch, bit):
    """The heads' pooled dropout takes JAX's keep bits ``bit``."""
    from volta_tpu_torch.ops.hash_dropout import apply_keep_mask

    def drop(x, seed, rate):
        assert tuple(x.shape) == bit.shape
        return apply_keep_mask(x, torch.from_numpy(bit), rate)

    monkeypatch.setattr(pheads, "hash_dropout", drop)


def _feed_negatives(monkeypatch, idx):
    monkeypatch.setattr(pl, "sample_negatives",
                        lambda b, r, n, g, device: torch.from_numpy(idx))


STEP_CASES = [("ctrl_uniter", 0), ("ctrl_uniter", 1), ("ctrl_uniter", 2),
              ("lxmert", 2)]
# attention dropout alone in the encoder (0.1 a stream): the other sites
# draw other masks in the two packages (hash dropout, Flax nn.Dropout)
_STEP_OVER = {f: dict(use_pallas=False, hidden_dropout_prob=0.0,
                      v_hidden_dropout_prob=0.0,
                      v_attention_probs_dropout_prob=0.1)
              for f in ("ctrl_uniter", "lxmert")}


@pytest.mark.parametrize("family,objective", STEP_CASES)
def test_pretrain_step_matches_jax(family, objective, monkeypatch):
    """One step: the losses, every gradient and every parameter after clip
    + AdamW. ctrl_uniter with KL and NCE; lxmert.json's shapes under
    objective 2 (its ITM head takes zero gradients, every parameter is
    updated or decayed, none is left out)."""
    jcfg = FAMILIES[family](**_STEP_OVER[family])
    batch = cc_batch(11, jcfg.add_global_imgfeat)
    key, nce_key = jax.random.PRNGKey(5), jax.random.PRNGKey(6)
    jstep, params, bits = _jax_step(family, jcfg, monkeypatch)
    jloss, jterms, jgrads, jparams = jstep(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()}, objective, key,
        nce_key)
    assert bits[-1].shape == (B, SMALL["pooler_size"])  # the pooled output

    model = port_model(jcfg, params).train()
    fed = _feed_bits(monkeypatch, list(bits[:-1]))
    _fed_pooled(monkeypatch, bits[-1])
    _feed_negatives(monkeypatch, jax_neg_idx(nce_key, B, R))
    opt = build_optimizer("adamw", warmup_linear_schedule(LR, 0, 4), model,
                          weight_decay=WD, clip_norm=CLIP, betas=BETAS,
                          eps=EPS)
    grads = {}
    step_opt = opt.step

    def capture():
        grads.update({n: (p.grad.clone() if p.grad is not None else None)
                      for n, p in model.named_parameters()})
        step_opt()

    opt.step = capture
    state = create_train_state(model, opt, seed=0)
    before = dict(LAUNCHES)
    out = make_pretrain_step(model, opt, pcfg_of(jcfg),
                             objective=objective)(state, batch)
    assert fed == [] and LAUNCHES == before and state.step == 1
    np.testing.assert_allclose(
        [float(out[k]) for k in ("loss", "masked_t", "masked_v", "itm")],
        [float(jloss)] + [float(t) for t in jterms], **STEP_TOL)
    ref = state_dict_from_flax(jax.tree.map(np.asarray, jgrads))
    assert [n for n, g in grads.items() if g is None] == []
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(),
                                   **STEP_TOL, err_msg=name)
    if objective == 2:
        assert float(out["itm"]) == 0.0
        assert all(not g.any() for n, g in grads.items()
                   if n.startswith("cls.bi_seq_relationship"))
    want = state_dict_from_flax(jax.tree.map(np.asarray, jparams))
    start = state_dict_from_flax(params)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                   **STEP_TOL, err_msg=name)
        if no_decay_mask(model)[name]:
            assert not torch.equal(p, start[name]), name  # decayed


def test_pretrain_eval_step_matches_jax(monkeypatch):
    jmodel, params = jax_init("ctrl_uniter", use_pallas=False)
    jcfg = jmodel.cfg
    batch = cc_batch(12, "first")
    want = jax_eval_step(jmodel, jcfg)(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    model = port_model(jcfg, params).train()
    _feed_negatives(monkeypatch, jax_neg_idx(jax.random.PRNGKey(0), B, R))
    step = make_pretrain_eval_step(model, pcfg_of(jcfg))
    got = step(batch)
    assert model.training  # the mode is restored
    keys = ("loss", "masked_t", "masked_v", "itm")
    np.testing.assert_allclose([float(got[k]) for k in keys],
                               [float(want[k]) for k in keys],
                               rtol=CRIT_RTOL)
    again = step(batch)
    assert all(torch.equal(got[k], again[k]) for k in keys)


# ------------------------------------------------------ masks, checkpoints
@pytest.mark.parametrize("family", list(FAMILIES))
def test_no_decay_mask_matches_jax(family):
    jmodel, params = jax_init(family)
    mask = jax.tree.map(lambda x: np.float32(x), jax_no_decay_mask(params))
    want = {k: bool(v.item()) for k, v in state_dict_from_flax(mask).items()}
    got = no_decay_mask(VoltaForVLPreTraining(pcfg_of(jmodel.cfg)))
    assert got == want
    assert not got["cls.predictions.decoder_bias"]
    assert got.get("cls.bi_seq_relationship.weight", True)
    assert not any(v for k, v in got.items() if "transform_ln" in k)


@pytest.mark.parametrize("family", ["ctrl_uniter", "lxmert", "vl-bert"])
def test_export_matches_jax(family):
    jmodel, params = jax_init(family)
    jcfg = jmodel.cfg
    want, jrep = jck.export_torch_state_dict(jcfg, params)
    model = port_model(jcfg, params)
    got, rep = ck.export_reference_state_dict(pcfg_of(jcfg), model)
    assert rep == jrep == {"unexported": []}
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)
    assert got["cls.predictions.decoder.weight"] is \
        got["bert.embeddings.word_embeddings.weight"]
    fresh = VoltaForVLPreTraining(pcfg_of(jcfg))
    report = ck.import_state_dict(pcfg_of(jcfg), fresh, got, strict=True)
    # the unused keys: the second names of shared tensors, the tied
    # decoder among them
    assert report["skipped"] == []
    assert set(report["unused"]) == ck._alias_key_set(pcfg_of(jcfg), got)
    assert "cls.predictions.decoder.weight" in report["unused"]
    for (n, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), n


def _resume_setup(seed=0):
    cfg = pcfg_of(FAMILIES["ctrl_uniter"]())
    model = VoltaForVLPreTraining(cfg)
    from volta_tpu_torch.models.layers import init_weights

    init_weights(model, torch.Generator().manual_seed(seed))
    opt = build_optimizer("adamw", warmup_linear_schedule(LR, 1, 6), model,
                          clip_norm=CLIP)
    state = create_train_state(model.train(), opt, seed=1)
    return cfg, state, make_pretrain_step(model, opt, cfg, objective=1)


def test_resume_bit_for_bit(tmp_path):
    """Four steps straight against two, a save, a resume into fresh weights
    and two more: the port's train state and the reference tar (which
    holds no generator: the resumed run takes the saved run's) give the
    same parameters and moments, bit for bit."""
    batches = [cc_batch(20 + i, "first") for i in range(4)]
    _, ref_state, ref_step = _resume_setup()
    for b in batches:
        ref_step(ref_state, b)

    cfg, state, step = _resume_setup()
    for b in batches[:2]:
        step(state, b)
    ck.save_train_state(str(tmp_path / "run"), state, 0, -1.0)
    ck.save_reference_tar(str(tmp_path / "ckpt.tar"), cfg, state, 0)
    gen = state.generator.get_state()
    for src in ("run", "ckpt.tar"):
        _, fresh, fstep = _resume_setup(seed=7)
        info = ck.resume(cfg, fresh, str(tmp_path / src), 2, 2)
        assert info["start_epoch"] == 1 and fresh.step == 2
        if src == "ckpt.tar":
            fresh.generator.set_state(gen)
        for b in batches[2:]:
            fstep(fresh, b)
        for (n, a), b in zip(ref_state.model.state_dict().items(),
                             fresh.model.state_dict().values()):
            assert torch.equal(a, b), (src, n)
        for key in ("mu", "nu"):
            for a, b in zip(getattr(ref_state.optimizer, key),
                            getattr(fresh.optimizer, key)):
                assert torch.equal(a, b), (src, key)


def test_bf16_pretraining_model_trains():
    """bf16 compute: a few steps on one batch are finite and the loss falls
    (the CPU runs every kernel's twin)."""
    cfg = pcfg_of(FAMILIES["ctrl_uniter"](compute_dtype="bfloat16"))
    model = VoltaForVLPreTraining(cfg)
    from volta_tpu_torch.data.packed import bf16_bits
    from volta_tpu_torch.models.layers import init_weights

    init_weights(model, torch.Generator().manual_seed(3))
    opt = build_optimizer("adamw", 1e-3, model, clip_norm=5.0)
    state = create_train_state(model.train(), opt, seed=2)
    step = make_pretrain_step(model, opt, cfg, objective=0)
    batch = cc_batch(30, "first")
    # the features and soft targets as a packed bf16 store gives them:
    # bf16 bit patterns
    for k in ("image_feat", "image_cls"):
        batch[k] = bf16_bits(batch[k])
    losses = [float(step(state, batch)["loss"]) for _ in range(6)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_hf_bert_bin_loads_as_in_jax(tmp_path):
    """An HF BERT ``.bin`` (its text layers and MLM bias, no other ``cls``
    key) into the pretraining model through ``from_pretrained``: JAX's
    report and weights, the heads but the MLM bias left at init."""
    from test_torch_port_checkpoint import hf_state_dict, torch_sd

    jmodel, params = jax_init("ctrl_uniter")
    jcfg = jmodel.cfg
    hf = hf_state_dict(jcfg, params, "bert.")
    hf["cls.predictions.bias"] = np.arange(V, dtype=np.float32)
    other = jax.tree.map(lambda x: np.asarray(x) * 0.5 + 0.01, params)
    jnew, jreport = jck.import_state_dict(jcfg, {"params": other}, hf,
                                          from_hf=True)
    want = state_dict_from_flax(jax.tree.map(np.asarray, jnew["params"]))
    model = port_model(jcfg, other)
    path = str(tmp_path / "hf.bin")
    torch.save(torch_sd(hf), path)
    report = ck.from_pretrained(pcfg_of(jcfg), model, path)
    assert report == jreport
    assert "cls.predictions.decoder_bias" in report["loaded"]
    assert any(k.startswith("cls.image_predictions") for k in
               report["skipped"])
    for k, v in want.items():
        assert torch.equal(model.state_dict()[k], v), k
