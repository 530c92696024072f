"""The other five families of the port against the JAX package on the CPU:
ViLBERT and LXMERT (dual-stream, ``TextEmbeddings`` beside their image
embeddings), VisualBERT and VL-BERT (single-stream, their joint
embeddings), and the RoBERTa text positions.

Small models from the JAX ``zoo`` (hidden 64, 4 heads of 16): a ViLBERT of
two text layers with its trunk from layer 1 (a text-only attention, a
co-attention, a per-modality attention, their feed-forwards), one whose
vision stream and co-attention are wider than the text (v_hidden 96, 2
heads of 48 in the co-attention and the vision stream), an LXMERT of one
text, one vision and one cross layer, and two-layer VisualBERT and VL-BERT.
One Flax init each, bridged with ``convert.state_dict_from_flax``, and the
same seed-made numpy inputs on both sides (8 text tokens and 10 regions, so
both query streams pass the kernels' gate of 8):

* the embeddings, fp32 within 1e-5 and bf16 as test_torch_port_model.py
  holds them; the encoder with ``use_pallas`` true (JAX's Pallas kernels in
  the interpreter, the port's twins) and false (both plain), fp32 1e-5 and
  bf16 1e-1; the logits, loss and score of each head type of the family's
  yml, fp32 1e-5 and bf16 5e-2;
* in training mode (attention dropout only, 0.1 text and 0.2 vision where
  the streams do not share) the loss and every gradient, the keep bits of
  JAX's ``nn.Dropout`` draws fed in as test_torch_port_capture.py feeds
  them (fp32 rtol 1e-4 / atol 1e-6);
* ``_attn_data`` on the dual plans against JAX's extras (None for absent
  flows, the (vt, vv) split order);
* ``fuse_dual_stream`` / ``fuse_dual_qkv`` against the unfused port and
  against JAX, as tests/test_fused_dual_stream.py holds JAX, and
  ``residual_ln_seg`` with its dropout bit for bit against JAX's for the
  seed JAX's key draws;
* the RoBERTa position offset; VL-BERT's zero-feature rows, position ids,
  ``obj_downsample`` dropout site and the [MASK] pooler on an
  ``append_mask_sep`` batch made by both packages' datasets;
* all eight ``configs/*.json``: the same ``sublayer_plan()`` and the same
  parameter tree as the JAX module's, shape for shape;
* the Flax bridge round-trips every leaf, and a JAX-exported reference
  ``.bin`` imports with JAX's report and logits, and the port's export
  equals JAX's, key for key and bit for bit.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_plain_route import _feed_bits
from test_torch_port_tasks import TASKS, make_task_batch
from volta_tpu import task_utils as jtu
from volta_tpu import zoo
from volta_tpu.config import VoltaConfig as JaxConfig
from volta_tpu.models import VoltaForVLTasks as JaxVLTasks
from volta_tpu.models import embeddings as jemb
from volta_tpu.models.encoder import GatedEncoder as JaxEncoder
from volta_tpu.ops import pallas_attention as pa
from volta_tpu.ops.attention import additive_mask as jax_mask
from volta_tpu_torch import VoltaForVLTasks
from volta_tpu_torch import task_utils as ptu
from volta_tpu_torch.config import VoltaConfig
from volta_tpu_torch.convert import load_flax_params, state_dict_from_flax
from volta_tpu_torch.eval_step import make_task_eval_step
from volta_tpu_torch.ops.attention import additive_mask

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, LT, LV, F = 2, 8, 10, 32
SMALL = dict(hidden_size=64, num_attention_heads=4, intermediate_size=128,
             pooler_size=64, v_pooler_size=64, vocab_size=50,
             max_position_embeddings=40, v_feature_size=F, v_hidden_size=64,
             v_num_attention_heads=4, v_intermediate_size=128,
             clf_hidden_size=48)
# a vision stream and a co-attention wider than the text, with other heads
WIDE = dict(SMALL, v_hidden_size=96, v_num_attention_heads=2,
            v_intermediate_size=80, sublayer2attn_hidden_size={"2": 96},
            sublayer2num_attention_heads={"2": 2})
VLBERT = dict(SMALL, type_vocab_size=3, v_coordinate_embeddings_dim=8,
              visual_target_weights={"6": 1.0})
FAMILIES = {
    "vilbert": lambda **o: zoo.vilbert(depth_text=2, cross_start=1,
                                       **{**SMALL, **o}),
    "vilbert_wide": lambda **o: zoo.vilbert(depth_text=2, cross_start=1,
                                            **{**WIDE, **o}),
    "lxmert": lambda **o: zoo.lxmert(n_text=1, n_vision=1, n_cross=1,
                                     **{**SMALL, **o}),
    "visualbert": lambda **o: zoo.single_stream("visualbert", depth=2,
                                                **{**SMALL, **o}),
    "vl-bert": lambda **o: zoo.single_stream("vl-bert", depth=2,
                                             **{**VLBERT, **o}),
}
# the head types of each family's yml (config_tasks/*_trainval_tasks.yml)
# among test_torch_port_tasks.py's tasks: VQA (and GQA's, the same head),
# retrieval, RefCOCO+ (VL-BERT's with two layers), NLVR2, and ViLBERT's
# tri-classifier
HEADS = {"vilbert": ("TASK1", "TASK8", "TASK10", "TASK12", "TASK13"),
         "vilbert_wide": ("TASK1", "TASK10"),
         "lxmert": ("TASK1", "TASK8", "TASK10", "TASK12"),
         "visualbert": ("TASK1", "TASK8", "TASK10", "TASK12"),
         "vl-bert": ("TASK1", "TASK8", "TASK11", "TASK12")}
TOL = dict(rtol=1e-5, atol=1e-5)
DUAL = ("vilbert", "vilbert_wide", "lxmert")


def make_batch(seed=0, lv=LV):
    """A VQA-shaped batch: padded text and regions, one all-zero feature
    row (a masked region for VL-BERT)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 50, (B, LT)).astype(np.int32)
    ids[1, 5:] = 0
    feats = rng.randn(B, lv, F).astype(np.float32)
    feats[0, 3] = 0.0
    v_mask = np.ones((B, lv), np.int32)
    v_mask[1, lv - 3:] = 0
    target = np.zeros((B, 9), np.float32)
    target[np.arange(B), rng.randint(0, 9, B)] = 1.0
    return {"question": ids, "features": feats,
            "spatials": rng.rand(B, lv, 5).astype(np.float32),
            "segment_ids": np.zeros((B, LT), np.int32),
            "input_mask": (ids != 0).astype(np.int32),
            "image_mask": v_mask, "target": target}


KEYS = ("question", "features", "spatials")
MASKS = ("segment_ids", "input_mask", "image_mask")


def jcfg(family, **o):
    return FAMILIES[family](**o)


def pcfg(family, **o):
    return VoltaConfig.from_dict(jcfg(family, **o).to_dict())


def heads(family):
    return {t: TASKS[t] for t in HEADS[family]}


_PARAMS = {}


def flax_params(family):
    """One Flax init of the family with its heads, made once."""
    if family not in _PARAMS:
        batch = make_batch()
        model = JaxVLTasks(jcfg(family), heads(family), HEADS[family])
        # eagerly: at these sizes a jitted init spends seconds compiling
        variables = model.init(jax.random.PRNGKey(0), *_j(batch, KEYS),
                               "TASK1", *_j(batch, MASKS))
        _PARAMS[family] = jax.tree.map(np.asarray, variables["params"])
    return _PARAMS[family]


def port(family, params=None, dropout_prob=0.1, **o):
    model = VoltaForVLTasks(pcfg(family, **o), heads(family), HEADS[family],
                            dropout_prob=dropout_prob)
    return load_flax_params(model, params or flax_params(family))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, dtype, atol_bf16, what=""):
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **TOL, err_msg=what)
    else:
        diff = float(np.abs(_np(got) - _np(want)).max())
        assert diff <= atol_bf16, (what, diff)


def _t(batch, keys):
    return [torch.from_numpy(batch[k]) for k in keys]


def _j(batch, keys):
    return [jnp.asarray(batch[k]) for k in keys]


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("name", zoo.ZOO_NAMES)
def test_every_config_builds_the_jax_tree(name):
    """``configs/<name>.json``: the port's plan equals JAX's field for
    field, and its model's parameters are the JAX module's tree, path for
    path and shape for shape (JAX traced abstractly, the port on the meta
    device; the full widths, nothing allocated)."""
    path = os.path.join(REPO, "configs", name + ".json")
    jc, pc = JaxConfig.from_json_file(path), VoltaConfig.from_json_file(path)
    assert [dataclasses.asdict(s) for s in pc.sublayer_plan()] == \
        [dataclasses.asdict(s) for s in jc.sublayer_plan()]
    if jc.fusion_method == "none":
        # vl-bert_base's VQA, as its yml overrides the fusion
        jc.fusion_method = pc.fusion_method = "vl-bert_vqa"
    jc = dataclasses.replace(jc, use_pallas=False)
    task = {"TASK1": TASKS["TASK1"]}
    model = JaxVLTasks(jc, task, ("TASK1",))
    ids = jnp.ones((1, 4), jnp.int32)
    shapes = jax.eval_shape(lambda r: model.init(
        r, ids, jnp.ones((1, 3, jc.v_feature_size)),
        jnp.ones((1, 3, jc.num_locs)), "TASK1"), jax.random.PRNGKey(0))
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                shape = tuple(v.shape)
                flat[".".join(prefix + ({"kernel": "weight",
                                        "scale": "weight",
                                        "embedding": "weight"}.get(k, k),))
                     ] = shape[::-1] if k == "kernel" else shape

    walk(shapes["params"], ())
    with torch.device("meta"):
        pm = VoltaForVLTasks(pc, task, ("TASK1",))
    got = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert got == flat


# ------------------------------------------------------------- embeddings
def _jax_embeddings(family, cfg, params, batch):
    p = params["bert"]
    if family in DUAL:
        t, _ = jemb.TextEmbeddings(cfg).apply(
            {"params": p["embeddings"]}, *_j(batch, ("question",
                                                     "segment_ids")))
        v = jemb.DUAL_EMBEDDINGS[cfg.image_embeddings](cfg).apply(
            {"params": p["v_embeddings"]}, *_j(batch, ("features",
                                                       "spatials")))
        return t, v
    t, v, _ = jemb.SHARED_EMBEDDINGS[cfg.image_embeddings](cfg).apply(
        {"params": p["embeddings"]}, *_j(batch, KEYS + ("segment_ids",)))
    return t, v


def _port_embeddings(family, model, batch):
    bert = model.bert
    with torch.no_grad():
        if family in DUAL:
            return (bert.embeddings(*_t(batch, ("question", "segment_ids"))),
                    bert.v_embeddings(*_t(batch, ("features", "spatials"))))
        return bert.embeddings(*_t(batch, KEYS + ("segment_ids",)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_embeddings_match(family, dtype):
    batch = make_batch(1)
    params = flax_params(family)
    jt, jv = _jax_embeddings(family, jcfg(family, compute_dtype=dtype),
                             params, batch)
    tt, tv = _port_embeddings(family, port(family, compute_dtype=dtype)
                              .eval(), batch)
    assert tt.dtype == tv.dtype == getattr(torch, dtype)
    assert tt.shape == jt.shape and tv.shape == jv.shape
    # bf16: LN outputs are O(3), where one bf16 ulp is 1.6e-2
    _close(tt, jt, dtype, 3.2e-2, "text")
    _close(tv, jv, dtype, 3.2e-2, "vision")


# ------------------------------------------------------- encoder and heads
@pytest.mark.parametrize("dtype,use_pallas", [
    ("float32", True), ("float32", False), ("bfloat16", True)],
    ids=["pallas", "xla", "pallas-bf16"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_encoder_matches(family, dtype, use_pallas):
    rng = np.random.RandomState(5)
    cfg = jcfg(family, compute_dtype=dtype, use_pallas=use_pallas)
    t = rng.randn(B, LT, cfg.hidden_size).astype(np.float32)
    v = rng.randn(B, LV, cfg.v_hidden_size).astype(np.float32)
    batch = make_batch(4)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    traced = pa.TRACE_COUNT[0]
    with pa.interpret_mode():
        jt, jv, _ = JaxEncoder(cfg).apply(
            {"params": flax_params(family)["bert"]["encoder"]},
            jnp.asarray(t, jdt), jnp.asarray(v, jdt),
            jax_mask(jnp.asarray(batch["input_mask"])),
            jax_mask(jnp.asarray(batch["image_mask"])))
    assert (pa.TRACE_COUNT[0] > traced) == use_pallas
    model = port(family, compute_dtype=dtype, use_pallas=use_pallas).eval()
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        tt, tv = model.bert.encoder(
            torch.from_numpy(t).to(tdt), torch.from_numpy(v).to(tdt),
            additive_mask(torch.from_numpy(batch["input_mask"])),
            additive_mask(torch.from_numpy(batch["image_mask"])))
    assert tt.dtype == tv.dtype == tdt
    # bf16: a few sublayers of rounding on O(3) LN outputs
    _close(tt, jt, dtype, 1e-1, "text")
    _close(tv, jv, dtype, 1e-1, "vision")


def _jax_heads(family, params, batches):
    """JAX's fp32 logits, loss and score of every head on its batch, in
    one jitted call on the plain route."""
    model = JaxVLTasks(jcfg(family, use_pallas=False), heads(family),
                       HEADS[family])

    def fn(p, jbs):
        out = {}
        for task, jb in jbs.items():
            tc = TASKS[task]
            inputs, info = jtu.process_batch(tc, jb)
            pred, _ = model.apply(
                {"params": p},
                *[inputs[k] for k in ("input_ids", "image_feat",
                                      "image_loc")], task,
                *[inputs[k] for k in ("token_type_ids", "attention_mask",
                                      "image_attention_mask")])
            out[task] = (pred, *jtu.task_loss_and_score(
                tc["type"], pred, jb, info, tc["loss"]))
        return out

    jbs = {t: {k: jnp.asarray(v) for k, v in b.items() if k != "question_id"}
           for t, b in batches.items()}
    return jax.tree.map(np.asarray, jax.jit(fn)(params, jbs))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_head_matches(family):
    """Each head type of the family's yml through the port's eval step
    against JAX's, fp32 logits, loss and score, on the plain route of both
    (``test_encoder_matches`` holds the kernel route and bf16)."""
    batches = {t: make_task_batch(t, seed=7) for t in HEADS[family]}
    want = _jax_heads(family, flax_params(family), batches)
    model = port(family, use_pallas=False).eval()
    for task, batch in batches.items():
        ref, jloss, jscore = want[task]
        out = make_task_eval_step(model, heads(family), task)(batch)
        assert out["prediction"].shape == ref.shape
        _close(out["prediction"], ref, "float32", 0, task)
        np.testing.assert_allclose(float(out["loss"]), float(jloss),
                                   rtol=1e-5, err_msg=task)
        assert float(out["score"]) == float(jscore), task


# ------------------------------------------------------------- training
def _bits_in_jit(monkeypatch):
    """``jax.random.bernoulli`` replaced by seed-made numpy keep bits,
    constants of the traced step, recorded in call order: the draws Flax's
    ``nn.Dropout`` makes, under ``jax.jit``."""
    bits, rng = [], np.random.RandomState(12)

    def draw(key, p=0.5, shape=None):
        keep = rng.rand(*shape) < p
        bits.append(keep)
        return jnp.asarray(keep)

    monkeypatch.setattr(jax.random, "bernoulli", draw)
    return bits


def _train_over(family):
    """Attention dropout alone (0.1, and 0.2 for a vision stream that
    does not share): the other sites draw other masks in the two packages
    (hash dropout, Flax nn.Dropout)."""
    return dict(hidden_dropout_prob=0.0, v_hidden_dropout_prob=0.0,
                v_attention_probs_dropout_prob=0.0 if family == "vl-bert"
                else 0.2, use_pallas=False)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_loss_and_grads_match_jax(family, monkeypatch):
    batch = make_batch(6)
    over = _train_over(family)
    task = {"TASK1": TASKS["TASK1"]}
    jmodel = JaxVLTasks(jcfg(family, **over), task, ("TASK1",),
                        dropout_prob=0.0)
    params = {k: v for k, v in flax_params(family).items()
              if not k.startswith("clf_") or k == "clf_TASK1"}

    def loss_fn(p):
        pred, _ = jmodel.apply(
            {"params": p}, *_j(batch, KEYS), "TASK1", *_j(batch, MASKS),
            deterministic=False, rngs={"dropout": jax.random.PRNGKey(7)})
        return jtu.task_loss_and_score(
            "VL-classifier", pred, {"target": jnp.asarray(batch["target"])},
            {"batch_size": B})[0]

    bits = _bits_in_jit(monkeypatch)
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, params))
    attn = [s for s in pcfg(family).sublayer_plan() if s.kind == "attn"]
    streams = sum(s.has_text + s.has_vision for s in attn)
    assert len(bits) == (streams if family in DUAL else len(attn))
    model = VoltaForVLTasks(pcfg(family, **over), task, ("TASK1",),
                            dropout_prob=0.0)
    model = load_flax_params(model, params).train()
    fed = _feed_bits(monkeypatch, bits)
    pred = model(*_t(batch, KEYS), "TASK1", *_t(batch, MASKS),
                 dropout_seed=5)
    loss, _ = ptu.task_loss_and_score(
        "VL-classifier", pred, {"target": torch.from_numpy(batch["target"])},
        {"batch_size": B})
    loss.backward()
    assert fed == []
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    ref = state_dict_from_flax(jax.tree.map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


