"""The port's ctrl_uniter serving slice against the JAX package on the CPU.

A small single-stream UNITER (two attention + feed-forward pairs, hidden 64,
4 heads of 16) is initialised in Flax, bridged into the port with
``convert.state_dict_from_flax`` and fed the same numpy batch (8 text tokens
+ 6 regions, so L = 14 >= 8 and the JAX kernel gate opens). Embeddings,
encoder, full ``VoltaForVLTasks`` logits and the VQA loss and score are
compared. The JAX model runs both through the Pallas kernel (in the Mosaic
interpreter) and through its plain XLA path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volta_tpu import zoo
from volta_tpu.models import VoltaForVLTasks as JaxVLTasks
from volta_tpu.models.embeddings import UniterEmbeddings as JaxUniterEmb
from volta_tpu.models.encoder import GatedEncoder as JaxEncoder
from volta_tpu.ops import pallas_attention as pa
from volta_tpu.ops.attention import additive_mask as jax_mask
from volta_tpu.task_utils import task_loss_and_score as jax_loss_and_score
from volta_tpu_torch import VoltaForVLTasks
from volta_tpu_torch.convert import load_flax_params, state_dict_from_flax
from volta_tpu_torch.ops.attention import additive_mask
from volta_tpu_torch.task_utils import task_loss_and_score

TASK_CFG = {"TASK1": {"type": "VL-classifier", "num_labels": 9,
                      "process": "normal", "loss": "BCEWithLogitLoss"}}
B, LT, LV = 3, 8, 6


def small_cfg(dtype="float32", use_pallas=False):
    return zoo.single_stream(
        "uniter", depth=2, hidden_size=64, num_attention_heads=4,
        intermediate_size=128, pooler_size=64, v_pooler_size=64,
        vocab_size=50, max_position_embeddings=32, v_feature_size=32,
        v_hidden_size=64, v_num_attention_heads=4, v_intermediate_size=128,
        clf_hidden_size=48, compute_dtype=dtype, use_pallas=use_pallas)


def make_batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 50, (B, LT)).astype(np.int32)
    t_mask = np.ones((B, LT), np.int32)
    t_mask[1, 5:] = 0
    ids[t_mask == 0] = 0
    v_mask = np.ones((B, LV), np.int32)
    v_mask[2, 4:] = 0
    target = np.zeros((B, 9), np.float32)
    target[np.arange(B), rng.randint(0, 9, B)] = 1.0
    target[0, 3] = 0.6
    return {"question": ids, "features": rng.randn(B, LV, 32).astype(
                np.float32),
            "spatials": rng.rand(B, LV, 5).astype(np.float32),
            "segment_ids": np.zeros((B, LT), np.int32),
            "input_mask": t_mask, "image_mask": v_mask, "target": target}


def _args(batch, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return [conv(batch[k]) for k in ("question", "features", "spatials")]


@pytest.fixture(scope="module")
def flax_params():
    batch = make_batch()
    model = JaxVLTasks(small_cfg(), TASK_CFG, ("TASK1",))
    q, f, s = _args(batch, "jax")
    variables = jax.jit(lambda r: model.init(
        r, q, f, s, "TASK1", jnp.asarray(batch["segment_ids"]),
        jnp.asarray(batch["input_mask"]),
        jnp.asarray(batch["image_mask"])))(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, variables["params"])


def torch_model(params, dtype="float32", use_pallas=True):
    """The port's model on ``params``; ``use_pallas`` picks its attention
    route as JAX's gate does (the kernels' twins here, or the plain
    composition)."""
    model = VoltaForVLTasks(small_cfg(dtype, use_pallas), TASK_CFG,
                            ("TASK1",))
    return load_flax_params(model, params).eval()


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_bridge_round_trips_every_leaf(flax_params):
    sd = state_dict_from_flax({"params": flax_params})
    model = torch_model(flax_params)
    own = model.state_dict()
    assert set(sd) == set(own)
    n = 0
    for path, val in _leaves(flax_params):
        leaf = {"kernel": "weight", "scale": "weight", "embedding": "weight",
                "bias": "bias"}[path[-1]]
        key = ".".join(path[:-1] + (leaf,))
        want = val.T if path[-1] == "kernel" else val
        np.testing.assert_array_equal(own[key].numpy(), want, err_msg=key)
        n += 1
    assert n == len(own)
    for name in ("bert.encoder.attn_0.query.weight",
                 "bert.embeddings.word_embeddings.weight",
                 "bert.t_pooler.dense.weight", "clf_TASK1.dense1.weight"):
        assert name in own

    # a leaf left over on either side raises
    extra = dict(flax_params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(RuntimeError, match="stray"):
        load_flax_params(torch_model(flax_params), extra)
    short = {k: v for k, v in flax_params.items() if k != "clf_TASK1"}
    with pytest.raises(RuntimeError, match="clf_TASK1"):
        load_flax_params(torch_model(flax_params), short)
    with pytest.raises(KeyError, match="momentum"):
        state_dict_from_flax({"a": {"momentum": np.zeros(2)}})


def _close(got, ref, dtype, atol_bf16):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    else:
        diff = float(np.abs(got - ref).max())
        assert diff <= atol_bf16, diff


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embeddings_match(flax_params, dtype):
    batch = make_batch(1)
    cfg = small_cfg(dtype)
    jt, jv, _ = JaxUniterEmb(cfg).apply(
        {"params": flax_params["bert"]["embeddings"]}, *_args(batch, "jax"),
        jnp.asarray(batch["segment_ids"]))
    model = torch_model(flax_params, dtype)
    with torch.no_grad():
        tt, tv = model.bert.embeddings(*_args(batch, "torch"),
                                       torch.from_numpy(batch["segment_ids"]))
    assert tt.dtype == tv.dtype == getattr(torch, dtype)
    # bf16: LN outputs are O(3), where one bf16 ulp is 1.6e-2
    _close(tt, jt, dtype, 3.2e-2)
    _close(tv, jv, dtype, 3.2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "xla"])
def test_encoder_matches(flax_params, dtype, use_pallas):
    batch = make_batch(2)
    rng = np.random.RandomState(5)
    t = rng.randn(B, LT, 64).astype(np.float32)
    v = rng.randn(B, LV, 64).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    with pa.interpret_mode():
        jt, jv, _ = JaxEncoder(small_cfg(dtype, use_pallas)).apply(
            {"params": flax_params["bert"]["encoder"]},
            jnp.asarray(t, jdt), jnp.asarray(v, jdt),
            jax_mask(jnp.asarray(batch["input_mask"])),
            jax_mask(jnp.asarray(batch["image_mask"])))
    model = torch_model(flax_params, dtype, use_pallas)
    with torch.no_grad():
        tt, tv = model.bert.encoder(
            torch.from_numpy(t).to(tdt), torch.from_numpy(v).to(tdt),
            additive_mask(torch.from_numpy(batch["input_mask"])),
            additive_mask(torch.from_numpy(batch["image_mask"])))
    # bf16: 4 sublayers of rounding on O(3) LN outputs
    _close(tt, jt, dtype, 1e-1)
    _close(tv, jv, dtype, 1e-1)


def _jax_logits(params, batch, dtype, use_pallas):
    model = JaxVLTasks(small_cfg(dtype, use_pallas), TASK_CFG, ("TASK1",))
    with pa.interpret_mode():
        pred, _ = model.apply(
            {"params": params}, *_args(batch, "jax"), "TASK1",
            jnp.asarray(batch["segment_ids"]),
            jnp.asarray(batch["input_mask"]),
            jnp.asarray(batch["image_mask"]))
    return pred


def _torch_logits(model, batch):
    with torch.no_grad():
        return model(*_args(batch, "torch"), "TASK1",
                     torch.from_numpy(batch["segment_ids"]),
                     torch.from_numpy(batch["input_mask"]),
                     torch.from_numpy(batch["image_mask"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "xla"])
def test_full_logits_and_loss_match(flax_params, dtype, use_pallas):
    batch = make_batch(3)
    ref = _jax_logits(flax_params, batch, dtype, use_pallas)
    if use_pallas:
        assert pa.TRACE_COUNT[0] > 0
    got = _torch_logits(torch_model(flax_params, dtype, use_pallas), batch)
    assert got.shape == (B, 9) and got.dtype == getattr(torch, dtype)
    # bf16 atol 5e-2 on logits; the largest difference found (batch seeds
    # 3-7, both JAX paths) was 1.95e-3, one bf16 ulp of logits of ~0.3
    _close(got, ref, dtype, 5e-2)

    jb = {"target": jnp.asarray(batch["target"])}
    jloss, jscore = jax_loss_and_score("VL-classifier", ref, jb,
                                       {"batch_size": B})
    tloss, tscore = task_loss_and_score(
        "VL-classifier", got, {"target": torch.from_numpy(batch["target"])},
        {"batch_size": B})
    if dtype == "float32":
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(tscore), float(jscore), rtol=1e-6)
    # the loss on the port's own logits matches the JAX loss function
    jloss2, jscore2 = jax_loss_and_score(
        "VL-classifier", jnp.asarray(got.float().numpy()), jb,
        {"batch_size": B})
    np.testing.assert_allclose(float(tloss), float(jloss2), rtol=1e-5)
    assert float(tscore) == float(jscore2)


def test_unported_configs_raise(tmp_path):
    """What the port still refuses: the JAX package's own Flax msgpack and
    Orbax saves, and a head type the JAX module does not know. Every
    family's config builds (tests/test_torch_port_families.py holds each
    against JAX), and so does ``use_scan`` (tests/test_torch_port_scan.py
    holds its route against JAX's)."""
    from volta_tpu_torch import checkpoint as ck
    from volta_tpu_torch.config import VoltaConfig

    cfg = dataclasses.replace(small_cfg(), use_scan=True)
    assert VoltaForVLTasks(cfg, TASK_CFG, ("TASK1",)).bert.encoder.scan
    pcfg = VoltaConfig.from_dict(small_cfg().to_dict())
    model = VoltaForVLTasks(pcfg, TASK_CFG, ("TASK1",))
    for name, leaf in (("flax", "flax_model.msgpack"),
                       ("orbax", "_CHECKPOINT_METADATA")):
        (tmp_path / name).mkdir()
        (tmp_path / name / leaf).write_bytes(b"")
        with pytest.raises(NotImplementedError, match="Orbax"):
            ck.from_pretrained(pcfg, model, str(tmp_path / name))
    # every head type of the JAX module is ported; an unknown one raises
    # as the JAX module's does
    VoltaForVLTasks(small_cfg(), {"TASK8": {"type": "VL-logit"}}, ("TASK8",))
    with pytest.raises(ValueError, match="Undefined task type: VL-other"):
        VoltaForVLTasks(small_cfg(), {"TASK8": {"type": "VL-other"}},
                        ("TASK8",))
