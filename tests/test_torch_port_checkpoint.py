"""The port's checkpoint import and export (``volta_tpu_torch.checkpoint``)
against the JAX package's ``volta_tpu/checkpoint.py``, on the CPU.

A reference-format state dict is made by JAX's ``export_torch_state_dict``
from random Flax params of a small ctrl_uniter (two attention +
feed-forward pairs, hidden 64). The port's import gives the tensors
``convert.state_dict_from_flax`` gives and the report JAX's
``import_state_dict`` gives, list for list; the port's export equals
JAX's key for key (in order) and bit for bit, with the ``v_*`` aliases of
the shared sublayers as one tensor under two names, and JAX imports it
with ``strict=True``. An HF BERT-keyed dict (written here, with and
without the ``bert.`` prefix, with a pooler and MLM keys nothing reads)
loads alike through both, by ``from_hf`` and by detection. The ``module.``
prefix, ``gamma``/``beta``, the token-type resize and the strict-mode
errors behave as in JAX; ``from_pretrained`` detects each format the port
reads, reads them for a RoBERTa config too, and refuses the JAX package's
own saves.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from test_torch_port_model import TASK_CFG, make_batch, small_cfg
from test_torch_port_train import _flax_init
from volta_tpu import checkpoint as jck
from volta_tpu_torch import VoltaForVLTasks
from volta_tpu_torch import checkpoint as ck
from volta_tpu_torch.config import VoltaConfig
from volta_tpu_torch.convert import load_flax_params, state_dict_from_flax
from volta_tpu_torch.models.layers import init_weights


@pytest.fixture(scope="module")
def jcfg():
    return small_cfg()


@pytest.fixture(scope="module")
def pcfg(jcfg):
    return VoltaConfig.from_dict(jcfg.to_dict())


@pytest.fixture(scope="module")
def params(jcfg):
    return _flax_init(jcfg, make_batch(0))[1]


@pytest.fixture(scope="module")
def ref_sd(jcfg, params):
    sd, report = jck.export_torch_state_dict(jcfg, params)
    assert report["unexported"] == []
    return sd


def fresh(pcfg, seed=5):
    model = VoltaForVLTasks(pcfg, TASK_CFG, ("TASK1",))
    return init_weights(model, torch.Generator().manual_seed(seed))


def torch_sd(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            sd.items()}


def assert_state_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def hf_state_dict(jcfg, params, prefix):
    """An HF BERT checkpoint of ``params``' text side: the keys JAX's
    ``_ref_key(from_hf=True)`` names, under ``prefix``, plus a pooler and
    MLM keys that nothing of a VQA model reads."""
    hf_names = ("embeddings.word_embeddings", "embeddings.position_embeddings",
                "embeddings.token_type_embeddings", "embeddings.LayerNorm",
                "encoder.layer.")
    sd = {}
    for path, leaf in _leaves(params):
        ref = jck._ref_key(path, jcfg, True)
        if ref is None:
            continue
        key = ref[0][len("bert."):] if ref[0].startswith("bert.") else ref[0]
        if not key.startswith(hf_names):
            continue
        leaf_name = {"kernel": "weight", "scale": "weight",
                     "embedding": "weight", "bias": "bias"}[path[-1]]
        arr = leaf.T if path[-1] == "kernel" else leaf
        sd[prefix + key + "." + leaf_name] = np.ascontiguousarray(
            arr.astype(np.float32))
    rng = np.random.RandomState(0)
    sd[prefix + "pooler.dense.weight"] = rng.randn(64, 64).astype(np.float32)
    sd[prefix + "pooler.dense.bias"] = np.zeros(64, np.float32)
    sd["cls.predictions.bias"] = np.zeros(50, np.float32)
    return sd


def test_import_matches_convert_and_jax_report(jcfg, pcfg, params, ref_sd):
    model = fresh(pcfg)
    report = ck.import_state_dict(pcfg, model, torch_sd(ref_sd), strict=True)
    assert_state_equal(model.state_dict(), state_dict_from_flax(params))
    _, jreport = jck.import_state_dict(jcfg, {"params": params}, ref_sd)
    assert report == jreport
    assert report["skipped"] == [] and len(report["loaded"]) == len(
        model.state_dict())
    # the aliases of the shared sublayers are read by nothing
    assert report["unused"] and all(".v_" in k for k in report["unused"])


def test_export_matches_jax(jcfg, pcfg, params, ref_sd):
    model = load_flax_params(fresh(pcfg), params)
    sd, report = ck.export_reference_state_dict(pcfg, model)
    assert report == {"unexported": []}
    assert list(sd) == list(ref_sd)
    for k, v in sd.items():
        assert v.dtype == torch.float32 and v.is_contiguous(), k
        np.testing.assert_array_equal(v.numpy(), ref_sd[k], err_msg=k)
    # one tensor under both names of a shared sublayer
    for spec in pcfg.sublayer_plan():
        aliases = ck._ATTN_ALIASES if spec.kind == "attn" else ck._FF_ALIASES
        for src, dst in aliases:
            base = f"bert.encoder.layer.{spec.index}."
            assert sd[base + dst + ".weight"] is sd[base + src + ".weight"]


def test_jax_imports_the_port_export_strictly(jcfg, pcfg, params, tmp_path):
    model = load_flax_params(fresh(pcfg), params)
    path = ck.save_reference_checkpoint(str(tmp_path / "model.bin"), pcfg,
                                        model)
    sd = jck.load_torch_state_dict(path)
    zeros = jax.tree.map(np.zeros_like, params)
    new, report = jck.import_state_dict(jcfg, {"params": zeros}, sd,
                                        strict=True)
    assert report["skipped"] == []
    for path_, leaf in _leaves(new["params"]):
        want = params
        for k in path_:
            want = want[k]
        np.testing.assert_array_equal(np.asarray(leaf), want)


@pytest.mark.parametrize("prefix", ["bert.", ""])
def test_hf_dict_loads_as_in_jax(jcfg, pcfg, params, prefix, tmp_path):
    hf = hf_state_dict(jcfg, params, prefix)
    init = _flax_init(jcfg, make_batch(1))[1]  # other weights to overlay
    jnew, jreport = jck.import_state_dict(jcfg, {"params": init}, hf,
                                          from_hf=True)
    want = state_dict_from_flax(jax.tree.map(np.asarray, jnew["params"]))

    model = load_flax_params(fresh(pcfg), init)
    report = ck.import_state_dict(pcfg, model, torch_sd(hf), from_hf=True)
    assert report == jreport
    assert any("attn_2.query" in k for k in report["loaded"])
    assert "bert.t_pooler.dense.kernel" in report["skipped"]
    assert prefix + "pooler.dense.weight" in report["unused"]
    assert_state_equal(model.state_dict(), want)

    # the file through from_pretrained: detected by its layer names
    path = str(tmp_path / "hf.bin")
    torch.save(torch_sd(hf), path)
    model = load_flax_params(fresh(pcfg), init)
    assert ck.from_pretrained(pcfg, model, path) == jreport
    assert_state_equal(model.state_dict(), want)
    _, jdetected = jck.from_pretrained(jcfg, {"params": init}, path)
    assert jdetected == jreport


def test_module_prefix_and_gamma_beta(jcfg, pcfg, params, ref_sd, tmp_path):
    renamed = {"module." + k.replace("LayerNorm.weight", "LayerNorm.gamma")
               .replace("LayerNorm.bias", "LayerNorm.beta"): v
               for k, v in ref_sd.items()}
    assert any(k.endswith(".gamma") for k in renamed)
    path = str(tmp_path / "ddp.bin")
    torch.save(torch_sd(renamed), path)
    sd = ck.load_torch_state_dict(path)
    assert set(sd) == set(ref_sd)
    assert set(jck.load_torch_state_dict(path)) == set(sd)
    model = fresh(pcfg)
    report = ck.from_pretrained(pcfg, model, path)
    assert_state_equal(model.state_dict(), state_dict_from_flax(params))
    _, jreport = jck.from_pretrained(jcfg, {"params": params}, path)
    assert report == jreport
    # wrapped in model_state_dict, or in state_dict, the same
    for wrap in ("model_state_dict", "state_dict"):
        torch.save({wrap: torch_sd(renamed)}, path)
        assert set(ck.load_torch_state_dict(path)) == set(ref_sd)


def test_token_type_resize(jcfg, pcfg, params, ref_sd):
    key = "bert.embeddings.token_type_embeddings.weight"
    assert ref_sd[key].shape[0] == 2
    cut = dict(ref_sd, **{key: ref_sd[key][:1] + 1.0})
    init = _flax_init(jcfg, make_batch(1))[1]
    jnew, jreport = jck.import_state_dict(jcfg, {"params": init}, cut)
    model = load_flax_params(fresh(pcfg), init)
    report = ck.import_state_dict(pcfg, model, torch_sd(cut), strict=True)
    assert report == jreport
    got = model.state_dict()[key]
    np.testing.assert_array_equal(got[0].numpy(), cut[key][0])
    np.testing.assert_array_equal(
        got[1].numpy(),
        init["bert"]["embeddings"]["token_type_embeddings"]["embedding"][1])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnew["params"]["bert"]["embeddings"][
            "token_type_embeddings"]["embedding"]))


def test_strict_mode_errors(jcfg, pcfg, params, ref_sd):
    key = "bert.embeddings.image_embeddings.weight"
    bad = dict(ref_sd, **{key: np.zeros((3, 3), np.float32)})
    model = fresh(pcfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="shape mismatch for "
                       "bert.embeddings.feat_dense.kernel"):
        ck.import_state_dict(pcfg, model, torch_sd(bad), strict=True)
    with pytest.raises(ValueError, match="shape mismatch"):
        jck.import_state_dict(jcfg, {"params": params}, bad, strict=True)
    assert_state_equal(model.state_dict(), before)  # nothing was written
    report = ck.import_state_dict(pcfg, model, torch_sd(bad))
    _, jreport = jck.import_state_dict(jcfg, {"params": params}, bad)
    assert report == jreport
    assert "bert.embeddings.feat_dense.kernel (shape)" in report["skipped"]

    short = {k: v for k, v in ref_sd.items() if "t_pooler" not in k}
    with pytest.raises(ValueError, match="missing keys.*t_pooler"):
        ck.import_state_dict(pcfg, fresh(pcfg), torch_sd(short), strict=True)
    with pytest.raises(ValueError, match="missing keys.*t_pooler"):
        jck.import_state_dict(jcfg, {"params": params}, short, strict=True)


def test_from_pretrained_detects_each_format(pcfg, params, ref_sd, tmp_path):
    src = load_flax_params(fresh(pcfg), params)
    want = src.state_dict()

    def loads(path):
        model = fresh(pcfg)
        ck.from_pretrained(pcfg, model, str(path))
        assert_state_equal(model.state_dict(), want)

    torch.save(src.state_dict(), tmp_path / "own.pt")
    loads(tmp_path / "own.pt")
    from volta_tpu_torch.optimization import build_optimizer
    from volta_tpu_torch.train_step import create_train_state

    state = create_train_state(src, build_optimizer("adamw", 1e-3, src), 0)
    run = tmp_path / "run"
    ck.save_train_state(str(run), state, 0, 0.5)
    loads(run / "train_state.pt")
    loads(run)
    ck.save_reference_checkpoint(str(tmp_path / "ref.bin"), pcfg, src)
    loads(tmp_path / "ref.bin")
    torch.save({"model_state_dict": torch_sd(ref_sd), "global_step": 3},
               tmp_path / "ckpt.tar")
    loads(tmp_path / "ckpt.tar")
    loads("file://" + str(tmp_path / "ref.bin"))

    (tmp_path / "flax").mkdir()
    (tmp_path / "flax" / "flax_model.msgpack").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="item 12"):
        ck.from_pretrained(pcfg, fresh(pcfg), str(tmp_path / "flax"))
    # a RoBERTa config reads the same file, as JAX's importer does
    loads_roberta = fresh(pcfg)
    report = ck.from_pretrained(dataclasses.replace(pcfg, model="roberta"),
                                loads_roberta, str(tmp_path / "ref.bin"))
    assert report["skipped"] == []
    assert_state_equal(loads_roberta.state_dict(), want)
    # the port's own names, a key short: strict, so it raises
    own = src.state_dict()
    own.pop("clf_TASK1.dense2.bias")
    torch.save(own, tmp_path / "short.pt")
    with pytest.raises(RuntimeError, match="clf_TASK1.dense2.bias"):
        ck.from_pretrained(pcfg, fresh(pcfg), str(tmp_path / "short.pt"))


def test_cached_path_downloads_nothing(tmp_path):
    f = tmp_path / "w.bin"
    f.write_bytes(b"x")
    assert ck.cached_path(str(f)) == str(f)
    assert ck.cached_path("file://" + str(f)) == str(f)
    with pytest.raises(FileNotFoundError):
        ck.cached_path(str(tmp_path / "missing.bin"))
    url = "https://example.invalid/pytorch_model.bin"
    cache = tmp_path / "cache"
    with pytest.raises(FileNotFoundError, match=str(cache)):
        ck.cached_path(url, str(cache))
    assert not cache.exists()  # nothing written
    import hashlib

    cache.mkdir()
    placed = cache / hashlib.sha256(url.encode()).hexdigest()
    placed.write_bytes(b"y")
    assert ck.cached_path(url, str(cache)) == str(placed)
    with pytest.raises(ValueError, match="unable to parse"):
        ck.cached_path("ftp://host/w.bin", str(cache))
    assert os.path.isdir(cache)
