"""The port's serving exporter (``volta_tpu_torch/export.py``) against the
JAX package's (``volta_tpu/export.py``) on the CPU.

The tiny VQA model of tests/test_export.py (two attention + feed-forward
pairs, hidden 48; 10 tokens + 7 regions), its Flax init bridged into the
port with ``convert.state_dict_from_flax``. Each port artifact goes through
``save_exported`` / ``load_exported`` before it is called.

- Portable artifacts (``use_pallas: false``: aten ops only), parameterized
  and baked, at a fixed batch (4) and a symbolic one (one artifact at b 2
  and b 5), against JAX's ``export_task_forward(..., platforms=("cpu",))``
  artifacts called the same way, within rtol 1e-4 / atol 1e-5 (float32
  logits of two frameworks, as tests/test_torch_port_int8.py holds the
  unquantized model), and bit-equal to the port's live forward.
- Kernel artifacts (``use_pallas``, ``platforms=("cuda",)``), natural,
  head-major and with both LayerNorm flags: the graph holds the registered
  ops (``volta::attention_fwd``, ``volta::attention_head_major_fwd``,
  ``volta::layer_norm_fwd``) and none of the aten ops of their twins
  (softmax, einsum, and with the flags the LayerNorm); on CPU tensors the
  ops run the twins, and the logits are bit-equal to the live forward's
  and within the tolerance above of JAX's exported forward.
- int8 and int8_static (JAX's static scales for both), kernel artifacts
  parameterized and baked, portable ones parameterized (the twins' aten
  ops, CPU serving: their product sums in int64): bit-equal to the live
  ``apply_quantized`` forward, and within 1e-3 of the largest |logit| of
  JAX's int8 artifact (tests/test_torch_port_int8.py's tolerance); the
  kernel artifacts hold ``volta::int8_quantize`` and ``volta::int8_matmul``
  and take the bundle's int8 weights and scales as inputs.
- The platform rule: a ``use_pallas`` artifact names ``cuda`` and
  refuses any other platform, or none (JAX's ``tpu`` rule,
  tests/test_export.py:83).

Bit-equality runs with one CPU thread (``one_thread``): a multithreaded
CPU matmul may split its sums differently from call to call under load.
"""

import jax
import numpy as np
import pytest
import torch
from torch.export.graph_signature import InputKind
from torch.utils._pytree import tree_leaves

from test_export import TASK_CFG, _batch, _tiny_cfg
from volta_tpu import export as jexport
from volta_tpu.models import VoltaForVLTasks as JaxVLTasks
from volta_tpu.ops import int8_dense as jint8
from volta_tpu_torch import VoltaForVLTasks
from volta_tpu_torch import export as pexport
from volta_tpu_torch.config import VoltaConfig
from volta_tpu_torch.convert import state_dict_from_flax
from volta_tpu_torch.ops import int8_dense as pint8

L, R = 10, 7
RTOL, ATOL = 1e-4, 1e-5
TWIN_OPS = {"aten.softmax.int", "aten.einsum.default"}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_side():
    cfg = _tiny_cfg()
    jmodel = JaxVLTasks(cfg, TASK_CFG, ("TASK1",))
    b = _batch(cfg, 4, L, R)
    variables = jmodel.init(jax.random.PRNGKey(0), *b[:3], "TASK1", *b[3:])
    scales = jint8.calibrate_activation_scales(
        lambda v, *a: jmodel.apply(v, *a[:3], "TASK1", *a[3:]), variables,
        [_batch(cfg, 4, L, R, seed=s) for s in (1, 2)])
    sd = state_dict_from_flax(jax.tree.map(np.asarray, variables["params"]))
    return dict(cfg=cfg, variables=variables, sd=sd, scales=scales)


def port_cfg(cfg, **kw):
    return VoltaConfig.from_dict(dict(cfg.to_dict(), **kw))


def port_model(cfg, sd):
    model = VoltaForVLTasks(cfg, TASK_CFG, ("TASK1",))
    model.load_state_dict(sd)
    return model.eval()


def tensors(batch):
    return [torch.from_numpy(np.asarray(x)) for x in batch]


def live(model, batch):
    t = tensors(batch)
    with torch.no_grad():
        return model(t[0], t[1], t[2], "TASK1", *t[3:])


def saved(exported, tmp_path, name):
    path = str(tmp_path / name)
    pexport.save_exported(exported, path)
    return pexport.load_exported(path)


def call(exported, params, batch):
    lead = () if params is None else (params,)
    with torch.no_grad():
        return exported.call(*lead, *tensors(batch))


def targets(exported):
    return {str(n.target) for n in exported.program.graph.nodes
            if n.op == "call_function"}


def sizes(bs):
    return (4,) if isinstance(bs, int) else (2, 5)


@pytest.mark.parametrize("bs", [4, "b"], ids=["fixed", "symbolic"])
@pytest.mark.parametrize("bake", [False, True], ids=["params", "baked"])
def test_portable_artifact_matches_jax_export(jax_side, tmp_path, bs, bake,
                                              one_thread):
    cfg, variables, sd = (jax_side[k] for k in ("cfg", "variables", "sd"))
    jexp = jexport.export_task_forward(cfg, TASK_CFG, "TASK1", variables,
                                       bs, L, R, platforms=("cpu",),
                                       bake_weights=bake)
    pc = port_cfg(cfg, use_pallas=False)
    exp = saved(pexport.export_task_forward(
        pc, TASK_CFG, "TASK1", sd, bs, L, R, bake_weights=bake), tmp_path,
        "portable.pt2")
    assert exp.platforms == ("cpu",)
    assert not any(t.startswith("volta.") for t in targets(exp))
    assert bool(exp.program.state_dict) == bake  # weights only if baked
    model = port_model(pc, sd)
    for b in sizes(bs):
        batch = _batch(cfg, b, L, R, seed=b)
        want = np.asarray(jexp.call(*batch) if bake
                          else jexp.call(variables, *batch))
        got = call(exp, None if bake else sd, batch)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        assert torch.equal(got, live(model, batch))
    # the sequence length is pinned
    with pytest.raises(Exception):
        call(exp, None if bake else sd, _batch(cfg, 4, L + 1, R))


@pytest.mark.parametrize("flags,ops", [
    ({}, {"volta.attention_fwd.default"}),
    ({"attn_natural_layout": False},
     {"volta.attention_head_major_fwd.default"}),
    ({"use_pallas_layernorm": True, "use_fused_residual_ln": True},
     {"volta.attention_fwd.default", "volta.layer_norm_fwd.default"})],
    ids=["natural", "head_major", "ln_flags"])
def test_kernel_artifact_holds_the_registered_ops(jax_side, tmp_path, flags,
                                                  ops, one_thread):
    cfg, variables, sd = (jax_side[k] for k in ("cfg", "variables", "sd"))
    pc = port_cfg(cfg, use_pallas=True, **flags)
    exp = saved(pexport.export_task_forward(
        pc, TASK_CFG, "TASK1", sd, "b", L, R, platforms=("cuda",)),
        tmp_path, "kernels.pt2")
    assert exp.platforms == ("cuda",)
    got_ops = {t for t in targets(exp) if t.startswith("volta.")}
    assert got_ops == ops
    twins = TWIN_OPS | ({"aten.layer_norm.default"} if flags.get(
        "use_pallas_layernorm") else set())
    assert not targets(exp) & twins
    jexp = jexport.export_task_forward(cfg, TASK_CFG, "TASK1", variables,
                                       "b", L, R, platforms=("cpu",))
    model = port_model(pc, sd)
    for b in (2, 5):
        batch = _batch(cfg, b, L, R, seed=b)
        got = call(exp, sd, batch)
        assert torch.equal(got, live(model, batch))
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jexp.call(variables, *batch)),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_pallas,bake", [
    (True, False), (True, True), (False, False)],
    ids=["kernels-params", "kernels-baked", "portable-params"])
@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_int8_artifacts(jax_side, tmp_path, mode, bake, use_pallas,
                        one_thread):
    cfg, variables, sd, scales = (jax_side[k] for k in (
        "cfg", "variables", "sd", "scales"))
    act = scales if mode == "int8_static" else None
    jexp = jexport.export_task_forward(cfg, TASK_CFG, "TASK1", variables,
                                       "b", L, R, platforms=("cpu",),
                                       quantize=mode, act_scales=act)
    jbundle = jint8.quantize_variables(variables, act_scales=act)
    pc = port_cfg(cfg, use_pallas=use_pallas)
    exp = saved(pexport.export_task_forward(
        pc, TASK_CFG, "TASK1", sd, "b", L, R,
        platforms=("cuda",) if use_pallas else None, bake_weights=bake,
        quantize=mode, act_scales=act), tmp_path, f"{mode}.pt2")
    int8_ops = {"volta.int8_quantize.default", "volta.int8_matmul.default"}
    assert (int8_ops <= targets(exp)) == use_pallas
    model = port_model(pc, sd)
    bundle = pint8.quantize_variables(model, act_scales=act)
    if not bake:  # the bundle's int8 weights and scales are inputs
        kinds = [s.kind for s in exp.program.graph_signature.input_specs]
        assert kinds.count(InputKind.USER_INPUT) == \
            len(tree_leaves(bundle)) + 6
        assert not exp.program.state_dict
    for b in (2, 5):
        batch = _batch(cfg, b, L, R, seed=b)
        got = call(exp, None if bake else bundle, batch)
        t = tensors(batch)
        with torch.no_grad():
            want = pint8.apply_quantized(model, bundle, t[0], t[1], t[2],
                                         "TASK1", *t[3:])
        assert torch.equal(got, want)
        ref = np.asarray(jexp.call(jbundle, *batch))
        assert np.abs(got.numpy() - ref).max() <= 1e-3 * np.abs(ref).max()
    with pytest.raises(ValueError, match="act_scales"):
        pexport.export_task_forward(pc, TASK_CFG, "TASK1", sd, 2, L, R,
                                    platforms=("cuda",),
                                    quantize="int8_static")


def test_kernel_artifacts_name_cuda_alone(jax_side):
    cfg, sd = jax_side["cfg"], jax_side["sd"]
    pc = port_cfg(cfg, use_pallas=True)
    for platforms in (("cpu",), ("cuda", "cpu"), None):
        with pytest.raises(ValueError, match="cuda"):
            pexport.export_task_forward(pc, TASK_CFG, "TASK1", sd, 2, L, R,
                                        platforms=platforms)
    with pytest.raises(ValueError, match="quantize"):
        pexport.export_task_forward(pc, TASK_CFG, "TASK1", sd, 2, L, R,
                                    platforms=("cuda",), quantize="int4")
