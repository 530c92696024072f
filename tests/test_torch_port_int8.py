"""K9, the port's int8 dense layer (``volta_tpu_torch/ops/int8_dense.py``,
on the CPU its plain twins), against ``volta_tpu.ops.int8_dense`` jitted,
as the JAX CLI runs it: ``quantize_kernel`` and the dynamic and static
activation quantization (xq, a) and y bit-equal, the twins' single-rounded
FMA against exact rationals; the bundle's keys and leaves
equal to ``quantize_variables``' (int8 kernels transposed, residuals cast to
bf16); ``calibrate_activation_scales`` within 1e-6; and the tiny model's
``apply_quantized`` logits in float32 within 1e-3 of the largest |logit|.
The kernels themselves run on the card (tests/test_torch_port_cuda.py)."""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_export import TASK_CFG, _batch, _tiny_cfg
from volta_tpu.ops import int8_dense as jint8
from volta_tpu_torch import VoltaForVLTasks
from volta_tpu_torch.config import VoltaConfig
from volta_tpu_torch.convert import load_flax_params
from volta_tpu_torch.ops import int8_dense as pint8
from volta_tpu_torch.optimization import flax_paths

# (M, K, N): the odd shapes of a Dense: K = num_locs = 5, N = 1
SHAPES = [(7, 16, 8), (33, 5, 1), (20, 100, 100)]


def _inputs(m, k, n, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(m, k) * rng.uniform(0.1, 4.0, (m, 1))).astype(np.float32)
    x[m // 2] = 0.0  # a padded row: a = 1e-12, xq = 0
    w = (rng.randn(k, n) * 0.1).astype(np.float32)  # JAX's [in, out]
    b = rng.randn(n).astype(np.float32)
    return x, w, b


def _jax_quantized(x, q, scale, b, a_scale):
    """JAX's int8_dense_apply, jitted, with the int8 activations it feeds
    its dot_general captured; its per-row scales by the same expression."""
    seen = {}
    real = jint8.lax.dot_general

    class _Lax:
        def __getattr__(self, name):
            return getattr(jax.lax, name)

        @staticmethod
        def dot_general(xq, *a, **kw):
            seen["xq"] = xq
            return real(xq, *a, **kw)

    def fn(x):
        y = jint8.int8_dense_apply(x, q, scale, b, out_dtype=jnp.float32,
                                   a_scale=a_scale)
        xf = jnp.asarray(x, jnp.float32)
        a = jnp.max(jnp.abs(xf), axis=-1) / 127.0 + 1e-12 \
            if a_scale is None else jnp.full(x.shape[:1], a_scale,
                                             jnp.float32)
        # the int8 activations divided by these scales are JAX's own
        # (captured), so a wrong a shows in xq too
        return y, seen["xq"], a

    jint8.lax = _Lax()
    try:
        return [np.asarray(v) for v in jax.jit(fn)(jnp.asarray(x))]
    finally:
        jint8.lax = jax.lax


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("static", [False, True])
def test_quantize_and_apply_match_jax(m, k, n, static):
    x, w, b = _inputs(m, k, n, m + k + n)
    # jitted, as the JAX CLI quantizes its variables
    jq, jscale = (np.asarray(v) for v in jax.jit(jint8.quantize_kernel)(w))
    q, scale = pint8.quantize_kernel(torch.from_numpy(w.T.copy()))
    assert q.dtype == torch.int8 and tuple(q.shape) == (n, k)
    np.testing.assert_array_equal(q.numpy(), jq.T)
    np.testing.assert_array_equal(scale.numpy(), jscale)

    a_static = np.float32(np.abs(x).max() / 127.0 + 1e-12) if static \
        else None
    jy, jxq, ja = _jax_quantized(x, jq, jscale, b, a_static)
    at = None if a_static is None else torch.tensor(a_static)
    xq, a = pint8.int8_quantize(torch.from_numpy(x), at)
    np.testing.assert_array_equal(xq.numpy(), jxq)
    np.testing.assert_array_equal(a.numpy(), ja)
    assert int(xq[m // 2].abs().max()) == 0
    y = pint8.int8_dense_apply(torch.from_numpy(x), q, scale,
                               torch.from_numpy(b), torch.float32, at)
    assert y.dtype == torch.float32 and tuple(y.shape) == (m, n)
    np.testing.assert_array_equal(y.numpy(), jy)
    # the twins' route, step by step
    twin = pint8.int8_matmul_ref(xq, a, q, scale, torch.from_numpy(b),
                                 torch.bfloat16)
    assert torch.equal(twin, y.to(torch.bfloat16))


def _fma_exact(x, y, z):
    """fma(x, y, z) of float32 values rounded once, half to even, from the
    exact rational."""
    v = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
    r = np.float32(float(v))
    near = [np.nextafter(r, np.float32(-np.inf)), r,
            np.nextafter(r, np.float32(np.inf))]
    return min(near, key=lambda c: (abs(Fraction(float(c)) - v),
                                    int(c.view(np.int32)) & 1))


def test_fma32_rounds_once(monkeypatch):
    """The twins' FMA equals the correctly rounded one: on sums whose
    float64 rounding lands exactly halfway between two float32 values
    (1 + 2^-23 + 2^-24 - 2^-60 rounds down, not to the even 1 + 2^-22),
    and on random operands over a wide range of magnitudes; in one piece
    and in chunks of rows."""
    f = np.float32
    x, y, z = f(2 ** -24 * (1 + 2 ** -18)), f(1 - 2 ** -18), f(1 + 2 ** -23)
    rng = np.random.RandomState(0)
    xs = np.concatenate([[x, -x], rng.randn(3000)]).astype(f)
    ys = np.concatenate([[y, y], rng.randn(3000)]).astype(f)
    zs = np.concatenate([[z, -z], rng.randn(3000) * rng.choice(
        [1e-9, 1e-3, 1.0, 1e3, 1e9], 3000)]).astype(f)
    got = pint8.fma32(torch.from_numpy(xs), torch.from_numpy(ys),
                      torch.from_numpy(zs)).numpy()
    assert got[0] == z and got[1] == -z
    want = np.array([_fma_exact(*t) for t in zip(xs, ys, zs)])
    np.testing.assert_array_equal(got, want)
    monkeypatch.setattr(pint8, "FMA_CHUNK", 7)
    rows = pint8.fma32(torch.from_numpy(xs[:3000].reshape(600, 5)),
                       torch.from_numpy(ys[:3000].reshape(600, 5)),
                       torch.from_numpy(zs[:5])[None, :]).numpy()
    want = np.array([_fma_exact(x, y, zs[i % 5]) for i, (x, y) in
                     enumerate(zip(xs[:3000], ys[:3000]))])
    np.testing.assert_array_equal(rows.ravel(), want)


def _k9_tie_inputs(device):
    """K9b's operands where float64 rounding of the epilogue's exact
    fma(acc, a * scale, bias) lands halfway between two float32 values:
    acc = +-(2^18 - 1), a * scale = (2^18 + 1) 2^-60, so the product is
    +-(2^-24 - 2^-60), and bias +-(1 + 2^-23). Every exact result rounds
    once to +-(1 + 2^-23); rounded through float64 it would go to the even
    neighbour, +-1 or +-(1 + 2^-22)."""
    row = [127] * 17 + [15]
    xq = torch.tensor([row, [-v for v in row]], dtype=torch.int8)
    q = torch.tensor([[127] * 16 + [32, 1]] * 2, dtype=torch.int8)
    a = torch.full((2,), (2 ** 18 + 1) * 2.0 ** -30)
    scale = torch.full((2,), 2.0 ** -30)
    bias = torch.tensor([1 + 2 ** -23, -(1 + 2 ** -23)])
    want = bias[None, :].expand(2, 2)
    return [t.to(device) for t in (xq, a, q, scale, bias, want)]


def test_k9_twin_epilogue_rounds_once():
    xq, a, q, scale, bias, want = _k9_tie_inputs("cpu")
    y = pint8.int8_matmul_ref(xq, a, q, scale, bias, torch.float32)
    assert torch.equal(y, want)
    acc = (xq.long() @ q.long().t()).double()
    twice = (acc * (a[:, None] * scale[None, :]).double()
             + bias.double()).float()
    assert not torch.equal(twice, want)  # the inputs are ties


# (K, body): K9b's rule on contiguous, 16-byte aligned int8 operands: K = 5
# (num_locs) and K = 100 have no 16-byte rows, a dispatch's 768, 3072 and
# the image features' 2048 have
BODY_KS = [(5, "mma.sync"), (100, "mma.sync"), (768, "wgmma"),
           (2048, "wgmma"), (3072, "wgmma")]


@pytest.mark.parametrize("k,body", BODY_KS)
def test_int8_body_by_k(k, body):
    xq = torch.zeros(7, k, dtype=torch.int8)
    q = torch.zeros(3, k, dtype=torch.int8)
    assert pint8.int8_body(xq, q) == body


@pytest.mark.parametrize("offset,body", [(1, "mma.sync"), (8, "mma.sync"),
                                         (16, "wgmma")])
def test_int8_body_by_alignment(offset, body):
    """An offset view of one buffer takes the Hopper body only where it
    starts on a 16-byte boundary, as xq and as q."""
    flat = torch.zeros(64 + 7 * 768, dtype=torch.int8)
    start = -flat.data_ptr() % 16 + offset  # 16-byte boundary + offset
    view = flat[start:start + 7 * 768].view(7, 768)
    other = torch.zeros(7, 768, dtype=torch.int8)
    assert view.is_contiguous() and view.data_ptr() % 16 == offset % 16
    assert pint8.int8_body(view, other) == body
    assert pint8.int8_body(other, view) == body


def test_int8_body_takes_only_contiguous_int8_matrices():
    xq = torch.zeros(7, 768, dtype=torch.int8)
    q = torch.zeros(768, 3, dtype=torch.int8).t()  # [3, 768], strided
    assert not q.is_contiguous()
    assert pint8.int8_body(xq, q) == "mma.sync"
    assert pint8.int8_body(torch.zeros(7, 1536, dtype=torch.int8)[:, :768],
                           xq) == "mma.sync"
    assert pint8.int8_body(xq, q.contiguous()) == "wgmma"
    assert pint8.int8_body(xq.to(torch.uint8), xq) == "mma.sync"
    assert pint8.int8_body(xq[:0], xq) == "mma.sync"


def test_int8_body_of_a_retrieval_dispatch():
    """Every Dense of ctrl_uniter_base under the retrieval head takes the
    Hopper body but the image-location embedding (K = num_locs = 5)."""
    import os

    cfg = VoltaConfig.from_json_file(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs", "ctrl_uniter_base.json"))
    task = {"TASK8": {"type": "VL-logit", "num_labels": 1}}
    with torch.device("meta"):
        model = VoltaForVLTasks(cfg, task, ("TASK8",))
    bodies = {}
    for key, mod in pint8.dense_modules(model).items():
        n, k = mod.weight.shape
        bodies[key] = pint8.int8_body(torch.zeros(4, k, dtype=torch.int8),
                                      torch.zeros(n, k, dtype=torch.int8))
    slow = sorted(k for k, b in bodies.items() if b != "wgmma")
    assert len(bodies) > 70 and len(slow) == 1, slow
    assert dict(pint8.dense_modules(model))[slow[0]].weight.shape[1] \
        == cfg.num_locs


@pytest.fixture(scope="module")
def models():
    """The tiny model in JAX (Flax init) and in the port (the same
    weights), two batches and JAX's calibration over them."""
    cfg = _tiny_cfg()
    batches = [_batch(cfg), _batch(cfg, seed=3)]
    from volta_tpu.models import VoltaForVLTasks as JaxVLTasks

    jmodel = JaxVLTasks(cfg, TASK_CFG, ("TASK1",))
    variables = jmodel.init(jax.random.PRNGKey(1), *batches[0][:3],
                            "TASK1", *batches[0][3:])
    pmodel = VoltaForVLTasks(VoltaConfig.from_dict(cfg.to_dict()), TASK_CFG,
                             ("TASK1",))
    load_flax_params(pmodel, jax.tree.map(np.asarray, variables["params"]))
    scales = jint8.calibrate_activation_scales(
        lambda v, *a: jmodel.apply(v, *a[:3], "TASK1", *a[3:]), variables,
        batches)
    return dict(batches=batches, jmodel=jmodel, variables=variables,
                pmodel=pmodel.eval(), scales=scales)


def _port_args(batch):
    t = [torch.from_numpy(np.asarray(v)) for v in batch]
    return (t[0], t[1], t[2], "TASK1", t[3], t[4], t[5])


@pytest.mark.parametrize("residual", [None, "bfloat16"])
def test_bundle_matches_quantize_variables(models, residual):
    """Key for key every 2-D kernel (every Dense), q transposed, scale,
    bias and the static scale; the other parameters leaf for leaf."""
    scales, pmodel = models["scales"], models["pmodel"]
    jb = jax.jit(lambda v: jint8.quantize_variables(
        v, residual_dtype=None if residual is None else jnp.bfloat16,
        act_scales=scales))(models["variables"])
    pb = pint8.quantize_variables(
        pmodel, None if residual is None else torch.bfloat16,
        act_scales=scales)
    assert set(pb["int8"]) == set(jb["int8"]) and len(pb["int8"]) > 10
    for key, je in jb["int8"].items():
        pe = pb["int8"][key]
        np.testing.assert_array_equal(pe["q"].numpy(), np.asarray(je["q"]).T)
        for f in ("scale", "bias", "a"):
            np.testing.assert_array_equal(pe[f].numpy(), np.asarray(je[f]),
                                          err_msg=f"{key} {f}")
    jleaves = {".".join(p.key for p in path): np.asarray(v) for path, v in
               jax.tree_util.tree_flatten_with_path(jb["params"])[0]}
    paths = flax_paths(pmodel)
    got = {".".join(paths[n]): v for n, v in pb["params"].items()}
    assert set(got) == set(jleaves)
    for k, want in jleaves.items():
        v = got[k]
        assert str(v.dtype).split(".")[-1] == str(want.dtype), k
        np.testing.assert_array_equal(v.float().numpy(),
                                      want.astype(np.float32), err_msg=k)


def test_calibration_and_quantized_logits_match_jax(models):
    batches, jmodel = models["batches"], models["jmodel"]
    variables, pmodel, js = (models[k] for k in
                             ("variables", "pmodel", "scales"))
    ps = pint8.calibrate_activation_scales(
        pmodel, [_port_args(b) for b in batches])
    assert set(ps) == set(js)
    for k in js:
        assert ps[k] == pytest.approx(js[k], rel=1e-6), k

    batch = batches[0]
    for act in (None, js):
        jbundle = jint8.quantize_variables(variables, act_scales=act)
        jl, _ = jint8.apply_quantized(jmodel, jbundle, *batch[:3], "TASK1",
                                      *batch[3:])
        pbundle = pint8.quantize_variables(pmodel, act_scales=act)
        pl = pint8.apply_quantized(pmodel, pbundle, *_port_args(batch))
        jl = np.asarray(jl)
        assert np.abs(pl.detach().numpy() - jl).max() <= \
            1e-3 * np.abs(jl).max()
    # the original model is left as it was: no int8 entry on its Dense
    assert all(m.int8 is None for m in pint8.dense_modules(pmodel).values())
    with torch.no_grad():
        again = pmodel(*_port_args(batch))
    fp, _ = jmodel.apply(variables, *batch[:3], "TASK1", *batch[3:])
    np.testing.assert_allclose(again.numpy(), np.asarray(fp), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("residual", [None, torch.bfloat16])
def test_quantized_model_holds_only_the_bundle(models, residual):
    """The served model keeps no float copy of a quantized Dense: its
    parameters are the bundle's ``params``, name for name and dtype for
    dtype, and its forward reads the int8 entries alone."""
    import copy

    pmodel = models["pmodel"]
    served = copy.deepcopy(pmodel)
    bundle = pint8.quantize_variables(served, residual)
    pint8.quantize_model(served, bundle)
    for key, mod in pint8.dense_modules(served).items():
        assert mod.int8 is bundle["int8"][key]
        assert mod.weight is None and mod.bias is None, key
    own = dict(served.named_parameters())
    assert set(own) == set(bundle["params"])
    for name, v in bundle["params"].items():
        assert own[name].dtype == torch.float32
        np.testing.assert_array_equal(own[name].detach().numpy(),
                                      v.float().numpy(), err_msg=name)
    with torch.no_grad():
        got = served(*_port_args(models["batches"][0]))
    want = pint8.apply_quantized(pmodel, pint8.quantize_variables(
        pmodel, residual), *_port_args(models["batches"][0]))
    np.testing.assert_array_equal(got.numpy(), want.detach().numpy())
