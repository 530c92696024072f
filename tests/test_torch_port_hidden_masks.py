"""The port's kernel-drawn hidden-dropout masks against the JAX package on
the CPU: Queue 2 row 9 (``fuse_hidden_dropout``, the dropout attention that
also draws the two tails' keep masks) and row 14 (``use_pallas_dropout_mask``,
the keep-mask kernel), the masked sublayer tail, and ctrl_uniter with each
flag.

The JAX kernels run as the JAX tests run them, in the Mosaic interpreter
(``pallas_attention.interpret_mode()``), whose PRNG gives all-zero bits:
every mask keeps everything, and the kept values are scaled by 1/(1 -
rate). The port's mask draws are replaced by the same all-zero draw where
the two are compared; at a real seed the port's masks are held to
``hash_dropout``'s zero pattern (``_seeded_hash_dropout``) and row 9 to row
5. Tolerances are those of tests/test_torch_port_attention_head_major.py
(forward rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-5) and of
the train-step tests (rtol 2e-4 / atol 2e-5); the flagged port step is held
to its own unflagged step within 1e-6, since the flags change no mask.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_attention_bwd import GRAD_TOL, RATE, SHAPES, _bias2, \
    _inputs, ids
from test_torch_port_ln_model import _seeded_hash_dropout
from test_torch_port_model import TASK_CFG, make_batch
from volta_tpu import zoo
from volta_tpu.models import VoltaForVLTasks as JaxVLTasks
from volta_tpu.models import layers as jl
from volta_tpu.ops import dropout_mask as jdm
from volta_tpu.ops import pallas_attention as pa
from volta_tpu.ops.attention import additive_mask as jax_mask
from volta_tpu.optimization import build_optimizer as jax_build_optimizer
from volta_tpu.task_utils import process_batch as jax_process_batch
from volta_tpu.task_utils import task_loss_and_score as jax_loss_and_score
from volta_tpu_torch import VoltaForVLTasks
from volta_tpu_torch.config import VoltaConfig
from volta_tpu_torch.convert import load_flax_params, state_dict_from_flax
from volta_tpu_torch.models import layers as port_layers
from volta_tpu_torch.models.layers import DropoutSeeds, LayerNorm, \
    init_weights
from volta_tpu_torch.ops import LAUNCHES
from volta_tpu_torch.ops import attention_dropout_cuda as adc
from volta_tpu_torch.ops import attention_head_major_cuda as ahm
from volta_tpu_torch.ops import attention_hidden_mask_cuda as ahc
from volta_tpu_torch.ops import dropout_mask as dm
from volta_tpu_torch.ops.hash import dropout_threshold
from volta_tpu_torch.ops.attention import dropout_attention_hidden_masks
from volta_tpu_torch.optimization import build_optimizer
from volta_tpu_torch.train_step import create_train_state, \
    make_task_train_step

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
HRATE = 0.1
LR, WD, CLIP, EPS, BETAS = 1e-4, 10.0, 1.0, 1e-3, (0.9, 0.999)


def _hm(x):
    """numpy [B, L, H, D] -> torch [H, B, L, D], contiguous."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1, 3)))


def _all_keep(monkeypatch):
    """The port's mask draws replaced by the interpreter's all-keep one:
    rows 3-4 and 14 (``keep_mask``), 5 and 9 (``keep_mask_head_major``)."""
    monkeypatch.setattr(ahm, "keep_mask_head_major",
                        lambda seed, shape, rate, device=None:
                        torch.ones(shape, dtype=torch.uint8, device=device))
    monkeypatch.setattr(adc, "keep_mask",
                        lambda seed, shape, rate, device=None:
                        torch.ones(tuple(shape), dtype=torch.bool,
                                   device=device))


def _hash_zero_pattern(shape, seed, rate):
    """Where JAX's ``hash_dropout`` with the uint32 ``seed`` keeps an
    element of a tensor of ``shape``, as a numpy bool array."""
    return np.asarray(_seeded_hash_dropout(jnp.ones(shape, jnp.float32),
                                           seed, rate)) != 0


# ------------------------------------------------------------------ row 9
@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_row_9_matches_pallas_interpreter(shape, monkeypatch):
    """``dropout_attention_hidden_masks`` against
    ``pallas_dropout_attention_hm`` in the interpreter, the port's draws
    all-keep as the interpreter's: the output, its vjp through row 6's
    twin, the hidden masks [B, Lq, H·D] (JAX's bf16 after a cast), and no
    bias gradient."""
    b, lq, lk, h, d = shape
    q, k, v, g, mask = _inputs(*shape, seed=20)
    scale = 1.0 / np.sqrt(d)
    jb = jax_mask(jnp.asarray(mask))
    with pa.interpret_mode():
        traced = pa.TRACE_COUNT[0]
        (out, jhm0, jhm1), vjp = jax.vjp(
            lambda q, k, v: pa.pallas_dropout_attention_hm(
                q, k, v, jb, scale, RATE, HRATE, 4321),
            *map(jnp.asarray, (q, k, v)))
        jgrads = vjp((jnp.asarray(g), jnp.zeros_like(jhm0),
                      jnp.zeros_like(jhm1)))
        assert pa.TRACE_COUNT[0] > traced
    assert jhm0.shape == (b, lq, h * d) and jhm0.dtype == jnp.bfloat16
    _all_keep(monkeypatch)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    bias4 = _bias2(mask).view(b, 1, 1, lk).requires_grad_()
    got, hm0, hm1 = dropout_attention_hidden_masks(
        *leaves, bias4, scale, RATE, HRATE, (7, 8, 9))
    assert got.shape == (b, lq, h, d)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               **FWD_TOL)
    for m, jm in ((hm0, jhm0), (hm1, jhm1)):
        assert m.dtype == torch.uint8 and not m.requires_grad
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm, np.uint8))
    got.backward(torch.from_numpy(g))
    for name, t, ref in zip(("dq", "dk", "dv"), leaves, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   err_msg=name, **GRAD_TOL)
    assert bias4.grad is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES[:3], ids=ids)
def test_row_9_is_row_5_plus_the_hidden_masks(shape, dtype):
    """At a real seed row 9's output and probability mask equal row 5's
    (bit for bit on the twins), its hidden masks are row 14's twin over
    [B, Lq, H·D] for their seeds, and its Function's gradients are row 5's
    Function's."""
    b, lq, lk, h, d = shape
    q, k, v, g, mask = _inputs(*shape, seed=21)
    dt = getattr(torch, dtype)
    qh, kh, vh, gh = (_hm(x).to(dt) for x in (q, k, v, g))
    bias, scale = _bias2(mask), 1.0 / np.sqrt(d)
    out, pmask, hm0, hm1 = ahc.attention_dropout_hidden_masks_fwd(
        qh, kh, vh, bias, scale, RATE, 1234, HRATE, 55, 66)
    out5, mask5 = ahm.attention_dropout_head_major_fwd(qh, kh, vh, bias,
                                                       scale, RATE, 1234)
    assert torch.equal(out, out5) and torch.equal(pmask, mask5)
    assert torch.equal(hm0, dm.keep_mask(hm0.shape, HRATE, 55, "cpu"))
    assert torch.equal(hm1, dm.keep_mask(hm1.shape, HRATE, 66, "cpu"))
    assert not torch.equal(hm0, hm1)

    grads = []
    for fn in (lambda *a: ahc.HiddenMaskDropoutAttention.apply(
                   *a, bias, scale, RATE, 1234, HRATE, 55, 66)[0],
               lambda *a: ahm.HeadMajorDropoutAttention.apply(
                   *a, bias, scale, RATE, 1234)):
        leaves = [x.clone().requires_grad_() for x in (qh, kh, vh)]
        fn(*leaves).backward(gh)
        grads.append([t.grad for t in leaves])
    for a, r in zip(*grads):
        assert torch.equal(a, r)


def test_row_9_function_gradcheck_float64():
    """The row-9 Function's twin path passes gradcheck in float64."""
    h, b, lq, lk, d = 2, 2, 3, 5, 4
    rng = np.random.RandomState(22)
    mk = lambda *s: torch.from_numpy(rng.randn(*s)).requires_grad_()  # noqa
    q, k, v = mk(h, b, lq, d), mk(h, b, lk, d), mk(h, b, lk, d)
    bias = torch.zeros(b, lk, dtype=torch.float64)
    bias[1, 3] = -2.0
    assert torch.autograd.gradcheck(
        lambda q, k, v: ahc.HiddenMaskDropoutAttention.apply(
            q, k, v, bias, 0.5, 0.3, 77, 0.3, 1, 2)[0], (q, k, v))


# ----------------------------------------------------------------- row 14
@pytest.mark.parametrize("shape", [(3, 14, 128), (24, 256), (1024, 128)],
                         ids=ids)
def test_row_14_matches_pallas_keep_mask(shape, monkeypatch):
    """The twin against ``pallas_keep_mask`` in the interpreter, the port's
    draw replaced by the interpreter's all-zero bits: the same 0/1 keep
    mask (all kept); no launch on the CPU."""
    with pa.interpret_mode():
        jm = jdm.pallas_keep_mask(shape, RATE, 99)
    assert jm.dtype == jnp.bfloat16 and jm.shape == shape
    monkeypatch.setattr(adc, "hash_keep", lambda index, seed, rate:
                        torch.zeros_like(index) < dropout_threshold(rate))
    before = dict(LAUNCHES)
    got = dm.keep_mask(shape, RATE, 99, "cpu")
    assert got.dtype == torch.uint8 and got.shape == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(jm, np.uint8))
    assert LAUNCHES == before


def test_row_14_gate_is_jax_s():
    shapes = [(8, 128), (7, 128), (3, 14, 128), (3, 14, 64), (256, 60, 768),
              (13, 256), (1021, 128), (2, 4, 384), (4, 1536), (9, 100)]
    for shape in shapes:
        assert dm.supported(shape) == jdm.supported(shape), shape


def test_row_14_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="rate"):
        dm.keep_mask((8, 128), 0.0, 1, "cpu")
    with pytest.raises(ValueError, match="seed"):
        dm.keep_mask((8, 128), RATE, 2**32, "cpu")
    with pytest.raises(ValueError, match="device"):
        dm.keep_mask((8, 128), RATE, 1, "meta")


@pytest.mark.parametrize("seed", [0, 0xDEADBEEF, 12345])
def test_masks_are_jax_hash_dropout(seed):
    """hm0, hm1 and row 14's mask at a real seed are the zero pattern of
    JAX's ``hash_dropout`` for the same uint32 seed, over the tensor they
    mask."""
    b, lq, lk, h, d = 3, 14, 14, 4, 32
    q, k, v, _, mask = _inputs(b, lq, lk, h, d, seed=23)
    _, _, hm0, hm1 = ahc.attention_dropout_hidden_masks_fwd(
        _hm(q), _hm(k), _hm(v), _bias2(mask), 0.25, RATE, 1, HRATE, seed,
        seed ^ 0x5A5A5A5A)
    shape = (b, lq, h * d)
    np.testing.assert_array_equal(hm0.numpy().astype(bool),
                                  _hash_zero_pattern(shape, seed, HRATE))
    np.testing.assert_array_equal(
        hm1.numpy().astype(bool),
        _hash_zero_pattern(shape, seed ^ 0x5A5A5A5A, HRATE))
    keep = dm.keep_mask(shape, HRATE, seed, "cpu")
    assert torch.equal(keep, hm0)
    assert 0.85 < float(keep.float().mean()) < 0.95


# -------------------------------------------------------- the masked tail
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernel,fused", [(False, False), (True, False),
                                              (False, True), (True, True)])
def test_masked_tail_matches_jax(dtype, use_kernel, fused, monkeypatch):
    """``LayerNorm`` with a real 0/1 ``keep_mask`` against the JAX
    ``LayerNorm`` with the same mask: the mask comes first, so with
    ``fused_residual`` the fused kernels are not called, and the LayerNorm
    kernel's twin (``use_kernel``) gives JAX's LayerNorm."""
    rng = np.random.RandomState(24)
    n, dim = 10, 128
    o = rng.randn(2, n, dim).astype(np.float32)
    x = rng.randn(2, n, dim).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(dim)).astype(np.float32)
    bias = (0.1 * rng.randn(dim)).astype(np.float32)
    keep = (rng.rand(2, n, dim) > HRATE).astype(np.uint8)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = jl.LayerNorm(dim).apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
        jnp.asarray(o, jdt), jnp.asarray(x, jdt), drop_rate=HRATE,
        deterministic=False, keep_mask=jnp.asarray(keep, jnp.bfloat16))

    calls = []
    for mod, name in ((port_layers, "dropout_residual_ln"),
                      (port_layers, "fused_layer_norm"), (dm, "keep_mask")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **kw: (
            calls.append(_n), _fn(*a, **kw))[1])
    ln = LayerNorm(dim, use_kernel=use_kernel, fused_residual=fused,
                   pallas_mask=True)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        dt = getattr(torch, dtype)
        got = ln(torch.from_numpy(o).to(dt), residual=torch.from_numpy(x).to(
            dt), drop_rate=HRATE, seed=5, keep_mask=torch.from_numpy(keep))
    assert got.dtype == dt
    want = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:  # one bf16 ulp of the output's scale
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=2 ** -8 * np.abs(want).max())
    assert calls == (["fused_layer_norm"] if use_kernel else [])


# --------------------------------------------------------------- the model
def hidden_cfg(**flags):
    """A narrow ctrl_uniter (two attention + feed-forward pairs, hidden
    128, 4 heads of 32) with attention and hidden dropout 0.1."""
    return zoo.single_stream(
        "uniter", depth=2, hidden_size=128, num_attention_heads=4,
        intermediate_size=256, pooler_size=128, v_pooler_size=128,
        vocab_size=50, max_position_embeddings=32, v_feature_size=32,
        v_hidden_size=128, v_num_attention_heads=4, v_intermediate_size=256,
        clf_hidden_size=96, attention_probs_dropout_prob=RATE,
        hidden_dropout_prob=HRATE, **flags)


FLAGS = {"fuse_hidden": dict(fuse_hidden_dropout=True),
         "pallas_mask": dict(use_pallas_dropout_mask=True),
         "both": dict(fuse_hidden_dropout=True,
                      use_pallas_dropout_mask=True)}
WRAPPERS = ((adc, "attention_dropout_fwd"), (adc, "attention_dropout_bwd"),
            (ahm, "attention_dropout_head_major_fwd"),
            (ahm, "attention_dropout_head_major_bwd"),
            (ahc, "attention_dropout_hidden_masks_fwd"), (dm, "keep_mask"))


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Counts of the calls of the dropout kernels' wrappers (on the CPU they
    run the twins and count no launch)."""
    calls = {}
    for mod, name in WRAPPERS:
        fn = getattr(mod, name)
        calls[name] = 0

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(mod, name, counted)
    return calls


def _calls(**got):
    want = {name: 0 for _, name in WRAPPERS}
    want.update(got)
    return want


# the wrapper calls of one step of the narrow model (2 attention sublayers,
# 4 tails)
STEP_CALLS = {
    "fuse_hidden": _calls(attention_dropout_hidden_masks_fwd=2,
                          attention_dropout_head_major_bwd=2),
    "pallas_mask": _calls(attention_dropout_fwd=2, attention_dropout_bwd=2,
                          keep_mask=4),
    "both": _calls(attention_dropout_hidden_masks_fwd=2,
                   attention_dropout_head_major_bwd=2)}


def _port_step(model, batch, state_seed=5):
    opt = build_optimizer("adamw", LR, model, weight_decay=WD,
                          clip_norm=CLIP, betas=BETAS, eps=EPS)
    state = create_train_state(model, opt, seed=state_seed)
    return float(make_task_train_step(model, opt, TASK_CFG, "TASK1")(
        state, batch)["loss"])


@pytest.mark.parametrize("flag", ["fuse_hidden", "pallas_mask"])
def test_flagged_train_step_matches_jax(flag, wrapper_calls, monkeypatch):
    """One fp32 step of the narrow ctrl_uniter with the flag against the
    JAX model in the interpreter, whose flagged kernels keep everything: the
    port's draws of rows 3-5, 9 and 14 are all-keep too, and the two
    embedding dropout sites hash with the same seeds on both sides. Loss
    and every parameter within rtol 2e-4 / atol 2e-5; the wrappers were
    called the counts of the flagged path."""
    cfg = hidden_cfg(**FLAGS[flag])
    batch = make_batch(6)
    state_seed = 5
    step_seed = int(torch.randint(
        0, 2**32, (), generator=torch.Generator().manual_seed(state_seed),
        dtype=torch.int64))
    seeds = DropoutSeeds(step_seed)
    drawn = []

    def next_seed():
        drawn.append(seeds.next())
        return drawn[-1]

    class SeededDropout(fnn.Module):
        rate: float

        @fnn.compact
        def __call__(self, x, deterministic=True):
            if deterministic or self.rate == 0.0:
                return x
            return _seeded_hash_dropout(x, next_seed(), self.rate)

    jmodel = JaxVLTasks(cfg, TASK_CFG, ("TASK1",), dropout_prob=0.0)
    init = jax.jit(lambda r: jmodel.init(
        r, *[jnp.asarray(batch[k]) for k in ("question", "features",
                                             "spatials")], "TASK1",
        *[jnp.asarray(batch[k]) for k in ("segment_ids", "input_mask",
                                          "image_mask")]))
    params = jax.tree.map(jnp.asarray, init(jax.random.PRNGKey(0))["params"])
    monkeypatch.setattr(fnn, "Dropout", SeededDropout)
    monkeypatch.setattr(jl, "hash_dropout", lambda x, key, rate:
                        _seeded_hash_dropout(x, next_seed(), rate))
    jmodel = JaxVLTasks(cfg, TASK_CFG, ("TASK1",), dropout_prob=0.0)
    tc = TASK_CFG["TASK1"]
    jb = jax.tree.map(jnp.asarray, batch)

    def loss_fn(p):
        inputs, info = jax_process_batch(tc, jb)
        pred, _ = jmodel.apply(
            {"params": p}, inputs["input_ids"], inputs["image_feat"],
            inputs["image_loc"], "TASK1", inputs["token_type_ids"],
            inputs["attention_mask"], inputs["image_attention_mask"],
            deterministic=False, rngs={"dropout": jax.random.PRNGKey(1)})
        return jax_loss_and_score(tc["type"], pred, jb, info)[0]

    with pa.interpret_mode():
        traced = pa.TRACE_COUNT[0]
        jax_loss, grads = jax.value_and_grad(loss_fn)(params)
        assert pa.TRACE_COUNT[0] > traced
    assert len(drawn) == 2  # the two embedding sites; the tails are masked
    tx = jax_build_optimizer("adamw", LR, params, weight_decay=WD,
                             clip_norm=CLIP, betas=BETAS, eps=EPS)
    upd, _ = tx.update(grads, tx.init(params), params)
    jax_params = optax.apply_updates(params, upd)

    _all_keep(monkeypatch)
    flax_params = jax.tree.map(np.asarray, params)
    model = load_flax_params(VoltaForVLTasks(
        VoltaConfig.from_dict(cfg.to_dict()), TASK_CFG, ("TASK1",),
        dropout_prob=0.0), flax_params).train()
    loss = _port_step(model, batch, state_seed)
    assert wrapper_calls == STEP_CALLS[flag]
    np.testing.assert_allclose(loss, float(jax_loss), rtol=2e-4)
    ref = state_dict_from_flax(jax.tree.map(np.asarray, jax_params))
    got = model.state_dict()
    assert set(got) == set(ref)
    for name, want in ref.items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("flag", ["fuse_hidden", "pallas_mask", "both"])
def test_flagged_train_step_equals_the_unflagged_one(flag, wrapper_calls):
    """The flags change no mask: from the same weights and step seed the
    flagged fp32 step equals the unflagged one (loss and parameters within
    1e-6) on the twins, and its wrappers were called the flagged path's
    counts (with both flags every tail already has row 9's mask, so row 14
    runs never)."""
    batch = make_batch(7)
    results = []
    for cfg in (hidden_cfg(), hidden_cfg(**FLAGS[flag])):
        model = VoltaForVLTasks(VoltaConfig.from_dict(cfg.to_dict()),
                                TASK_CFG, ("TASK1",))
        init_weights(model, torch.Generator().manual_seed(3))
        for name in wrapper_calls:
            wrapper_calls[name] = 0
        loss = _port_step(model.train(), batch)
        results.append((loss, model.state_dict(), dict(wrapper_calls)))
    (l0, p0, c0), (l1, p1, c1) = results
    assert c0 == _calls(attention_dropout_fwd=2, attention_dropout_bwd=2)
    assert c1 == STEP_CALLS[flag]
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    for name in p0:
        np.testing.assert_allclose(p1[name].numpy(), p0[name].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_flags_follow_the_jax_gates():
    """Row 9 needs ``use_pallas`` and a sublayer whose attention width is
    the hidden size; row 14 needs ``use_pallas``; eval mode draws nothing."""
    on = VoltaForVLTasks(VoltaConfig.from_dict(hidden_cfg(
        **FLAGS["both"]).to_dict()), TASK_CFG, ("TASK1",))
    enc = on.bert.encoder
    assert enc.attn_0.fuse_hidden and enc.ff_1.out_ln.pallas_mask
    off = dataclasses.replace(VoltaConfig.from_dict(hidden_cfg(
        **FLAGS["both"]).to_dict()), use_pallas=False)
    enc = VoltaForVLTasks(off, TASK_CFG, ("TASK1",)).bert.encoder
    assert not enc.attn_0.fuse_hidden and not enc.ff_1.out_ln.pallas_mask
    before = dict(LAUNCHES)
    with torch.no_grad():
        on.eval()(*[torch.from_numpy(make_batch(8)[k]) for k in
                    ("question", "features", "spatials")], "TASK1",
                  *[torch.from_numpy(make_batch(8)[k]) for k in
                    ("segment_ids", "input_mask", "image_mask")])
    assert LAUNCHES == before
