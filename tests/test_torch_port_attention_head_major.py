"""The port's head-major attention (Queue 2 rows 5-8, the
``attn_natural_layout: false`` configuration) against the JAX package's
Pallas kernels on the CPU.

The JAX kernels run as the JAX tests run them: in the Mosaic interpreter
(``pallas_attention.interpret_mode()``), whose PRNG gives all-zero bits, so
its dropout keeps everything at scale 1/(1 - rate); the port's twins are
fed the mask that kernel emitted (bf16, all ones). At a real hash mask the
port's row-6 twin is held against ``_dropout_bwd_core``, the JAX kernel,
which takes the mask as an input. The CUDA kernels are held against these
twins on the card by ``test_torch_port_cuda.py``. Tolerances are those of
tests/test_torch_port_attention_bwd.py: rtol 1e-5 / atol 1e-6 for forward
outputs, rtol 1e-4 / atol 1e-5 for gradients (sums in another order).

The model tests use the small ctrl_uniter of test_torch_port_model.py
(L = 14) with ``attn_natural_layout: false``: eval logits against the JAX
model's row-7 path, as that file compares them; six fp32 dropout-free train
steps against the JAX rows 7-8 path within rtol 2e-4 / atol 2e-5, as
test_torch_port_train.py; and the wrapper calls of each path counted.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_attention_bwd import GRAD_TOL, RATE, SHAPES, _bias2, \
    _inputs, ids
from test_torch_port_model import TASK_CFG, _close, make_batch, small_cfg
from test_torch_port_train import BETAS, CLIP, EPS, LR, STEPS, WARMUP, WD, \
    _flax_init, _jax_steps
from volta_tpu.models import VoltaForVLTasks as JaxVLTasks
from volta_tpu.ops import pallas_attention as pa
from volta_tpu.ops.attention import additive_mask as jax_mask
from volta_tpu_torch import VoltaForVLTasks
from volta_tpu_torch.config import VoltaConfig
from volta_tpu_torch.convert import load_flax_params, state_dict_from_flax
from volta_tpu_torch.ops import LAUNCHES
from volta_tpu_torch.ops import attention_cuda as ac
from volta_tpu_torch.ops import attention_dropout_cuda as adc
from volta_tpu_torch.ops import attention_head_major_cuda as ahm
from volta_tpu_torch.ops.attention import dropout_attention_head_major, \
    fused_attention
from volta_tpu_torch.optimization import build_optimizer, \
    warmup_linear_schedule
from volta_tpu_torch.train_step import create_train_state, \
    make_task_train_step

FWD_TOL = dict(rtol=1e-5, atol=1e-6)


def _hm(x):
    """numpy [B, L, H, D] -> torch [H, B, L, D], contiguous."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1, 3)))


def _jhm(x):
    return jnp.asarray(np.ascontiguousarray(x.transpose(2, 0, 1, 3)))


def _back(t):
    """torch [H, B, L, D] -> numpy [B, L, H, D]."""
    return t.detach().permute(1, 2, 0, 3).numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_rows_7_8_twins_match_pallas(shape):
    """Row 7: pallas_fused_attention (``_pallas_forward``, the head-major
    kernel) against the port's twin; row 8: jax.vjp of it (its rule runs
    ``_attn_bwd_pallas`` for Lq >= 8, the XLA recipe below) against the
    twin's dq, dk, dv and per-head bias partials, directly and through
    HeadMajorAttention. CPU tensors launch nothing."""
    b, lq, lk, h, d = shape
    q, k, v, g, mask = _inputs(*shape, seed=10)
    scale = 1.0 / np.sqrt(d)
    jb = jax_mask(jnp.asarray(mask))
    with pa.interpret_mode():
        traced = pa.TRACE_COUNT[0]
        out, vjp = jax.vjp(
            lambda q, k, v, bias: pa.pallas_fused_attention(
                q, k, v, bias, scale), *map(jnp.asarray, (q, k, v)), jb)
        jgrads = vjp(jnp.asarray(g))
        assert pa.TRACE_COUNT[0] > traced
    bias = _bias2(mask)
    before = dict(LAUNCHES)
    got = ahm.attention_head_major_fwd(_hm(q), _hm(k), _hm(v), bias, scale)
    assert got.shape == (h, b, lq, d) and got.is_contiguous()
    np.testing.assert_allclose(_back(got), np.asarray(out), **FWD_TOL)
    dq, dk, dv, db_part = ahm.attention_head_major_bwd(
        _hm(q), _hm(k), _hm(v), bias, _hm(g), scale, want_db=True)
    assert db_part.shape == (h, b, lk) and db_part.dtype == torch.float32
    for name, t, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), jgrads):
        np.testing.assert_allclose(_back(t), np.asarray(ref), err_msg=name,
                                   **GRAD_TOL)
    np.testing.assert_allclose(db_part.sum(0).numpy(),
                               np.asarray(jgrads[3]).reshape(b, lk),
                               **GRAD_TOL)
    assert ahm.attention_head_major_bwd(_hm(q), _hm(k), _hm(v), bias, _hm(g),
                                        scale)[3] is None

    leaves = [_hm(x).requires_grad_() for x in (q, k, v)]
    tb = bias.clone().requires_grad_()
    fout = ahm.HeadMajorAttention.apply(*leaves, tb, scale)
    fout.backward(_hm(g))
    assert torch.equal(fout, got)
    for t, want in zip(leaves, (dq, dk, dv)):
        assert torch.equal(t.grad, want)
    assert torch.equal(tb.grad, db_part.sum(0))
    assert LAUNCHES == before


@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_rows_5_6_twins_match_pallas_interpreter(shape):
    """Rows 5-6: pallas_dropout_attention(natural=False) in the Mosaic
    interpreter against the port's twins fed the interpreter's own keep
    mask (``_dropout_fwd_core``'s bf16 output, all ones there): forward and
    vjp."""
    b, lq, lk, h, d = shape
    q, k, v, g, mask = _inputs(*shape, seed=11)
    scale = 1.0 / np.sqrt(d)
    jb = jax_mask(jnp.asarray(mask))
    with pa.interpret_mode():
        out, vjp = jax.vjp(
            lambda q, k, v: pa.pallas_dropout_attention(
                q, k, v, jb, scale, RATE, 1234, natural=False),
            *map(jnp.asarray, (q, k, v)))
        jgrads = vjp(jnp.asarray(g))
        _, jmask = pa._dropout_fwd_core(
            _jhm(q), _jhm(k), _jhm(v), pa._bias_bcast(jb, b, lk),
            jnp.asarray([1234], jnp.int32), scale, RATE,
            pa._pick_tile(b, 16, lq, lk, d))
    assert jmask.dtype == jnp.bfloat16 and jmask.shape == (h, b, lq, lk)
    assert bool(jnp.all(jmask == 1))  # the interpreter keeps everything
    keep = torch.from_numpy(np.asarray(jmask, np.float32)).bfloat16()
    args = (_hm(q), _hm(k), _hm(v), _bias2(mask))
    got = ahm.attention_dropout_head_major_fwd_ref(*args, scale, RATE, keep)
    np.testing.assert_allclose(_back(got), np.asarray(out), **FWD_TOL)
    grads = ahm.attention_dropout_head_major_bwd_ref(*args, _hm(g), keep,
                                                     scale, RATE)
    for name, t, ref in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(_back(t), np.asarray(ref), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_row_6_twin_matches_pallas_at_a_real_mask(shape):
    """Row 6 at a real mask: the port's head-major hash mask, as bf16, into
    the JAX kernel ``_dropout_bwd_core`` and the port's twin."""
    b, lq, lk, h, d = shape
    q, k, v, g, mask = _inputs(*shape, seed=12)
    scale = 1.0 / np.sqrt(d)
    keep = ahm.keep_mask_head_major(0xDEADBEEF, (h, b, lq, lk), RATE)
    assert keep.dtype == torch.uint8
    assert 0.7 < float(keep.float().mean()) < 1.0  # some probabilities drop
    jb = jax_mask(jnp.asarray(mask))
    with pa.interpret_mode():
        jgrads = pa._dropout_bwd_core(
            _jhm(q), _jhm(k), _jhm(v), pa._bias_bcast(jb, b, lk), _jhm(g),
            jnp.asarray(keep.numpy(), jnp.bfloat16), scale, RATE,
            pa._pick_tile(b, 16, lq, lk, d))
    grads = ahm.attention_dropout_head_major_bwd_ref(
        _hm(q), _hm(k), _hm(v), _bias2(mask), _hm(g), keep, scale, RATE)
    for name, t, ref in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(ref), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("shape", SHAPES[:2], ids=ids)
def test_dropout_attention_head_major_entry_matches_jax(shape, monkeypatch):
    """The port's ``dropout_attention_head_major`` (operands already
    head-major, no layout copies) against the JAX entry of that name in the
    interpreter: the port's mask draw is replaced by the interpreter's
    all-keep mask. Forward, vjp, and no bias gradient."""
    b, lq, lk, h, d = shape
    q, k, v, g, mask = _inputs(*shape, seed=13)
    scale = 1.0 / np.sqrt(d)
    jb = jax_mask(jnp.asarray(mask))
    with pa.interpret_mode():
        out, vjp = jax.vjp(
            lambda q, k, v: pa.dropout_attention_head_major(
                q, k, v, jb, scale, RATE, 77), _jhm(q), _jhm(k), _jhm(v))
        jgrads = vjp(_jhm(g))
    monkeypatch.setattr(ahm, "keep_mask_head_major",
                        lambda seed, shape, rate, device=None:
                        torch.ones(shape, dtype=torch.uint8))
    leaves = [_hm(x).requires_grad_() for x in (q, k, v)]
    bias4 = _bias2(mask).view(b, 1, 1, lk).requires_grad_()
    got = dropout_attention_head_major(*leaves, bias4, scale, RATE, 77)
    got.backward(_hm(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               **FWD_TOL)
    for name, t, ref in zip(("dq", "dk", "dv"), leaves, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   err_msg=name, **GRAD_TOL)
    assert bias4.grad is None


@pytest.mark.parametrize("rate", [0.0, RATE], ids=["no_dropout", "dropout"])
def test_head_major_agrees_with_natural(rate):
    """One seed drops the same probabilities in both layouts, so
    fused_attention with natural=False equals natural=True on the CPU twins:
    the output and the gradients of q, k and v within 1e-6."""
    b, lq, lk, h, d = 3, 14, 14, 4, 16
    q, k, v, g, mask = _inputs(b, lq, lk, h, d, seed=14)
    bias4 = _bias2(mask).view(b, 1, 1, lk)
    outs, grads = [], []
    for natural in (True, False):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = fused_attention(*leaves, bias4, 0.25, rate, 1234,
                              natural=natural)
        assert out.shape == (b, lq, h, d)
        out.backward(torch.from_numpy(g))
        outs.append(out.detach())
        grads.append([t.grad for t in leaves])
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), rtol=1e-6,
                               atol=1e-6)
    for a, r in zip(*grads):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-6,
                                   atol=1e-6)
    keep = ahm.keep_mask_head_major(1234, (h, b, lq, lk), RATE)
    assert torch.equal(keep.transpose(0, 1).bool(),
                       adc.keep_mask(1234, (b, h, lq, lk), RATE))


def test_head_major_functions_gradcheck_float64():
    """Both Functions' twin paths pass torch.autograd.gradcheck in float64:
    HeadMajorAttention with the bias gradient, HeadMajorDropoutAttention
    with its saved mask."""
    h, b, lq, lk, d = 2, 2, 3, 5, 4
    rng = np.random.RandomState(15)
    mk = lambda *s: torch.from_numpy(rng.randn(*s)).requires_grad_()  # noqa
    q, k, v = mk(h, b, lq, d), mk(h, b, lk, d), mk(h, b, lk, d)
    bias = torch.zeros(b, lk, dtype=torch.float64)
    bias[1, 3] = -2.0
    keep = ahm.keep_mask_head_major(77, (h, b, lq, lk), 0.3)
    assert 0 < int(keep.sum()) < keep.numel()  # the mask drops something
    assert torch.autograd.gradcheck(
        lambda q, k, v: ahm.HeadMajorDropoutAttention.apply(
            q, k, v, bias, 0.5, 0.3, 77), (q, k, v))
    assert torch.autograd.gradcheck(
        lambda q, k, v, bias: ahm.HeadMajorAttention.apply(q, k, v, bias,
                                                           0.5),
        (q, k, v, bias.clone().requires_grad_()))


def test_head_major_wrappers_refuse_what_the_kernels_do_not_take():
    """On no CUDA device the wrappers raise, and the dropout backward
    refuses a rate outside (0, 1)."""
    meta = torch.zeros(2, 3, 8, 16, device="meta")
    bias = torch.zeros(3, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        ahm.attention_head_major_fwd(meta, meta, meta, bias, 0.25)
    with pytest.raises(ValueError, match="CUDA device"):
        ahm.attention_dropout_head_major_bwd(meta, meta, meta, bias, meta,
                                             meta.to(torch.uint8), 0.25,
                                             RATE)
    cpu = torch.zeros(2, 3, 8, 16)
    with pytest.raises(ValueError, match="rate"):
        ahm.attention_dropout_head_major_bwd(cpu, cpu, cpu, cpu[0, :, :, 0],
                                             cpu, cpu, 0.25, 0.0)


# ------------------------------------------------------------------ model
def hm_cfg(dtype="float32", use_pallas=True):
    return dataclasses.replace(small_cfg(dtype, use_pallas),
                               attn_natural_layout=False)


def port_cfg(cfg):
    return VoltaConfig.from_dict(cfg.to_dict())


@pytest.fixture(scope="module")
def flax_params():
    return _flax_init(small_cfg(), make_batch(0))[1]


@pytest.fixture
def attention_calls(monkeypatch):
    """Counts of the calls of the eight attention wrappers (on the CPU they
    run the twins and count no launch)."""
    calls = {}
    for mod, name in ((ac, "attention_fwd"), (ac, "attention_bwd"),
                      (adc, "attention_dropout_fwd"),
                      (adc, "attention_dropout_bwd"),
                      (ahm, "attention_head_major_fwd"),
                      (ahm, "attention_head_major_bwd"),
                      (ahm, "attention_dropout_head_major_fwd"),
                      (ahm, "attention_dropout_head_major_bwd")):
        fn = getattr(mod, name)
        calls[name] = 0

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(mod, name, counted)
    return calls


def _logits(model, batch):
    with torch.no_grad():
        return model(*[torch.from_numpy(batch[k]) for k in
                       ("question", "features", "spatials")], "TASK1",
                     *[torch.from_numpy(batch[k]) for k in
                       ("segment_ids", "input_mask", "image_mask")])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_major_eval_logits_match_jax(flax_params, attention_calls,
                                          dtype):
    """The eval forward of the head-major config against the JAX model's
    Pallas row-7 path in the interpreter (tolerances of
    test_torch_port_model.py: fp32 1e-4, bf16 5e-2); the port called the
    row-7 wrapper once per attention sublayer and nothing else."""
    batch = make_batch(3)
    jmodel = JaxVLTasks(hm_cfg(dtype, use_pallas=True), TASK_CFG,
                        ("TASK1",))
    with pa.interpret_mode():
        traced = pa.TRACE_COUNT[0]
        ref, _ = jmodel.apply(
            {"params": flax_params},
            *[jnp.asarray(batch[k]) for k in
              ("question", "features", "spatials")], "TASK1",
            *[jnp.asarray(batch[k]) for k in
              ("segment_ids", "input_mask", "image_mask")])
        assert pa.TRACE_COUNT[0] > traced
    model = load_flax_params(VoltaForVLTasks(port_cfg(hm_cfg(dtype)),
                                             TASK_CFG, ("TASK1",)),
                             flax_params).eval()
    assert not model.bert.encoder.attn_0.natural
    got = _logits(model, batch)
    assert got.dtype == getattr(torch, dtype)
    _close(got, ref, dtype, 5e-2)
    want = dict.fromkeys(attention_calls, 0)
    want["attention_head_major_fwd"] = 2
    assert attention_calls == want


def test_head_major_train_steps_match_jax(attention_calls):
    """Six fp32 dropout-free steps of the head-major config against the JAX
    package's rows 7-8 in the interpreter, as test_torch_port_train.py holds
    the natural config: losses and every parameter within rtol 2e-4 /
    atol 2e-5. Each port step calls rows 7 and 8 once per attention
    sublayer, and no natural wrapper."""
    batch = make_batch(4)
    jmodel, params = _flax_init(hm_cfg(use_pallas=True), batch)
    jax_losses, norms, jax_params = _jax_steps(jmodel, params, batch)
    assert norms[0] > CLIP  # the clip is active
    tmodel = load_flax_params(
        VoltaForVLTasks(port_cfg(hm_cfg()), TASK_CFG, ("TASK1",)),
        params).eval()
    opt = build_optimizer("adamw", warmup_linear_schedule(LR, WARMUP, STEPS),
                          tmodel, weight_decay=WD, clip_norm=CLIP,
                          betas=BETAS, eps=EPS)
    state = create_train_state(tmodel, opt, seed=0)
    step = make_task_train_step(tmodel, opt, TASK_CFG, "TASK1")
    before = dict(LAUNCHES)
    losses = [float(step(state, batch)["loss"]) for _ in range(STEPS)]
    assert LAUNCHES == before
    np.testing.assert_allclose(losses, jax_losses, rtol=2e-4)
    want = dict.fromkeys(attention_calls, 0)
    want.update(attention_head_major_fwd=2 * STEPS,
                attention_head_major_bwd=2 * STEPS)
    assert attention_calls == want

    ref = state_dict_from_flax(jax.tree.map(np.asarray, jax_params))
    got = tmodel.state_dict()
    assert set(got) == set(ref)
    for name, want_p in ref.items():
        np.testing.assert_allclose(got[name].numpy(), want_p.numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("natural", [True, False],
                         ids=["natural", "head_major"])
@pytest.mark.parametrize("mode", ["eval", "train", "train_dropout_free"])
def test_layout_flag_routes_the_attention_wrappers(attention_calls, natural,
                                                   mode):
    """``attn_natural_layout`` picks the wrappers, as it picks the JAX
    kernels: each forward of the small model (two attention sublayers)
    calls the layout's forward wrapper twice, each train step its backward
    wrapper twice too, and the other layout's wrappers never."""
    cfg = port_cfg(small_cfg(use_pallas=True) if natural else hm_cfg())
    assert cfg.attn_natural_layout is natural
    torch.manual_seed(0)
    model = VoltaForVLTasks(cfg, TASK_CFG, ("TASK1",))
    batch = make_batch(5)
    if mode == "eval":
        _logits(model.eval(), batch)
    else:
        model.train(mode == "train")
        opt = build_optimizer("adamw", 1e-4, model, clip_norm=1.0)
        step = make_task_train_step(model, opt, TASK_CFG, "TASK1")
        assert np.isfinite(float(step(create_train_state(model, opt, 3),
                                      batch)["loss"]))
    fwd, bwd = {
        (True, False): ("attention_fwd", "attention_bwd"),
        (True, True): ("attention_dropout_fwd", "attention_dropout_bwd"),
        (False, False): ("attention_head_major_fwd",
                         "attention_head_major_bwd"),
        (False, True): ("attention_dropout_head_major_fwd",
                        "attention_dropout_head_major_bwd")}[
        natural, mode == "train"]
    want = dict.fromkeys(attention_calls, 0)
    want[fwd] = 2
    want[bwd] = 0 if mode == "eval" else 2
    assert attention_calls == want
