"""``use_scan``: the port runs JAX's scanned block as a loop, held against
the JAX package's ``_scan_fused`` on the CPU.

The small single-stream UNITER of tests/test_torch_port_model.py (two
attention + feed-forward pairs, hidden 64, 4 heads of 16; 8 text tokens +
6 regions), its Flax init bridged into the port.

- Eval: the encoder's outputs and the logits with ``use_scan`` against
  JAX's with ``use_scan``, within JAX's own tolerance for the scan
  (tests/test_fused_single_stream.py:52-71, rtol 2e-5 / atol 2e-6), fp32,
  on the kernel route (the twins of rows 1 and 7; JAX's Pallas kernels in
  the Mosaic interpreter) and on the plain route (JAX's XLA path).
- Training: the encoder at attention and hidden dropout 0.1 in training
  mode, loss sum(y · r) for a fixed random r, and every parameter's gradient, against JAX's
  ``jax.value_and_grad`` of the same loss with JAX's scan, on the plain
  route (``use_pallas: false``), where each of JAX's drops is a Bernoulli
  draw (``_dropout``, encoder.py:490-496): those draws are recorded in a
  forward of the same key and fed to the port through ``encoder
  .scan_keep`` in call order (a layer: probabilities, attention tail,
  feed-forward tail). Loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-6
  (float32 sums in two frameworks' orders).
  On the kernel route JAX's interpreter keeps every probability (its PRNG
  gives zero bits), so there the port's step is checked for its routes:
  rows 3-4 (twins) a layer, no LayerNorm, fused-tail or K10 wrapper, and
  the forward equal to the same recipe with the drops done by hand.
- The gate: plans that JAX's ``_scannable`` refuses (odd depth, no
  alternation, unequal heads or widths), a dual-stream plan and the
  capture flags take the loop, with its outputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_model import TASK_CFG, B, LT, LV, flax_params, \
    make_batch, small_cfg  # noqa: F401 (a fixture)
from volta_tpu.models import VoltaForVLTasks as JaxVLTasks
from volta_tpu.models import encoder as jenc
from volta_tpu.models.encoder import GatedEncoder as JaxEncoder
from volta_tpu.ops import pallas_attention as pa
from volta_tpu.ops.attention import additive_mask as jax_mask
from volta_tpu_torch import VoltaForVLTasks
from volta_tpu_torch.config import VoltaConfig
from volta_tpu_torch.convert import load_flax_params, state_dict_from_flax
from volta_tpu_torch.models import encoder as tenc
from volta_tpu_torch.models.layers import DropoutSeeds
from volta_tpu_torch.ops import attention_cuda, attention_dropout_cuda, \
    fused_residual, hash_dropout, layernorm
from volta_tpu_torch.ops.attention import additive_mask

RTOL, ATOL = 2e-5, 2e-6


def scan_cfg(use_pallas=True, natural=True, rate=0.1, **kw):
    return dataclasses.replace(
        small_cfg("float32", use_pallas),
        **dict(dict(use_scan=True, attn_natural_layout=natural,
                    attention_probs_dropout_prob=rate,
                    hidden_dropout_prob=rate), **kw))


def port_encoder(params, cfg):
    enc = tenc.GatedEncoder(VoltaConfig.from_dict(cfg.to_dict()))
    enc.load_state_dict(state_dict_from_flax(params["bert"]["encoder"]))
    return enc


def encoder_inputs(seed=2):
    batch = make_batch(seed)
    rng = np.random.RandomState(5)
    return (rng.randn(B, LT, 64).astype(np.float32),
            rng.randn(B, LV, 64).astype(np.float32),
            batch["input_mask"], batch["image_mask"])


@pytest.mark.parametrize("natural", [True, False],
                         ids=["natural", "head_major"])
@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "xla"])
def test_scan_eval_matches_jax(flax_params, use_pallas, natural):
    t, v, tm, vm = encoder_inputs()
    cfg = scan_cfg(use_pallas, natural)
    with pa.interpret_mode():
        jt, jv, _ = JaxEncoder(cfg).apply(
            {"params": flax_params["bert"]["encoder"]}, jnp.asarray(t),
            jnp.asarray(v), jax_mask(jnp.asarray(tm)),
            jax_mask(jnp.asarray(vm)))
    enc = port_encoder(flax_params, cfg).eval()
    assert enc.scan
    with torch.no_grad():
        tt, tv = enc(torch.from_numpy(t), torch.from_numpy(v),
                     additive_mask(torch.from_numpy(tm)),
                     additive_mask(torch.from_numpy(vm)))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)

    # the whole model's logits
    batch = make_batch(3)
    keys = ("question", "features", "spatials")
    rest = ("segment_ids", "input_mask", "image_mask")
    with pa.interpret_mode():
        ref, _ = JaxVLTasks(cfg, TASK_CFG, ("TASK1",)).apply(
            {"params": flax_params},
            *[jnp.asarray(batch[k]) for k in keys], "TASK1",
            *[jnp.asarray(batch[k]) for k in rest])
    model = load_flax_params(VoltaForVLTasks(
        VoltaConfig.from_dict(cfg.to_dict()), TASK_CFG, ("TASK1",)),
        flax_params).eval()
    with torch.no_grad():
        got = model(*[torch.from_numpy(batch[k]) for k in keys], "TASK1",
                    *[torch.from_numpy(batch[k]) for k in rest])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def _recorded_jax_masks(monkeypatch, cfg, params, args, key):
    """JAX's Bernoulli keep draws of one training forward of the scan, in
    call order."""
    record = []

    def recording(x, k, rate, deterministic):
        if deterministic or rate == 0.0:
            return x
        keep = jax.random.bernoulli(k, 1.0 - rate, x.shape)
        jax.debug.callback(lambda m: record.append(np.asarray(m)), keep,
                           ordered=True)
        return jnp.where(keep, x / (1.0 - rate), 0)

    with monkeypatch.context() as m:
        m.setattr(jenc, "_dropout", recording)
        out = JaxEncoder(cfg).apply({"params": params}, *args,
                                    deterministic=False,
                                    rngs={"dropout": key})
        jax.block_until_ready(out[0])
        jax.effects_barrier()
    return record


def test_scan_training_step_matches_jax(flax_params, monkeypatch):
    cfg = scan_cfg(use_pallas=False)
    t, v, tm, vm = encoder_inputs()
    jparams = flax_params["bert"]["encoder"]
    args = (jnp.asarray(t), jnp.asarray(v), jax_mask(jnp.asarray(tm)),
            jax_mask(jnp.asarray(vm)))
    key = jax.random.PRNGKey(7)
    # a fixed projection of the outputs (the sum of squares of a
    # LayerNorm's output is constant per row and sends back no gradient)
    rng = np.random.RandomState(9)
    rt, rv = (rng.randn(*x.shape).astype(np.float32) for x in (t, v))
    masks = _recorded_jax_masks(monkeypatch, cfg, jparams, args, key)
    # two layers: probabilities, attention tail, feed-forward tail each
    assert [m.shape for m in masks] == [
        (B, 4, LT + LV, LT + LV), (B, LT + LV, 64), (B, LT + LV, 64)] * 2
    for m in masks:
        assert 0.75 < m.mean() < 0.99

    def loss_fn(p):
        jt, jv, _ = JaxEncoder(cfg).apply({"params": p}, *args,
                                          deterministic=False,
                                          rngs={"dropout": key})
        return jnp.sum(jt * rt) + jnp.sum(jv * rv)

    jloss, jgrads = jax.value_and_grad(loss_fn)(jparams)

    fed = iter(masks)
    shapes = []

    def keep(shape, rate, seed, device):
        shapes.append(tuple(shape))
        return torch.from_numpy(next(fed).copy())

    monkeypatch.setattr(tenc, "scan_keep", keep)
    enc = port_encoder(flax_params, cfg).train()
    tt, tv = enc(torch.from_numpy(t), torch.from_numpy(v),
                 additive_mask(torch.from_numpy(tm)),
                 additive_mask(torch.from_numpy(vm)), DropoutSeeds(3))
    loss = (tt * torch.from_numpy(rt)).sum() + \
        (tv * torch.from_numpy(rv)).sum()
    loss.backward()
    assert shapes == [m.shape for m in masks]
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    ref = state_dict_from_flax(jax.tree.map(np.asarray, jgrads))
    grads = {n: p.grad for n, p in enc.named_parameters()}
    assert set(grads) == set(ref)
    for name, want in ref.items():
        np.testing.assert_allclose(grads[name].numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Calls of the wrappers a scan step could reach (on the CPU they run
    the twins)."""
    calls = {}
    for mod, name in ((attention_cuda, "attention_fwd"),
                      (attention_cuda, "attention_bwd"),
                      (attention_dropout_cuda, "attention_dropout_fwd"),
                      (attention_dropout_cuda, "attention_dropout_bwd"),
                      (layernorm, "layer_norm_fwd"),
                      (fused_residual, "dropout_residual_ln_fwd"),
                      (hash_dropout, "hash_dropout_fwd")):
        fn = getattr(mod, name)
        calls[name] = 0

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    return calls


def test_scan_kernel_route_training(flax_params, wrapper_calls, monkeypatch):
    """Rows 3-4 once a layer, and nothing of rows 10-13 or K10 in the
    tails even with the LayerNorm flags on; the forward equals the recipe
    with its drops made by hand."""
    cfg = scan_cfg(use_pallas=True, use_pallas_layernorm=True,
                   use_fused_residual_ln=True)
    t, v, tm, vm = encoder_inputs()
    drawn = []
    real = tenc.scan_keep

    def keep(shape, rate, seed, device):
        drawn.append((tuple(shape), seed))
        return real(shape, rate, seed, device)

    monkeypatch.setattr(tenc, "scan_keep", keep)
    enc = port_encoder(flax_params, cfg).train()
    inputs = (torch.from_numpy(t).requires_grad_(), torch.from_numpy(v),
              additive_mask(torch.from_numpy(tm)),
              additive_mask(torch.from_numpy(vm)))
    tt, tv = enc(*inputs, DropoutSeeds(11))
    (tt.sum() + tv.sum()).backward()
    assert wrapper_calls == {"attention_fwd": 0, "attention_bwd": 0,
                             "attention_dropout_fwd": 2,
                             "attention_dropout_bwd": 2,
                             "layer_norm_fwd": 0,
                             "dropout_residual_ln_fwd": 0,
                             "hash_dropout_fwd": 0}
    assert [s for s, _ in drawn] == [(B, LT + LV, 64)] * 4
    assert all(np.isfinite(p.grad.numpy()).all()
               for p in enc.parameters())

    # the same forward by hand: the seeds in draw order a layer
    seeds = DropoutSeeds(11)
    x = torch.cat(inputs[:2], 1)
    bias = torch.cat(inputs[2:], -1)
    for i in (0, 2):
        a, f = getattr(enc, f"attn_{i}"), getattr(enc, f"ff_{i + 1}")
        q, k, vv = (m(x).view(B, LT + LV, 4, 16)
                    for m in (a.query, a.key, a.value))
        ctx = tenc.fused_attention(q, k, vv, bias, 0.25, 0.1, seeds.next())
        o = a.out_dense(ctx.reshape(B, LT + LV, 64))
        o = torch.where(tenc.probs_keep(o.shape, 0.1, seeds.next(), "cpu"),
                        o / torch.tensor(0.9), 0.0)
        x = tenc.layer_norm(o + x, a.out_ln.weight, a.out_ln.bias)
        o = f.out_dense(f.act(f.inter_dense(x)))
        o = torch.where(tenc.probs_keep(o.shape, 0.1, seeds.next(), "cpu"),
                        o / torch.tensor(0.9), 0.0)
        x = tenc.layer_norm(o + x, f.out_ln.weight, f.out_ln.bias)
    np.testing.assert_allclose(tt.detach().numpy(), x[:, :LT].detach()
                               .numpy(), rtol=1e-6, atol=1e-6)


def _plan_cfg(**kw):
    return VoltaConfig.from_dict(dict(scan_cfg().to_dict(), **kw))


def test_scannable_gate_is_jax_gate():
    cfg = _plan_cfg()
    plan = cfg.sublayer_plan()
    assert tenc._scannable(cfg, plan)
    assert not tenc._scannable(_plan_cfg(use_scan=False), plan)
    assert not tenc._scannable(cfg, plan[:3])  # odd depth
    assert not tenc._scannable(cfg, [plan[0], plan[0], plan[1], plan[1]])
    assert not tenc._scannable(cfg, plan[:2] + [
        dataclasses.replace(plan[2], num_heads=2), plan[3]])
    assert not tenc._scannable(cfg, plan[:2] + [
        dataclasses.replace(plan[2], attn_hidden_size=32), plan[3]])


def test_unscannable_plans_take_the_loop(flax_params):
    """A dual-stream plan builds with ``use_scan`` and runs its loop; the
    capture flags take the general loop from the scan route too, with the
    loop model's outputs."""
    from test_model_shapes import tiny_zoo

    vil = tiny_zoo("ctrl_vilbert_base")
    enc = tenc.GatedEncoder(VoltaConfig.from_dict(dict(vil.to_dict(),
                                                       use_scan=True)))
    assert not enc.fused and not enc.scan

    t, v, tm, vm = encoder_inputs()
    args = (torch.from_numpy(t), torch.from_numpy(v),
            additive_mask(torch.from_numpy(tm)),
            additive_mask(torch.from_numpy(vm)))
    scan = port_encoder(flax_params, scan_cfg()).eval()
    loop = port_encoder(flax_params, scan_cfg(use_scan=False)).eval()
    assert scan.scan and not loop.scan
    with torch.no_grad():
        got = scan(*args, output_all_layers=True)
        want = loop(*args, output_all_layers=True)
    assert len(got[2][0]) == 4
    for g, w in zip(got[2][0] + got[2][1], want[2][0] + want[2][1]):
        assert torch.equal(g, w)
