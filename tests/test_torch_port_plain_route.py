"""The port's plain attention route, JAX's gate and ``--no_pallas``, against
the JAX package on the CPU.

JAX's ``fused_attention`` runs the Pallas kernels only with ``use_pallas``,
a bias and at least 8 queries (volta_tpu/ops/attention.py:61); anything
else, and every dropout in training outside that gate, takes the XLA
composition, whose probabilities ``nn.Dropout`` drops
(volta_tpu/models/encoder.py:94-122). The port keeps the same gate:

* ``use_pallas: false`` logits equal JAX's XLA path (fp32 rtol 1e-5, bf16
  at test_torch_port_model.py's 5e-2);
* in training mode (attention dropout 0.1, every other rate 0) the loss
  and every gradient agree with JAX's, the keep bits of JAX's
  ``jax.random.bernoulli`` draws fed in through ``ops.attention
  .probs_keep``, as tests/test_torch_port_int_threshold.py feeds its bits;
* a route spy: the default config calls the kernel wrappers (their twins
  here), ``use_pallas: false``, no bias and Lq < 8 call none, in eval and
  in training; each attention site takes one seed on either route;
* the plain route's own draw: Bernoulli(0.9) keep bits from the seed,
  kept values divided by 0.9 as a 0-dim tensor, the same seed the same
  bits;
* ``--no_pallas`` on both CLIs sets ``use_pallas`` false.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_model import (B, LT, LV, TASK_CFG, _close, make_batch,
                                   small_cfg)
from volta_tpu.models import VoltaForVLTasks as JaxVLTasks
from volta_tpu.task_utils import process_batch as jax_process_batch
from volta_tpu.task_utils import task_loss_and_score as jax_loss_and_score
from volta_tpu_torch import VoltaForVLTasks
from volta_tpu_torch.config import VoltaConfig
from volta_tpu_torch.convert import load_flax_params, state_dict_from_flax
from volta_tpu_torch.models import layers as pl
from volta_tpu_torch.ops import attention as pa_ops
from volta_tpu_torch.ops import attention_cuda as ac
from volta_tpu_torch.ops import attention_dropout_cuda as adc
from volta_tpu_torch.ops import attention_head_major_cuda as ahm
from volta_tpu_torch.ops import attention_hidden_mask_cuda as ahmask
from volta_tpu_torch.task_utils import task_loss_and_score

KEYS = ("question", "features", "spatials")
MASKS = ("segment_ids", "input_mask", "image_mask")


def _flax_params(cfg, batch):
    model = JaxVLTasks(cfg, TASK_CFG, ("TASK1",), dropout_prob=0.0)
    variables = jax.jit(lambda r: model.init(
        r, *[jnp.asarray(batch[k]) for k in KEYS], "TASK1",
        *[jnp.asarray(batch[k]) for k in MASKS]))(jax.random.PRNGKey(0))
    return model, jax.tree.map(np.asarray, variables["params"])


def _port(cfg, params, dropout_prob=0.1):
    model = VoltaForVLTasks(VoltaConfig.from_dict(cfg.to_dict()), TASK_CFG,
                            ("TASK1",), dropout_prob=dropout_prob)
    return load_flax_params(model, params)


def _torch_args(batch):
    return ([torch.from_numpy(batch[k]) for k in KEYS],
            [torch.from_numpy(batch[k]) for k in MASKS])


@pytest.fixture(scope="module")
def plain_params():
    return _flax_params(small_cfg(), make_batch(0))[1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_route_logits_match_jax_xla(plain_params, dtype):
    batch = make_batch(3)
    cfg = small_cfg(dtype, use_pallas=False)
    jmodel = JaxVLTasks(cfg, TASK_CFG, ("TASK1",))
    ref, _ = jmodel.apply({"params": plain_params},
                          *[jnp.asarray(batch[k]) for k in KEYS], "TASK1",
                          *[jnp.asarray(batch[k]) for k in MASKS])
    model = _port(cfg, plain_params).eval()
    assert not model.bert.encoder.attn_0.use_pallas
    args, masks = _torch_args(batch)
    with torch.no_grad():
        got = model(*args, "TASK1", *masks)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)
    else:
        _close(got, ref, dtype, 5e-2)


def _jax_bernoulli_spy(monkeypatch):
    """Record the keep bits of every ``jax.random.bernoulli`` draw, the
    draw Flax's ``nn.Dropout`` makes."""
    bits = []
    real = jax.random.bernoulli

    def spy(key, p=0.5, shape=None):
        out = real(key, p, shape)
        bits.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "bernoulli", spy)
    return bits


def _feed_bits(monkeypatch, bits):
    """The port's plain route takes ``bits`` in order, as its keep bits."""
    fed = list(bits)

    def keep(shape, rate, seed, device):
        got = torch.from_numpy(fed.pop(0))
        assert tuple(got.shape) == tuple(shape)
        return got

    monkeypatch.setattr(pa_ops, "probs_keep", keep)
    return fed


def _train_cfg():
    # attention dropout only: the tails' and embeddings' dropouts draw
    # other masks in the two packages (hash dropout, Flax nn.Dropout)
    return dataclasses.replace(small_cfg(use_pallas=False),
                               hidden_dropout_prob=0.0)


def test_plain_route_train_loss_and_grads_match_jax(monkeypatch):
    batch = make_batch(4)
    cfg = _train_cfg()
    jmodel, params = _flax_params(cfg, batch)
    tc = TASK_CFG["TASK1"]
    jb = jax.tree.map(jnp.asarray, batch)

    def loss_fn(p):
        inputs, info = jax_process_batch(tc, jb)
        pred, _ = jmodel.apply(
            {"params": p}, inputs["input_ids"], inputs["image_feat"],
            inputs["image_loc"], "TASK1", inputs["token_type_ids"],
            inputs["attention_mask"], inputs["image_attention_mask"],
            deterministic=False, rngs={"dropout": jax.random.PRNGKey(7)})
        return jax_loss_and_score(tc["type"], pred, jb, info)[0]

    bits = _jax_bernoulli_spy(monkeypatch)
    jloss, jgrads = jax.value_and_grad(loss_fn)(
        jax.tree.map(jnp.asarray, params))
    # one draw an attention sublayer, the probabilities' shape
    assert [b.shape for b in bits] == [(B, 4, LT + LV, LT + LV)] * 2
    assert 0.8 < np.mean(bits) < 0.97

    model = _port(cfg, params, dropout_prob=0.0).train()
    fed = _feed_bits(monkeypatch, bits)
    args, masks = _torch_args(batch)
    pred = model(*args, "TASK1", *masks, dropout_seed=5)
    loss, _ = task_loss_and_score(
        tc["type"], pred, {"target": torch.from_numpy(batch["target"])},
        {"batch_size": B})
    loss.backward()
    assert fed == []
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    ref = state_dict_from_flax(jax.tree.map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.fixture
def kernel_calls(monkeypatch):
    """Calls of every attention wrapper (on the CPU they run the twins)."""
    calls = {}
    for mod, name in ((ac, "attention_fwd"), (ac, "attention_bwd"),
                      (adc, "attention_dropout_fwd"),
                      (adc, "attention_dropout_bwd"),
                      (ahm, "attention_head_major_fwd"),
                      (ahm, "attention_head_major_bwd"),
                      (ahm, "attention_dropout_head_major_fwd"),
                      (ahm, "attention_dropout_head_major_bwd"),
                      (ahmask, "attention_dropout_hidden_masks_fwd")):
        fn = getattr(mod, name)
        calls[name] = 0

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(mod, name, counted)
    return calls


def _short_batch():
    """3 text tokens + 4 regions: L = 7 < 8, below the kernels' gate."""
    rng = np.random.RandomState(2)
    return {"question": rng.randint(1, 50, (B, 3)).astype(np.int32),
            "features": rng.randn(B, 4, 32).astype(np.float32),
            "spatials": rng.rand(B, 4, 5).astype(np.float32),
            "segment_ids": np.zeros((B, 3), np.int32),
            "input_mask": np.ones((B, 3), np.int32),
            "image_mask": np.ones((B, 4), np.int32),
            "target": np.eye(9, dtype=np.float32)[:B]}


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("route", ["default", "no_pallas", "short"])
def test_route_spy(kernel_calls, monkeypatch, route, mode):
    """Two attention sublayers: the default config calls a kernel wrapper
    at each (forward, and backward in training); ``use_pallas: false`` and
    L < 8 call none and draw the plain route's bits instead, one seed an
    attention site on either route."""
    cfg = small_cfg(use_pallas=route != "no_pallas")
    batch = _short_batch() if route == "short" else make_batch(5)
    torch.manual_seed(0)
    model = VoltaForVLTasks(VoltaConfig.from_dict(cfg.to_dict()), TASK_CFG,
                            ("TASK1",))
    seeds = pl.DropoutSeeds(3)
    seed_at = [seeds.next() for _ in range(9)]
    draws = []
    real_keep = pa_ops.probs_keep
    monkeypatch.setattr(pa_ops, "probs_keep", lambda *a: (
        draws.append(a[2]) or real_keep(*a)))
    sites = []
    real_next = pl.DropoutSeeds.next
    monkeypatch.setattr(pl.DropoutSeeds, "next", lambda self: (
        sites.append(self.count) or real_next(self)))
    args, masks = _torch_args(batch)
    if mode == "eval":
        with torch.no_grad():
            model.eval()(*args, "TASK1", *masks)
    else:
        pred = model.train()(*args, "TASK1", *masks, dropout_seed=3)
        pred.float().sum().backward()
    kernels = route == "default"
    want = dict.fromkeys(kernel_calls, 0)
    if kernels and mode == "eval":
        want["attention_fwd"] = 2
    elif kernels:
        want.update(attention_dropout_fwd=2, attention_dropout_bwd=2)
    assert kernel_calls == want
    # each attention site's seed: the plain route draws its bits from it
    if mode == "train":
        # 2 embeddings, then (attention, tail, feed-forward tail) x 2,
        # then the pooled output: the same sites on either route
        assert sites == list(range(9))
        assert draws == ([] if kernels else
                         [seed_at[2], seed_at[5]])
    else:
        assert sites == draws == []


def test_bias_none_and_short_queries_take_the_plain_route(kernel_calls):
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(2, l, 2, 16).astype(np.float32))
               for l in (9, 11, 11))
    bias = torch.zeros(2, 1, 1, 11)
    want = pa_ops.plain_attention(q, k, v, None, 0.25)[0]
    assert torch.equal(pa_ops.fused_attention(q, k, v, None, 0.25), want)
    assert torch.equal(pa_ops.fused_attention(q[:, :7], k, v, bias, 0.25),
                       pa_ops.plain_attention(q[:, :7], k, v, bias, 0.25)[0])
    assert not any(kernel_calls.values())
    # the gate open: the kernel wrapper, the same values as the plain route
    got = pa_ops.fused_attention(q, k, v, bias, 0.25)
    assert kernel_calls["attention_fwd"] == 1
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_plain_route_dropout_draws_from_its_seed():
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(4, 30, 2, 16).astype(np.float32))
               for _ in range(3))
    out, probs = pa_ops.plain_attention(q, k, v, None, 0.25, 0.1, 11)
    keep = pa_ops.probs_keep(probs.shape, 0.1, 11, "cpu")
    clean = pa_ops.attention_probs(q, k, None, 0.25)
    denom = torch.tensor(0.9, dtype=torch.float32)
    assert torch.equal(probs, torch.where(keep, clean / denom, 0.0))
    assert abs(float(keep.float().mean()) - 0.9) < 0.01
    assert torch.equal(out, pa_ops.attention_out(probs, v))
    again = pa_ops.plain_attention(q, k, v, None, 0.25, 0.1, 11)
    assert torch.equal(again[1], probs)
    assert not torch.equal(
        pa_ops.plain_attention(q, k, v, None, 0.25, 0.1, 12)[1], probs)
    with pytest.raises(ValueError, match="seed"):
        pa_ops.plain_attention(q, k, v, None, 0.25, 0.1)
    # the global generator is neither read nor moved
    before = torch.random.get_rng_state()
    pa_ops.plain_attention(q, k, v, None, 0.25, 0.1, 3)
    assert torch.equal(before, torch.random.get_rng_state())


def test_no_pallas_flag_on_both_clis(tmp_path):
    from volta_tpu_torch import eval_task, train_task

    for cli in (eval_task, train_task):
        assert cli.parse_args(["--no_pallas"]).no_pallas
        assert not cli.parse_args([]).no_pallas
    # the eval CLI builds its model with use_pallas false
    import fixtures
    from volta_tpu import zoo

    ids = [10, 11]
    feat = fixtures.make_features_lmdb(str(tmp_path), ids, feature_size=32)
    fixtures.make_vqa_annotations(str(tmp_path), ids, n_questions=4,
                                  num_labels=9)
    vocab = fixtures.make_vocab(str(tmp_path))
    cfg = zoo.single_stream(
        "uniter", depth=2, hidden_size=64, num_attention_heads=4,
        intermediate_size=128, pooler_size=64, v_pooler_size=64,
        vocab_size=23, max_position_embeddings=64, v_feature_size=32,
        v_hidden_size=64, v_num_attention_heads=4, v_intermediate_size=128,
        clf_hidden_size=32)
    model_cfg = tmp_path / "model.json"
    model_cfg.write_text(cfg.to_json_string())
    yml = tmp_path / "tasks.yml"
    yml.write_text(f"""TASK1:
  name: VQA
  type: VL-classifier
  num_labels: 9
  loss: BCEWithLogitLoss
  process: normal
  dataroot: {tmp_path}
  features_h5path1: {feat}
  features_h5path2: ''
  train_annotations_jsonpath: ''
  val_annotations_jsonpath: ''
  max_seq_length: 12
  max_region_num: 6
  batch_size: 2
  eval_batch_size: 2
  train_split: train
  val_split: train
""")
    base = ["--config_file", str(model_cfg), "--tasks_config_file", str(yml),
            "--task", "1", "--vocab_file", vocab, "--num_workers", "0",
            "--device", "cpu"]
    for flag, want in (([], True), (["--no_pallas"], False)):
        model = eval_task.setup(eval_task.parse_args(base + flag))[0]
        enc = model.bert.encoder
        assert [getattr(enc, n).use_pallas for n in enc.names
                if n.startswith("attn_")] == [want, want]
