"""Every task head, process, loss and score of the port against the JAX
package on the CPU.

One small single-stream UNITER (``test_torch_port_model.small_cfg``: two
attention + feed-forward pairs, hidden 64, 4 heads of 16) holds one head
of every type of ``volta_tpu/models/model.py:176-195``: VL-classifier,
VL-logit under the ``expand``, ``retrieval`` and ``dialog`` processes,
V-logit with one and two layers, VL-binary-classifier under ``nlvr``,
VL-tri-classifier with cross entropy and with BCE, and V-logit-mc with one
and two layers (their candidates in region slots 101 on). One Flax init of
that model, bridged with ``convert.state_dict_from_flax``, is fed the same
seed-made numpy batch per task on both sides:

* ``process_batch`` gives the same model inputs, bit for bit, and the same
  ``info``; the ``nlvr`` pairs stay consecutive rows;
* every head's logits, loss and score, fp32 and bf16, against JAX's Pallas
  path (Mosaic interpreter) and its XLA path, at
  ``test_full_logits_and_loss_match``'s tolerances; the V-logit padding
  penalty equal to JAX's, -9984 in bf16;
* three fp32 steps at dropout 0 for NLVR2, V-logit and retrieval at
  ``test_torch_port_train.py``'s tolerances;
* in training mode, the sites after the encoder (the pooled output's, the
  region outputs', ``VLogitMLP``'s) take consecutive seeds of
  ``DropoutSeeds``, keep about 0.9, and repeat for the same seed;
* the reference ``.bin`` export and import of every head, key for key and
  bit for bit, against ``volta_tpu/checkpoint.py``;
* the port's ``collect_results`` writes the root ``eval_task.py``'s
  records for every type.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_model import small_cfg
from volta_tpu import checkpoint as jck
from volta_tpu import task_utils as jtu
from volta_tpu.models import VoltaForVLTasks as JaxVLTasks
from volta_tpu.ops import pallas_attention as pa
from volta_tpu.optimization import build_optimizer as jax_build_optimizer
from volta_tpu.optimization import warmup_linear_schedule as jax_warmup
from volta_tpu_torch import VoltaForVLTasks
from volta_tpu_torch import checkpoint as ck
from volta_tpu_torch import task_utils as ptu
from volta_tpu_torch.config import VoltaConfig
from volta_tpu_torch.convert import load_flax_params, state_dict_from_flax
from volta_tpu_torch.eval_step import make_task_eval_step
from volta_tpu_torch.models import model as model_mod
from volta_tpu_torch.models.layers import DropoutSeeds
from volta_tpu_torch.optimization import build_optimizer, \
    warmup_linear_schedule
from volta_tpu_torch.train_step import create_train_state, \
    make_task_train_step

NL, LT, LV, F = 9, 8, 6, 32
MC_LV = 106  # V-logit-mc reads its candidates from region slots 101 on
BCE, CE = "BCEWithLogitLoss", "CrossEntropyLoss"
TASKS = {
    "TASK1": dict(type="VL-classifier", num_labels=NL, process="normal",
                  loss=BCE),
    "TASK6": dict(type="VL-logit", process="expand", loss=CE),
    "TASK8": dict(type="VL-logit", process="retrieval", loss=CE),
    "TASK9": dict(type="VL-logit", process="dialog", loss=CE),
    "TASK10": dict(type="V-logit", process="normal", loss=BCE),
    "TASK11": dict(type="V-logit", num_clf_layers=2, process="normal",
                   loss=BCE),
    "TASK12": dict(type="VL-binary-classifier", num_labels=2,
                   process="nlvr", loss=BCE),
    "TASK13": dict(type="VL-tri-classifier", process="normal", loss=CE),
    "TASK14": dict(type="VL-tri-classifier", process="normal", loss=BCE),
    "TASK15": dict(type="V-logit-mc", process="normal", loss=BCE),
    "TASK16": dict(type="V-logit-mc", num_clf_layers=2, process="normal",
                   loss=BCE),
}
IDS = tuple(TASKS)
PROCESS_TASK = {"normal": "TASK1", "expand": "TASK6", "retrieval": "TASK8",
                "dialog": "TASK9", "nlvr": "TASK12"}
LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
        "bias": "bias"}


def _text(rng, lead):
    ids = rng.randint(1, 50, lead + (LT,)).astype(np.int32)
    mask = np.ones(lead + (LT,), np.int32)
    mask.reshape(-1, LT)[1, 5:] = 0
    ids[mask == 0] = 0
    return {"question": ids, "input_mask": mask,
            "segment_ids": np.zeros_like(ids)}


def _image(rng, lead, lv):
    mask = np.ones(lead + (lv,), np.int32)
    mask.reshape(-1, lv)[-1, lv - 2:] = 0
    return {"features": rng.randn(*lead, lv, F).astype(np.float32),
            "spatials": rng.rand(*lead, lv, 5).astype(np.float32),
            "image_mask": mask}


def make_task_batch(task, seed=0):
    """A seed-made numpy batch for ``task`` in its dataset's layout."""
    rng = np.random.RandomState(seed)
    tc = TASKS[task]
    process, ttype = tc["process"], tc["type"]
    if process == "nlvr":  # two images of R regions on one region axis
        b = 2
        batch = {**_image(rng, (b,), 2 * LV), **_text(rng, (b,))}
        target = np.eye(2, dtype=np.float32)[rng.randint(0, 2, b)]
    elif process == "retrieval":  # 4 ways of (image, caption)
        b = 2
        batch = {**_image(rng, (b, 4), LV), **_text(rng, (b, 4))}
        target = rng.randint(0, 4, b).astype(np.int32)
    elif process == "expand":  # one image, 4 answer options
        b = 2
        batch = {**_image(rng, (b,), LV), **_text(rng, (b, 4))}
        target = rng.randint(0, 4, b).astype(np.int32)
    elif process == "dialog":  # 2 rounds x 3 options
        b = 2
        batch = {**_image(rng, (b,), LV), **_text(rng, (b, 2, 3))}
        target = rng.randint(0, 3, (b, 2)).astype(np.int32)
    else:
        b = 3
        lv = MC_LV if ttype == "V-logit-mc" else LV
        batch = {**_image(rng, (b,), lv), **_text(rng, (b,))}
        if ttype == "VL-classifier":
            target = np.zeros((b, NL), np.float32)
            target[np.arange(b), rng.randint(0, NL, b)] = 1.0
            target[0, 3] = 0.6
        elif ttype == "V-logit":  # IoU of each region with the referent
            target = rng.rand(b, lv, 1).astype(np.float32)
            target[0, 2, 0] = 1.0
        elif ttype == "V-logit-mc":
            batch["multi_choice_ids"] = np.stack(
                [rng.permutation(lv - 101)[:4] for _ in range(b)]
            ).astype(np.int32)
            target = np.zeros((b, 4, 1), np.float32)
            target[np.arange(b), rng.randint(0, 4, b), 0] = 1.0
        elif tc["loss"] == CE:
            target = rng.randint(0, 3, b).astype(np.int32)
        else:
            target = rng.dirichlet(np.ones(3), b).astype(np.float32)
    batch["target"] = target
    batch["question_id"] = np.arange(100, 100 + b, dtype=np.int64)
    return batch


def _model_args(inputs):
    return [inputs[k] for k in ("input_ids", "image_feat", "image_loc")]


def _model_kwargs(inputs):
    return [inputs[k] for k in ("token_type_ids", "attention_mask",
                                "image_attention_mask")]


@pytest.fixture(scope="module")
def flax_params():
    """One Flax init holding every head (the JAX module materialises all
    of them at init)."""
    batch = make_task_batch("TASK1")
    model = JaxVLTasks(small_cfg(), TASKS, IDS)
    inputs, _ = jtu.process_batch(TASKS["TASK1"],
                                  jax.tree.map(jnp.asarray, batch))
    variables = jax.jit(lambda r: model.init(
        r, *_model_args(inputs), "TASK1", *_model_kwargs(inputs)))(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, variables["params"])


def torch_model(params, dtype="float32", use_pallas=True):
    """The port's model on ``params``; ``use_pallas`` picks its attention
    route as JAX's gate does (the kernels' twins here, or the plain
    composition)."""
    model = VoltaForVLTasks(small_cfg(dtype, use_pallas), TASKS, IDS)
    return load_flax_params(model, params).eval()


def jax_step_outputs(params, task, batch, dtype, use_pallas):
    """JAX's logits, loss, score and info for ``batch``, as its eval step
    computes them (jitted; the Pallas kernels in the interpreter)."""
    tc = TASKS[task]
    jb = {k: jnp.asarray(v) for k, v in batch.items()
          if k != "question_id"}
    model = JaxVLTasks(small_cfg(dtype, use_pallas), TASKS, IDS)

    def fn(p, b):
        inputs, info = jtu.process_batch(tc, b)
        pred, _ = model.apply({"params": p}, *_model_args(inputs), task,
                              *_model_kwargs(inputs))
        loss, score = jtu.task_loss_and_score(tc["type"], pred, b, info,
                                              tc["loss"])
        return pred, loss, score

    with pa.interpret_mode():
        pred, loss, score = jax.jit(fn)(params, jb)
    info = jtu.process_batch(tc, jb)[1]
    return np.asarray(pred.astype(jnp.float32)), float(loss), float(score), \
        info


# ------------------------------------------------------------- processes
@pytest.mark.parametrize("process", list(PROCESS_TASK))
def test_process_batch_matches(process):
    task = PROCESS_TASK[process]
    tc = TASKS[task]
    batch = make_task_batch(task, seed=1)
    jin, jinfo = jtu.process_batch(tc, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    pin, pinfo = ptu.process_batch(tc, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    assert pinfo == jinfo
    assert list(pin) == list(jin)
    for k in jin:
        want = np.asarray(jin[k])
        got = pin[k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    if process == "nlvr":
        # the two images of a pair are consecutive rows under one sentence
        q = pin["input_ids"].numpy()
        np.testing.assert_array_equal(q[0::2], q[1::2])
        np.testing.assert_array_equal(q[0::2], batch["question"])
        np.testing.assert_array_equal(pin["image_feat"][1].numpy(),
                                      batch["features"][0, LV:])


def test_unknown_process_and_type():
    batch = {k: torch.from_numpy(v)
             for k, v in make_task_batch("TASK1").items()}
    # an unknown process passes the batch through, as JAX's does
    inputs, info = ptu.process_batch({"process": "other"}, batch)
    assert inputs["input_ids"] is batch["question"] and info == {
        "batch_size": 3, "num_options": 1}
    with pytest.raises(ValueError, match="Undefined task type"):
        ptu.task_loss_and_score("VL-other", torch.zeros(3, 2), batch, info)
    with pytest.raises(ValueError, match="Undefined task type"):
        VoltaForVLTasks(small_cfg(), {"T": {"type": "VL-other"}}, ("T",))


# ------------------------------------------------------- heads and losses
@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_head_matches(flax_params, dtype, use_pallas):
    """Every head's logits, loss and score against JAX's eval step, on the
    same attention route."""
    model = torch_model(flax_params, dtype, use_pallas)
    traced = pa.TRACE_COUNT[0]
    for task in IDS:
        tc = TASKS[task]
        batch = make_task_batch(task, seed=3)
        ref, jloss, jscore, jinfo = jax_step_outputs(
            flax_params, task, batch, dtype, use_pallas)
        out = make_task_eval_step(model, TASKS, task)(batch)
        got = out["prediction"]
        assert got.dtype == getattr(torch, dtype), task
        got = got.float().numpy()
        assert got.shape == ref.shape, task
        assert out["info"] == jinfo and out["batch_size"] == \
            jinfo["batch_size"]
        if tc["type"].startswith("V-logit"):
            # the padding penalty: -10000 in the logits' dtype on both sides
            # (-9984 in bf16), so the padded slots agree exactly
            pad = make_task_batch(task, seed=3)["image_mask"] == 0
            assert pad.any()
            np.testing.assert_array_equal(got[pad], ref[pad], err_msg=task)
            assert got[pad].max() < (-9000 if dtype == "bfloat16"
                                     else -9990)
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4,
                                       err_msg=task)
            np.testing.assert_allclose(float(out["loss"]), jloss,
                                       rtol=1e-5, err_msg=task)
            assert float(out["score"]) == jscore, task
        else:
            # bf16 logits of ~0.3: a few bf16 ulps after two layers
            diff = float(np.abs(got - ref).max())
            assert diff <= 5e-2, (task, diff)
        # the port's loss and score of its own logits are JAX's functions'
        jb = {k: jnp.asarray(v) for k, v in batch.items()
              if k != "question_id"}
        jloss2, jscore2 = jtu.task_loss_and_score(
            tc["type"], jnp.asarray(out["prediction"].float().numpy()), jb,
            jinfo, tc["loss"])
        np.testing.assert_allclose(float(out["loss"]), float(jloss2),
                                   rtol=1e-5, err_msg=task)
        assert float(out["score"]) == float(jscore2), task
    if use_pallas:
        assert pa.TRACE_COUNT[0] > traced


def test_bf16_penalty_is_minus_9984(flax_params):
    model = torch_model(flax_params, "bfloat16")
    batch = make_task_batch("TASK10", seed=4)
    pred = make_task_eval_step(model, TASKS, "TASK10")(batch)["prediction"]
    pad = torch.from_numpy(batch["image_mask"] == 0)
    with torch.no_grad():
        seq_v = model.bert(*(torch.from_numpy(batch[k]) for k in (
            "question", "features", "spatials", "segment_ids", "input_mask",
            "image_mask")))[1]
        logit = model.clf_TASK10(seq_v)[..., 0]
    want = logit + torch.tensor(-9984.0, dtype=torch.bfloat16)
    assert torch.equal(pred[..., 0][pad], want[pad])
    assert torch.equal(pred[..., 0][~pad], logit[~pad])


# ------------------------------------------------------------ train steps
LR, WD, CLIP, EPS, BETAS = 1e-4, 10.0, 1.0, 1e-3, (0.9, 0.999)
STEPS, WARMUP = 3, 1


def _jax_steps(params, task, batch):
    """JAX's fp32 steps on its XLA path, dropout off."""
    tc = TASKS[task]
    model = JaxVLTasks(small_cfg(), TASKS, IDS)
    tx = jax_build_optimizer("adamw", jax_warmup(LR, WARMUP, STEPS),
                             params, weight_decay=WD, clip_norm=CLIP,
                             betas=BETAS, eps=EPS)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "question_id"}

    def loss_fn(p):
        inputs, info = jtu.process_batch(tc, jb)
        pred, _ = model.apply({"params": p}, *_model_args(inputs), task,
                              *_model_kwargs(inputs), deterministic=True)
        return jtu.task_loss_and_score(tc["type"], pred, jb, info,
                                       tc["loss"])[0]

    @jax.jit
    def step(p, state):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        upd, state = tx.update(grads, state, p)
        return optax.apply_updates(p, upd), state, loss

    params = jax.tree.map(jnp.asarray, params)
    state = tx.init(params)
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("task", ["TASK12", "TASK10", "TASK8"],
                         ids=["nlvr2", "v_logit", "retrieval"])
def test_train_steps_match_jax_without_dropout(flax_params, task):
    """Three fp32 steps, dropout off (the port's model in eval mode), clip
    and AdamW with a large weight decay, from the same init."""
    batch = make_task_batch(task, seed=5)
    jax_losses, jax_params = _jax_steps(flax_params, task, batch)

    model = torch_model(flax_params)
    opt = build_optimizer("adamw", warmup_linear_schedule(LR, WARMUP, STEPS),
                          model, weight_decay=WD, clip_norm=CLIP,
                          betas=BETAS, eps=EPS)
    state = create_train_state(model, opt, seed=0)
    step = make_task_train_step(model, opt, TASKS, task)
    losses = [float(step(state, batch)["loss"]) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, jax_losses, rtol=2e-4)
    ref = state_dict_from_flax(jax_params)
    got = model.state_dict()
    assert set(got) == set(ref)
    for name, want in ref.items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=name)
    # the task's own head trained
    start = state_dict_from_flax(flax_params)
    head = [k for k in ref if k.startswith(f"clf_{task}.")]
    assert head and all(not torch.equal(got[k], start[k]) for k in head)


# ---------------------------------------------------- training-mode sites
@pytest.fixture
def recorded_sites(monkeypatch):
    """The hash dropouts ``models/model.py`` runs: (shape, seed, rate,
    keep fraction of the output) in call order."""
    calls = []
    real = model_mod.hash_dropout

    def spy(x, seed, rate):
        out = real(x, seed, rate)
        # among the inputs that are not 0 already (a pooled output is a
        # ReLU's)
        calls.append((tuple(x.shape), seed, rate,
                      float((out != 0).sum() / (x != 0).sum())))
        return out

    monkeypatch.setattr(model_mod, "hash_dropout", spy)
    return calls


def _train_logits(model, task, batch, seed):
    inputs, _ = ptu.process_batch(
        TASKS[task], {k: torch.from_numpy(v) for k, v in batch.items()})
    with torch.no_grad():
        return model(*_model_args(inputs), task, *_model_kwargs(inputs),
                     dropout_seed=seed)


@pytest.mark.parametrize("task", ["TASK11", "TASK16", "TASK12", "TASK8"])
def test_training_mode_sites(flax_params, recorded_sites, task):
    """The sites after the encoder take consecutive seeds of
    ``DropoutSeeds``: the pooled output's first (drawn but not run for a
    V-logit head, which reads no pooled output), then the region outputs'
    and ``VLogitMLP``'s; each keeps about 0.9; the same seed repeats the
    logits bit for bit, another changes them."""
    model = torch_model(flax_params).train()
    batch = make_task_batch(task, seed=6)
    a = _train_logits(model, task, batch, 1234)
    sites = list(recorded_sites)
    b = _train_logits(model, task, batch, 1234)
    c = _train_logits(model, task, batch, 1235)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert recorded_sites[len(sites):2 * len(sites)] == sites

    seeds = DropoutSeeds(1234)
    stream = [seeds.next() for _ in range(64)]
    first = stream.index(sites[0][1])
    assert [s for _, s, _, _ in sites] == stream[first:first + len(sites)]
    cfg = small_cfg()
    if TASKS[task]["type"].startswith("V-logit"):
        # the pooled output's seed comes first and is not run
        n_v = (MC_LV if TASKS[task]["type"] == "V-logit-mc" else LV)
        want = [((3, n_v, 64), 0.1)]
        if TASKS[task].get("num_clf_layers") == 2:
            want.append(((3, n_v, 64), cfg.v_attention_probs_dropout_prob))
    else:
        rows = 2 * 2 if task == "TASK12" else 2 * 4
        want = [((rows, 64), 0.1)]
    assert [(s[0], s[2]) for s in sites] == want
    for shape, _, _, keep in sites:
        n = int(np.prod(shape)) // 2
        assert abs(keep - 0.9) < 4 * (0.09 / n) ** 0.5 + 1e-9, (shape, keep)
    # the V-logit sites follow the pooled output's seed, which a binary or
    # classifier head runs: the same encoder, so the same position
    other = torch_model(flax_params).train()
    recorded_sites.clear()
    _train_logits(other, "TASK12", make_task_batch("TASK12", seed=6), 1234)
    pooled_at = stream.index(recorded_sites[0][1])
    if TASKS[task]["type"].startswith("V-logit"):
        assert first == pooled_at + 1
    else:
        assert first == pooled_at


# ------------------------------------------------------ export and import
def test_export_and_import_every_head(flax_params, tmp_path):
    jcfg = small_cfg()
    pcfg = VoltaConfig.from_dict(jcfg.to_dict())
    ref_sd, jreport = jck.export_torch_state_dict(jcfg, flax_params)
    assert jreport["unexported"] == []
    model = torch_model(flax_params)
    sd, report = ck.export_reference_state_dict(pcfg, model)
    assert report == {"unexported": []}
    assert list(sd) == list(ref_sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), ref_sd[k], err_msg=k)
    # the heads under the reference's names: a bare Linear, the anonymous
    # Sequential of the 2-layer V-logit head (0 and 3), SimpleClassifier's
    # logit_fc
    for key in ("clfs_dict.TASK8.weight", "clfs_dict.TASK13.bias",
                "clfs_dict.TASK10.weight", "clfs_dict.TASK11.0.weight",
                "clfs_dict.TASK11.3.bias", "clfs_dict.TASK16.3.weight",
                "clfs_dict.TASK12.logit_fc.0.weight",
                "clfs_dict.TASK12.logit_fc.2.weight",
                "clfs_dict.TASK12.logit_fc.3.weight"):
        assert key in sd, key
    assert tuple(sd["clfs_dict.TASK12.logit_fc.0.weight"].shape) == (48, 128)

    # import: the same tensors and report as JAX's importer
    fresh = VoltaForVLTasks(pcfg, TASKS, IDS)
    torch_sd = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in ref_sd.items()}
    preport = ck.import_state_dict(pcfg, fresh, torch_sd, strict=True)
    _, jimport = jck.import_state_dict(jcfg, {"params": flax_params}, ref_sd)
    assert preport == jimport and preport["skipped"] == []
    want = state_dict_from_flax(flax_params)
    got = fresh.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k

    # JAX reads the port's file strictly
    path = ck.save_reference_checkpoint(str(tmp_path / "heads.bin"), pcfg,
                                        model)
    zeros = jax.tree.map(np.zeros_like, flax_params)
    new, _ = jck.import_state_dict(jcfg, {"params": zeros},
                                   jck.load_torch_state_dict(path),
                                   strict=True)
    assert state_dict_from_flax(jax.tree.map(np.asarray, new["params"])
                                ).keys() == want.keys()
    for k, v in state_dict_from_flax(
            jax.tree.map(np.asarray, new["params"])).items():
        assert torch.equal(v, want[k]), k


def test_no_decay_mask_walks_every_head(flax_params):
    """The decay mask of every new head's parameters is JAX's."""
    from volta_tpu.optimization import no_decay_mask as jax_mask
    from volta_tpu_torch.optimization import no_decay_mask

    jm = jax_mask(flax_params)
    want = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                want[".".join(prefix + (LEAF[k],))] = bool(v)

    walk(jm, ())
    got = no_decay_mask(torch_model(flax_params))
    assert got == want
    assert got["clf_TASK8.weight"] and not got["clf_TASK8.bias"]
    assert got["clf_TASK11.dense1.weight"]


# ------------------------------------------------------------ result records
def test_collect_results_writes_the_root_cli_records(flax_params):
    import eval_task as jax_cli
    from volta_tpu_torch import eval_task as port_cli

    class Answers:
        label2ans = [f"answer{i}" for i in range(NL)]

    model = torch_model(flax_params)
    for task in IDS:
        tc = TASKS[task]
        batch = make_task_batch(task, seed=7)
        out = make_task_eval_step(model, TASKS, task)(batch)
        pred = out["prediction"].float().numpy()
        _, jinfo = jtu.process_batch(tc, batch)
        want = jax_cli.collect_results(tc["type"], pred, batch, jinfo,
                                       Answers, [])
        got = port_cli.collect_results(tc["type"], pred, batch, out["info"],
                                       Answers, [])
        assert got == want and len(got) == len(batch["question_id"]), task
