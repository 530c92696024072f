"""The port's data parallelism on the CPU, pretraining: two ranks of a
gloo group (``_torch_dp_worker.py``, as in
tests/test_torch_port_distributed.py) take one update of gradient
accumulation 2 (two micro-steps) of the Conceptual Captions step, KL and
NCE, objective 1, each on its own half of the global batch. The halves
differ in masked tokens, masked regions and valid ITM labels, so a mean
of the ranks' means would miss. The update must be JAX's
``pretraining_losses`` step with optax's ``MultiSteps`` on the
concatenated batch, the NCE draws fed in (dropout off), and, with dropout
and the NCE draws the port makes, the port's one-process step; the ranks
end equal to the bit. Tolerance rtol 2e-4 / atol 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_dp_worker import run
from test_torch_port_distributed import (BETAS, CLIP, EPS, LR, OPT, WD, W,
                                         assert_close, assert_ranks_equal,
                                         concat, spawn)
from test_torch_port_pretrain import (FAMILIES, MODEL_ARGS, cc_batch,
                                      jax_init, jax_neg_idx)
from volta_tpu import losses as jl
from volta_tpu.optimization import build_optimizer as jax_build_optimizer
from volta_tpu.optimization import warmup_linear_schedule as jax_warmup
from volta_tpu.parallel.train_step import _strip_global as jax_strip
from volta_tpu_torch.convert import state_dict_from_flax

PRE_MICRO_STEPS = 2  # one update of gradient accumulation 2
PRE_OVER = dict(use_pallas=False)


def _pre_batches():
    """Each rank's micro-batches: different seeds, and rank 1's last pair
    with an ignored ITM label, so the halves' masked-token, masked-region
    and valid ITM counts differ."""
    glob = FAMILIES["ctrl_uniter"]().add_global_imgfeat
    per_rank = []
    for r in range(W):
        steps = []
        for i in range(PRE_MICRO_STEPS):
            b = cc_batch(20 + 7 * i + 3 * r, glob)
            if r == 1:
                b["is_match"] = np.array([0, 1, -1], np.int32)
            steps.append(b)
        per_rank.append(steps)
    return per_rank


def _jax_pretrain(jcfg, params, batches, keys):
    model, _ = jax_init("ctrl_uniter", **PRE_OVER)

    def loss_fn(p, jb, nce_key):
        keep = (jb["is_match"] == 0)[:, None]
        lm = jnp.where(keep, jb["lm_label_ids"], -1)
        il = jnp.where(keep, jb["image_label"], -1)
        out = model.apply({"params": p}, *[jb[k] for k in MODEL_ARGS],
                          deterministic=True)
        mlm, mrm, itm = jl.pretraining_losses(
            jcfg, out, masked_lm_labels=lm, image_label=il,
            image_cls=jb["image_cls"],
            image_feat=jax_strip(jcfg, jb["image_feat"]),
            next_sentence_label=jb["is_match"], rng=nce_key)
        return mlm + mrm + itm

    tx = jax_build_optimizer("adamw", jax_warmup(LR, 0, 2), params,
                             weight_decay=WD, clip_norm=CLIP, betas=BETAS,
                             eps=EPS, grad_accum_steps=2)
    p = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(p)
    losses = []
    grad = jax.jit(jax.value_and_grad(loss_fn))
    for batch, key in zip(batches, keys):
        loss, g = grad(p, jax.tree.map(jnp.asarray, batch), key)
        upd, opt_state = tx.update(g, opt_state, p)
        p = optax.apply_updates(p, upd)
        losses.append(float(loss))
    return losses, p


@pytest.fixture(scope="module")
def pretrain_runs(tmp_path_factory):
    jcfg = FAMILIES["ctrl_uniter"](**PRE_OVER)
    assert set(jcfg.visual_target_weights) == {"0", "2"}  # KL and NCE
    _, params = jax_init("ctrl_uniter", **PRE_OVER)
    per_rank = _pre_batches()
    batches = concat(per_rank)
    b = batches[0]["input_ids"].shape[0]
    r = batches[0]["image_label"].shape[1]
    keys = [jax.random.PRNGKey(50 + i) for i in range(PRE_MICRO_STEPS)]
    base = jcfg.to_dict()
    common = {"steps": PRE_MICRO_STEPS, "objective": 1, "grad_acc": 2}
    cases = [{"name": "eval", "config": base, "train": False,
              "neg_idx": [jax_neg_idx(k, b, r) for k in keys], **common},
             {"name": "dropout", "train": True, "seed": 3,
              "config": {**base, "use_pallas": True}, **common}]
    spec = {"kind": "pretrain", "cases": cases,
            "weights": state_dict_from_flax(params),
            "opt": {**OPT, "warmup": 0, "total": 2}, "batches": per_rank}
    ranks = spawn(str(tmp_path_factory.mktemp("dp_pretrain")), spec)
    jax_losses, jax_params = _jax_pretrain(jcfg, params, batches, keys)
    return {"ranks": ranks, "one": run(spec, batches), "per_rank": per_rank,
            "start": spec["weights"], "jax": {"losses": jax_losses,
                    "params": [state_dict_from_flax(
                        jax.tree.map(np.asarray, jax_params))]}}


def test_pretrain_halves_have_unequal_counts(pretrain_runs):
    """Under objective 1 (mismatched pairs' labels ignored) the halves of
    every micro-step differ in masked tokens, masked regions and valid
    ITM labels, so a mean of the ranks' means would miss."""
    for halves in zip(*pretrain_runs["per_rank"]):
        counts = []
        for b in halves:
            keep = (b["is_match"] == 0)[:, None]
            counts.append((int(((b["lm_label_ids"] != -1) & keep).sum()),
                           int(((b["image_label"] == 1) & keep).sum()),
                           int((b["is_match"] != -1).sum())))
        assert all(x != y for x, y in zip(*counts)), counts


def test_pretrain_matches_jax(pretrain_runs):
    assert_ranks_equal(pretrain_runs["ranks"], "eval")
    assert_close(pretrain_runs["ranks"][0]["eval"], pretrain_runs["jax"],
                 "eval")
    assert_close(pretrain_runs["ranks"][0]["eval"],
                 pretrain_runs["one"]["eval"], "eval one process")
    # one update every two micro-steps: nothing moves on the first, the
    # second moves every parameter
    start = pretrain_runs["start"]
    first, second = pretrain_runs["ranks"][0]["eval"]["params"]
    assert all(torch.equal(first[k], v) for k, v in start.items())
    assert not any(torch.equal(second[k], v) for k, v in start.items())


def test_pretrain_with_dropout_matches_one_process(pretrain_runs):
    assert_ranks_equal(pretrain_runs["ranks"], "dropout")
    assert_close(pretrain_runs["ranks"][0]["dropout"],
                 pretrain_runs["one"]["dropout"], "dropout")
