"""The port's data parallelism (``volta_tpu_torch.parallel``) on the CPU.

Two ranks of a gloo group (``_torch_dp_worker.py``, two processes that
import the port and no JAX, joined through a file store in the test's
temporary directory) each take their own half of a global batch. A step of
the two must be the one-process step over the concatenated batch:

* fine-tuning, dropout off (the model in eval mode, as
  tests/test_torch_port_train.py runs it), against JAX's
  ``make_task_train_step`` on the concatenated batch under
  ``interpret_mode()`` (its model applied deterministically): four fp32
  steps with the clip active, the losses and the final parameters
  (through ``state_dict_from_flax``) within rtol 2e-4 / atol 2e-5;
* fine-tuning with dropout on, against the port's one-process step on the
  concatenated batch within the same tolerance, on every dropout route:
  the hash tails with the attention twins (natural and head-major), the
  LayerNorm flags (the fused residual twin), row 9's and row 14's flags
  (whose gates close across ranks: their entries are never called there,
  and the masks are the same), the plain attention route, the int-threshold
  tails, ``remat_ff`` and ``use_scan``;
* after every step the two ranks hold parameters equal to the bit
  (pretraining: tests/test_torch_port_distributed_pretrain.py).

In one process: each hashed index space folded for rank r equals rows r·B
to (r+1)·B of the global mask to the bit (K10 also against JAX's
``hash_dropout`` of the global tensor), a generator draw is the global
draw's rows, and each rank's loader batches equal JAX's ``DataLoader``
shard's, for a task set and for per-rank Conceptual Captions shards.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from _torch_dp_worker import run
from test_torch_port_model import TASK_CFG, make_batch, small_cfg
from volta_tpu import zoo
from volta_tpu.models import VoltaForVLTasks as JaxVLTasks
from volta_tpu.models import layers as jlayers
from volta_tpu.ops import pallas_attention as pa
from volta_tpu.optimization import build_optimizer as jax_build_optimizer
from volta_tpu.optimization import warmup_linear_schedule as jax_warmup
from volta_tpu.parallel import create_train_state as jax_train_state
from volta_tpu.parallel import make_task_train_step as jax_task_step
from volta_tpu_torch.convert import state_dict_from_flax
from volta_tpu_torch.ops import attention_dropout_cuda as adc
from volta_tpu_torch.ops import attention_head_major_cuda as ahm
from volta_tpu_torch.ops import dropout_mask, fused_residual
from volta_tpu_torch.ops.attention_hidden_mask_cuda import \
    HiddenMaskDropoutAttention
from volta_tpu_torch.ops.hash import fold_seed, seeded_bits
from volta_tpu_torch.ops.hash_dropout import HashDropout
from volta_tpu_torch.parallel import data_parallel

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_dp_worker.py")
W = 2
TOL = dict(rtol=2e-4, atol=2e-5)
LR, WD, CLIP, EPS, BETAS = 1e-4, 10.0, 1.0, 1e-3, (0.9, 0.999)
OPT = dict(lr=LR, wd=WD, clip=CLIP, eps=EPS, betas=BETAS)


def spawn(tmp, spec, world=W):
    """``spec`` on ``world`` worker ranks; their outputs in rank order."""
    spec_path = os.path.join(tmp, "spec.pt")
    torch.save(spec, spec_path)
    outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, spec_path, str(r), str(world),
         os.path.join(tmp, "store"), outs[r]], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(world)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        errs.append(err.decode()[-3000:])
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err
    return [torch.load(o, weights_only=False) for o in outs]


def concat(per_rank):
    """The global batch of each step: the ranks' batches in rank order."""
    return [{k: np.concatenate([b[k] for b in step]) for k in step[0]}
            for step in zip(*per_rank)]


def assert_ranks_equal(ranks, name):
    for i, (a, b) in enumerate(zip(ranks[0][name]["params"],
                                   ranks[1][name]["params"])):
        for k in a:
            assert torch.equal(a[k], b[k]), (name, i, k)
    assert ranks[0][name]["losses"] == ranks[1][name]["losses"]


def assert_close(got, want, name):
    np.testing.assert_allclose(got["losses"], want["losses"], **TOL,
                               err_msg=name)
    for k, v in want["params"][-1].items():
        np.testing.assert_allclose(got["params"][-1][k].numpy(), v.numpy(),
                                   **TOL, err_msg=f"{name} {k}")


# ------------------------------------------------------------ fine-tuning
TASK_STEPS = 4
DROPOUT_CASES = {
    "hash": {},
    "head_major": {"attn_natural_layout": False},
    "ln_flags": {"use_pallas_layernorm": True, "use_fused_residual_ln": True},
    "hidden_masks": {"fuse_hidden_dropout": True},
    "keep_mask": {"use_pallas_dropout_mask": True},
    "plain_route": {"use_pallas": False},
    "int_threshold": {"use_hash_dropout": False},
    "remat_ff": {"remat_ff": True},
    "use_scan": {"use_scan": True},
}


def task_cfg():
    """tests/test_torch_port_model.py's small ctrl_uniter at hidden 128
    (4 heads of 32), where row 14's gate (a last axis a multiple of 128)
    opens."""
    return zoo.single_stream(
        "uniter", depth=2, hidden_size=128, num_attention_heads=4,
        intermediate_size=256, pooler_size=128, v_pooler_size=128,
        vocab_size=50, max_position_embeddings=32, v_feature_size=32,
        v_hidden_size=128, v_num_attention_heads=4, v_intermediate_size=256,
        clf_hidden_size=48, compute_dtype="float32", use_pallas=True)


class _Deterministic:
    """A Flax model whose ``apply`` runs without dropout whatever the step
    asks: JAX's train step with dropout off."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, *args, deterministic=False, rngs=None):
        return self.model.apply(variables, *args, deterministic=True)


def _jax_task_steps(cfg, params, batches):
    model = _Deterministic(JaxVLTasks(cfg, TASK_CFG, ("TASK1",)))
    tx = jax_build_optimizer("adamw", jax_warmup(LR, 1, TASK_STEPS),
                             params, weight_decay=WD, clip_norm=CLIP,
                             betas=BETAS, eps=EPS)
    state = jax_train_state(jax.random.PRNGKey(1),
                            jax.tree.map(jnp.asarray, params), tx)
    step = jax_task_step(model, tx, TASK_CFG, "TASK1", donate=False)
    losses = []
    with pa.interpret_mode():
        traced = pa.TRACE_COUNT[0]
        for batch in batches:
            state, m = step(state, jax.tree.map(jnp.asarray, batch))
            losses.append(float(m["loss"]))
        assert pa.TRACE_COUNT[0] > traced  # the Pallas kernels ran
    return losses, state.params


@pytest.fixture(scope="module")
def task_runs(tmp_path_factory):
    jcfg = task_cfg()
    per_rank = [[make_batch(10 * i + r) for i in range(TASK_STEPS)]
                for r in range(W)]
    batches = concat(per_rank)
    jmodel = JaxVLTasks(jcfg, TASK_CFG, ("TASK1",))
    b0 = batches[0]
    params = jax.tree.map(np.asarray, jax.jit(lambda k: jmodel.init(
        k, *[jnp.asarray(b0[n]) for n in ("question", "features",
                                           "spatials")], "TASK1",
        jnp.asarray(b0["segment_ids"]), jnp.asarray(b0["input_mask"]),
        jnp.asarray(b0["image_mask"])))(jax.random.PRNGKey(0))["params"])
    base = jcfg.to_dict()
    cases = [{"name": "eval", "config": base, "train": False,
              "steps": TASK_STEPS}] + [
        {"name": name, "config": {**base, **over}, "train": True,
         "steps": 2, "seed": 7} for name, over in DROPOUT_CASES.items()]
    spec = {"kind": "task", "task_cfg": TASK_CFG, "cases": cases,
            "weights": state_dict_from_flax(params),
            "opt": {**OPT, "warmup": 1, "total": TASK_STEPS},
            "batches": per_rank}
    ranks = spawn(str(tmp_path_factory.mktemp("dp_task")), spec)
    jax_losses, jax_params = _jax_task_steps(jcfg, params, batches)
    return {"ranks": ranks, "one": run(spec, batches),
            "jax": {"losses": jax_losses,
                    "params": [state_dict_from_flax(
                        jax.tree.map(np.asarray, jax_params))]}}


def test_dropout_off_matches_jax(task_runs):
    got = task_runs["ranks"][0]["eval"]
    assert_close(got, task_runs["jax"], "eval")
    assert_ranks_equal(task_runs["ranks"], "eval")
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("case", list(DROPOUT_CASES))
def test_dropout_on_matches_one_process(task_runs, case):
    assert_ranks_equal(task_runs["ranks"], case)
    assert_close(task_runs["ranks"][0][case], task_runs["one"][case], case)
    # a step that drops nothing would pass too: the losses must move
    # from the eval run's on the same first batch
    assert task_runs["one"][case]["losses"][0] != \
        task_runs["one"]["eval"]["losses"][0]


def test_gates_close_across_ranks(task_runs):
    """Rows 9 and 14 run in one process and are never called on two
    ranks, as JAX's gates close under a mesh; the masks are the same."""
    one, rank0 = task_runs["one"], task_runs["ranks"][0]
    assert one["hidden_masks"]["calls"].get("hidden_masks", 0) > 0
    assert one["keep_mask"]["calls"].get("keep_mask", 0) > 0
    for case in DROPOUT_CASES:
        assert rank0[case]["calls"] == {}, case


def test_workers_import_no_jax(task_runs):
    assert task_runs["ranks"][0]["modules"] == []


# ------------------------------------------------- the folded hash masks
B, L, H, D, RATE, SEED = 3, 9, 2, 8, 0.25, 0xDEADBEEF


def _spy(monkeypatch, module, name, got):
    real = getattr(module, name)

    def spy(*a, **k):
        out = real(*a, **k)
        got.append(out)
        return out

    monkeypatch.setattr(module, name, spy)


def _each_rank(fn, seed=SEED):
    """fn(rank's inputs slice, seed) inside ``data_parallel(r, W)`` for
    each rank, and fn on the global inputs outside any group."""
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(W * B, L, H * D).astype(
        np.float32)) for _ in range(3))
    bias = torch.zeros(W * B, L)
    glob = fn(q, k, v, bias, seed)
    ranks = []
    for r in range(W):
        sl = slice(r * B, (r + 1) * B)
        with data_parallel(r, W):
            ranks.append(fn(q[sl], k[sl], v[sl], bias[sl], seed))
    return glob, ranks


def _hm(x):
    return x.view(x.shape[0], L, H, D).permute(2, 0, 1, 3).contiguous()


def _k10(monkeypatch):
    def fn(q, k, v, bias, seed):
        return HashDropout.apply(torch.ones_like(q), seed, RATE) != 0
    return fn, 0


def _natural(monkeypatch):
    got = []
    _spy(monkeypatch, adc, "keep_mask", got)

    def fn(q, k, v, bias, seed):
        adc.DropoutAttention.apply(q, k, v, bias, 0.3, H, RATE, seed)
        return got.pop()
    return fn, 0


def _head_major(monkeypatch):
    got = []
    _spy(monkeypatch, ahm, "keep_mask_head_major", got)

    def fn(q, k, v, bias, seed):
        ahm.HeadMajorDropoutAttention.apply(_hm(q), _hm(k), _hm(v), bias,
                                            0.3, RATE, seed)
        return got.pop()
    return fn, 1  # [H, B, Lq, Lk]


def _hidden_masks(monkeypatch):
    got = []
    _spy(monkeypatch, ahm, "keep_mask_head_major", got)

    def fn(q, k, v, bias, seed):
        _, hm0, hm1 = HiddenMaskDropoutAttention.apply(
            _hm(q), _hm(k), _hm(v), bias, 0.3, RATE, seed, RATE, seed + 1,
            seed + 2)
        return torch.cat([got.pop().transpose(0, 1).reshape(q.shape[0], -1),
                          hm0.reshape(q.shape[0], -1),
                          hm1.reshape(q.shape[0], -1)], 1)
    return fn, 0


def _fused_residual(monkeypatch):
    got = []
    _spy(monkeypatch, fused_residual, "tail_keep_mask", got)

    def fn(q, k, v, bias, seed):
        fused_residual.dropout_residual_ln(q, k, torch.ones(H * D),
                                           torch.zeros(H * D), seed, RATE)
        return got.pop().view(q.shape[0], -1)
    return fn, 0


def _keep_mask(monkeypatch):
    def fn(q, k, v, bias, seed):
        return dropout_mask.keep_mask(q.shape, RATE, seed, "cpu")
    return fn, 0


def _generator(monkeypatch):
    def fn(q, k, v, bias, seed):
        return seeded_bits(q.shape, seed, "cpu")
    return fn, 0


SPACES = {"k10": _k10, "attention_natural": _natural,
          "attention_head_major": _head_major,
          "hidden_masks": _hidden_masks, "fused_residual": _fused_residual,
          "keep_mask": _keep_mask, "generator_draws": _generator}


@pytest.mark.parametrize("space", list(SPACES))
def test_rank_masks_are_the_global_rows(space, monkeypatch):
    fn, axis = SPACES[space](monkeypatch)
    glob, ranks = _each_rank(fn)
    assert 0 < glob.float().mean() < 1 or space == "generator_draws"
    for r, got in enumerate(ranks):
        want = glob.narrow(axis, r * B, B) if axis == 0 else \
            glob[:, r * B:(r + 1) * B]
        assert torch.equal(got, want), (space, r)
    # rank 1's own seed alone draws another mask
    assert not torch.equal(ranks[1], ranks[0]) or space == "hidden_masks"


def test_k10_folds_to_jax_hash_dropout_of_the_global_tensor():
    """The wrapper's folded seed, for a rank whose base r·numel wraps
    modulo 2^32, drops what JAX's ``hash_dropout`` drops at the global
    tensor's rows, as JAX's uint32 iota wraps."""
    key = jax.random.PRNGKey(9)
    seed = int(jax.random.bits(key, (), jnp.uint32))
    shape = (W * B, L, H * D)
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    ref = np.asarray(jlayers.hash_dropout(jnp.asarray(x), key, RATE))
    for r in range(W):
        sl = slice(r * B, (r + 1) * B)
        with data_parallel(r, W):
            got = HashDropout.apply(torch.from_numpy(x[sl]), seed, RATE)
        np.testing.assert_array_equal(got.numpy(), ref[sl])
    # the wrap: rank 3 of 4 over 2^31 elements folds modulo 2^32
    with data_parallel(3, 4):
        assert fold_seed(seed, 2**31) == (seed + ((3 * 2**31) % 2**32)
                                          * 0x9E3779B9) % 2**32


# -------------------------------------------------------------- loaders
def _task_loaders(tmp_path, monkeypatch):
    """The port's and JAX's ``load_dataset`` train and val loaders of rank
    r of 2, each package told so through its own rank functions."""
    from volta_tpu import task_utils as jtu
    from volta_tpu_torch import task_utils as ptu
    from volta_tpu_torch.config import VoltaConfig
    from volta_tpu_torch.parallel import mesh

    ids = [10, 11, 12, 13]
    tmp = str(tmp_path)
    feat = fixtures.make_features_lmdb(tmp, ids, feature_size=32)
    fixtures.make_vqa_annotations(tmp, ids, n_questions=14, num_labels=9)
    vocab = fixtures.make_vocab(tmp)
    tc = {"TASK1": {"name": "VQA", "type": "VL-classifier", "num_labels": 9,
                    "loss": "BCEWithLogitLoss", "process": "normal",
                    "dataroot": tmp, "features_h5path1": feat,
                    "features_h5path2": "", "train_annotations_jsonpath": "",
                    "val_annotations_jsonpath": "", "max_seq_length": 12,
                    "max_region_num": 6, "batch_size": 4,
                    "eval_batch_size": 4, "train_split": "train",
                    "val_split": "train", "lr": 1e-3}}

    class Args:
        bert_model, do_lower_case, vocab_file = "bert-base-uncased", True, \
            vocab
        grad_acc_steps, num_workers, seed, in_memory = 1, 0, 3, False

    jcfg = small_cfg()
    pcfg = VoltaConfig.from_dict(jcfg.to_dict())
    out = []
    for r in range(W):
        monkeypatch.setattr(jax, "process_count", lambda: W)
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        monkeypatch.setattr(mesh, "world_size", lambda: W)
        monkeypatch.setattr(mesh, "rank", lambda r=r: r)
        out.append((ptu.load_dataset(Args, pcfg, tc, "1"),
                    jtu.load_dataset(Args, jcfg, tc, "1")))
    return [[(p[k], j[k]) for k in ("train_loader", "val_loader")]
            for p, j in out]


def _cc_loaders(tmp_path, monkeypatch):
    """Both packages' ``make_concap_loader`` of rank r over per-rank
    ``training_feat_part_<r>.lmdb`` shards."""
    from volta_tpu.data.datasets.concap import make_concap_loader as jmake
    from volta_tpu.data.tokenization import BertTokenizer as JTok
    from volta_tpu_torch.data.datasets.concap import \
        make_concap_loader as pmake
    from volta_tpu_torch.data.tokenization import BertTokenizer as PTok

    tmp = str(tmp_path)
    fixtures.make_concap_shards(tmp, n_per_shard=8, shards=W)
    vocab = fixtures.make_vocab(tmp)
    out = []
    for r in range(W):
        kw = dict(split="train", seq_len=14, region_len=5, batch_size=2,
                  num_workers=0, objective=0, num_locs=5,
                  add_global_imgfeat="first", seed=0, num_shards=W,
                  shard_index=r)
        args = (os.path.join(tmp, "imgfeats"),
                os.path.join(tmp, "annotations"))
        out.append([(pmake(*args, PTok(vocab), **kw)[1],
                     jmake(*args, JTok(vocab), **kw)[1])])
    return out


@pytest.mark.parametrize("source", ["task", "concap"])
def test_rank_loaders_equal_jax_shards(source, tmp_path, monkeypatch):
    ranks = (_task_loaders if source == "task" else _cc_loaders)(
        tmp_path, monkeypatch)
    seen = []
    for loaders in ranks:
        for port, ref in loaders:
            port.set_epoch(1)
            ref.set_epoch(1)
            pb, jb = list(port), list(ref)
            assert len(pb) == len(jb) == len(port) > 0
            for a, b in zip(pb, jb):
                assert set(a) == set(b)
                for key in a:
                    np.testing.assert_array_equal(a[key], b[key], key)
            seen.append(pb)
    # the ranks read different rows
    key = "question" if source == "task" else "input_ids"
    assert not np.array_equal(seen[0][0][key], seen[-1][0][key])
