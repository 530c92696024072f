"""K10, the port's hash dropout as a CUDA kernel (ops/csrc/hash_dropout.cu),
and row 5 on the tensor-core forward body, on the CPU.

The kernel cannot run here. What can:
- ``models.layers.hash_dropout``, now the ``HashDropout`` Function, through
  its CPU twin: forward and gradient against
  ``volta_tpu.models.layers.hash_dropout`` and its ``jax.vjp``, for the
  uint32 seed that the JAX key draws, bit for bit;
- a tiny ctrl_uniter train step's loss and gradients through the Function
  against the plain autograd path that ran before it (``hash_dropout_ref``
  in every dropout site's place), bit for bit;
- the kernel's index arithmetic replayed in Python (``split``,
  ``grid_blocks`` and the kernel's two grid-stride loops): every index
  once, every vector on a 16-byte boundary of both x and out;
- the launch counts and ``chip_smoke.twins()``, which swaps every kernel;
- row 5's wrapper checks with ``fwd_body(dtype, dropout=True)``, seen
  through a stand-in ``check`` on meta tensors, and every bf16 shape that
  its CUDA-core body took is taken by the tensor-core body.
Every comparison here is bit for bit. The kernel is held to the twin on the
card by tests/test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from volta_tpu.models import layers as jl
from volta_tpu_torch import VoltaForVLTasks
from volta_tpu_torch.eval_step import to_device
from volta_tpu_torch.models import embeddings as temb
from volta_tpu_torch.models import layers as tl
from volta_tpu_torch.models import model as tmodel
from volta_tpu_torch.models.layers import init_weights
from volta_tpu_torch.ops import LAUNCHES
from volta_tpu_torch.ops import attention_cuda as ac
from volta_tpu_torch.ops import attention_head_major_cuda as ahm
from volta_tpu_torch.ops import hash_dropout as hd
from volta_tpu_torch.task_utils import process_batch, task_loss_and_score

from test_torch_port_model import TASK_CFG, make_batch, small_cfg

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


def _torch_bits(t):
    return _bits(t.detach().view(torch.int16 if t.dtype == torch.bfloat16
                                 else torch.int32).numpy())


# ------------------------------------------------ against the JAX package
@pytest.mark.parametrize("shape", [(4, 23, 96), (2, 60, 768), (3, 7, 11)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("rate", [0.1, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_matches_jax_forward_and_vjp(dtype, rate, shape):
    """The port's hash_dropout (HashDropout through its CPU twin) and its
    gradient equal JAX's hash_dropout and its jax.vjp for three keys, bit
    for bit (bf16 compared as raw bits)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(len(shape) + int(rate * 100))
    x = (rng.randn(*shape) * 3).astype(np.float32)
    ct = rng.randn(*shape).astype(np.float32)
    for k in range(3):
        key = jax.random.PRNGKey(200 + k)
        seed = int(jax.random.bits(key, (), jnp.uint32))
        ref, vjp = jax.vjp(lambda a: jl.hash_dropout(a, key, rate),
                           jnp.asarray(x, jdt))
        (dref,) = vjp(jnp.asarray(ct, jdt))
        xt = torch.from_numpy(x).to(tdt).requires_grad_()
        out = tl.hash_dropout(xt, seed, rate)
        assert type(out.grad_fn).__name__ == "HashDropoutBackward"
        out.backward(torch.from_numpy(ct).to(tdt))
        assert out.dtype == xt.grad.dtype == tdt
        np.testing.assert_array_equal(_torch_bits(out), _bits(ref))
        np.testing.assert_array_equal(_torch_bits(xt.grad), _bits(dref))
        assert 0 < float((out == 0).float().mean()) < 2 * rate


def test_function_saves_no_tensor_and_replays_the_hash():
    """The Function saves nothing but the seed and the rate; its backward
    is the twin on the cotangent, where(keep, g / denom, 0)."""
    x = torch.randn(5, 40, requires_grad=True)
    out = tl.hash_dropout(x, 99, 0.1)
    assert out.grad_fn.saved_tensors == ()
    g = torch.randn(5, 40)
    out.backward(g)
    assert torch.equal(x.grad, hd.hash_dropout_ref(g, 99, 0.1))
    assert torch.equal(out != 0, x.grad != 0)


def test_denominator_is_one_minus_rate_in_the_dtype():
    """``dropout_denom``: 1 - rate rounded to x's dtype, the value JAX's
    weak-typed scalar takes; ``apply_keep_mask`` divides by it."""
    assert hd.dropout_denom(0.1, torch.bfloat16) == 0.8984375
    assert hd.dropout_denom(0.1, torch.float32) == float(np.float32(0.9))
    x = torch.tensor([1.0, 2.0, 3.0], dtype=torch.bfloat16)
    keep = torch.tensor([True, False, True])
    got = tl.apply_keep_mask(x, keep, 0.1)
    assert torch.equal(got, torch.where(keep, x / 0.8984375,
                                        torch.zeros((), dtype=x.dtype)))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """A tensor that lies neither on the CPU nor on a CUDA device raises;
    so do a rate outside [0, 1) and a seed that is not a uint32."""
    meta = torch.empty(4, 8, device="meta")
    for fn in (hd.hash_dropout_fwd, hd.hash_dropout_bwd):
        with pytest.raises(ValueError, match="CUDA device or the CPU"):
            fn(meta, 1, 0.1)
        with pytest.raises(ValueError, match="rate"):
            fn(meta, 1, 1.0)
        with pytest.raises(ValueError, match="uint32"):
            fn(meta, 2**32, 0.1)


# --------------------------------------------------- a tiny train step
def _grads(model, batch):
    tc = TASK_CFG["TASK1"]
    inputs, info = process_batch(tc, batch)
    pred = model(inputs["input_ids"], inputs["image_feat"],
                 inputs["image_loc"], "TASK1", inputs["token_type_ids"],
                 inputs["attention_mask"], inputs["image_attention_mask"],
                 dropout_seed=12345)
    loss, _ = task_loss_and_score(tc["type"], pred, batch, info,
                                  tc.get("loss", "BCEWithLogitLoss"))
    loss.backward()
    out = {n: p.grad.clone() for n, p in model.named_parameters()
           if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.detach(), out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_gradients_equal_the_plain_autograd_path(dtype,
                                                            monkeypatch):
    """A two-layer ctrl_uniter at narrow widths in training mode (every
    dropout site at rate 0.1): the loss and every parameter's gradient
    through HashDropout equal those of the path before it, autograd
    through ``hash_dropout_ref`` at every site, bit for bit; the 2 · 2
    tails, 2 embedding sites and the pooled output took the Function."""
    model = VoltaForVLTasks(small_cfg(dtype), TASK_CFG, ("TASK1",))
    init_weights(model, torch.Generator().manual_seed(3))
    model.train()
    batch = to_device(make_batch(7), "cpu")
    calls = []
    apply = hd.HashDropout.apply
    monkeypatch.setattr(hd.HashDropout, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    loss, grads = _grads(model, batch)
    assert len(calls) == 7
    monkeypatch.undo()
    for mod in (tl, temb, tmodel):
        monkeypatch.setattr(mod, "hash_dropout", hd.hash_dropout_ref)
    ref_loss, ref = _grads(model, batch)
    assert torch.equal(loss, ref_loss)
    assert set(grads) == set(ref) and len(ref) > 20
    for name, g in ref.items():
        assert torch.equal(grads[name], g), name


# -------------------------------------- the kernel's index arithmetic
def _replay(n, head, blocks, width):
    """The indices each element is written at by the kernel's two loops
    (csrc/hash_dropout.cu), over every thread of the grid, and each
    vector's first index."""
    stride = blocks * hd.THREADS
    nvec = (n - head) // width
    tail0 = head + nvec * width
    written, starts = [], []
    for first in range(stride):
        for v in range(first, nvec, stride):
            i0 = head + v * width
            starts.append(i0)
            written.extend(range(i0, i0 + width))
        for r in range(first, head + (n - tail0), stride):
            written.append(r if r < head else tail0 + (r - head))
    return written, starts


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
def test_head_vectors_and_tail_cover_every_index_once(itemsize):
    """At every element offset of x within 16 bytes, with out at x's
    offset (as ``out_like`` allocates it) and at another one, and at odd n:
    the kernel's loops write each of the n indices once, and every vector
    starts on a 16-byte boundary of both x and out."""
    width = hd.VEC_BYTES // itemsize
    base = 1 << 20
    for off in range(0, 16, itemsize):
        for out_off in (off, (off + itemsize) % 16):
            for n in (1, 3, width - 1, width, width + 1, 97, 4099):
                x_addr, out_addr = base + off, 2 * base + out_off
                head, nvec, tail = hd.split(x_addr, out_addr, n, itemsize)
                assert head + nvec * width + tail == n
                if out_off != off:
                    assert (head, nvec, tail) == (n, 0, 0)
                else:
                    assert head < width and tail < width
                for blocks in (1, 2):
                    written, starts = _replay(n, head, blocks, width)
                    assert sorted(written) == list(range(n))
                    for i0 in starts:
                        assert (x_addr + i0 * itemsize) % 16 == 0
                        assert (out_addr + i0 * itemsize) % 16 == 0


def test_grid_is_one_wave_at_most():
    """``grid_blocks``: no more blocks than the card holds at once, no more
    than one vector a thread, at least one."""
    assert hd.grid_blocks(1, 2, 1056) == 1
    assert hd.grid_blocks(15360 * 768, 2, 1056) == 1056
    assert hd.grid_blocks(8 * 256 * 10, 2, 1056) == 10
    assert hd.grid_blocks(4 * 256 * 10 + 1, 4, 1056) == 11


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_out_like_takes_x_offset_without_a_view(dtype):
    """``out_like`` gives a contiguous tensor of x's shape and dtype at x's
    offset modulo 16 bytes, which is no view (an autograd Function's
    output may then be modified in place)."""
    base = torch.zeros(64, dtype=dtype)
    size = base.element_size()
    for k in range(16 // size):
        x = base[k:k + 24].view(4, 6)
        out = hd.out_like(x)
        assert out.shape == x.shape and out.dtype == dtype
        assert out.is_contiguous() and out._base is None
        assert out.data_ptr() % 16 == x.data_ptr() % 16


# ------------------------------------------------------- launch counts
def test_launches_and_twins_cover_k10():
    """``ops.LAUNCHES`` counts K10 forward and backward, and
    ``chip_smoke.twins()`` puts a twin in the place of every kernel it
    counts, K10's included, and puts the wrappers back after."""
    assert {"hash_dropout_fwd", "hash_dropout_bwd"} <= set(LAUNCHES)
    swaps = chip_smoke.twin_swaps()
    assert sorted(name for _, name, _ in swaps) == sorted(LAUNCHES)
    wrappers = {name: getattr(mod, name) for mod, name, _ in swaps}
    with chip_smoke.twins():
        for mod, name, twin in swaps:
            swapped = getattr(mod, name)
            assert swapped is not wrappers[name]
            assert swapped.__qualname__ == twin.__qualname__
    assert all(getattr(mod, name) is wrappers[name]
               for mod, name, _ in swaps)
    assert hd.hash_dropout_fwd is wrappers["hash_dropout_fwd"]


# ----------------------------------------------- row 5's forward body
class _Checked(Exception):
    pass


def _row5_check(dtype, monkeypatch):
    """What row 5's wrapper hands ``check`` for meta operands of dtype:
    (rows, shared memory (lq, lk, d) -> bytes)."""
    seen = {}

    def check(name, *args, rows=ac.ROWS_PER_BLOCK, **kwargs):
        seen[name] = (rows, args[5])
        raise _Checked

    monkeypatch.setattr(ahm, "check", check)
    xh = torch.empty((2, 2, 60, 64), dtype=dtype, device="meta")
    bias = torch.empty((2, 60), device="meta")
    with pytest.raises(_Checked):
        ahm.attention_dropout_head_major_fwd(xh, xh, xh, bias, 0.125, 0.1, 5)
    return seen["attention_dropout_head_major_fwd"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_row_5_checks_with_the_dropout_forward_body(dtype, monkeypatch):
    """Row 5 checks a card's operands against ``fwd_body(dtype,
    dropout=True)``: in bf16 the tensor-core body's 64-row tile and shared
    memory that does not grow with Lk, in fp32 the CUDA-core body's."""
    rows, smem = _row5_check(dtype, monkeypatch)
    _, want_rows, want = ac.fwd_body(dtype, dropout=True)
    assert rows == want_rows
    for lq, lk, d in ((1, 1, 16), (60, 60, 64), (5, 563, 128)):
        assert smem(lq, lk, d) == want(lq, lk, d)
    if dtype == torch.bfloat16:
        assert rows == ac.TC_ROWS_PER_BLOCK
        assert smem(60, 60, 64) == smem(60, 10**6, 64) == ac.tc_smem_bytes(64)


@pytest.mark.parametrize("d", ac.HEAD_DIMS)
def test_every_bf16_row_5_shape_that_ran_still_runs(d, monkeypatch):
    """Every (Lq, Lk) the CUDA-core body's grid and shared memory took in
    bf16 before row 5 moved to the tensor cores is taken by what row 5's
    wrapper now checks with, which also takes Lk past that limit."""
    rows, tc = _row5_check(torch.bfloat16, monkeypatch)
    core_rows = ac.ROWS_PER_BLOCK
    core = lambda lq, lk, d: ac.smem_bytes(lk, d)  # noqa: E731
    max_lk = max(lk for lk in range(1, 4000)
                 if core(1, lk, d) <= ac.MAX_SMEM_BYTES)
    for lq in (1, 5, 16, 60, 63, 64, 65, 128, 563, 65535 * core_rows):
        for lk in sorted({1, 60, 63, 64, 65, 563, max_lk // 2, max_lk}):
            ac.check_extent("old", 4, lq, lk, 12, d, core, core_rows)
            ac.check_extent("new", 4, lq, lk, 12, d, tc, rows)
    ac.check_extent("new", 4, 60, 100 * max_lk, 12, d, tc, rows)
