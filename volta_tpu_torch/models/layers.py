"""Shared PyTorch building blocks: TF-style LayerNorm, activations, init.

Counterpart of ``volta_tpu/models/layers.py``. Numerics follow it exactly:

  * LayerNorm is TF-style: epsilon 1e-12 inside the square root, statistics
    in float32 whatever the input dtype, output in the input's dtype.
    ``torch.nn.LayerNorm`` (eps 1e-5, stats in the input dtype) is not it.
  * gelu is the exact erf form in float32 and the tanh form in bf16/fp16.
  * A ``Dense`` in bf16 casts the input, the fp32 weight and the bias to the
    compute dtype before the product, as Flax ``nn.Dense(dtype=bf16,
    param_dtype=f32)`` does.
  * Dropout is the JAX package's ``hash_dropout``: keep bit =
    fmix32(position * 0x9E3779B9 + seed) < threshold, bit-equal for the
    same uint32 seed. Each dropout site of a forward takes its own seed from
    ``DropoutSeeds``, which derives them from one step seed. With
    ``use_hash_dropout: false`` the sublayer tails take
    ``int_threshold_dropout`` instead: raw uint32 draws against the same
    threshold, the draws from a ``torch.Generator`` seeded with the site's
    seed where JAX draws threefry bits from a Flax key.

Parameters are float32. Initialisation takes an optional ``torch.Generator``
(``init_weights``) so a model's random weights are a function of one seed.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import dropout_mask
from ..ops.fused_residual import dropout_residual_ln
from ..ops.hash import _M32, GOLDEN, dropout_threshold, fmix32, \
    seeded_bits  # noqa: F401
from ..ops.hash_dropout import HashDropout, apply_keep_mask
from ..ops.layernorm import LN_EPS, fused_layer_norm


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf gelu in float32; the original-BERT tanh form in bf16/fp16
    (the JAX package's sub-f32 default, ``GELU_BF16_TANH``)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return F.gelu(x, approximate="tanh")
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


ACT2FN: Dict[str, Callable] = {
    "gelu": gelu,
    "gelu_tanh": gelu_tanh,
    "relu": F.relu,
    "swish": swish,
}


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """TF-style layernorm; fp32 statistics, output in x.dtype.
    ``F.layer_norm`` on the fp32 upcast is that formula (biased variance,
    eps inside the square root) in one pass; only its default eps differs."""
    y = F.layer_norm(x.float(), x.shape[-1:], weight.float(), bias.float(),
                     eps)
    return y.to(x.dtype)


class LayerNorm(nn.Module):
    """TF-style layernorm with learnable ``weight`` (Flax ``scale``) and
    ``bias``.

    Residual mode, ``ln(o, residual=x, drop_rate=p, seed=s)``, computes
    ``LN(hash_dropout(o, s, p) + x)``, the tail of every encoder sublayer
    (volta_tpu/models/layers.py:111-172); without a seed or a ``keep_mask``
    the dropout is off (eval). ``use_kernel``, ``fused_residual`` and
    ``pallas_mask`` are the port's names for the JAX module's
    ``use_pallas``, ``fused_residual`` and ``pallas_mask``; ``hash_mask``
    is its own. A dropping residual call takes, in the JAX module's order
    (volta_tpu/models/layers.py:119-167): an explicit 0/1 ``keep_mask``
    (drawn by the attention kernel of row 9); else, with ``pallas_mask``
    at the shapes the TPU kernel takes, the keep mask of the CUDA kernel of
    row 14 (``ops.dropout_mask``) for the seed; else, with
    ``fused_residual``, the fused CUDA dropout+residual+LN kernels
    (``ops.fused_residual``); else, with ``hash_mask``, ``hash_dropout``;
    else ``int_threshold_dropout``. The first four draw the same mask for
    the same seed. A mask is applied as ``hash_dropout`` applies its own;
    then, with ``use_kernel``, the LayerNorm runs the CUDA LayerNorm
    kernels (``ops.layernorm``), else plain torch."""

    def __init__(self, dim: int, eps: float = LN_EPS,
                 use_kernel: bool = False, fused_residual: bool = False,
                 pallas_mask: bool = False, hash_mask: bool = True):
        super().__init__()
        self.eps = eps
        self.use_kernel = use_kernel
        self.fused_residual = fused_residual
        self.pallas_mask = pallas_mask
        self.hash_mask = hash_mask
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor, residual: torch.Tensor = None,
                drop_rate: float = 0.0, seed: Optional[int] = None,
                keep_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if residual is not None:
            dropping = drop_rate > 0.0 and (seed is not None
                                            or keep_mask is not None)
            if (dropping and keep_mask is None and self.pallas_mask
                    and dropout_mask.supported(x.shape)):
                keep_mask = dropout_mask.keep_mask(x.shape, drop_rate, seed,
                                                   x.device)
            if dropping and keep_mask is not None:
                x = apply_keep_mask(x, keep_mask, drop_rate)
            elif dropping and self.fused_residual:
                return dropout_residual_ln(x, residual, self.weight,
                                           self.bias, seed, drop_rate,
                                           self.eps)
            elif dropping and self.hash_mask:
                x = hash_dropout(x, seed, drop_rate)
            elif dropping:
                x = int_threshold_dropout(x, seed, drop_rate)
            x = x + residual
        if self.use_kernel:
            return fused_layer_norm(x, self.weight, self.bias, self.eps)
        return layer_norm(x, self.weight, self.bias, self.eps)


class Dense(nn.Module):
    """Linear layer with the reference's init: N(0, stddev) weight, zero
    bias. ``dtype`` is the compute dtype; parameters stay float32."""

    def __init__(self, in_features: int, out_features: int, stddev: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stddev = stddev
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.normal_(0.0, self.stddev, generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class _SmallTableLookup(torch.autograd.Function):
    """``F.embedding`` forward; the table's gradient as the float32 product
    one_hot(ids)ᵀ · g. ``F.embedding``'s backward on the card sums a row
    that nearly every token hits in an order that changes from run to run;
    the product sums in one order."""

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.rows = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        rows = torch.arange(ctx.rows, device=ids.device)
        one_hot = (ids.reshape(-1, 1) == rows).to(torch.float32)
        gw = one_hot.t() @ g.reshape(-1, g.shape[-1]).to(torch.float32)
        return None, gw.to(g.dtype)


class Embed(nn.Module):
    """Embedding table with N(0, stddev) init; ``zero_pad_row`` zeroes row 0
    to match torch's ``padding_idx=0`` initialisation. ``fixed_order_grad``
    (the token-type table's few rows) sums the gradient in a fixed order
    (``_SmallTableLookup``)."""

    def __init__(self, num: int, features: int, stddev: float,
                 zero_pad_row: bool = False, fixed_order_grad: bool = False):
        super().__init__()
        self.stddev = stddev
        self.zero_pad_row = zero_pad_row
        self.fixed_order_grad = fixed_order_grad
        self.weight = nn.Parameter(torch.empty(num, features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.normal_(0.0, self.stddev, generator=generator)
            if self.zero_pad_row:
                self.weight[0].zero_()

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.fixed_order_grad:
            return _SmallTableLookup.apply(ids, self.weight)
        return F.embedding(ids, self.weight)


def init_weights(module: nn.Module,
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """Re-draw every parameter of ``module`` from ``generator``, in module
    registration order, so that one seed fixes the whole model."""
    for m in module.modules():
        if isinstance(m, (Dense, Embed, LayerNorm)):
            m.reset_parameters(generator)
        elif hasattr(m, "reset_own_parameters"):
            m.reset_own_parameters(generator)  # a module's raw parameters
    return module


def residual_ln_seg(o, res, w_t, b_t, w_v, b_v, lt: int, rate: float,
                    seed: Optional[int], hash_mask: bool = True,
                    eps: float = LN_EPS) -> torch.Tensor:
    """One dropout + residual + LayerNorm chain over a [text ‖ vision]
    sequence whose segments own different LayerNorm affines, the JAX
    package's ``residual_ln_seg`` (volta_tpu/models/layers.py:175-203):
    one dropout over the concatenation (``hash_dropout``, or
    ``int_threshold_dropout`` without ``hash_mask``) for ``seed``, float32
    statistics a token, then text rows take (w_t, b_t) and the rest
    (w_v, b_v); output in the sum's dtype."""
    if seed is not None and rate > 0.0:
        o = hash_dropout(o, seed, rate) if hash_mask \
            else int_threshold_dropout(o, seed, rate)
    s = o + res
    dim, lv = s.shape[-1], s.shape[-2] - lt
    y = F.layer_norm(s.float(), (dim,), eps=eps)
    seg = lambda a, b: torch.cat([  # noqa: E731
        a.float().expand(lt, dim), b.float().expand(lv, dim)])
    return (y * seg(w_t, w_v) + seg(b_t, b_v)).to(s.dtype)


# ------------------------------------------------------------------ dropout
def hash_dropout(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Counter-based dropout, bit-equal to volta_tpu.models.layers
    .hash_dropout for the uint32 ``seed`` that its key draws: the keep bit
    of element n (x's linear index) is fmix32(n * 0x9E3779B9 + seed) <
    threshold; kept values are divided by 1 - rate in x's dtype (JAX's
    weak-typed scalar is rounded to x's dtype first, so is this one). On
    the card forward and backward run the CUDA kernel K10
    (``ops/csrc/hash_dropout.cu``, the backward replaying the hash); on the
    CPU its plain twin (``ops.hash_dropout``)."""
    return HashDropout.apply(x, int(seed), float(rate))


def int_threshold_keep(bits: torch.Tensor, rate: float) -> torch.Tensor:
    """The keep bits of uint32 draws ``bits`` (held in int64, or an int32
    view of the same 32 bits): bits < ``dropout_threshold(rate)``, the
    threshold JAX's ``jnp.uint32((1.0 - rate) * 4294967295.0)`` truncates to
    (volta_tpu/models/layers.py:206-213)."""
    if bits.dtype == torch.int32:
        bits = bits.to(torch.int64) & _M32
    return bits < dropout_threshold(rate)


def int_threshold_dropout(x: torch.Tensor, seed: int,
                          rate: float) -> torch.Tensor:
    """Dropout by a raw-bits compare, the JAX package's
    ``int_threshold_dropout``: ``x.numel()`` uint32 draws from a
    ``torch.Generator`` on x's device seeded with the site's uint32
    ``seed``, kept where ``int_threshold_keep``, applied by
    ``apply_keep_mask`` (a kept value divided by 1 - rate in x's dtype).
    The generator is made here from the seed, so a recomputation of the
    same call draws the same bits. JAX draws threefry bits from a Flax key,
    which this cannot reproduce: parity holds for the same bits."""
    return apply_keep_mask(x, int_threshold_keep(
        seeded_bits(x.shape, seed, x.device), rate), rate)


class DropoutSeeds:
    """The uint32 seeds of one forward's dropout sites, derived from one
    step seed: site n takes fmix32(step_seed + n * 0x9E3779B9). fmix32 is a
    bijection of uint32 and n * 0x9E3779B9 differs for every n < 2^32, so no
    two sites of a forward share a seed, whatever their shapes."""

    def __init__(self, step_seed: int):
        self.step_seed = int(step_seed) & _M32
        self.count = 0

    def next(self) -> int:
        seed = fmix32((self.step_seed + self.count * GOLDEN) & _M32)
        self.count += 1
        return seed


def site_seed(module: nn.Module, rate: float,
              seeds: Optional[DropoutSeeds]) -> Optional[int]:
    """The seed of one dropout site of ``module``: None where no dropout
    runs (eval mode, or rate 0), else the next of ``seeds``."""
    if not module.training or rate <= 0.0:
        return None
    if seeds is None:
        raise ValueError(f"{type(module).__name__} in training mode needs "
                         "a dropout seed (VoltaForVLTasks' dropout_seed)")
    return seeds.next()
