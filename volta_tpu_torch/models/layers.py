"""Shared PyTorch building blocks: TF-style LayerNorm, activations, init.

Counterpart of ``volta_tpu/models/layers.py``. Numerics follow it exactly:

  * LayerNorm is TF-style: epsilon 1e-12 inside the square root, statistics
    in float32 whatever the input dtype, output in the input's dtype.
    ``torch.nn.LayerNorm`` (eps 1e-5, stats in the input dtype) is not it.
  * gelu is the exact erf form in float32 and the tanh form in bf16/fp16.
  * A ``Dense`` in bf16 casts the input, the fp32 weight and the bias to the
    compute dtype before the product, as Flax ``nn.Dense(dtype=bf16,
    param_dtype=f32)`` does.

Parameters are float32. Initialisation takes an optional ``torch.Generator``
(``init_weights``) so a model's random weights are a function of one seed.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-12


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
    ``bias``."""

    def __init__(self, dim: int, eps: float = LN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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


class Embed(nn.Module):
    """Embedding table with N(0, stddev) init; ``zero_pad_row`` zeroes row 0
    to match torch's ``padding_idx=0`` initialisation."""

    def __init__(self, num: int, features: int, stddev: float,
                 zero_pad_row: bool = False):
        super().__init__()
        self.stddev = stddev
        self.zero_pad_row = zero_pad_row
        self.weight = nn.Parameter(torch.empty(num, features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.normal_(0.0, self.stddev, generator=generator)
            if self.zero_pad_row:
                self.weight[0].zero_()

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


def init_weights(module: nn.Module,
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """Re-draw every parameter of ``module`` from ``generator``, in module
    registration order, so that one seed fixes the whole model."""
    for m in module.modules():
        if isinstance(m, (Dense, Embed, LayerNorm)):
            m.reset_parameters(generator)
    return module
