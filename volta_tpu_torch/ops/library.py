"""The eval forward's kernels registered as PyTorch ops, for ``torch.export``.

The wrappers reach their kernels through ``ctypes`` with ``data_ptr()``,
which ``torch.export`` cannot trace: its FakeTensors hold no data. So each
kernel of the eval forward is registered here as an op of the ``volta``
namespace with ``torch.library.custom_op``, and a ``register_fake`` that
gives its outputs' shapes and dtypes only:

    volta::attention_fwd             row 1  (attention_cuda.attention_fwd)
    volta::attention_head_major_fwd  row 7  (attention_head_major_cuda
                                             .attention_head_major_fwd)
    volta::layer_norm_fwd            row 10 (layernorm.layer_norm_fwd)
    volta::residual_ln_fwd           row 12 at rate 0 (fused_residual
                                             .dropout_residual_ln_fwd)
    volta::int8_quantize             K9a    (int8_dense.int8_quantize)
    volta::int8_matmul               K9b    (int8_dense.int8_matmul)

Each op's implementation is its wrapper, so the wrapper's rule holds
inside the op when the exported program runs: a CUDA tensor takes the
kernel or raises, a CPU tensor takes the twin. Every host-side decision
(the body by dtype, ``int8_body``, ``band_blocks``, the extent and
16-byte alignment checks) is made there too, on the real tensors, and so
none is fixed into the traced graph.

The model reaches these ops only while ``torch.export`` traces it with
``kernel_export`` on (``export.export_task_forward`` for a ``use_pallas``
artifact): ``ops.in_kernel_export`` gates the call sites, and the eager
forward keeps its direct calls. A loaded artifact that holds these ops
needs this module imported and nothing of ``volta_tpu_torch.models``.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
from torch import Tensor

from . import KERNEL_EXPORT, attention_cuda, attention_head_major_cuda, \
    fused_residual, in_kernel_export, int8_dense, layernorm  # noqa: F401

OPS = ("attention_fwd", "attention_head_major_fwd", "layer_norm_fwd",
       "residual_ln_fwd", "int8_quantize", "int8_matmul")


@contextlib.contextmanager
def kernel_export(on: bool = True):
    """Within this context a model traced by ``torch.export`` calls the
    registered ops at its kernel sites (``in_kernel_export``)."""
    prev = KERNEL_EXPORT[0]
    KERNEL_EXPORT[0] = on
    try:
        yield
    finally:
        KERNEL_EXPORT[0] = prev


def _own(t: Tensor, *inputs: Tensor) -> Tensor:
    """t, or a copy where it shares storage with an input (an op's outputs
    may not alias its inputs)."""
    ptr = t.untyped_storage().data_ptr()
    if any(x is not None and x.untyped_storage().data_ptr() == ptr
           for x in inputs):
        return t.clone()
    return t


@torch.library.custom_op("volta::attention_fwd", mutates_args=())
def attention_fwd(q: Tensor, k: Tensor, v: Tensor, bias: Tensor,
                  scale: float, heads: int) -> Tensor:
    return attention_cuda.attention_fwd(q, k, v, bias, scale, heads)


@attention_fwd.register_fake
def _(q, k, v, bias, scale, heads):
    return q.new_empty(q.shape)


@torch.library.custom_op("volta::attention_head_major_fwd", mutates_args=())
def attention_head_major_fwd(q: Tensor, k: Tensor, v: Tensor, bias: Tensor,
                             scale: float) -> Tensor:
    return attention_head_major_cuda.attention_head_major_fwd(q, k, v, bias,
                                                              scale)


@attention_head_major_fwd.register_fake
def _(q, k, v, bias, scale):
    return q.new_empty(q.shape)


@torch.library.custom_op("volta::layer_norm_fwd", mutates_args=())
def layer_norm_fwd(x: Tensor, weight: Tensor, bias: Tensor,
                   eps: float) -> Tuple[Tensor, Tensor, Tensor]:
    return layernorm.layer_norm_fwd(x, weight, bias, eps)


@layer_norm_fwd.register_fake
def _(x, weight, bias, eps):
    n = x.shape[0]
    return (x.new_empty(x.shape), x.new_empty((n,), dtype=torch.float32),
            x.new_empty((n,), dtype=torch.float32))


@torch.library.custom_op("volta::residual_ln_fwd", mutates_args=())
def residual_ln_fwd(o: Tensor, x: Tensor, weight: Tensor, bias: Tensor,
                    eps: float) -> Tuple[Tensor, Tensor, Tensor]:
    """LN(o + x) over rows: row 12 at rate 0 (no mask is drawn); y, and
    the rows' mean and rstd."""
    y, _, mean, rstd = fused_residual.dropout_residual_ln_fwd(
        o, x, weight, bias, 0, 0.0, eps)
    return y, mean, rstd


@residual_ln_fwd.register_fake
def _(o, x, weight, bias, eps):
    n = o.shape[0]
    return (o.new_empty(o.shape), o.new_empty((n,), dtype=torch.float32),
            o.new_empty((n,), dtype=torch.float32))


@torch.library.custom_op("volta::int8_quantize", mutates_args=())
def int8_quantize(x: Tensor, a_scale: Optional[Tensor]
                  ) -> Tuple[Tensor, Tensor]:
    xq, a = int8_dense.int8_quantize(x, a_scale)
    return xq, _own(a, a_scale)


@int8_quantize.register_fake
def _(x, a_scale):
    return (x.new_empty(x.shape, dtype=torch.int8),
            x.new_empty(x.shape[:1], dtype=torch.float32))


@torch.library.custom_op("volta::int8_matmul", mutates_args=())
def int8_matmul(xq: Tensor, a: Tensor, q: Tensor, scale: Tensor,
                bias: Optional[Tensor], out_dtype: torch.dtype) -> Tensor:
    return int8_dense.int8_matmul(xq, a, q, scale, bias, out_dtype)


@int8_matmul.register_fake
def _(xq, a, q, scale, bias, out_dtype):
    return xq.new_empty((xq.shape[0], q.shape[0]), dtype=out_dtype)
