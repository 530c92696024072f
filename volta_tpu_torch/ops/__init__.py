"""Attention, LayerNorm, dropout, matmul, NCE-score and int8 dense ops of
the port and the hand-written CUDA kernels behind them.

Kernels are built from ``ops/csrc`` at first use (``ops/_build.py``);
importing this package builds nothing.

``LAUNCHES`` counts the launches of each kernel since its count was last
set to 0. A wrapper adds one where it launches its kernel and nowhere else,
so a run can show that its path went through the kernels.

``in_kernel_export`` gates the kernel sites of the eval forward: true only
while ``torch.export`` traces a model inside ``library.kernel_export``,
where those sites call the ops that ``library`` registers instead of their
wrappers.
"""

import torch

LAUNCHES = {"attention_fwd": 0, "attention_bwd": 0,
            "attention_dropout_fwd": 0, "attention_dropout_bwd": 0,
            "attention_head_major_fwd": 0, "attention_head_major_bwd": 0,
            "attention_dropout_head_major_fwd": 0,
            "attention_dropout_head_major_bwd": 0,
            "attention_dropout_hidden_masks_fwd": 0,
            "layer_norm_fwd": 0, "layer_norm_bwd": 0,
            "dropout_residual_ln_fwd": 0, "dropout_residual_ln_bwd": 0,
            "keep_mask": 0, "hash_dropout_fwd": 0, "hash_dropout_bwd": 0,
            "wgrad": 0, "matmul_bias_act": 0,
            "nce_plan": 0, "nce_scores_fwd": 0, "nce_scores_bwd": 0,
            "int8_quantize": 0, "int8_matmul": 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# set by library.kernel_export
KERNEL_EXPORT = [False]


def in_kernel_export() -> bool:
    return KERNEL_EXPORT[0] and torch.compiler.is_exporting()
