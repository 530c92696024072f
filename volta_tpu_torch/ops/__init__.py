"""Attention, LayerNorm, dropout, matmul and NCE-score ops of the port and
the hand-written CUDA kernels behind them.

Kernels are built from ``ops/csrc`` at first use (``ops/_build.py``);
importing this package builds nothing.

``LAUNCHES`` counts the launches of each kernel since its count was last
set to 0. A wrapper adds one where it launches its kernel and nowhere else,
so a run can show that its path went through the kernels.
"""

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
            "nce_plan": 0, "nce_scores_fwd": 0, "nce_scores_bwd": 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0
