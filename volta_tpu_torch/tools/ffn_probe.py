"""Decision probe: does a hand-written tensor-core matmul with the bias and
tanh-gelu epilogue inside beat cuBLAS and torch's gelu at the step's FFN
shapes?

The port of ``tools/pallas_ffn_probe.py`` (the same flags, defaults and
JSON lines) to the card. Variants, all bf16 in and out with float32
accumulation, chained ``--calls`` times with each output the next input
(the 12 FFN sublayers):

  torch   gelu_tanh(x @ W1 + b1) @ W2 + b2 through addmm and F.gelu
  cuda1   the hand-written kernel of Queue 2 row 16
          (``ops.matmul.matmul_bias_act``) for the [n, h] x [h, f] leg with
          its bias and gelu, addmm for the [n, f] x [f, h] leg
  cuda2   both legs through the kernel (the second with its bias only)

Each line reports ms per chain, TFLOP/s and ``tensor_pct``, the share of
the H100's 989 TFLOP/s dense bf16, beside the card's name and power limit.
The last line names the fastest variant and its gain over torch.

    python -m volta_tpu_torch.tools.ffn_probe [--iters 20] [--device cuda]

``--device cpu`` runs the kernel's plain twin on the CPU, for tests: its
times are the CPU's.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from ..ops.matmul import matmul_bias_act
from . import probe_utils


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--tokens", type=int, default=15360)  # 256 * (23 + 37)
    p.add_argument("--hidden", type=int, default=768)
    p.add_argument("--ffn", type=int, default=3072)
    p.add_argument("--calls", type=int, default=12)  # 12 FFN sublayers
    p.add_argument("--bm", type=int, default=512,
                   help="the TPU kernel's row block, accepted as the TPU "
                        "probe accepts it; the CUDA kernel's tiles are fixed")
    p.add_argument("--bn", type=int, default=1024,
                   help="the TPU kernel's column block, as --bm")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = probe_utils.device(args.device)
    where = probe_utils.card(dev)
    n, h, f, calls = args.tokens, args.hidden, args.ffn, args.calls
    gen = torch.Generator(device=dev).manual_seed(0)

    def mk(*shape):  # made on the device, from the seed
        return (torch.randn(*shape, generator=gen, device=dev) * 0.05).to(
            torch.bfloat16)

    x = mk(n, h)
    w1, b1 = mk(h, f), mk(1, f)
    w2, b2 = mk(f, h), mk(1, h)
    flops = calls * 2 * 2 * n * h * f  # two products a call

    def torch_ffn(x):
        y = F.gelu(torch.addmm(b1, x, w1), approximate="tanh")
        return torch.addmm(b2, y, w2)

    def cuda1_ffn(x):
        return torch.addmm(b2, matmul_bias_act(x, w1, b1, True), w2)

    def cuda2_ffn(x):
        return matmul_bias_act(matmul_bias_act(x, w1, b1, True), w2, b2,
                               False)

    def chain(step):
        def run():
            y = x
            for _ in range(calls):
                y = step(y)
            return y
        return run

    results = {}
    for name, step in (("torch", torch_ffn), ("cuda1", cuda1_ffn),
                       ("cuda2", cuda2_ffn)):
        probe_utils.record(results, name,
                           probe_utils.time_ms(chain(step), args.iters, dev),
                           flops, where, dev)
    return results, probe_utils.verdict(results, "torch", "gain_vs_torch_pct")


if __name__ == "__main__":
    main()
