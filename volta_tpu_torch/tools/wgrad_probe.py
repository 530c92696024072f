"""Decision probe: does a hand-written tensor-core kernel beat cuBLAS at the
train step's weight-gradient shapes?

The port of ``tools/wgrad_probe.py`` (the same flags, defaults and JSON
lines) to the card. The wgrad family is [h, n] x [n, f], a contraction over
the token axis (n = 15360 at b256) into a small [768, 3072] output, summed
over the 12 layers. Variants:

  torch_T       sum of (g.T @ a) in float32   (what autograd runs)
  torch_dg      the token axis contracted by einsum, no explicit transpose
  torch_dg_f32  the same product on float32 operands
  cuda_k        the hand-written kernel of Queue 2 row 15
                (``ops.matmul.wgrad``): bf16 in, float32 accumulation and
                output, the token axis walked inside each block

Each line reports ms per call, TFLOP/s and ``tensor_pct``, the share of the
H100's 989 TFLOP/s dense bf16, beside the card's name and power limit. The
last line names the fastest variant and its gain over torch_T.

    python -m volta_tpu_torch.tools.wgrad_probe [--iters 30] [--device cuda]

``--device cpu`` runs the kernel's plain twin on the CPU, for tests: its
times are the CPU's.
"""

from __future__ import annotations

import argparse

import torch

from ..ops.matmul import wgrad
from . import probe_utils


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--tokens", type=int, default=15360)
    p.add_argument("--hidden", type=int, default=768)
    p.add_argument("--ffn", type=int, default=3072)
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--bk", type=int, default=512,
                   help="the TPU kernel's token block, accepted as the TPU "
                        "probe accepts it; the CUDA kernel walks the tokens "
                        "inside each block and reads no block size")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = probe_utils.device(args.device)
    where = probe_utils.card(dev)
    n, h, f, layers = args.tokens, args.hidden, args.ffn, args.layers
    gen = torch.Generator(device=dev).manual_seed(0)

    def mk(*shape):  # made on the device, from the seed
        return (torch.randn(*shape, generator=gen, device=dev) * 0.05).to(
            torch.bfloat16)

    gys = [mk(n, h) for _ in range(layers)]
    acts = [mk(n, f) for _ in range(layers)]
    flops = 2 * n * h * f * layers
    variants = {
        "torch_T": lambda: sum((g.t() @ a).float()
                               for g, a in zip(gys, acts)),
        "torch_dg": lambda: sum(torch.einsum("nh,nf->hf", g, a).float()
                                for g, a in zip(gys, acts)),
        "torch_dg_f32": lambda: sum(g.float().t() @ a.float()
                                    for g, a in zip(gys, acts)),
        "cuda_k": lambda: sum(wgrad(g, a) for g, a in zip(gys, acts)),
    }
    results = {}
    for name, fn in variants.items():
        probe_utils.record(results, name,
                           probe_utils.time_ms(fn, args.iters, dev), flops,
                           where, dev)
    return results, probe_utils.verdict(results, "torch_T",
                                        "gain_vs_torch_T_pct")


if __name__ == "__main__":
    main()
