"""torchrun's entry point for tests/test_torch_port_distributed_cli.py:

    torchrun --nproc_per_node N tests/_torch_dp_cli.py <module> <out> <argv...>

runs ``volta_tpu_torch.<module>.main(argv)`` on this rank and writes its
steps, losses and validation to ``<out>_<RANK>.json``.
"""

import importlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import torch

    torch.set_num_threads(1)
    module, out = sys.argv[1:3]
    res = importlib.import_module(f"volta_tpu_torch.{module}").main(
        sys.argv[3:])
    keep = ("steps", "best_score", "val_scores", "train_losses",
            "val_losses")
    with open(f"{out}_{os.environ['RANK']}.json", "w") as f:
        json.dump({k: res[k] for k in keep if k in res}, f)


if __name__ == "__main__":
    main()
