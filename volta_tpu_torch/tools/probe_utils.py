"""What the two decision probes share: the device, the card's name and
power limit, timing and the JSON lines."""

from __future__ import annotations

import json
import subprocess
import time

import torch

PEAK_TFLOPS = 989.0  # NVIDIA H100 SXM, dense bf16 tensor cores


def device(name: str) -> torch.device:
    """``--device``: the card unless the caller asks for the CPU; no
    fallback from one to the other."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass --device cpu for the plain "
                           "twins on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {name}")
    return dev


def card(dev: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, iters: int, dev: torch.device) -> float:
    """ms per call of ``fn`` over ``iters`` calls after one warm call, on
    the host clock around work that ends in a synchronise."""
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync(dev)
    return (time.perf_counter() - t0) / iters * 1e3


def record(results: dict, name: str, ms: float, flops: int, where: str,
           dev: torch.device) -> None:
    """Print one variant's JSON line and keep its TFLOP/s. tensor_pct is
    the share of the card's dense bf16 peak; none on the CPU."""
    tf = flops / (ms * 1e-3) / 1e12
    results[name] = tf
    print(json.dumps({"variant": name, "ms": round(ms, 4),
                      "tflops": round(tf, 2),
                      "tensor_pct": round(100 * tf / PEAK_TFLOPS, 2)
                      if dev.type == "cuda" else None,
                      "card": where}), flush=True)


def verdict(results: dict, base: str, key: str) -> dict:
    """The fastest variant and its gain over ``base``, as the last line."""
    best = max(results, key=results.get)
    line = {"verdict": best,
            key: round(100 * (results[best] / results[base] - 1), 1)}
    print(json.dumps(line), flush=True)
    return line
