"""Build the port's CUDA sources at first use; load them with ctypes.

Every ``ops/csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds). The library goes to ``build/volta_tpu_torch/`` at the root
of the checkout, named by a hash of the sources and flags, so a changed
source builds anew and an unchanged one is loaded as it is. Importing this
module builds nothing; ``load()`` does, and raises if ``nvcc`` is missing
or fails.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "volta_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _sources():
    return sorted(p for p in CSRC.iterdir()
                  if p.suffix in (".cu", ".cuh", ".h"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libvolta_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
            "volta_tpu_torch are built from source at first use")
    return path


def _compile(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(p) for p in _sources() if p.suffix == ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = path.with_suffix(".log")
    log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode} "
                           f"(log: {log}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing


def build_log() -> str:
    """The compiler's output for the current sources (ptxas register and
    shared-memory report included), or '' before the first build."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.cache
def load() -> ctypes.CDLL:
    """The kernels' shared library, built on the first call. Concurrent
    builders are safe: each compiles to its own temporary file and renames
    it into place."""
    path = library_path()
    if not path.exists():
        _compile(path)
    return ctypes.CDLL(str(path))
