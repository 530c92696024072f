"""Build the port's CUDA sources at first use; load them with ctypes.

Every ``ops/csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a``, one
``nvcc`` per source, all started together, and the objects are linked into
one shared library with a plain C interface (no PyTorch headers, so a build
takes seconds). The library goes to ``build/volta_tpu_torch/`` at the root
of the checkout, named by a hash of the sources (headers included) and
flags, so a changed source builds anew and an unchanged one is loaded as it
is. Importing this module builds nothing; ``load()`` does, and raises if
``nvcc`` is missing or fails.
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
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# No --use_fast_math: it would turn every division into a reciprocal and a
# multiply and flush denormals, and the kernels divide as the JAX package
# and torch's CPU kernels do (hash_dropout.cu's __fdiv_rn among them).
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
                     "-v")


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
    nvcc = _nvcc()
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    objs, procs = [], []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = tmp.with_name(f"{tmp.name}.{src.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    runs = [(cmd, proc.communicate()[0], proc.returncode)
            for cmd, proc in procs]
    if all(rc == 0 for _, _, rc in runs):
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        runs.append((cmd, proc.stdout, proc.returncode))
    for obj in objs:
        obj.unlink(missing_ok=True)
    log = path.with_suffix(".log")
    log.write_text("".join(" ".join(cmd) + "\n" + out
                           for cmd, out, _ in runs))
    failed = [(cmd, out, rc) for cmd, out, rc in runs if rc != 0]
    if failed:
        cmd, out, rc = failed[0]
        raise RuntimeError(f"nvcc failed with code {rc} on {cmd[-1]} "
                           f"(log: {log}):\n{out[-4000:]}")
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
