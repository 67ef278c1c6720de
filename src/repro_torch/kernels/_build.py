"""Build the hand-written CUDA kernels into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C launcher, is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/repro_torch_kernels/<name>-<hash>.so``
under the repository root, and is loaded with ``ctypes``. The hash covers
the source and the flags, so an edited kernel is rebuilt and an unchanged
one is reused. Nothing here runs at import time: the first launch of a
kernel builds it.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "load", "nvcc_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
# no --use_fast_math: expf, IEEE division and sqrt; -fmad=false keeps a*b+c
# as two roundings, the way PyTorch's elementwise ops compute it
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from the CUDA toolkit (``CUDA_HOME``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise FileNotFoundError(f"nvcc not found on PATH or at {path}; set CUDA_HOME")
    return path


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"{name}-{digest}.so"


def build(name: str, *, ptxas_verbose: bool = False) -> tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    Returns ``(library path, build seconds, compiler output)``; the seconds
    are 0 and the output empty when the library was already there. Raises
    ``RuntimeError`` with nvcc's output when the build fails."""
    src, lib = _target(name)
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose else []),
           "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {src}:\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib, seconds, proc.stdout + proc.stderr


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib, _, _ = build(name)
    return ctypes.CDLL(str(lib))
