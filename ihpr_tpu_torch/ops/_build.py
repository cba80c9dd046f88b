"""Build and load the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, ``build/kernels/lib<name>.so``
under the repository root, and loaded with ctypes. The build runs at first
use and again whenever the source or a shared ``csrc/*.cuh`` header is
newer than the library; it writes a
temporary file and renames it into place, so concurrent builders never
load a half-written library. ``nvcc``'s ``-Xptxas -v`` report (registers,
shared memory, spills) is kept beside the library as ``lib<name>.log``.
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): cannot build the CUDA kernels")
    return path


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is newer than the
    source and every header under ``csrc/``; return the library's path."""
    src = CSRC / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}.so"
    newest = max(p.stat().st_mtime for p in (src, *CSRC.glob("*.cuh")))
    if lib.exists() and lib.stat().st_mtime >= newest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)], capture_output=True, text=True
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    (BUILD_DIR / f"lib{name}.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def build_all(names) -> list:
    """``build`` several kernels at once, one ``nvcc`` process each."""
    names = list(names)
    with cf.ThreadPoolExecutor(max(1, len(names))) as pool:
        return list(pool.map(build, names))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built if needed, loaded once per process."""
    return ctypes.CDLL(str(build(name)))
