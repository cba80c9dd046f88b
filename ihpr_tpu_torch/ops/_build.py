"""Build and load the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, ``build/kernels/lib<name>.so``
under the repository root, and loaded with ctypes. The build runs at first
use and again whenever the source or a shared ``csrc/*.cuh`` header is
newer than the library; it writes a
temporary file and renames it into place, so concurrent builders never
load a half-written library. ``nvcc``'s ``-Xptxas -v`` report (registers,
shared memory, spills) is kept beside the library as ``lib<name>.log``.

A source that calls a library of the CUDA toolkit names it in ``_LIBS``
(``nvjpeg_codec``: nvJPEG). The build looks for it beside ``nvcc``, links
it with that directory as the run path, and raises, naming the directories
it searched, where the toolkit does not have it.
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
# Toolkit libraries a source links, by source name.
_LIBS = {"nvjpeg_codec": ("nvjpeg",)}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): cannot build the CUDA kernels")
    return path


def _link_flags(name: str) -> list:
    """``-L``, run path and ``-l`` flags for the toolkit libraries ``name``
    links; RuntimeError where one is not in the toolkit's library
    directories."""
    toolkit = Path(nvcc()).resolve().parents[1]
    dirs = [toolkit / "lib64", toolkit / "targets" / "x86_64-linux" / "lib"]
    flags = []
    for lib in _LIBS.get(name, ()):
        found = next((d for d in dirs if any(d.glob(f"lib{lib}.so*"))), None)
        if found is None:
            raise RuntimeError(f"lib{lib}.so not found in {', '.join(map(str, dirs))}: cannot build {name}")
        flags += [f"-L{found}", "-Xlinker", f"-rpath={found}", f"-l{lib}"]
    return flags


def build(name: str, defines: tuple = ()) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is newer than the
    source and every header under ``csrc/``; return the library's path.
    ``defines`` are ``-D`` macros (a stripped build for timing), named in
    the library's file name."""
    src = CSRC / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}{''.join('-' + d.lower() for d in defines)}.so"
    newest = max(p.stat().st_mtime for p in (src, *CSRC.glob("*.cuh")))
    if lib.exists() and lib.stat().st_mtime >= newest:
        return lib
    link = _link_flags(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp), str(src), *link],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
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
