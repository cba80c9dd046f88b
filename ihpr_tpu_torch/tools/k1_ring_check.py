"""K1 with a 3-slot feature ring against the 4-slot ring it ships with,
looped on the card to look for the NaN and the non-repeating results that
an odd ring could give (two consumer warpgroups alternate tiles, so with 3
slots a warpgroup meets its slot's full barrier two phases on and a parity
wait cannot tell the phases apart).

    python -m ihpr_tpu_torch.tools.k1_ring_check [--launches 10000] [--rounds 2]

Writes a copy of ``csrc/fused_head_integral_fwd.cu`` under
``build/kernels/`` with ``kStages`` behind a define (the shipped source is
not touched), builds it twice with ``nvcc`` (``-DIHPR_K1_RING3`` and
without), and swaps each build in for K1 in turn. At the served (64, 4096,
256) and trained (128, 4096, 256) shapes (J = 18, D = 64, C = 256, bf16)
it launches K1 ``--launches`` times on one input, each launch after a bf16
matmul that leaves other data in shared memory (as ``chip_smoke.py``'s
repeat check), and counts the launches whose coords, m or s hold a NaN or
differ bitwise from the first launch's. The 4-slot build's first launch is
held against ``plain`` (5e-4 voxel). CUDA only.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import subprocess
import sys
import time
import types

import torch

from ihpr_tpu_torch.ops import _build
from ihpr_tpu_torch.ops import fused_head_integral as fhi

_RING = 'constexpr int kStages = 4;            // feature tiles in flight\n'
_ASSERT = 'static_assert(kStages % 2 == 0, "each consumer warpgroup must own its ring slots");\n'


def _builds() -> dict:
    """{"ring3", "ring4": path of the built library}, both built at once."""
    src = (_build.CSRC / f"{fhi._LIB}.cu").read_text()
    if _RING + _ASSERT not in src:
        raise RuntimeError(f"{fhi._LIB}.cu no longer declares its ring as this tool expects")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    copy = _build.BUILD_DIR / "k1_ring_check.cu"
    copy.write_text(src.replace(_RING + _ASSERT, "#ifdef IHPR_K1_RING3\nconstexpr int kStages = 3;\n#else\n"
                                + _RING + _ASSERT + "#endif\n"))
    procs = {}
    for tag, defines in (("ring3", ["-DIHPR_K1_RING3"]), ("ring4", [])):
        lib = _build.BUILD_DIR / f"libk1_{tag}.so"
        procs[tag] = (lib, subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, *defines, "-I", str(_build.CSRC),
                                             "-o", str(lib), str(copy)], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    for tag, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {tag} build:\n{log}")
    return {tag: lib for tag, (lib, _) in procs.items()}


@contextlib.contextmanager
def _k1_from(path):
    """fhi.kernel_stats launching the K1 of the library at ``path``."""
    real = fhi._build
    fhi._build = types.SimpleNamespace(load=lambda name: ctypes.CDLL(str(path)))
    fhi._lib.cache_clear()
    try:
        yield
    finally:
        fhi._build = real
        fhi._lib.cache_clear()


def _inputs(b: int, seed: int = 0):
    """feat (b, 4096, 256), kernel (256, 18 * 64), bias: bf16 on the card,
    logits of std ~5."""
    g = torch.Generator().manual_seed(seed)
    feat = torch.randn(b, 64 * 64, 256, generator=g) * 0.5
    kernel = torch.randn(256, 18 * 64, generator=g) * (10.0 / 256**0.5)
    bias = torch.randn(18 * 64, generator=g) * 0.1
    return tuple(t.to("cuda", torch.bfloat16) for t in (feat, kernel, bias))


def loop(b: int, n: int) -> tuple:
    """(launches that differ bitwise from the first, launches holding a NaN,
    the first launch's largest |coords - plain| in voxels) of n launches."""
    args = _inputs(b)
    want = fhi.kernel_stats(*args, 18, 64, 64)
    err = float((want[0] - fhi.plain(*args, 18, 64, 64)[0]).abs().max())
    x = torch.randn(2048, 2048, device="cuda", dtype=torch.bfloat16)
    differ = torch.zeros((), dtype=torch.int64, device="cuda")
    nan = torch.zeros((), dtype=torch.int64, device="cuda")
    for _ in range(n):
        x @ x
        got = fhi.kernel_stats(*args, 18, 64, 64)
        differ += torch.stack([(a != w).any() for a, w in zip(got, want)]).any()
        nan += torch.stack([torch.isnan(a).any() for a in got]).any()
    return int(differ), int(nan), err


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--launches", type=int, default=10000, help="K1 launches per build, shape and round")
    parser.add_argument("--rounds", type=int, default=2, help="passes over both builds and both shapes")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_ring_check: no CUDA device", file=sys.stderr)
        return 1
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    libs = _builds()
    bad = 0
    for _ in range(args.rounds):
        for tag in ("ring3", "ring4"):
            with _k1_from(libs[tag]):
                for b in (64, 128):
                    t0 = time.perf_counter()
                    differ, nan, err = loop(b, args.launches)
                    bad += differ + nan
                    print(f"K1 {tag} ({b}, 4096, 256): {differ} of {args.launches} launches differ bitwise from the "
                          f"first, {nan} hold a NaN; first launch vs plain {err:.3g} voxel; "
                          f"{time.perf_counter() - t0:.1f} s  [{gpu}]", flush=True)
    print(f"k1_ring_check: {bad} launches differed or held a NaN in all")
    return 0


if __name__ == "__main__":
    sys.exit(main())
