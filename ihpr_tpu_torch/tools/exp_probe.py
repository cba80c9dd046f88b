"""The exp-pass probe (P1): the counterpart of ``tools/exp_probe.py``.

Does the integral's exp pass cost anything beyond the read? K1 and K3 take
one ``ex2.approx.ftz.f32`` per logit (``ops/csrc/fused_head_common.cuh``,
``ops/csrc/integral_volume_common.cuh``). This probe streams the volume of
their geometry, (B, NCHUNK * CHUNK, LANES) = (128, 4096, 1152) fp32 (2.416
GB, 604M values), through one kernel that differs by mode in ONE pass over
each (CHUNK, LANES) block:

  read      every value loaded and consumed, nothing computed   (read floor)
  sum       one block reduce
  maxsum    a max and a sum
  expsum    sum exp(v - 3), as ex2((v - 3) * log2e)             (the exp pass)
  exp2sum   sum exp2(v - 3)                      (is the *log2e multiply free?)
  bexpsum   bf16 exp on pairs, fp32 sum          (does bf16x2 ex2 halve it?)

``expsum - sum`` is the marginal cost of the exp pass. The kernel is
``ops/csrc/exp_probe.cu`` (its note says what each mode runs on Hopper);
``plain`` is the same function in PyTorch, and ``probe`` sends a CUDA tensor
to the kernel and a CPU tensor to ``plain``.

    python -m ihpr_tpu_torch.tools.exp_probe [--iters 30] [--device cuda]

Times are CUDA events over ``--iters`` back-to-back launches on the resident
volume (far past the 50 MB L2, so every launch reads device memory), the
least of two rounds taken in turns. A
``read`` faster than the volume's bytes at 3.35 TB/s means the loads were
elided: the probe then raises and prints no numbers. ``--device cpu`` runs
the plain versions at the ``--shape`` given, on the host clock.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
from typing import Tuple

import torch

from ihpr_tpu_torch.ops import _build
from ihpr_tpu_torch.tools import device_line, time_ms

B, CHUNK, LANES, NCHUNK = 128, 256, 1152, 16
MODES = ("read", "sum", "maxsum", "expsum", "exp2sum", "bexpsum")
PEAK_HBM_BYTES = 3.35e12  # one H100 SXM (NVIDIA's data sheet)
ROUNDS = 2  # timing rounds per mode, in turns

_LIB = "exp_probe"

# Launches of the kernel since the count was last set to 0; ``kernel`` adds
# one per launch and nothing else touches it.
launches = 0


def plain(x: torch.Tensor, mode: str, chunk: int | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version. x (B, NCHUNK * chunk, LANES) fp32 ->
    (partials (B, NCHUNK), token (8, 128)), fp32: each (chunk, LANES)
    block's r (``read``: the block's v[0, 0]), and what the TPU kernel's
    output holds after its sequential grid: the last block's v[:8, :128]
    for ``read``, else its r broadcast. ``chunk`` defaults to CHUNK, read
    at call time."""
    chunk = CHUNK if chunk is None else chunk
    b, rows, lanes = x.shape
    nchunk = rows // chunk
    v = x.reshape(b, nchunk, chunk * lanes)
    if mode == "read":
        last = (nchunk - 1) * chunk
        return v[..., 0].clone(), x[b - 1, last : last + 8, :128].clone()
    if mode == "sum":
        r = v.sum(-1)
    elif mode == "maxsum":
        r = v.amax(-1) + v.sum(-1)
    elif mode == "expsum":
        r = torch.exp(v - 3.0).sum(-1)
    elif mode == "exp2sum":
        r = torch.exp2(v - 3.0).sum(-1)
    elif mode == "bexpsum":
        r = torch.exp(v.to(torch.bfloat16) - 3.0).float().sum(-1)
    else:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    return r, r[-1, -1].expand(8, 128).clone()


def _check(x: torch.Tensor, chunk: int) -> Tuple[int, int, int]:
    """What the kernel requires of x; returns (B, NCHUNK, LANES)."""
    if x.dim() != 3 or not x.is_cuda:
        raise ValueError(f"x must be a (B, NCHUNK*CHUNK, LANES) CUDA tensor, got {x.device} {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"x is {x.dtype}: need float32")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    b, rows, lanes = x.shape
    if chunk < 8 or rows % chunk or lanes < 128 or (chunk * lanes) % 4:
        raise ValueError(f"x {tuple(x.shape)} does not split into (chunk={chunk} >= 8, LANES >= 128) blocks")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    if not 1 <= b * (rows // chunk) < 2**31:
        raise ValueError(f"{b * (rows // chunk)} blocks do not fit the grid")
    return b, rows // chunk, lanes


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    lib.ihpr_exp_probe.restype = ctypes.c_int
    lib.ihpr_exp_probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


def kernel(x: torch.Tensor, mode: str, chunk: int | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel on the same contract as ``plain``. Launches on the
    current stream without synchronizing; raises on any input the kernel
    does not take and on a refused launch."""
    global launches
    chunk = CHUNK if chunk is None else chunk
    b, nchunk, lanes = _check(x, chunk)
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    partials = torch.empty((b, nchunk), dtype=torch.float32, device=x.device)
    token = torch.empty((8, 128), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().ihpr_exp_probe(
            x.data_ptr(), partials.data_ptr(), token.data_ptr(), b * nchunk, chunk, lanes,
            MODES.index(mode), torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"{_LIB} launch failed: CUDA error {err}")
    launches += 1
    return partials, token


def probe(x: torch.Tensor, mode: str, chunk: int | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kernel`` for a CUDA tensor, ``plain`` for a CPU tensor."""
    return (kernel if x.is_cuda else plain)(x, mode, chunk)


def make_volume(device="cuda", seed: int = 0, shape=None) -> torch.Tensor:
    """N(0, 1) - 3 in fp32, made on ``device`` from ``seed``: the exp
    operand's range in the stabilized integral kernels. ``shape`` defaults
    to (B, NCHUNK * CHUNK, LANES), read at call time."""
    shape = (B, NCHUNK * CHUNK, LANES) if shape is None else shape
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device, dtype=torch.float32).sub_(3.0)


def read_floor_ms(nbytes: int) -> float:
    """The least time one read of ``nbytes`` takes at 3.35 TB/s, in ms."""
    return nbytes / PEAK_HBM_BYTES * 1e3


def check_read_floor(read_ms: float, nbytes: int) -> None:
    """Raises if ``read`` beat the card's memory rate: its loads were
    elided, and no number of the run measures anything."""
    floor = read_floor_ms(nbytes)
    if read_ms < floor:
        raise RuntimeError(
            f"read took {read_ms:.4f} ms, under the {floor:.4f} ms that {nbytes / 1e9:.3f} GB take at "
            f"3.35 TB/s: the loads were elided, so no number of this run is valid"
        )


def run(x: torch.Tensor, iters: int = 30, chunk: int | None = None) -> dict:
    """ms per pass of each mode over ``x``: ``time_ms`` in ROUNDS rounds, the
    modes in order and then in reverse (on an H100 one pass in order timed
    the first mode 5% slow), the least of each mode's rounds. On a CUDA tensor the read
    floor is checked before anything is returned."""
    times = {mode: [] for mode in MODES}
    for r in range(ROUNDS):
        for mode in MODES if r % 2 == 0 else MODES[::-1]:
            times[mode].append(time_ms(lambda m=mode: probe(x, m, chunk), iters, x.device))
    results = {mode: min(t) for mode, t in times.items()}
    if x.is_cuda:
        check_read_floor(results["read"], x.numel() * x.element_size())
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shape", type=int, nargs=4, default=(B, NCHUNK, CHUNK, LANES),
                    metavar=("B", "NCHUNK", "CHUNK", "LANES"))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("exp_probe: no CUDA device (--device cpu runs the plain versions)")
    b, nchunk, chunk, lanes = args.shape
    x = make_volume(device, 0, (b, nchunk * chunk, lanes))
    gb, n = x.numel() * 4 / 1e9, x.numel()
    results = run(x, args.iters, chunk)
    print(f"exp_probe: ({b}, {nchunk * chunk}, {lanes}) fp32, {gb:.3f} GB, blocks ({chunk}, {lanes}), "
          f"{args.iters} passes per mode  [{device_line(device)}]")
    for mode, ms in results.items():
        print(f"{mode:8s} {ms:8.4f} ms  ({gb / ms * 1e3:7.1f} GB/s read)")
    if device.type == "cuda":
        print(f"read floor at 3.35 TB/s: {read_floor_ms(x.numel() * 4):.4f} ms")
    print(f"\nmarginal exp pass (expsum - sum): {results['expsum'] - results['sum']:.4f} ms per {n / 1e6:.0f}M exps")
    print(f"without the *log2e multiply (exp2sum - expsum): {results['exp2sum'] - results['expsum']:.4f} ms")
    print(f"bf16x2 exp against fp32 (bexpsum - expsum): {results['bexpsum'] - results['expsum']:.4f} ms")
    return results


if __name__ == "__main__":
    main()
