"""The tiled int8/bf16 matmul probe (P2): the counterpart of
``tools/mxu_int8_probe.py``.

How close does a hand-written tensor-core GEMM get to the card's peaks (989
TFLOP/s bf16, 1,979 TOP/s int8, dense), next to cuBLAS? Each phase is int8
against bf16 at the same shape:

  dot      the library products at M = N = K = 4096: ``torch.matmul`` (bf16)
           and ``torch._int_mm`` (int8), where the TPU probe had XLA's dot
  pallas   ``pallas_mm``: the tiled kernel ``ops/csrc/probe_mm.cu`` (TMA ring,
           one producer and two consumer warpgroups, wgmma bf16 / s8; int8 B
           transposed in the same call) at each tile of TILES, and the best
  conv9    a 3x3 SAME conv as 9 shifted (B*H*W, C) @ (C, C) library products
           at (64, 64, 64, 256) x (3, 3, 256, 256)
  convref  cuDNN's ``F.conv2d`` (channels_last) at the same shape; there is no
           int8 conv on CUDA in torch, so the int8 row is not run

    python -m ihpr_tpu_torch.tools.mxu_int8_probe [--iters 30] [--device cuda] [--check]

Times are CUDA events around the products themselves (an eager launch
cannot be narrowed to part of its output, so no reduce token is needed).
``--check`` holds the kernel against ``plain_mm`` at 1024^3 for every tile
(int8 bitwise, bf16 within 1e-4 of max|plain|) and int8 ``conv9`` against a
float64 ``F.conv2d`` of the same integers (bitwise), on the device asked
for. ``--device cpu`` runs the plain versions at ``--size`` and ``--conv``,
on the host clock.
"""

from __future__ import annotations

import argparse
import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ihpr_tpu_torch.ops import _build
from ihpr_tpu_torch.ops.fused_head_integral import no_tf32
from ihpr_tpu_torch.tools import device_line, time_ms

_LIB = "probe_mm"
TAGS = {torch.bfloat16: "bf16", torch.int8: "int8"}
_ACC = {torch.bfloat16: torch.float32, torch.int8: torch.int32}
# (bm, bn, bk) of the kernel's tile list (csrc/probe_mm.cu's note says why):
# bk is one 128-byte k-block, 64 bf16 or 128 int8 values, so a stage moves
# the same bytes in both types.
TILES = {
    torch.bfloat16: ((128, 256, 64), (256, 128, 64), (128, 128, 64)),
    torch.int8: ((128, 256, 128), (256, 128, 128), (128, 128, 128)),
}
# Dense peaks of one H100 SXM (NVIDIA's data sheet), operations per second.
PEAK = {torch.bfloat16: 989e12, torch.int8: 1979e12}

# Launches of the kernel since the count was last set to 0; ``kernel_mm``
# adds one per call (the int8 transpose and product are one call) and
# nothing else touches it.
launches = 0


def plain_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version on either device: bf16 -> fp32 as a float32
    product with TF32 off; int8 -> int32 through float64, exact since
    |sum| <= K * 127 * 127 < 2^53 (CUDA has no int32 matmul)."""
    if a.dtype == torch.int8:
        return (a.double() @ b.double()).to(torch.int32)
    with no_tf32():
        return a.float() @ b.float()


def lib_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One library product, the yardstick: ``torch._int_mm`` (int8 -> int32)
    or ``torch.matmul`` (bf16, fp32 accumulation, bf16 out)."""
    return torch._int_mm(a, b) if a.dtype == torch.int8 else torch.matmul(a, b)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    lib.ihpr_probe_mm.restype = ctypes.c_int
    lib.ihpr_probe_mm.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return lib


def kernel_mm(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int, bk: int) -> torch.Tensor:
    """The CUDA kernel: a (M, K) @ b (K, N), bf16 -> fp32 or int8 -> int32,
    with tile (bm, bn, bk) from TILES. Launches on the current stream
    without synchronizing; raises on any input the kernel does not take and
    on a refused launch."""
    global launches
    if a.dim() != 2 or b.dim() != 2 or not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError(f"a and b must be 2-D CUDA tensors on one device, got {a.device} {b.device}")
    if a.dtype != b.dtype or a.dtype not in TILES:
        raise ValueError(f"a, b are {a.dtype}, {b.dtype}: need both bfloat16 or both int8")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} do not chain")
    if (bm, bn, bk) not in TILES[a.dtype]:
        raise ValueError(f"tile {(bm, bn, bk)} is not in the {TAGS[a.dtype]} list {TILES[a.dtype]}")
    if m % bm or n % bn or k % bk or max(m, n, k) >= 2**31 or m // bm > 65535:
        raise ValueError(f"({m}, {n}, {k}) is not a multiple of the tile {(bm, bn, bk)}")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("a and b must be 16-byte aligned")
    out = torch.empty((m, n), dtype=_ACC[a.dtype], device=a.device)
    bt = torch.empty((n, k), dtype=torch.int8, device=a.device) if a.dtype == torch.int8 else None
    with torch.cuda.device(a.device):
        err = _lib().ihpr_probe_mm(
            a.data_ptr(), b.data_ptr(), None if bt is None else bt.data_ptr(), out.data_ptr(),
            m, n, k, int(a.dtype == torch.int8), bm, bn, bk, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"{_LIB} launch failed: CUDA error {err}")
    launches += 1
    return out


def pallas_mm(m: int, n: int, k: int, dtype, bm: int = 128, bn: int = 128, bk: int | None = None):
    """Tiled (m, k) @ (k, n) with the tile (bm, bn, bk): a callable
    ``(a, b) -> out`` (bf16 -> fp32, int8 -> int32) that runs the kernel on
    CUDA tensors and ``plain_mm`` on CPU tensors. The name and signature are
    the TPU probe's."""
    if bk is None:
        bk = 128 if dtype == torch.int8 else 64
    assert m % bm == 0 and n % bn == 0 and k % bk == 0

    def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if tuple(a.shape) != (m, k) or tuple(b.shape) != (k, n) or a.dtype != dtype:
            raise ValueError(f"need {dtype} ({m}, {k}) @ ({k}, {n}), got {a.dtype} {tuple(a.shape)} @ {tuple(b.shape)}")
        return kernel_mm(a, b, bm, bn, bk) if a.is_cuda else plain_mm(a, b)

    return mm


def conv9_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A 3x3 SAME conv as 9 shifted library products: x (B, H, W, C), w (3,
    3, C, C) -> (B*H*W, C) in int32 (int8 inputs) or fp32 (bf16 inputs)."""
    b, h, wd, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = torch.zeros((b * h * wd, c), dtype=_ACC[x.dtype], device=x.device)
    for dy in range(3):
        for dx in range(3):
            xs = xp[:, dy : dy + h, dx : dx + wd, :].reshape(b * h * wd, c)
            out += lib_mm(xs, w[dy, dx])
    return out


def conv9(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The TPU probe's token of ``conv9_out``: the sum of the whole output
    (int64 for int8 inputs, where JAX's int32 token wraps)."""
    return conv9_out(x, w).sum()


def conv_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same conv through cuDNN (``F.conv2d``, channels_last), bf16."""
    wt = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return F.conv2d(x.permute(0, 3, 1, 2), wt, padding=1)


def _mats(rng: np.random.RandomState, m: int, n: int, k: int, dtype):
    """The TPU probe's operands, from the same numpy draws: a ~ N(0, 1), b ~
    0.05 N(0, 1); int8 scales by 10 and 100, rounds and clips to +-127.
    CPU tensors of ``dtype``."""
    a = rng.randn(m, k).astype(np.float32)
    b = (rng.randn(k, n) * 0.05).astype(np.float32)
    if dtype == torch.int8:
        a = np.clip(np.round(a * 10), -127, 127)
        b = np.clip(np.round(b * 100), -127, 127)
    return torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype)


def _conv_operands(xf: np.ndarray, wf: np.ndarray, dtype):
    """x (B, H, W, C) and w (3, 3, C, C) of ``dtype`` from the conv phases'
    float draws, as the TPU probe makes them."""
    if dtype == torch.int8:
        xf, wf = np.clip(np.round(xf * 10), -127, 127), np.clip(np.round(wf * 100), -127, 127)
    return torch.from_numpy(xf).to(dtype), torch.from_numpy(wf).to(dtype)


def check_tiles(a: torch.Tensor, b: torch.Tensor) -> float:
    """Every tile of a's dtype against ``plain_mm`` on the same operands:
    int8 bitwise, bf16 within 1e-4 of max|plain|. Returns the largest
    |difference|."""
    m, k = a.shape
    n = b.shape[1]
    want = plain_mm(a, b)
    scale = float(want.abs().max())
    worst = 0.0
    for bm, bn, bk in TILES[a.dtype]:
        got = pallas_mm(m, n, k, a.dtype, bm, bn, bk)(a, b)
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"tile {(bm, bn, bk)}: {got.dtype}{tuple(got.shape)}")
        err = float((got.double() - want.double()).abs().max())
        if a.dtype == torch.int8 and not torch.equal(got, want):
            raise AssertionError(f"int8 tile {(bm, bn, bk)} differs from plain_mm by {err}")
        if not err <= 1e-4 * scale:
            raise AssertionError(f"{TAGS[a.dtype]} tile {(bm, bn, bk)}: {err} from plain_mm (max {scale})")
        worst = max(worst, err)
    return worst


def check(device="cuda") -> None:
    """The TPU probe's ``check()`` on ``device``: the kernel (``plain_mm``
    on the CPU) at 1024^3 for every tile, and int8 conv9 against a float64
    ``F.conv2d`` of the same integers, bitwise."""
    rng = np.random.RandomState(0)
    for dtype in (torch.bfloat16, torch.int8):
        a, b = (t.to(device) for t in _mats(rng, 1024, 1024, 1024, dtype))
        check_tiles(a, b)
    x = torch.from_numpy(np.clip(rng.randn(2, 8, 8, 128) * 10, -127, 127)).to(torch.int8).to(device)
    w = torch.from_numpy(np.clip(rng.randn(3, 3, 128, 128) * 5, -127, 127)).to(torch.int8).to(device)
    ref = F.conv2d(x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1), padding=1)
    if not torch.equal(conv9_out(x, w).long(), ref.permute(0, 2, 3, 1).reshape(-1, 128).long()):
        raise AssertionError("conv9 differs from a float64 conv2d of the same integers")
    print(f"check OK: every tile (bf16 + int8) against plain_mm and conv9 against conv2d  "
          f"[{device_line(device)}]")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--size", type=int, default=4096, help="M = N = K of the products")
    ap.add_argument("--conv", type=int, nargs=4, default=(64, 64, 64, 256), metavar=("B", "H", "W", "C"))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("mxu_int8_probe: no CUDA device (--device cpu runs the plain versions)")
    if args.check:
        check(device)
        return {}

    rng = np.random.RandomState(0)
    size = args.size
    mm_flops = 2 * size**3
    cb, ch, cw, cc = args.conv
    conv_flops = 2 * cb * ch * cw * cc * cc * 9
    on_card = device.type == "cuda"
    print(f"mxu_int8_probe: M = N = K = {size}, conv ({cb}, {ch}, {cw}, {cc}) x (3, 3, {cc}, {cc}), "
          f"{args.iters} calls per phase  [{device_line(device)}]")
    results: dict = {}

    def phase(name, fn, flops, dtype):
        ms = time_ms(fn, args.iters, device)
        results[name] = ms
        rate = flops / ms / 1e9
        peak = f" = {rate / PEAK[dtype] * 1e12:.3f} of {PEAK[dtype] / 1e12:.0f}" if on_card else ""
        print(f"{name:24s} {ms:9.4f} ms = {rate:7.1f} T(FL)OP/s{peak}", flush=True)

    for dtype in (torch.bfloat16, torch.int8):
        tag = TAGS[dtype]
        a, b = (t.to(device) for t in _mats(rng, size, size, size, dtype))
        phase(f"dot_{tag}", lambda: lib_mm(a, b), mm_flops, dtype)
        for bm, bn, bk in TILES[dtype]:
            f = pallas_mm(size, size, size, dtype, bm, bn, bk)
            phase(f"pallas_{tag}_{bm}x{bn}x{bk}", lambda f=f: f(a, b), mm_flops, dtype)
        results[f"pallas_{tag}"] = min(v for p, v in results.items() if p.startswith(f"pallas_{tag}_"))
        del a, b
    xf = rng.randn(cb, ch, cw, cc).astype(np.float32)
    wf = (rng.randn(3, 3, cc, cc) * 0.05).astype(np.float32)
    for dtype in (torch.bfloat16, torch.int8):
        tag = TAGS[dtype]
        x, w = (t.to(device) for t in _conv_operands(xf, wf, dtype))
        phase(f"conv9_{tag}", lambda: conv9(x, w), conv_flops, dtype)
        if dtype == torch.int8:  # decided here, before any launch
            print(f"{'convref_' + tag:24s} not available: no int8 conv on CUDA in torch")
        else:
            phase(f"convref_{tag}", lambda: conv_ref(x, w), conv_flops, dtype)

    print()
    for pair in ("dot", "pallas", "conv9", "convref"):
        b8, i8 = results.get(f"{pair}_bf16"), results.get(f"{pair}_int8")
        if b8 and i8:
            print(f"{pair}: int8 is {b8 / i8:.2f}x bf16")
    return results


if __name__ == "__main__":
    main()
