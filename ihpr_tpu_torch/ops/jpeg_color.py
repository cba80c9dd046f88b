"""libjpeg's chroma upsampling and YCbCr -> RGB conversion of decoded JPEG
planes: the colour kernel (``ops/csrc/jpeg_color.cu``) and its plain
PyTorch version.

nvJPEG decodes a frame to planar YCbCr at its stored subsampling
(``data/jpeg.py``); ``to_rgb`` turns those planes into interleaved RGB with
the arithmetic of libjpeg's ``jdsample.c`` (fancy upsampling) and
``jdcolor.c`` (16-bit fixed-point conversion), so that the card decodes to
libjpeg's pixels, as the JAX package's host decode (cv2, ``native/warp.cc``)
does, up to nvJPEG's IDCT.

A batch's planes lie in one flat uint8 tensor; ``Layout`` gives each frame's
plane offsets, size and subsampling: ``(hs, vs)`` of ``SAMPLINGS``, the
luma's samples per chroma sample across and down, or ``(0, 0)`` for a
grayscale frame, which has no chroma planes. A chroma plane holds
``ceil(h / vs)`` rows of ``ceil(w / hs)`` samples.

``to_rgb`` launches the kernel on a CUDA tensor (one launch a batch) and
runs ``plain`` on a CPU tensor; ``launches`` counts the kernel's launches
since it was last set to 0. Nothing on the card's path uses ``plain``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence

import torch

from ihpr_tpu_torch.ops import _build

_LIB = "jpeg_color"
# (hs, vs) by name; grayscale is (0, 0).
SAMPLINGS = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2)}
GRAY = (0, 0)

launches = 0


class Layout(NamedTuple):
    """One frame's planes in a flat uint8 tensor (byte offsets), its height
    and width, and its subsampling."""

    y: int
    cb: int
    cr: int
    h: int
    w: int
    hs: int
    vs: int

    @property
    def chroma_shape(self):
        if (self.hs, self.vs) == GRAY:
            return (0, 0)
        return (-(-self.h // self.vs), -(-self.w // self.hs))


def _shift(v: torch.Tensor) -> torch.Tensor:
    """libjpeg's RIGHT_SHIFT(v, 16): an arithmetic shift, so it floors."""
    return torch.bitwise_right_shift(v, 16)


def upsample(c: torch.Tensor, h: int, w: int, hs: int, vs: int) -> torch.Tensor:
    """A (ceil(h / vs), ceil(w / hs)) chroma plane -> (h, w) int32 samples,
    libjpeg's fancy upsampling (``h2v2_fancy_upsample``,
    ``h2v1_fancy_upsample``; none at 4:4:4)."""
    c = c.to(torch.int32)
    if (hs, vs) == (1, 1):
        return c[:h, :w]
    ch, cw = c.shape
    x = torch.arange(w, device=c.device)
    col, odd = x // 2, x % 2 == 1
    beside = torch.where(odd, (col + 1).clamp(max=cw - 1), (col - 1).clamp(min=0))
    if vs == 1:  # h2v1: 3/4 nearer + 1/4 farther column, + 1 (even) / + 2 (odd)
        rows = c[:h]
        return (3 * rows[:, col] + rows[:, beside] + odd.to(torch.int32) + 1) >> 2
    # h2v2: column sums of the nearer row and the row above (even output
    # rows) or below (odd), replicated at the first and last rows.
    r = torch.arange(h, device=c.device)
    near = r // 2
    far = torch.where(r % 2 == 1, (near + 1).clamp(max=ch - 1), (near - 1).clamp(min=0))
    sums = 3 * c[near] + c[far]
    return (3 * sums[:, col] + sums[:, beside] + 8 - odd.to(torch.int32)) >> 4


def convert(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """Full-resolution Y, Cb, Cr -> (h, w, 3) uint8 RGB, libjpeg's
    ``ycc_rgb_convert``."""
    y, x, xb = y.to(torch.int32), cr.to(torch.int32) - 128, cb.to(torch.int32) - 128
    r = y + _shift(91881 * x + 32768)
    g = y + _shift(-22554 * xb - 46802 * x + 32768)
    b = y + _shift(116130 * xb + 32768)
    return torch.stack([r, g, b], -1).clamp(0, 255).to(torch.uint8)


def plain(y: torch.Tensor, cb: Optional[torch.Tensor], cr: Optional[torch.Tensor], hs: int, vs: int) -> torch.Tensor:
    """One frame's planes -> (h, w, 3) uint8 RGB in integer tensor
    arithmetic: (h, w) Y and its chroma planes at ``(hs, vs)``, or
    ``GRAY`` with no chroma (R = G = B = Y)."""
    h, w = y.shape
    if (hs, vs) == GRAY:
        return y.to(torch.uint8).unsqueeze(-1).expand(h, w, 3).contiguous()
    return convert(y, upsample(cb, h, w, hs, vs), upsample(cr, h, w, hs, vs))


def plane_views(planes: torch.Tensor, lay: Layout):
    """(Y, Cb, Cr) views of one frame's planes (Cb, Cr None if gray)."""
    y = planes[lay.y : lay.y + lay.h * lay.w].view(lay.h, lay.w)
    if (lay.hs, lay.vs) == GRAY:
        return y, None, None
    ch, cw = lay.chroma_shape
    return (y, planes[lay.cb : lay.cb + ch * cw].view(ch, cw), planes[lay.cr : lay.cr + ch * cw].view(ch, cw))


def _rgb_offsets(layouts: Sequence[Layout]) -> List[int]:
    offsets = [0]
    for lay in layouts:
        offsets.append(offsets[-1] + lay.h * lay.w * 3)
    return offsets


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    lib.ihpr_jpeg_color.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_void_p]
    lib.ihpr_jpeg_color.restype = ctypes.c_int
    return lib


def kernel(planes: torch.Tensor, layouts: Sequence[Layout], out: torch.Tensor) -> None:
    """Launch the colour kernel once over every frame of ``layouts`` on the
    current stream, writing each frame's RGB at its offset in the flat
    uint8 ``out``. CUDA tensors only."""
    global launches
    if planes.device.type != "cuda" or out.device != planes.device:
        raise ValueError(f"jpeg_color.kernel takes CUDA tensors on one device, got {planes.device} and {out.device}")
    if planes.dtype != torch.uint8 or out.dtype != torch.uint8 or not planes.is_contiguous():
        raise ValueError("jpeg_color.kernel takes contiguous uint8 planes and output")
    offsets = _rgb_offsets(layouts)
    if out.numel() < offsets[-1]:
        raise ValueError(f"output of {out.numel()} bytes < the {offsets[-1]} the frames need")
    for lay in layouts:
        if (lay.hs, lay.vs) not in (*SAMPLINGS.values(), GRAY):
            raise ValueError(f"subsampling {(lay.hs, lay.vs)} is not one of {sorted(SAMPLINGS)} or gray")
        ch, cw = lay.chroma_shape
        if max(lay.y + lay.h * lay.w, lay.cb + ch * cw, lay.cr + ch * cw) > planes.numel():
            raise ValueError(f"a frame's planes {lay} run past the {planes.numel()} bytes given")
    if not layouts:
        return
    meta = torch.tensor([[lay.y, lay.cb, lay.cr, o, lay.h, lay.w, lay.hs, lay.vs]
                         for lay, o in zip(layouts, offsets)], dtype=torch.int64)
    meta = meta.pin_memory().to(planes.device, non_blocking=True)
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    err = _lib().ihpr_jpeg_color(planes.data_ptr(), meta.data_ptr(), len(layouts),
                                 max(lay.h for lay in layouts), max(lay.w for lay in layouts), out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"jpeg_color kernel launch failed: CUDA error {err - 1000}")
    launches += 1


def to_rgb(planes: torch.Tensor, layouts: Sequence[Layout]) -> List[torch.Tensor]:
    """Flat decoded planes -> one (h, w, 3) uint8 RGB tensor per frame, views
    of one new buffer on ``planes``' device: the kernel on a CUDA tensor,
    ``plain`` on a CPU tensor."""
    offsets = _rgb_offsets(layouts)
    out = torch.empty(offsets[-1], dtype=torch.uint8, device=planes.device)
    if planes.device.type == "cuda":
        kernel(planes, layouts, out)
    elif planes.device.type == "cpu":
        for lay, o in zip(layouts, offsets):
            out[o : o + lay.h * lay.w * 3] = plain(*plane_views(planes, lay), lay.hs, lay.vs).reshape(-1)
    else:
        raise ValueError(f"jpeg_color.to_rgb: no colour path on {planes.device}")
    return [out[o : o + lay.h * lay.w * 3].view(lay.h, lay.w, 3) for lay, o in zip(layouts, offsets)]
