"""JPEG decode and encode: nvJPEG and libjpeg's colour arithmetic on a CUDA
device, cv2 on the CPU.

The JAX package reads a dataset's JPEGs on the host, with libjpeg fused
into the native warp (``native/warp.cc``) or with ``cv2.imread``
(``ihpr_tpu/data/pipeline.py:_load_image``). The port decodes on the
card, so that it needs neither cv2 nor libjpeg beside the CUDA toolkit:
``ops/csrc/nvjpeg_codec.cu``, built by ``ops/_build.py`` and linked with
the CUDA toolkit's nvJPEG, decodes a batch's files in one
``nvjpegDecodeBatched`` call into planar YCbCr at each file's stored
subsampling (``decode_planes``), and the colour kernel
(``ops/jpeg_color.py``) upsamples the chroma and converts to interleaved
RGB, the JAX package's channel order, with libjpeg's integer arithmetic.
Only nvJPEG's IDCT then stands between the card's pixels and libjpeg's.
The card takes 4:4:4, 4:2:2, 4:2:0 and grayscale files; any other
subsampling raises ``ValueError`` naming the file (``subsampling``).
``encode`` is the inverse (baseline 4:2:0 at the quality asked for, as
``cv2.imwrite`` writes by default), for ``datasets.materialize_synthetic``.

``device`` chooses the codec: a CUDA device takes nvJPEG, which builds or
raises (a toolkit without nvJPEG is an error at build time, naming the
directories searched); the CPU takes ``cv2.imdecode`` / ``cv2.imencode``,
the plain version the CPU tests use. Nothing falls back from one to the
other. ``decode_rgbi`` is nvJPEG's own upsampling and colour conversion,
kept only as the baseline the colour kernel is measured against
(``chip_smoke.py``). Bytes that do not decode raise ``ValueError`` naming
the file.

``launches`` and ``encode_launches`` count the nvJPEG decode and encode
calls (one a batch, one an image) since they were last set to 0; the
colour kernel counts its own (``jpeg_color.launches``).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from ihpr_tpu_torch.ops import _build, jpeg_color
from ihpr_tpu_torch.ops.jpeg_color import GRAY, SAMPLINGS, Layout

_LIB = "nvjpeg_codec"

launches = 0
encode_launches = 0

# nvJPEG's status codes (nvjpeg.h); 1000 + e is cudaError_t e.
_STATUS = {
    1: "NOT_INITIALIZED", 2: "INVALID_PARAMETER", 3: "BAD_JPEG", 4: "JPEG_NOT_SUPPORTED",
    5: "ALLOCATOR_FAILURE", 6: "EXECUTION_FAILED", 7: "ARCH_MISMATCH", 8: "INTERNAL_ERROR",
    9: "IMPLEMENTATION_NOT_SUPPORTED", 10: "INCOMPLETE_BITSTREAM",
}
_P = ctypes.c_void_p


def _status(code: int) -> str:
    if code >= 1000:
        return f"CUDA error {code - 1000}"
    return f"nvJPEG status {code} ({_STATUS.get(code, 'unknown')})"


class _Codec:
    """The process's nvJPEG handle, decode and encode states, and the lock
    that serialises their use (the states are not thread-safe)."""

    def __init__(self):
        lib = _build.load(_LIB)
        lib.ihpr_jpeg_create.argtypes = [ctypes.POINTER(_P)]
        lib.ihpr_jpeg_destroy.argtypes = [_P]
        lib.ihpr_jpeg_destroy.restype = None
        lib.ihpr_jpeg_info.argtypes = [_P, ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int)]
        lib.ihpr_jpeg_decode_batch.argtypes = [_P, ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
                                               ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(_P),
                                               ctypes.POINTER(ctypes.c_int), ctypes.c_int, _P]
        lib.ihpr_jpeg_decode_one.argtypes = [_P, ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(_P),
                                             ctypes.POINTER(ctypes.c_int), ctypes.c_int, _P]
        lib.ihpr_jpeg_encode.argtypes = [_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_size_t), _P]
        lib.ihpr_jpeg_encode_retrieve.argtypes = [_P, ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t), _P]
        for fn in ("create", "info", "decode_batch", "decode_one", "encode", "encode_retrieve"):
            getattr(lib, f"ihpr_jpeg_{fn}").restype = ctypes.c_int
        handle = _P()
        err = lib.ihpr_jpeg_create(ctypes.byref(handle))
        if err:
            raise RuntimeError(f"nvJPEG: creating the codec failed: {_status(err)}")
        self.lib, self.handle, self.lock = lib, handle, threading.Lock()


@functools.cache
def _codec() -> _Codec:
    return _Codec()


def _name(names: Optional[Sequence[str]], i: int) -> str:
    return names[i] if names is not None else f"image {i}"


def _decode_cpu(blobs: Sequence[bytes], names) -> List[torch.Tensor]:
    import cv2

    out = []
    for i, blob in enumerate(blobs):
        img = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError(f"{_name(names, i)}: not a decodable image")
        out.append(torch.from_numpy(np.ascontiguousarray(img[:, :, ::-1])))  # BGR -> RGB
    return out


# Start-of-frame markers (SOF0-SOF15 but DHT, JPG and DAC).
_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def subsampling(blob: bytes, name: str = "image") -> tuple:
    """The frame's chroma subsampling from its start-of-frame header: ``(hs,
    vs)`` of ``jpeg_color.SAMPLINGS``, or ``jpeg_color.GRAY``. Any other
    (4:4:0, 4:1:1, CMYK, a chroma plane of its own layout) raises
    ``ValueError`` naming ``name``: the card's colour kernel has no path
    for it."""
    i, n = 2, len(blob)
    if blob[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG (no start-of-image marker)")
    while i + 4 <= n:
        if blob[i] != 0xFF:
            raise ValueError(f"{name}: malformed JPEG marker at byte {i}")
        marker = blob[i + 1]
        if marker == 0xFF:  # fill byte
            i += 1
            continue
        if marker == 0xDA:
            break
        length = int.from_bytes(blob[i + 2 : i + 4], "big")
        if marker in _SOF:
            comps = blob[i + 9] if i + 9 < n else 0
            if i + 11 + 3 * comps > n:
                raise ValueError(f"{name}: truncated start-of-frame header")
            factors = [(blob[i + 11 + 3 * k] >> 4, blob[i + 11 + 3 * k] & 15) for k in range(comps)]
            if comps == 1:
                return GRAY
            if comps == 3 and factors[1] == factors[2] and factors[0] == max(factors):
                (hy, vy), (hc, vc) = factors[0], factors[1]
                mode = (hy // hc, vy // vc) if hy % hc == 0 and vy % vc == 0 else None
                if mode in SAMPLINGS.values():
                    return mode
            raise ValueError(
                f"{name}: {comps} components with sampling factors {factors}: the card decodes "
                f"{', '.join(SAMPLINGS)} and grayscale only"
            )
        i += 2 + length
    raise ValueError(f"{name}: no start-of-frame header before the scan")


def _layouts(codec, blobs, names):
    """Each frame's planes in one flat buffer, from its header: Y, then Cb
    and Cr at its subsampling (a grayscale frame keeps room for two planes
    of its own size, which nvJPEG may write and the colour kernel ignores),
    and the buffer's size in bytes."""
    info = (ctypes.c_int * 6)()
    layouts, offset = [], 0
    for i, blob in enumerate(blobs):
        err = codec.lib.ihpr_jpeg_info(codec.handle, blob, len(blob), info)
        if err or info[2] <= 0 or info[3] <= 0:
            raise ValueError(f"{_name(names, i)}: not a JPEG nvJPEG reads: {_status(err)}")
        hs, vs = subsampling(blob, _name(names, i))
        h, w = info[2], info[3]
        lay = Layout(offset, 0, 0, h, w, hs, vs)
        ch, cw = lay.chroma_shape if (hs, vs) != GRAY else (h, w)
        if (hs, vs) != GRAY and (info[4], info[5]) != (ch, cw):
            raise ValueError(f"{_name(names, i)}: nvJPEG reports a {info[4]}x{info[5]} chroma plane for a {h}x{w} "
                             f"frame at {(hs, vs)}; libjpeg's is {ch}x{cw}")
        layouts.append(lay._replace(cb=offset + h * w, cr=offset + h * w + ch * cw))
        offset += h * w + 2 * ch * cw
    return layouts, offset


def _pitches(lay: Layout) -> List[int]:
    return [lay.w] + [lay.chroma_shape[1] if (lay.hs, lay.vs) != GRAY else lay.w] * 2


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"jpeg.decode: no decoder on {device}")
    return device


def _nvjpeg(codec, blobs, names, bases, pitches, rgbi: int, stream):
    """One ``nvjpegDecodeBatched`` call of ``blobs`` into the planes at
    ``bases`` (three a frame); on failure, find the file at fault by
    decoding them one at a time, then raise."""
    global launches
    lib, n = codec.lib, len(blobs)
    planes = (_P * (3 * n))(*bases)
    rows = (ctypes.c_int * (3 * n))(*pitches)
    err = lib.ihpr_jpeg_decode_batch(codec.handle, n, (ctypes.c_char_p * n)(*blobs),
                                     (ctypes.c_size_t * n)(*map(len, blobs)), planes, rows, rgbi, stream)
    if err:
        for i, blob in enumerate(blobs):
            one = lib.ihpr_jpeg_decode_one(codec.handle, blob, len(blob), (_P * 3)(*bases[3 * i : 3 * i + 3]),
                                           (ctypes.c_int * 3)(*pitches[3 * i : 3 * i + 3]), rgbi, stream)
            if one:
                raise ValueError(f"{_name(names, i)}: nvJPEG could not decode it: {_status(one)}")
        raise RuntimeError(f"nvjpegDecodeBatched of {n} images failed: {_status(err)}")
    launches += 1


def decode_planes(blobs: Sequence[bytes], device, names: Optional[Sequence[str]] = None):
    """JPEG bytes -> (one flat uint8 tensor on the CUDA ``device`` holding
    every frame's Y, Cb and Cr planes at its stored subsampling, and each
    frame's ``jpeg_color.Layout``): one ``nvjpegDecodeBatched`` call on the
    current stream. ``names`` (one per blob, e.g. file paths) label
    errors."""
    device = _check_device(device)
    codec = _codec()
    with codec.lock, torch.cuda.device(device):
        layouts, size = _layouts(codec, blobs, names)
        planes = torch.empty(size, dtype=torch.uint8, device=device)
        if layouts:
            base = planes.data_ptr()
            _nvjpeg(codec, blobs, names, [base + o for lay in layouts for o in (lay.y, lay.cb, lay.cr)],
                    [p for lay in layouts for p in _pitches(lay)], 0, torch.cuda.current_stream(device).cuda_stream)
    return planes, layouts


def decode(blobs: Sequence[bytes], device, names: Optional[Sequence[str]] = None) -> List[torch.Tensor]:
    """JPEG bytes -> RGB ``(H, W, 3)`` uint8 tensors on ``device``. On a CUDA
    device: ``decode_planes`` (one nvJPEG call), then one launch of the
    colour kernel, on the current stream; the returned tensors view one
    buffer. ``names`` (one per blob, e.g. file paths) label errors."""
    device = torch.device(device)
    if device.type == "cpu":
        return _decode_cpu(blobs, names)
    _check_device(device)
    if not blobs:
        return []
    planes, layouts = decode_planes(blobs, device, names)
    return jpeg_color.to_rgb(planes, layouts)


def decode_rgbi(blobs: Sequence[bytes], device, names: Optional[Sequence[str]] = None) -> List[torch.Tensor]:
    """JPEG bytes -> RGB tensors by nvJPEG's own chroma upsampling and colour
    conversion (``NVJPEG_OUTPUT_RGBI``), one batched call: the baseline the
    colour kernel is measured against. The loader never calls it."""
    device = _check_device(device)
    codec = _codec()
    with codec.lock, torch.cuda.device(device):
        layouts, _ = _layouts(codec, blobs, names)
        offsets = np.cumsum([0] + [lay.h * lay.w * 3 for lay in layouts])
        flat = torch.empty(int(offsets[-1]), dtype=torch.uint8, device=device)
        base = flat.data_ptr()
        _nvjpeg(codec, blobs, names, [p for o in offsets[:-1] for p in (base + int(o), 0, 0)],
                [p for lay in layouts for p in (lay.w * 3, 0, 0)], 1, torch.cuda.current_stream(device).cuda_stream)
    return [flat[int(o) : int(o) + lay.h * lay.w * 3].view(lay.h, lay.w, 3) for o, lay in zip(offsets, layouts)]


def encode(images: Sequence, quality: int = 95, device="cuda") -> List[bytes]:
    """RGB ``(H, W, 3)`` uint8 images (numpy or tensors) -> baseline 4:2:0
    JPEG bytes of ``quality``, encoded on ``device``: nvJPEG on a CUDA
    device, ``cv2.imencode`` on the CPU."""
    global encode_launches
    device = torch.device(device)
    if not 1 <= quality <= 100:
        raise ValueError(f"JPEG quality {quality} is not in [1, 100]")
    imgs = [im if isinstance(im, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(im)) for im in images]
    for im in imgs:
        if im.dtype != torch.uint8 or im.ndim != 3 or im.shape[2] != 3:
            raise ValueError(f"jpeg.encode takes (H, W, 3) uint8 images, got {tuple(im.shape)} {im.dtype}")
    if device.type == "cpu":
        import cv2

        out = []
        for im in imgs:
            ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(im.cpu().numpy()[:, :, ::-1]),
                                   [cv2.IMWRITE_JPEG_QUALITY, quality])
            if not ok:
                raise RuntimeError(f"cv2.imencode failed on a {tuple(im.shape)} image")
            out.append(buf.tobytes())
        return out
    if device.type != "cuda":
        raise ValueError(f"jpeg.encode: no encoder on {device}")
    codec = _codec()
    lib = codec.lib
    out = []
    length = ctypes.c_size_t()
    with codec.lock, torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for im in imgs:
            src = im.to(device).contiguous()
            err = lib.ihpr_jpeg_encode(codec.handle, src.data_ptr(), src.shape[0], src.shape[1], quality,
                                       ctypes.byref(length), stream)
            if err:
                raise RuntimeError(f"nvJPEG encode of a {tuple(src.shape)} image failed: {_status(err)}")
            buf = ctypes.create_string_buffer(length.value)
            err = lib.ihpr_jpeg_encode_retrieve(codec.handle, buf, ctypes.byref(length), stream)
            if err:
                raise RuntimeError(f"nvJPEG bitstream retrieval failed: {_status(err)}")
            encode_launches += 1
            out.append(buf.raw[: length.value])
    return out
