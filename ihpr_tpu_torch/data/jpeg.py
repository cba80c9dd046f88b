"""JPEG decode and encode: nvJPEG on a CUDA device, cv2 on the CPU.

The JAX package reads a dataset's JPEGs on the host, with libjpeg fused
into the native warp (``native/warp.cc``) or with ``cv2.imread``
(``ihpr_tpu/data/pipeline.py:_load_image``). The port decodes on the
card, so that it needs neither cv2 nor libjpeg beside the CUDA toolkit:
``ops/csrc/nvjpeg_codec.cu``, built by ``ops/_build.py`` and linked with
the CUDA toolkit's nvJPEG, decodes a batch's files in one
``nvjpegDecodeBatched`` call into interleaved RGB, the JAX package's
channel order. ``encode`` is its inverse (baseline 4:2:0 at the quality
asked for, as ``cv2.imwrite`` writes by default), for
``datasets.materialize_synthetic``.

``device`` chooses the codec: a CUDA device takes nvJPEG, which builds or
raises (a toolkit without nvJPEG is an error at build time, naming the
directories searched); the CPU takes ``cv2.imdecode`` / ``cv2.imencode``,
the plain version the CPU tests use. Nothing falls back from one to the
other. The two decoders' IDCTs and chroma upsampling differ by a few levels
(``chip_smoke.py``'s real-data phase measures the difference on the card).
Bytes that do not decode raise ``ValueError`` naming the file.

``launches`` and ``encode_launches`` count the nvJPEG decode and encode
calls (one a batch, one an image) since they were last set to 0.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from ihpr_tpu_torch.ops import _build

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
        lib.ihpr_jpeg_info.argtypes = [_P, ctypes.c_char_p, ctypes.c_size_t,
                                       ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.ihpr_jpeg_decode_batch.argtypes = [_P, ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
                                               ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(_P),
                                               ctypes.POINTER(ctypes.c_int), _P]
        lib.ihpr_jpeg_decode_one.argtypes = [_P, ctypes.c_char_p, ctypes.c_size_t, _P, ctypes.c_int, _P]
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


def decode(blobs: Sequence[bytes], device, names: Optional[Sequence[str]] = None) -> List[torch.Tensor]:
    """JPEG bytes -> RGB ``(H, W, 3)`` uint8 tensors on ``device``. On a CUDA
    device the whole list is one ``nvjpegDecodeBatched`` call on the current
    stream, into one buffer that the returned tensors view. ``names`` (one
    per blob, e.g. file paths) label errors."""
    global launches
    device = torch.device(device)
    if device.type == "cpu":
        return _decode_cpu(blobs, names)
    if device.type != "cuda":
        raise ValueError(f"jpeg.decode: no decoder on {device}")
    if not blobs:
        return []
    codec = _codec()
    lib = codec.lib
    n = len(blobs)
    h, w = ctypes.c_int(), ctypes.c_int()
    sizes = []
    with codec.lock, torch.cuda.device(device):
        for i, blob in enumerate(blobs):
            err = lib.ihpr_jpeg_info(codec.handle, blob, len(blob), ctypes.byref(h), ctypes.byref(w))
            if err or h.value <= 0 or w.value <= 0:
                raise ValueError(f"{_name(names, i)}: not a JPEG nvJPEG reads: {_status(err)}")
            sizes.append((h.value, w.value))
        offsets = np.cumsum([0] + [hh * ww * 3 for hh, ww in sizes])
        flat = torch.empty(int(offsets[-1]), dtype=torch.uint8, device=device)
        base = flat.data_ptr()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ihpr_jpeg_decode_batch(
            codec.handle, n, (ctypes.c_char_p * n)(*blobs), (ctypes.c_size_t * n)(*map(len, blobs)),
            (_P * n)(*[base + int(o) for o in offsets[:-1]]), (ctypes.c_int * n)(*[ww for _, ww in sizes]),
            stream,
        )
        if err:
            # Find the file at fault: decode them one at a time, then raise.
            for i, blob in enumerate(blobs):
                one = lib.ihpr_jpeg_decode_one(codec.handle, blob, len(blob), base + int(offsets[i]),
                                               sizes[i][1], stream)
                if one:
                    raise ValueError(f"{_name(names, i)}: nvJPEG could not decode it: {_status(one)}")
            raise RuntimeError(f"nvjpegDecodeBatched of {n} images failed: {_status(err)}")
        launches += 1
    return [flat[int(o) : int(o) + hh * ww * 3].view(hh, ww, 3) for o, (hh, ww) in zip(offsets, sizes)]


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
