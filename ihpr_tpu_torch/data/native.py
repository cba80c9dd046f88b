"""ctypes binding to the native host-warp library (``native/warp.cc``).

The same C++ source and shared library the JAX package uses. The library
is built by ``native/build.sh`` at first use, and rebuilt when ``warp.cc``
is newer than the ``.so``. ``available()`` says whether it could be built
and loaded, and ``unavailable_reason()`` why not; the loader and the server
then take the device warp (``data/warp.py:affine_warp_bilinear``), as the
JAX package does, and log that reason. ``warp_batch`` itself raises when the
library is missing: it has no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from typing import Sequence

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE = os.path.join(_ROOT, "native")
_SO = os.path.join(_NATIVE, "libihprwarp.so")


def _build_and_open() -> ctypes.CDLL:
    src = os.path.join(_NATIVE, "warp.cc")
    if not os.path.exists(src):
        raise RuntimeError(f"native warp source missing: {src}")
    if not os.path.exists(_SO) or os.path.getmtime(src) > os.path.getmtime(_SO):
        proc = subprocess.run(
            ["sh", os.path.join(_NATIVE, "build.sh")], capture_output=True
        )
        if proc.returncode != 0:
            raise RuntimeError(
                "building the native warp library failed (native/build.sh):\n"
                + proc.stderr.decode(errors="replace")[-2000:]
            )
    lib = ctypes.CDLL(_SO)
    lib.warp_batch_u8.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),  # srcs
        ctypes.POINTER(ctypes.c_int32),  # dims
        ctypes.c_int,  # ch
        ctypes.POINTER(ctypes.c_float),  # invs
        ctypes.POINTER(ctypes.c_int32),  # flips
        ctypes.POINTER(ctypes.c_uint8),  # dst
        ctypes.c_int,  # batch
        ctypes.c_int,  # oh
        ctypes.c_int,  # ow
    ]
    lib.warp_batch_u8.restype = None
    return lib


@functools.cache
def _load():
    """(library, None), or (None, why it could not be built or loaded)."""
    try:
        return _build_and_open(), None
    except (RuntimeError, OSError) as e:
        return None, f"{type(e).__name__}: {e}"


def available() -> bool:
    """True when the native library was built (or found) and loaded."""
    return _load()[0] is not None


def unavailable_reason() -> str | None:
    """Why ``available()`` is False (the build's or the load's error), else None."""
    return _load()[1]


def _lib() -> ctypes.CDLL:
    lib, why = _load()
    if lib is None:
        raise RuntimeError(f"the native warp library is unavailable: {why}")
    return lib


def warp_batch(
    images: Sequence[np.ndarray],
    inv_mats: np.ndarray,
    flips: np.ndarray,
    out_h: int,
    out_w: int,
) -> np.ndarray:
    """Warp B variable-size uint8 HWC images -> (B, out_h, out_w, C) uint8.

    inv_mats: (B, 2, 3) DESTINATION->SOURCE affines; flips: (B,) bool,
    mirroring source x before sampling. Borders are constant zero.
    """
    batch = len(images)
    if batch == 0:
        raise ValueError("warp_batch needs at least one image")
    imgs = [np.ascontiguousarray(im, dtype=np.uint8) for im in images]
    ch = imgs[0].shape[2]
    if any(im.ndim != 3 or im.shape[2] != ch for im in imgs):
        raise ValueError("images must all be HWC with the same channel count")
    invs = np.ascontiguousarray(inv_mats, np.float32).reshape(batch, 6)
    fl = np.ascontiguousarray(flips, np.int32).reshape(batch)
    lib = _lib()
    srcs = (ctypes.c_void_p * batch)(
        *[im.ctypes.data_as(ctypes.c_void_p).value for im in imgs]
    )
    dims = np.asarray([[im.shape[0], im.shape[1]] for im in imgs], np.int32)
    out = np.empty((batch, out_h, out_w, ch), np.uint8)
    lib.warp_batch_u8(
        srcs,
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ch,
        invs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        fl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        batch,
        out_h,
        out_w,
    )
    return out
