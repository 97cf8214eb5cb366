"""ctypes bindings of the native C++ image encoder (native/imageio.cpp).

Port of ``openglraytracer_tpu/utils/native_imageio.py``: loads the prebuilt
``native/libimageio.so`` at the repository root (it needs only libz and
libc); ``utils/image.encode_png`` falls back to the pure-Python encoder when
it does not load. ctypes releases the interpreter lock during a foreign
call, so threads encode in parallel (the live viewer's workers do)."""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np


@functools.cache
def _load() -> ctypes.CDLL:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    lib = ctypes.CDLL(os.path.join(root, "native", "libimageio.so"))
    lib.oglrt_encode_png.restype = ctypes.c_long
    lib.oglrt_encode_png.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
    lib.oglrt_tonemap_u8.restype = None
    lib.oglrt_tonemap_u8.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int]
    lib.oglrt_free.restype = None
    lib.oglrt_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    return lib


def _rgb_shape(img: np.ndarray) -> tuple[int, int]:
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"want an (H, W, 3) image, got {img.shape}")
    return img.shape[0], img.shape[1]


def tonemap_u8(image: np.ndarray) -> np.ndarray:
    """float (H, W, 3) [0,1] row-0-bottom -> uint8 (H, W, 3) row-0-top."""
    lib = _load()
    img = np.ascontiguousarray(image, np.float32)
    h, w = _rgb_shape(img)
    out = np.empty((h, w, 3), np.uint8)
    lib.oglrt_tonemap_u8(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w)
    return out


def encode_png(rgb8: np.ndarray) -> bytes:
    """(H, W, 3) uint8 top-first -> PNG bytes via the native encoder."""
    lib = _load()
    arr = np.ascontiguousarray(rgb8, np.uint8)
    h, w = _rgb_shape(arr)
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = lib.oglrt_encode_png(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        ctypes.byref(out))
    if n < 0:
        raise RuntimeError("native PNG encode failed")
    try:
        return ctypes.string_at(out, n)
    finally:
        lib.oglrt_free(out)
