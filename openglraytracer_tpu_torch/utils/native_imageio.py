"""ctypes bindings of the port's native image codec (native/imageio.cpp
beside this package's modules).

Port of ``openglraytracer_tpu/utils/native_imageio.py``, with the library
built from the port's own source at first use: the host C++ compiler
(``$CXX``, else ``c++`` or ``g++`` on PATH) compiles ``native/imageio.cpp``
with ``-O3 -fPIC -shared -std=c++17`` and links zlib, into
``_build/imageio-<digest>/`` beside the package (listed in .gitignore),
where the digest covers the source, the compiler and the flags. The build
runs in a temporary directory that is renamed into place, so processes
that build at once each load a whole library. ``utils/image.encode_png``
falls back to the pure-Python encoder when the library does not build or
load; the JPEG and GIF encoders have no fallback. ctypes releases the
interpreter lock during a foreign call, so threads encode in parallel (the
live viewer's workers do)."""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "imageio.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
LIBS = ("-lz",)
LIB_NAME = "libimageio.so"

_U8P = ctypes.POINTER(ctypes.c_uint8)
_OUT = ctypes.POINTER(_U8P)
_I = ctypes.c_int
_SIGNATURES = {
    "oglrt_encode_png": [_U8P, _I, _I, _OUT],
    "oglrt_encode_jpeg_yuv420": [_U8P, _U8P, _U8P, _I, _I, _I, _OUT],
    "oglrt_encode_jpeg_rgb": [_U8P, _I, _I, _I, _OUT],
    "oglrt_encode_gif": [_U8P, _I, _I, _I, _I, _I, _OUT],
}


def find_compiler() -> str:
    """The host C++ compiler: ``$CXX``, else ``c++`` or ``g++`` on PATH;
    OSError when there is none."""
    for name in (os.environ.get("CXX"), "c++", "g++"):
        path = name and shutil.which(name)
        if path:
            return path
    raise OSError("no C++ compiler ($CXX, c++ or g++ on PATH) to build the "
                  f"native image codec from {SOURCE}")


def build(root: Path | None = None) -> tuple[Path, list]:
    """Compile the codec unless this digest is built already under root
    (default BUILD_ROOT). Returns the library's path and the compiler's
    command line (empty when the library was already there). OSError when
    it does not build."""
    root = Path(root or BUILD_ROOT)
    cxx = find_compiler()
    h = hashlib.sha256(" ".join((cxx,) + CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    final = root / f"imageio-{h.hexdigest()[:16]}"
    out = final / LIB_NAME
    if out.exists():
        return out, []
    root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=f".{final.name}.", dir=root))
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp / LIB_NAME), str(SOURCE), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise OSError(f"the native image codec did not build (exit "
                          f"{proc.returncode}): {' '.join(cmd)}\n"
                          f"{proc.stdout}{proc.stderr}")
        tmp.chmod(0o755)
        try:
            os.rename(tmp, final)   # atomic; fails if another build won
        except OSError:
            if not out.exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, cmd


@functools.cache
def _library() -> ctypes.CDLL | OSError:
    """The loaded codec, built first if needed, or the OSError that stopped
    it (kept, so that a failed build is not retried at every call)."""
    try:
        lib = ctypes.CDLL(str(build()[0]))
    except OSError as e:
        return e
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_long
    lib.oglrt_tonemap_u8.restype = None
    lib.oglrt_tonemap_u8.argtypes = [
        ctypes.POINTER(ctypes.c_float), _U8P, _I, _I]
    lib.oglrt_free.restype = None
    lib.oglrt_free.argtypes = [_U8P]
    return lib


def _load() -> ctypes.CDLL:
    """The loaded codec; OSError when it does not build or load."""
    lib = _library()
    if isinstance(lib, OSError):
        raise lib
    return lib


def _rgb_shape(img: np.ndarray) -> tuple[int, int]:
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"want an (H, W, 3) image, got {img.shape}")
    return img.shape[0], img.shape[1]


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(_U8P)


def _call(name: str, *args) -> bytes:
    """Call encoder ``name`` with args and the out pointer; the bytes it
    wrote, its buffer freed."""
    lib = _load()
    out = _U8P()
    n = getattr(lib, name)(*args, ctypes.byref(out))
    if n < 0:
        raise RuntimeError(f"native encoder {name} failed")
    try:
        return ctypes.string_at(out, n)
    finally:
        lib.oglrt_free(out)


def tonemap_u8(image: np.ndarray) -> np.ndarray:
    """float (H, W, 3) [0,1] row-0-bottom -> uint8 (H, W, 3) row-0-top."""
    lib = _load()
    img = np.ascontiguousarray(image, np.float32)
    h, w = _rgb_shape(img)
    out = np.empty((h, w, 3), np.uint8)
    lib.oglrt_tonemap_u8(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), _u8(out), h, w)
    return out


def encode_png(rgb8: np.ndarray) -> bytes:
    """(H, W, 3) uint8 top-first -> PNG bytes via the native encoder."""
    arr = np.ascontiguousarray(rgb8, np.uint8)
    h, w = _rgb_shape(arr)
    return _call("oglrt_encode_png", _u8(arr), h, w)


def encode_jpeg_yuv420(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                       quality: int) -> bytes:
    """Baseline JPEG of uint8 planes Y (H, W) and Cb, Cr (H/2, W/2), H and
    W even, rows top-first: the file libjpeg writes (as PIL calls it) of
    the YCbCr image whose chroma is each plane repeated 2x2."""
    y, cb, cr = (np.ascontiguousarray(p, np.uint8) for p in (y, cb, cr))
    h, w = y.shape if y.ndim == 2 else (1, 1)
    if (y.ndim != 2 or h % 2 or w % 2 or cb.shape != (h // 2, w // 2)
            or cr.shape != cb.shape):
        raise ValueError(f"want Y (H, W) with H, W even and Cb, Cr "
                         f"(H/2, W/2), got {y.shape}, {cb.shape}, {cr.shape}")
    return _call("oglrt_encode_jpeg_yuv420", _u8(y), _u8(cb), _u8(cr), h, w,
                 quality)


def encode_jpeg_rgb(rgb8: np.ndarray, quality: int) -> bytes:
    """Baseline 4:2:0 JPEG of (H, W, 3) uint8 top-first: the file libjpeg
    writes (as PIL calls it) of the RGB image."""
    arr = np.ascontiguousarray(rgb8, np.uint8)
    h, w = _rgb_shape(arr)
    return _call("oglrt_encode_jpeg_rgb", _u8(arr), h, w, quality)


def encode_gif(frames: np.ndarray, delay_cs: int, loop: int = 0) -> bytes:
    """Animated GIF89a of (N, H, W, 3) uint8 frames, rows top-first, each
    shown delay_cs hundredths of a second, looping loop times (0: for
    ever); each frame on its own median-cut palette of at most 256
    colours."""
    arr = np.ascontiguousarray(frames, np.uint8)
    if arr.ndim != 4 or arr.shape[3] != 3 or not arr.shape[0]:
        raise ValueError(f"want (N, H, W, 3) frames, got {arr.shape}")
    if not (0 <= delay_cs < 65536 and 0 <= loop < 65536):
        raise ValueError(f"delay {delay_cs} and loop {loop} are 16-bit "
                         "fields of the GIF")
    n, h, w, _ = arr.shape
    return _call("oglrt_encode_gif", _u8(arr), n, h, w, delay_cs, loop)
