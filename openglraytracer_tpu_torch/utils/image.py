"""Image output: float image -> PNG bytes/file.

Port of the host-side part of ``openglraytracer_tpu/utils/image.py``: the
image is copied to the host, clamped to [0, 1], quantized to 8 bits, its
rows flipped (row 0 of a render is the bottom, GL convention; PNG stores
the top first) and written by a pure-Python PNG encoder. The reference's
native encoder is not used by this package yet.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def to_uint8(image) -> np.ndarray:
    """Clamp [0,1] float (H, W, 3) -> uint8, flipping rows to top-first."""
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    img = np.clip(np.asarray(image), 0.0, 1.0)
    img = (img * 255.0 + 0.5).astype(np.uint8)
    return img[::-1]  # GL row 0 = bottom -> PNG row 0 = top


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    chunk = tag + data
    return struct.pack(">I", len(data)) + chunk + \
        struct.pack(">I", zlib.crc32(chunk) & 0xFFFFFFFF)


def encode_png_py(rgb8: np.ndarray) -> bytes:
    """Pure-Python PNG encoder for (H, W, 3) uint8."""
    h, w, c = rgb8.shape
    if c != 3 or rgb8.dtype != np.uint8:
        raise ValueError(f"encode_png_py wants (H, W, 3) uint8, got "
                         f"{rgb8.shape} {rgb8.dtype}")
    raw = b"".join(b"\x00" + rgb8[i].tobytes() for i in range(h))
    return b"".join([
        b"\x89PNG\r\n\x1a\n",
        _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
        _png_chunk(b"IDAT", zlib.compress(raw, 6)),
        _png_chunk(b"IEND", b""),
    ])


def save_png(image, path: str) -> None:
    """Save a float (H, W, 3) image (tensor on any device, or array) as PNG."""
    with open(path, "wb") as f:
        f.write(encode_png_py(to_uint8(image)))
