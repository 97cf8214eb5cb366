"""Image output and input: float image <-> PNG bytes/file, and the live
viewer's 4:2:0 JPEG transport.

Port of ``openglraytracer_tpu/utils/image.py``: the image is clamped to
[0, 1], quantized to 8 bits and its rows flipped (row 0 of a render is the
bottom, GL convention; PNG stores the top first), on the host
(``to_uint8``) or on the tensor's device (``to_uint8_device``, so that a
frame crosses to the host at 1 byte a channel), and encoded by the port's
native C++ codec (``native/imageio.cpp``, built at first use,
utils/native_imageio.py) when it loads, else by the pure-Python one.
``to_yuv420_device`` and ``pack_yuv420_device`` turn a frame into
full-range BT.601 planes with 2x2-subsampled chroma on the device (1.5
bytes a pixel cross to the host), ``unpack_yuv420`` splits them on the
host and ``yuv420_to_jpeg`` encodes them with the native JPEG encoder.
``load_png`` reads a PNG back without PIL, which the port does not depend
on: a chunk walk with CRC checks, zlib inflate and the five scanline
filters, for 8-bit grey, RGB, palette, grey + alpha and RGBA files (mapped
to RGB as PIL's ``convert("RGB")`` does: alpha dropped, grey repeated).
Other bit depths and Adam7 interlace raise ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from openglraytracer_tpu_torch.utils.profiling import span

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> bytes a pixel at bit depth 8
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def to_uint8(image) -> np.ndarray:
    """Clamp [0,1] float (H, W, 3) -> uint8, flipping rows to top-first."""
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    img = np.clip(np.asarray(image), 0.0, 1.0)
    img = (img * 255.0 + 0.5).astype(np.uint8)
    return img[::-1]  # GL row 0 = bottom -> PNG row 0 = top


def to_uint8_device(image: torch.Tensor) -> torch.Tensor:
    """to_uint8 on the tensor's device: the same clamp, quantization and
    row flip, so a frame is fetched at 1 byte a channel; equal to
    to_uint8 byte for byte."""
    with span("quantize", "to_uint8_device"):
        img = torch.clamp(image, 0.0, 1.0)
        return (img * 255.0 + 0.5).to(torch.uint8).flip(0)


def to_yuv420_device(image: torch.Tensor):
    """[0,1] float (H, W, 3) -> (Y (H, W), Cb (H/2, W/2), Cr (H/2, W/2))
    uint8 planes on the tensor's device, rows flipped top-first; H and W
    even. Full-range BT.601 (JFIF's YCbCr) with the reference's constants
    and order of operations, each a separate float32 op; the chroma is the
    mean of each 2x2 block (summed left to right, then down) before it is
    quantized."""
    img = torch.clamp(image, 0.0, 1.0).flip(0)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 0.5 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 0.5 + 0.5 * r - 0.418688 * g - 0.081312 * b

    def q(x):
        return (torch.clamp(x, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)

    def pool2(x):
        h, w = x.shape
        x = x.reshape(h // 2, 2, w // 2, 2)
        return (x[:, 0, :, 0] + x[:, 0, :, 1] + x[:, 1, :, 0]
                + x[:, 1, :, 1]) / 4.0

    return q(y), q(pool2(cb)), q(pool2(cr))


def pack_yuv420_device(image: torch.Tensor) -> torch.Tensor:
    """to_yuv420_device packed into one flat uint8 tensor (Y | Cb | Cr),
    so that a frame crosses to the host in one copy."""
    y, cb, cr = to_yuv420_device(image)
    return torch.cat([y.reshape(-1), cb.reshape(-1), cr.reshape(-1)])


def unpack_yuv420(buf, height: int, width: int):
    """Host-side inverse of pack_yuv420_device -> (Y, Cb, Cr) arrays."""
    buf = np.asarray(buf)
    hw = height * width
    q = hw // 4
    return (buf[:hw].reshape(height, width),
            buf[hw:hw + q].reshape(height // 2, width // 2),
            buf[hw + q:hw + 2 * q].reshape(height // 2, width // 2))


def yuv420_to_jpeg(y, cb, cr, quality: int = 85) -> bytes:
    """JPEG of 4:2:0 planes (rows top-first) by the native encoder: the
    bytes PIL writes for the YCbCr image of the planes with the chroma
    repeated 2x2, as the reference encodes them."""
    from openglraytracer_tpu_torch.utils import native_imageio
    return native_imageio.encode_jpeg_yuv420(y, cb, cr, quality)


def _rgb_to_jpeg(rgb8: np.ndarray, quality: int = 85) -> bytes:
    """JPEG (4:2:0) of (H, W, 3) uint8 top-first by the native encoder:
    the bytes of PIL's ``Image.fromarray(rgb8).save(buf, "JPEG",
    quality=quality)``, the reference viewer's 'rgb' transport."""
    from openglraytracer_tpu_torch.utils import native_imageio
    return native_imageio.encode_jpeg_rgb(rgb8, quality)


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
        _SIGNATURE,
        _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
        _png_chunk(b"IDAT", zlib.compress(raw, 6)),
        _png_chunk(b"IEND", b""),
    ])


def encode_png(rgb8: np.ndarray) -> bytes:
    """PNG-encode (H, W, 3) uint8 top-first, with the native encoder when
    its library loads, else encode_png_py."""
    from openglraytracer_tpu_torch.utils import native_imageio
    try:
        native_imageio._load()
    except OSError:
        return encode_png_py(rgb8)
    return native_imageio.encode_png(rgb8)


def _chunks(data: bytes):
    """(tag, body) of each chunk up to IEND, each CRC checked."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while True:
        if pos + 12 > len(data):
            raise ValueError("PNG truncated before IEND")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"PNG chunk {tag!r} truncated")
        if struct.unpack(">I", crc)[0] != zlib.crc32(tag + body) & 0xFFFFFFFF:
            raise ValueError(f"PNG chunk {tag!r} fails its CRC check")
        yield tag, body
        if tag == b"IEND":
            return
        pos += 12 + length


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the scanline filters: (h, stride) uint8. None, Sub and Up are
    whole-row numpy operations (Sub a running sum mod 256 per byte of the
    pixel); Average and Paeth depend on the byte to their left as it is
    decoded, so their rows run a loop over the row's bytes."""
    if len(raw) < h * (stride + 1):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, want "
                         f"{h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(
        h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint64).astype(np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prior      # uint8 arithmetic wraps mod 256
        elif kind in (3, 4):
            x, up = bytearray(line.tobytes()), prior.tobytes()
            for i in range(stride):
                a = x[i - bpp] if i >= bpp else 0
                if kind == 3:
                    x[i] = (x[i] + ((a + up[i]) >> 1)) & 0xFF
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    x[i] = (x[i] + _paeth(a, up[i], c)) & 0xFF
            cur = np.frombuffer(bytes(x), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has filter type {kind} (0-4)")
        out[y] = cur
        prior = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8, rows top-first, as PIL's
    ``Image.open(...).convert("RGB")`` gives them."""
    ihdr, plte, idat = None, None, []
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not a PNG colour type")
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth} is not supported (8 only)")
    if interlace != 0:
        raise ValueError("PNG with Adam7 interlace is not supported")
    ch = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch).reshape(
        h, w, ch)
    if ctype == 2:
        return px
    if ctype == 6:
        return np.ascontiguousarray(px[..., :3])
    if ctype == 3:
        if plte is None:
            raise ValueError("palette PNG has no PLTE chunk")
        if int(px.max(initial=0)) >= len(plte):
            raise ValueError("palette PNG indexes past its PLTE chunk")
        return plte[px[..., 0]]
    return np.repeat(px[..., :1], 3, axis=-1)       # grey, grey + alpha


def load_png(path: str) -> np.ndarray:
    """PNG -> float32 (H, W, 3) in [0, 1], rows flipped back to the render's
    GL convention (row 0 = bottom), so ``load_png(save_png(img)) ~= img`` and
    a loaded file can serve directly as an inverse-rendering target."""
    with open(path, "rb") as f:
        rgb8 = decode_png(f.read())
    return rgb8[::-1].astype(np.float32) / 255.0


def save_png(image, path: str, gather: bool = True) -> None:
    """Save a float (H, W, 3) image (tensor on any device, or array) as PNG.
    With gather and a process group of more than one rank, image is this
    rank's tile and the tiles are assembled first
    (parallel/distributed.gather_image)."""
    if gather:
        from openglraytracer_tpu_torch.parallel.distributed import (
            gather_image)
        image = gather_image(image)
    with open(path, "wb") as f:
        f.write(encode_png(to_uint8(image)))
