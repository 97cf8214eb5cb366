"""PyTorch port: the native animated-GIF encoder (native/imageio.cpp
oglrt_encode_gif through utils/native_imageio.encode_gif), which ``cli
animate --gif`` writes with, against PIL's GIF writer, which the
reference's CLI calls. PIL must read the port's file with the frame count,
size, per-frame duration and loop of PIL's own file of the same frames;
each frame's mean absolute error against its RGB source must be at most
that of PIL's file plus 1.0 code value (both quantize to 256 colours with
a median cut); frames of at most 256 colours come back exactly, through
several LZW table clears."""

import io

import numpy as np
import pytest
import torch
from PIL import Image

from openglraytracer_tpu_torch.models.animated import reference_frame
from openglraytracer_tpu_torch.ops.render import render
from openglraytracer_tpu_torch.utils.image import to_uint8
from openglraytracer_tpu_torch.utils.native_imageio import encode_gif

import _torch_helpers  # noqa: F401  (one torch thread per worker)


def _read(data: bytes):
    """(frame count, size, durations, loop, RGB frames) as PIL reads them."""
    im = Image.open(io.BytesIO(data))
    frames, durations = [], []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert("RGB")))
        durations.append(im.info.get("duration"))
    return im.n_frames, im.size, durations, im.info.get("loop"), frames


def _pil_gif(frames, duration_ms: int) -> bytes:
    ims = [Image.fromarray(f) for f in frames]
    buf = io.BytesIO()
    ims[0].save(buf, "GIF", save_all=True, append_images=ims[1:],
                duration=duration_ms, loop=0)
    return buf.getvalue()


def _renders(h, w, n):
    out = []
    for i in range(n):
        scene, cam = reference_frame(0.4 + i / 10, device="cpu")
        with torch.no_grad():
            out.append(to_uint8(render(scene, cam, h, w, engine="xla")))
    return np.stack(out)


def _gradients(h, w, n, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = [np.stack([(xx * 255 // w + 40 * i) % 256, yy * 255 // h,
                        ((xx + yy) * 128 // (h + w) + 20 * i) % 256], -1)
              for i in range(n)]
    noisy = np.stack(frames) + rng.integers(-6, 7, (n, h, w, 3))
    return np.clip(noisy, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("kind,hw,fps", [("render", (36, 64), 30.0),
                                         ("render", (45, 80), 12.0),
                                         ("gradients", (60, 90), 30.0)])
def test_gif_reads_like_pils(kind, hw, fps):
    frames = (_renders(*hw, 3) if kind == "render"
              else _gradients(*hw, 3, seed=hw[0]))
    duration = int(1000 / fps)          # what the reference's CLI passes
    got = _read(encode_gif(frames, duration // 10, loop=0))
    want = _read(_pil_gif(list(frames), duration))
    assert got[:4] == want[:4]
    assert got[0] == 3 and got[1] == (hw[1], hw[0]) and got[3] == 0
    assert got[2] == [duration // 10 * 10] * 3
    for ours, pils, src in zip(got[4], want[4], frames):
        err = np.abs(ours.astype(np.int16) - src).mean()
        pil_err = np.abs(pils.astype(np.int16) - src).mean()
        assert err <= pil_err + 1.0, (err, pil_err)


@pytest.mark.parametrize("colours,hw", [(256, (200, 300)), (129, (64, 64)),
                                        (2, (16, 16)), (1, (3, 5))])
def test_gif_is_lossless_at_256_colours_or_fewer(colours, hw):
    """Random indices into a random palette: the median cut keeps every
    colour, and the LZW stream (which clears its table several times on
    the 200x300 frames of white-noise indices) decodes exactly; palettes
    of 2 and 1 colours use the minimum code size of 2."""
    rng = np.random.default_rng(colours)
    palette = rng.permutation(256 ** 3)[:colours]
    rgb = np.stack([palette >> 16, (palette >> 8) & 255, palette & 255],
                   -1).astype(np.uint8)
    frames = rgb[rng.integers(0, colours, (2, *hw))]
    n, size, durations, loop, back = _read(encode_gif(frames, 7, loop=3))
    assert (n, size, durations, loop) == (2, (hw[1], hw[0]), [70, 70], 3)
    for a, b in zip(back, frames):
        np.testing.assert_array_equal(a, b)


def _blocks(data: bytes):
    """The GIF's structure: header, loop count, each frame's delay and
    descriptor, the trailer (a walk over its blocks)."""
    assert data[:6] == b"GIF89a"
    flags = data[10]
    pos = 13 + (3 * 2 ** ((flags & 7) + 1) if flags & 0x80 else 0)
    loop, delays, images = None, [], []
    while data[pos] != 0x3B:
        if data[pos] == 0x21:
            label, pos = data[pos + 1], pos + 2
            body = b""
            while data[pos]:
                body += data[pos + 1:pos + 1 + data[pos]]
                pos += 1 + data[pos]
            pos += 1
            if label == 0xFF and body.startswith(b"NETSCAPE2.0"):
                loop = int.from_bytes(body[12:14], "little")
            elif label == 0xF9:
                delays.append(int.from_bytes(body[1:3], "little"))
        else:
            assert data[pos] == 0x2C
            w, h = (int.from_bytes(data[pos + i:pos + i + 2], "little")
                    for i in (5, 7))
            flags = data[pos + 9]
            images.append((w, h))
            pos += 10 + (3 * 2 ** ((flags & 7) + 1) if flags & 0x80 else 0)
            pos += 1                                    # LZW code size
            while data[pos]:
                pos += 1 + data[pos]
            pos += 1
    assert pos == len(data) - 1
    return loop, delays, images


def test_gif_structure():
    frames = _gradients(20, 30, 3, seed=5)
    loop, delays, images = _blocks(encode_gif(frames, 3, loop=0))
    assert loop == 0 and delays == [3, 3, 3] and images == [(30, 20)] * 3


def test_gif_rejects_bad_frames():
    with pytest.raises(ValueError, match=r"\(N, H, W, 3\)"):
        encode_gif(np.zeros((4, 4, 3), np.uint8), 3)
    with pytest.raises(ValueError, match=r"\(N, H, W, 3\)"):
        encode_gif(np.zeros((0, 4, 4, 3), np.uint8), 3)
    with pytest.raises(ValueError, match="16-bit"):
        encode_gif(np.zeros((1, 4, 4, 3), np.uint8), 65536)
