"""PyTorch port: PNG input and output (utils/image.py, utils/
native_imageio.py) against the JAX package's. The port's decoder (no PIL)
must give exactly the pixels of the reference's load_png (PIL) on PNGs
written by both encoders, by PIL in its modes, and on PNGs this file builds
with every scanline filter; what it does not decode (16-bit, interlaced)
raises. The native codec builds from the port's own source (never the
prebuilt native/libimageio.so), atomically when processes build at once,
and encode_png falls back to the Python encoder without a compiler. Every
comparison is exact."""

import io
import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from openglraytracer_tpu.utils import image as j_image
from openglraytracer_tpu.utils import native_imageio as j_native
from openglraytracer_tpu_torch.utils import image as t_image
from openglraytracer_tpu_torch.utils import native_imageio as t_native

import _torch_helpers  # noqa: F401  (one torch thread per worker)

RNG = np.random.default_rng(12)


def _write(tmp_path, name, data: bytes) -> str:
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


def _assert_loads_like_pil(path):
    got = t_image.load_png(path)
    want = j_image.load_png(path)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _smooth(h, w, c):
    """A field with runs and gradients, so that PIL's adaptive filter picks
    more than one filter type."""
    base = RNG.integers(0, 256, (h // 4 + 1, w // 4 + 1, c), np.uint8)
    img = np.repeat(np.repeat(base, 4, 0), 4, 1)[:h, :w]
    ramp = (np.arange(w, dtype=np.uint16)[None, :, None] * 3) % 256
    return ((img.astype(np.uint16) + ramp) % 256).astype(np.uint8)


def test_load_png_of_both_encoders(tmp_path):
    rgb = _smooth(19, 27, 3)
    for name, data in [("py", t_image.encode_png_py(rgb)),
                       ("native", t_native.encode_png(rgb)),
                       ("ref_py", j_image.encode_png_py(rgb))]:
        path = _write(tmp_path, f"{name}.png", data)
        _assert_loads_like_pil(path)
        np.testing.assert_array_equal(t_image.decode_png(data), rgb)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_load_png_of_pil_modes(tmp_path, mode):
    rgb = _smooth(33, 41, 3)
    img = Image.fromarray(rgb, "RGB")
    if mode == "RGBA":
        img = Image.fromarray(np.concatenate(
            [rgb, _smooth(33, 41, 1)], axis=-1), "RGBA")
    elif mode == "P":
        img = img.quantize(64)
    elif mode != "RGB":
        img = img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, "PNG")
    _assert_loads_like_pil(_write(tmp_path, f"{mode}.png", buf.getvalue()))


def _filter_rows(px: np.ndarray, bpp: int) -> bytes:
    """Scanlines of px (h, stride) uint8, row y filtered with type y % 5."""
    out = []
    prior = [0] * px.shape[1]
    for y, row in enumerate(px.tolist()):
        kind = y % 5
        line = []
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) >> 1
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            line.append((x - pred) & 0xFF)
        out.append(bytes([kind] + line))
        prior = row
    return b"".join(out)


def _png(w, h, depth, ctype, idat, interlace=0, extra=()):
    chunks = [j_image._png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))]
    chunks += [j_image._png_chunk(tag, body) for tag, body in extra]
    chunks += [j_image._png_chunk(b"IDAT", zlib.compress(idat)),
               j_image._png_chunk(b"IEND", b"")]
    return b"\x89PNG\r\n\x1a\n" + b"".join(chunks)


@pytest.mark.parametrize("ctype,ch", [(2, 3), (6, 4), (0, 1), (4, 2), (3, 1)])
def test_load_png_every_filter_type(tmp_path, ctype, ch):
    """Rows filtered 0, 1, 2, 3, 4, 0, ... with bytes that wrap mod 256."""
    h, w = 12, 9
    px = RNG.integers(0, 256, (h, w * ch), np.uint8)
    extra = ()
    if ctype == 3:
        px = RNG.integers(0, 16, (h, w), np.uint8)
        extra = [(b"PLTE", RNG.integers(0, 256, (16, 3), np.uint8).tobytes())]
    data = _png(w, h, 8, ctype, _filter_rows(px, ch), extra=extra)
    _assert_loads_like_pil(_write(tmp_path, f"f{ctype}.png", data))


def test_load_png_rejects_what_it_does_not_decode(tmp_path):
    px = np.zeros((4, 1 + 4 * 6), np.uint8).tobytes()
    with pytest.raises(ValueError, match="bit depth 16"):
        t_image.load_png(_write(tmp_path, "d16.png", _png(4, 4, 16, 2, px)))
    with pytest.raises(ValueError, match="Adam7"):
        t_image.load_png(_write(tmp_path, "il.png",
                                _png(4, 4, 8, 2, px, interlace=1)))
    good = bytearray(t_image.encode_png_py(np.zeros((2, 2, 3), np.uint8)))
    good[-14] ^= 1      # the IDAT chunk's CRC
    with pytest.raises(ValueError, match="CRC"):
        t_image.decode_png(bytes(good))


def test_to_uint8_device_equals_to_uint8():
    img = RNG.normal(0.5, 0.6, (23, 17, 3)).astype(np.float32)
    img[0, 0] = [0.0, 1.0, 0.5]
    got = t_image.to_uint8_device(torch.from_numpy(img))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), j_image.to_uint8(img))
    np.testing.assert_array_equal(got.numpy(), t_image.to_uint8(img))


def test_native_encoder_matches_the_reference():
    t_native._load()        # the port's codec builds and loads here
    rgb = RNG.integers(0, 256, (33, 41, 3), np.uint8)
    assert t_native.encode_png(rgb) == j_native.encode_png(rgb)
    assert t_image.encode_png(rgb) == j_native.encode_png(rgb)
    img = RNG.normal(0.5, 0.5, (19, 27, 3)).astype(np.float32)
    np.testing.assert_array_equal(t_native.tonemap_u8(img),
                                  j_image.to_uint8(img))


def test_save_load_round_trip(tmp_path):
    img = np.linspace(0, 1, 16 * 8 * 3, dtype=np.float32).reshape(16, 8, 3)
    path = str(tmp_path / "rt.png")
    t_image.save_png(torch.from_numpy(img), path)
    back = t_image.load_png(path)
    assert back.shape == (16, 8, 3)
    np.testing.assert_array_equal(
        back, j_image.to_uint8(img)[::-1].astype(np.float32) / 255.0)
    np.testing.assert_allclose(back, img, atol=1.0 / 255.0)
    j_image.save_png(img, str(tmp_path / "ref.png"))
    assert (tmp_path / "ref.png").read_bytes() == open(path, "rb").read()


REPO = Path(__file__).resolve().parents[1]


def test_native_codec_builds_from_the_ports_source():
    """In a fresh process (this one has the JAX package's library loaded):
    the codec the port maps is built from openglraytracer_tpu_torch/native/
    imageio.cpp into the package's _build/, and the prebuilt
    native/libimageio.so is never mapped."""
    code = ("import numpy as np;"
            "from openglraytracer_tpu_torch.utils import image, "
            "native_imageio as n;"
            "image.encode_png(np.zeros((2, 2, 3), np.uint8));"
            "image.yuv420_to_jpeg(np.zeros((2, 2), np.uint8), "
            "np.zeros((1, 1), np.uint8), np.zeros((1, 1), np.uint8));"
            "print(n.SOURCE);"
            "print(open('/proc/self/maps').read())")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    source, maps = proc.stdout.split("\n", 1)
    assert Path(source) == (REPO / "openglraytracer_tpu_torch" / "native"
                            / "imageio.cpp")
    mapped = {line.split()[-1] for line in maps.splitlines()
              if line.endswith(".so")}
    ours = [m for m in mapped if "libimageio" in m]
    assert ours and all(
        Path(m).parent.parent == REPO / "openglraytracer_tpu_torch" / "_build"
        and Path(m).parent.name.startswith("imageio-") for m in ours), ours
    assert not [m for m in mapped if m.endswith("native/libimageio.so")]


def test_native_codec_builds_atomically(tmp_path):
    """Three processes building into one empty root at once each get the
    same whole library, and no temporary directory is left behind."""
    code = ("import sys; from pathlib import Path;"
            "from openglraytracer_tpu_torch.utils import native_imageio as n;"
            "path, cmd = n.build(Path(sys.argv[1]));"
            "import ctypes; ctypes.CDLL(str(path)).oglrt_encode_gif;"
            "print(path, bool(cmd))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    paths = {o.split()[0] for o, _ in outs}
    assert len(paths) == 1
    assert [p.name for p in tmp_path.iterdir()] == [Path(*paths).parent.name]
    assert t_native.build(tmp_path)[1] == []     # built already


def test_encode_png_falls_back_without_a_compiler(monkeypatch, tmp_path):
    """No $CXX and nothing on PATH: the build raises OSError naming the
    compiler, encode_png writes the Python encoder's bytes, and the JPEG
    encoder (which has no fallback) raises."""
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(t_native, "BUILD_ROOT", tmp_path / "build")
    t_native._library.cache_clear()
    try:
        with pytest.raises(OSError, match="C\\+\\+ compiler"):
            t_native.build()
        rgb = RNG.integers(0, 256, (5, 7, 3), np.uint8)
        assert t_image.encode_png(rgb) == t_image.encode_png_py(rgb)
        with pytest.raises(OSError, match="compiler"):
            t_image._rgb_to_jpeg(rgb)
    finally:
        t_native._library.cache_clear()
