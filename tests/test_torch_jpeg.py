"""PyTorch port: the live viewer's 4:2:0 JPEG transport (utils/image.py
to_yuv420_device, pack_yuv420_device, unpack_yuv420, yuv420_to_jpeg) and
the native JPEG encoders (native/imageio.cpp through
utils/native_imageio.py) against the JAX package and PIL.

The planes are bit-equal to the JAX functions run op by op; under jax.jit
XLA may contract the weighted sums into fused multiply-adds, so the share
of codes that differ from the jitted reference is measured, printed and
held to at most one code value. The port's JPEG of YCbCr planes and of RGB
frames must decode (through PIL) to exactly the pixels of PIL's JPEG of the
same input as the reference calls it, at qualities 50, 85 and 95, on smooth
fields and on renders, at sizes that are and are not multiples of the
16x16 MCU; the files are byte-equal too."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from openglraytracer_tpu.utils import image as j_image
from openglraytracer_tpu_torch.models.animated import reference_frame
from openglraytracer_tpu_torch.ops.render import render
from openglraytracer_tpu_torch.utils import image as t_image
from openglraytracer_tpu_torch.utils import native_imageio as t_native

import _torch_helpers  # noqa: F401  (one torch thread per worker)

SIZES = [(36, 48), (40, 56), (360, 640)]
QUALITIES = [50, 85, 95]


def _smooth(h, w, seed):
    """A smooth field with fine noise: blocks of a coarse random image
    blended along rows and columns, plus a little Gaussian noise."""
    rng = np.random.default_rng(seed)
    base = rng.random((h // 6 + 2, w // 6 + 2, 3))
    ys = np.linspace(0, h // 6, h)
    xs = np.linspace(0, w // 6, w)
    iy, ix = ys.astype(int), xs.astype(int)
    fy, fx = (ys - iy)[:, None, None], (xs - ix)[None, :, None]
    img = ((1 - fy) * (1 - fx) * base[iy][:, ix]
           + fy * (1 - fx) * base[iy + 1][:, ix]
           + (1 - fy) * fx * base[iy][:, ix + 1]
           + fy * fx * base[iy + 1][:, ix + 1])
    img += 0.02 * rng.standard_normal((h, w, 3))
    return np.clip(img, -0.1, 1.1).astype(np.float32)


_RENDERS = {}


def _render(h, w):
    """The reference's animated world at t = 0.7, rendered on the plain
    dense engine (float (H, W, 3), row 0 at the bottom)."""
    if (h, w) not in _RENDERS:
        scene, cam = reference_frame(0.7, device="cpu")
        with torch.no_grad():
            _RENDERS[h, w] = render(scene, cam, h, w,
                                    engine="xla").numpy()
    return _RENDERS[h, w]


def _field(kind, h, w):
    return _smooth(h, w, h * w) if kind == "smooth" else _render(h, w)


def _decode(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _pil_jpeg(img: np.ndarray, mode: str, quality: int) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["smooth", "render"])
@pytest.mark.parametrize("hw", SIZES)
def test_to_yuv420_device_matches_jax(hw, kind, capsys):
    """Bit-equal to the JAX function run op by op; against jax.jit of it,
    at most one code value apart, with the share that differs printed."""
    img = _field(kind, *hw)
    got = [p.numpy() for p in t_image.to_yuv420_device(torch.from_numpy(img))]
    with jax.disable_jit():
        eager = [np.asarray(p)
                 for p in j_image.to_yuv420_device(jnp.asarray(img))]
    jitted = [np.asarray(p) for p in
              jax.jit(j_image.to_yuv420_device)(jnp.asarray(img))]
    h, w = hw
    shares = []
    for g, e, j, shape in zip(got, eager, jitted,
                              [(h, w), (h // 2, w // 2), (h // 2, w // 2)]):
        assert g.dtype == np.uint8 and g.shape == shape
        np.testing.assert_array_equal(g, e)
        d = np.abs(g.astype(np.int16) - j)
        assert int(d.max()) <= 1
        shares.append(f"{float((d > 0).mean()):.6f}")
    with capsys.disabled():
        print(f"\n  to_yuv420_device {kind} {h}x{w}: share of Y, Cb, Cr "
              f"codes one value from the jitted reference: {shares}")


def test_pack_unpack_yuv420_match_jax():
    img = _smooth(36, 48, 1)
    got = t_image.pack_yuv420_device(torch.from_numpy(img))
    want = np.asarray(j_image.pack_yuv420_device(jnp.asarray(img)))
    assert got.dtype == torch.uint8 and got.shape == (36 * 48 * 3 // 2,)
    np.testing.assert_array_equal(got.numpy(), want)
    for t_plane, j_plane in zip(t_image.unpack_yuv420(got, 36, 48),
                                j_image.unpack_yuv420(want, 36, 48)):
        np.testing.assert_array_equal(t_plane, j_plane)
    # a flat buffer with the overflow byte appended unpacks the same
    tail = np.concatenate([want, [7]]).astype(np.uint8)
    for t_plane, j_plane in zip(t_image.unpack_yuv420(tail, 36, 48),
                                j_image.unpack_yuv420(want, 36, 48)):
        np.testing.assert_array_equal(t_plane, j_plane)


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("kind", ["smooth", "render"])
@pytest.mark.parametrize("hw", SIZES)
def test_yuv420_jpeg_decodes_like_pil(hw, kind, quality):
    """yuv420_to_jpeg of the port's planes against the reference's
    yuv420_to_jpeg (PIL) of the same planes."""
    img = _field(kind, *hw)
    planes = [p.numpy() for p in
              t_image.to_yuv420_device(torch.from_numpy(img))]
    got = t_image.yuv420_to_jpeg(*planes, quality=quality)
    want = j_image.yuv420_to_jpeg(*planes, quality=quality)
    np.testing.assert_array_equal(_decode(got), _decode(want))
    assert got == want


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("kind", ["smooth", "render"])
@pytest.mark.parametrize("hw", SIZES)
def test_rgb_jpeg_decodes_like_pil(hw, kind, quality):
    """The 'rgb' transport's encoder against the reference viewer's
    ``Image.fromarray(host).save(buf, "JPEG", quality=quality)``."""
    rgb8 = t_image.to_uint8(_field(kind, *hw))
    got = t_image._rgb_to_jpeg(rgb8, quality=quality)
    want = _pil_jpeg(np.ascontiguousarray(rgb8), "RGB", quality)
    np.testing.assert_array_equal(_decode(got), _decode(want))
    assert got == want


@pytest.mark.parametrize("hw", [(1, 1), (17, 23), (9, 31), (33, 8),
                                (15, 16), (2, 130)])
def test_jpeg_edges_and_byte_stuffing(hw):
    """Odd sides and sides off the MCU grid (libjpeg's edge replication and
    dummy blocks), white noise at quality 100 (large coefficients and
    0xFF bytes stuffed with 0x00 in the scan) and quality 1 (tables
    clamped to 255): equal to PIL's file for RGB, and for YCbCr planes
    where the sides are even."""
    rng = np.random.default_rng(hw[0] * 131 + hw[1])
    rgb8 = rng.integers(0, 256, (*hw, 3), np.uint8)
    for quality in (1, 100):
        got = t_native.encode_jpeg_rgb(rgb8, quality)
        assert got == _pil_jpeg(rgb8, "RGB", quality)
        if quality == 100 and hw[0] * hw[1] > 64:
            assert b"\xff\x00" in got
        h, w = hw
        if h % 2 == 0 and w % 2 == 0:
            y, cb, cr = (rgb8[..., 0], rgb8[::2, ::2, 1],
                         np.ascontiguousarray(rgb8[1::2, 1::2, 2]))
            want = j_image.yuv420_to_jpeg(y, cb, cr, quality=quality)
            assert t_native.encode_jpeg_yuv420(y, cb, cr, quality) == want


def test_jpeg_rejects_bad_planes():
    y = np.zeros((6, 8), np.uint8)
    with pytest.raises(ValueError, match="even"):
        t_native.encode_jpeg_yuv420(np.zeros((5, 8), np.uint8),
                                    np.zeros((2, 4), np.uint8),
                                    np.zeros((2, 4), np.uint8), 85)
    with pytest.raises(ValueError, match="Cb, Cr"):
        t_native.encode_jpeg_yuv420(y, np.zeros((3, 3), np.uint8),
                                    np.zeros((3, 4), np.uint8), 85)
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        t_native.encode_jpeg_rgb(np.zeros((4, 4), np.uint8), 85)


def test_yuv420_transport_matches_rgb_jpeg():
    """The reference's test with the port's encoders: a YUV420-transported
    frame decodes to (almost) the same pixels as the RGB-transported one,
    since JPEG subsamples chroma to 4:2:0 anyway."""
    rng = np.random.default_rng(7)
    # smooth-ish field (JPEG murders white noise; the viewer ships renders)
    base = rng.random((9, 12, 3))
    img = torch.from_numpy(np.repeat(np.repeat(base, 4, 0), 4, 1)
                           .astype(np.float32))          # (36, 48, 3)
    jpeg_yuv = t_image.yuv420_to_jpeg(
        *[p.numpy() for p in t_image.to_yuv420_device(img)], quality=95)
    jpeg_rgb = t_image._rgb_to_jpeg(t_image.to_uint8_device(img).numpy(),
                                    quality=95)
    a = _decode(jpeg_yuv).astype(np.int16)
    b = _decode(jpeg_rgb).astype(np.int16)
    assert a.shape == b.shape
    err = np.abs(a - b)
    assert err.mean() < 3.0, f"mean {err.mean()}"
    assert np.percentile(err, 99) <= 12, f"p99 {np.percentile(err, 99)}"
