"""Primary camera ray generation.

Port of ``openglraytracer_tpu/ops/raygen.py``: NDC coords from integer pixel
ids, two clip-space points at z=0.5 and z=1.0 unprojected through
inverse(proj @ view) with w-divide, origin at the camera position, direction
normalize(end - start). Row 0 is the bottom of the image (GL convention).

Every op rounds as the JAX package's on the CPU (the camera inverse, the
pairwise unprojection sums, the fused |d|^2), so the rays are the
reference's bit for bit at the c3, c5 and OBB cameras.

The reference's integer division is kept: ``(pixel.x - width/2) /
(width/2)`` divides by the integer half width, so odd resolutions match.
"""

from __future__ import annotations

import torch

from openglraytracer_tpu_torch.models.scene import Camera
from openglraytracer_tpu_torch.ops.transforms import _fma, camera_matrices


def pixel_ndc(height: int, width: int, dtype=torch.float32, device="cuda",
              rows: slice | None = None, cols: slice | None = None):
    """Per-pixel NDC xy coords, shape (H, W) each, on ``device`` (the GPU
    unless asked otherwise, as every builder of the port). rows and cols
    cut the pixel grid to a tile, of the same values: each pixel's coords
    depend on its own ids only."""
    half_w = width // 2
    half_h = height // 2
    r = range(height)[rows] if rows is not None else range(height)
    c = range(width)[cols] if cols is not None else range(width)
    px = torch.arange(c.start, c.stop, c.step, dtype=dtype, device=device)
    py = torch.arange(r.start, r.stop, r.step, dtype=dtype, device=device)
    x = (px - half_w) / half_w
    y = (py - half_h) / half_h
    shape = (len(r), len(c))
    return x[None, :].expand(shape), y[:, None].expand(shape)


def unproject(inv_vp, x, y, z: float):
    """inverse-viewproj @ (x, y, z, 1) with w-divide; x/y arbitrary shape.
    Each row's 4-term product is summed pairwise, (x m0 + y m1) + (z m2 +
    m3), every op rounded once: the JAX package's float32 matmul rounds so
    on the CPU, jitted or not."""
    xs, ys = x[..., None], y[..., None]
    world = ((xs * inv_vp[:, 0] + ys * inv_vp[:, 1])
             + (z * inv_vp[:, 2] + inv_vp[:, 3]))
    return world[..., :3] / world[..., 3:4]


def generate_rays(cam: Camera, height: int, width: int,
                  rows: slice | None = None, cols: slice | None = None):
    """Returns (origins (H,W,3), dirs (H,W,3)) world-space primary rays on
    the camera's device; with rows and cols, those of that tile of the
    image alone, equal bit for bit to the whole image's cut to it."""
    _, _, inv_vp = camera_matrices(cam)
    x, y = pixel_ndc(height, width, dtype=cam.position.dtype,
                     device=cam.position.device, rows=rows, cols=cols)
    start = unproject(inv_vp, x, y, 0.5)
    end = unproject(inv_vp, x, y, 1.0)
    d = end - start
    # |d|^2 with fused multiply-adds and a correctly rounded sqrt, as the
    # JAX package's jnp.linalg.norm rounds on the CPU
    dx, dy, dz = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    n2 = _fma(dz, dz, _fma(dy, dy, dx * dx))
    d = d / torch.sqrt(n2.double()).to(d.dtype)
    origins = cam.position.expand(d.shape)
    return origins, d
