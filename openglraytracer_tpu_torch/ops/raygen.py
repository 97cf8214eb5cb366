"""Primary camera ray generation.

Port of ``openglraytracer_tpu/ops/raygen.py``: NDC coords from integer pixel
ids, two clip-space points at z=0.5 and z=1.0 unprojected through
inverse(proj @ view) with w-divide, origin at the camera position, direction
normalize(end - start). Row 0 is the bottom of the image (GL convention).

The reference's integer division is kept: ``(pixel.x - width/2) /
(width/2)`` divides by the integer half width, so odd resolutions match.
"""

from __future__ import annotations

import torch

from openglraytracer_tpu_torch.models.scene import Camera
from openglraytracer_tpu_torch.ops.transforms import camera_matrices


def pixel_ndc(height: int, width: int, dtype=torch.float32, device="cuda"):
    """Per-pixel NDC xy coords, shape (H, W) each, on ``device`` (the GPU
    unless asked otherwise, as every builder of the port)."""
    half_w = width // 2
    half_h = height // 2
    px = torch.arange(width, dtype=dtype, device=device)
    py = torch.arange(height, dtype=dtype, device=device)
    x = (px - half_w) / half_w
    y = (py - half_h) / half_h
    return x[None, :].expand(height, width), y[:, None].expand(height, width)


def unproject(inv_vp, x, y, z: float):
    """inverse-viewproj @ (x, y, z, 1) with w-divide; x/y arbitrary shape."""
    clip = torch.stack([x, y, torch.full_like(x, z), torch.ones_like(x)],
                       dim=-1)                             # (..., 4)
    world = clip @ inv_vp.T      # float32 product: TF32 is off (transforms)
    return world[..., :3] / world[..., 3:4]


def generate_rays(cam: Camera, height: int, width: int):
    """Returns (origins (H,W,3), dirs (H,W,3)) world-space primary rays on
    the camera's device."""
    _, _, inv_vp = camera_matrices(cam)
    x, y = pixel_ndc(height, width, dtype=cam.position.dtype,
                     device=cam.position.device)
    start = unproject(inv_vp, x, y, 0.5)
    end = unproject(inv_vp, x, y, 1.0)
    d = end - start
    d = d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
    origins = cam.position.expand(d.shape)
    return origins, d
