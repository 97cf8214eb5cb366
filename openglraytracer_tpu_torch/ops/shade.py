"""Fused Phong shade kernel.

Port of the forward of ``openglraytracer_tpu/ops/pallas_shade.py``
(``phong_fused`` / ``shade_fused``). ``phong_fused`` launches the CUDA
kernel csrc/phong_shade.cu on CUDA tensors — one pass per ray: material
row, direction, hit point and normal and the per-light occlusion bytes go
in, rgb * alpha comes out — and runs its plain version,
``shading.phong_core`` (same arguments), on CPU tensors. The analytic
backward kernel comes with the training slice (see ROADMAP.md).
"""

from __future__ import annotations

import torch

from openglraytracer_tpu_torch import kernels
from openglraytracer_tpu_torch.ops.shading import phong_core

MAT_COLS, LIGHT_COLS = 20, 16


@torch.no_grad()
def phong_fused(mat_rows, lpos, lamb, ldiff, lspec, dirs, p, n, occluded):
    """ADS Phong per ray: mat_rows (R, 20); lpos (L, 3); lamb/ldiff/lspec
    (L, 4); dirs/p/n (R, 3); occluded (R, L) bool. Returns (R, 3)."""
    if kernels.on_cpu(dirs):
        return phong_core(mat_rows, lpos, lamb, ldiff, lspec, dirs, p, n,
                          occluded)
    dev = dirs.device
    r_total, n_lights = dirs.shape[0], lpos.shape[0]
    f32 = torch.float32
    # (L, 16) [pos(3) pad amb(4) diff(4) spec(4)]
    lights = torch.cat([lpos, torch.zeros_like(lpos[:, :1]), lamb, ldiff,
                        lspec], dim=-1)
    kernels.check("lights", lights, dev, f32, (n_lights, LIGHT_COLS))
    kernels.check("mat_rows", mat_rows, dev, f32, (r_total, MAT_COLS))
    kernels.check("dirs", dirs, dev, f32, (r_total, 3))
    kernels.check("p", p, dev, f32, (r_total, 3))
    kernels.check("n", n, dev, f32, (r_total, 3))
    kernels.check("occluded", occluded, dev, torch.bool,
                  (r_total, n_lights))
    rgb = torch.empty((r_total, 3), dtype=f32, device=dev)
    kernels.launch("oglrt_phong_shade", dev, lights, mat_rows, dirs, p, n,
                   occluded, r_total, n_lights, rgb)
    kernels.LAUNCHES["phong_fused"] += 1
    return rgb


def shade_fused(scene, dirs, hit, occluded, mat_rows):
    """Phong color (R, 3) of each ray's hit from its survivor-routed
    material rows (R, 20) and occlusion (R, L); garbage-but-finite on
    misses (the caller masks)."""
    lights = scene.lights
    return phong_fused(mat_rows, lights.position, lights.ambient,
                       lights.diffuse, lights.specular, dirs, hit.p, hit.n,
                       occluded)
