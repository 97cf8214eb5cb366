"""The renderer: ``render(scene, camera) -> image`` for engine culled_pallas.

Port of the ``culled_pallas`` depth-0 path of
``openglraytracer_tpu/ops/render.py`` (``trace_rays_fast``, ``render`` and
the culled branch of ``_render_jit``). There is no jit: these are plain
functions that enqueue device work and never wait for the device, so a frame
(raygen -> image) runs without a host sync once the cull spec and the
shadow-light mask are known; both are computed on the host, once, outside
the frame.

The engine name ``culled_pallas`` names the reference's contract: the cone
broad phase, then the survivor-list narrow-phase kernels, then the fused
shade kernel. Here those kernels are CUDA (ops/culled.py, ops/shade.py).

Both functions are differentiable: gradients of the image flow to the
spheres, boxes and planes through the culled op's analytic winner backward
(ops/culled.py culled_geometry_op) and to the materials and lights through
the survivor-routed material rows and the shade backward kernel. A caller
that only renders wraps the call in ``torch.no_grad()``. Other engines and
bounces (depth > 0) are not ported yet and raise NotImplementedError; see
ROADMAP.md.
"""

from __future__ import annotations

import torch

from openglraytracer_tpu_torch.models.scene import Camera, Scene
from openglraytracer_tpu_torch.ops.accel import (cull_overflow_count,
                                                 culled_material_rows,
                                                 parse_cull_spec, tile_image,
                                                 untile_image)
from openglraytracer_tpu_torch.ops.culled import culled_geometry_op
from openglraytracer_tpu_torch.ops.raygen import generate_rays
from openglraytracer_tpu_torch.ops.shade import shade_fused
from openglraytracer_tpu_torch.ops.shading import static_shadow_mask

ENGINE = "culled_pallas"


def _check_slice(engine: str, depth: int) -> None:
    if engine != ENGINE:
        raise NotImplementedError(
            f"engine '{engine}' is not yet ported; this package renders "
            f"with engine '{ENGINE}' only; see ROADMAP.md")
    if depth > 0:
        raise NotImplementedError(
            f"depth {depth}: reflection/refraction bounces are not yet "
            "ported; see ROADMAP.md")


def trace_rays_fast(scene: Scene, origins, dirs, depth: int = 0,
                    engine: str = ENGINE, cull: tuple | None = None,
                    shadow_lights: tuple | None = None,
                    with_cull_stats: bool = False):
    """Trace tile-major rays (R, 3) sharing one origin: culled narrow phase,
    survivor-routed materials, fused shade. cull = (tile_p, kp, ks[, hot_m[,
    kb, ksb]]). Returns colors (R, 3), black on misses, and with
    with_cull_stats also a device int32 scalar counting (tile, list) slots
    that overflowed their static K."""
    _check_slice(engine, depth)
    if cull is None:
        raise ValueError(
            f"engine='{engine}' needs cull=(tile_p, kp, ks[, hot_m[, kb, "
            "ksb]])")
    tile_p, kp, ks, hot_m, kb, ksb = parse_cull_spec(cull)
    hit, occ, aux = culled_geometry_op(scene, origins, dirs, tile_p, kp, ks,
                                       shadow_lights, hot_m, kb, ksb)
    mat_rows = culled_material_rows(scene, hit, aux, tile_p)
    color = shade_fused(scene, dirs, hit, occ, mat_rows)
    color = torch.where(hit.hit[:, None], color, 0.0)
    if with_cull_stats:
        return color, cull_overflow_count(aux)
    return color


def _check_device(scene: Scene, camera: Camera, device: torch.device):
    for part in (*scene, camera):
        for x in part:
            if x.device != device:
                raise ValueError(f"scene and camera must be on {device}; "
                                 f"found a tensor on {x.device}")


def render(scene: Scene, camera: Camera, height: int, width: int,
           depth: int = 0, engine: str = ENGINE, cull: tuple | None = None,
           shadow_lights: tuple | None = None,
           with_cull_stats: bool = False, device=None):
    """Render an (H, W, 3) image on ``device`` (default: the camera's).

    cull = ((tile_h, tile_w), kp, ks[, hot_m[, kb, ksb]]) — size it with
    ops/accel.suggest_cull_config (counts above K drop objects and are
    reported through with_cull_stats). shadow_lights: static per-light
    bools; None reads the light table on the host (static_shadow_mask),
    which waits for the device — pass it to keep the frame sync-free.
    with_cull_stats: return (image, overflow) where overflow is a device
    int32 scalar counting K overflows."""
    _check_slice(engine, depth)
    if cull is None:
        raise ValueError(
            f"engine='{engine}' needs cull=((th, tw), kp, ks[, hot_m[, kb, "
            "ksb]])")
    device = (torch.device(device) if device is not None
              else camera.position.device)
    _check_device(scene, camera, device)
    if shadow_lights is None:
        shadow_lights = static_shadow_mask(scene)
    (th, tw), kp, ks, hot_m, kb, ksb = parse_cull_spec(cull)
    origins, dirs = generate_rays(camera, height, width)
    o = tile_image(origins, th, tw).reshape(-1, 3)
    d = tile_image(dirs, th, tw).reshape(-1, 3)
    out = trace_rays_fast(scene, o, d, depth, engine=engine,
                          cull=(th * tw, kp, ks, hot_m, kb, ksb),
                          shadow_lights=shadow_lights,
                          with_cull_stats=with_cull_stats)
    if with_cull_stats:
        colors, ovf = out
        return untile_image(colors, height, width, th, tw), ovf
    return untile_image(out, height, width, th, tw)
