"""The renderer: ``render(scene, camera) -> image`` for engine culled_pallas.

Port of the ``culled_pallas`` path of ``openglraytracer_tpu/ops/render.py``
(``trace_rays_fast``, ``render``, ``_apply_bounces``,
``_trace_child_culled`` and the culled branch of ``_render_jit``). There is
no jit: these are plain functions that enqueue device work and never wait
for the device, so a frame (raygen -> image) runs without a host sync once
the cull specs and the static light and bounce masks are known; they are
computed on the host, once, outside the frame.

The engine name ``culled_pallas`` names the reference's contract: the cone
broad phase, then the survivor-list narrow-phase kernels, then the fused
shade kernel. Here those kernels are CUDA (ops/culled.py, ops/shade.py).

Bounces (depth > 0) run the reference's static tree unroll: each level's
reflection and refraction children are traced for all rays and blended
``mix(mix(phong, refl, reflectivity), refr, transparency)``. The children
take the secondary-ray culled path (``child_cull``: bounce cones, kernel 2
with its hot launch, kernel B) and are shaded by the plain-torch
``phong_shade_lit``, as the reference shades them with its XLA chain.
Children without ``child_cull`` run the dense engine in the reference,
which is not ported: that raises NotImplementedError (see ROADMAP.md), as
do other engines.

Both functions are differentiable: gradients of the image flow to the
spheres, boxes and planes through the culled ops' analytic winner backward
(ops/culled.py) and to the materials and lights through the survivor-routed
material rows, the shade backward kernel and the children's plain shade.
A caller that only renders wraps the call in ``torch.no_grad()``.
"""

from __future__ import annotations

import torch

from openglraytracer_tpu_torch.models.scene import AIR_IOR, Camera, Scene
from openglraytracer_tpu_torch.ops.accel import (cull_hot_p,
                                                 cull_overflow_count,
                                                 culled_material_rows,
                                                 parse_cull_spec, tile_image,
                                                 untile_image)
from openglraytracer_tpu_torch.ops.culled import (bounce_culled_geometry_op,
                                                  culled_geometry_op)
from openglraytracer_tpu_torch.ops.raygen import generate_rays
from openglraytracer_tpu_torch.ops.shade import shade_fused
from openglraytracer_tpu_torch.ops.shading import (gather_materials,
                                                   materials_from_rows,
                                                   phong_shade_lit,
                                                   static_bounce_mask,
                                                   static_shadow_mask)
from openglraytracer_tpu_torch.ops.transforms import reflect, refract

ENGINE = "culled_pallas"
BOUNCE_EPS = 1.0e-3  # reflection/refraction origin offset along the normal


def _check_slice(engine: str, depth: int, child_cull) -> None:
    if engine != ENGINE:
        raise NotImplementedError(
            f"engine '{engine}' is not yet ported; this package renders "
            f"with engine '{ENGINE}' only; see ROADMAP.md")
    if depth > 0 and child_cull is None:
        raise NotImplementedError(
            f"depth {depth} without child_cull: dense bounce children (the "
            "dense engine) are not yet ported; pass a child spec from "
            "ops/accel.suggest_child_cull_config; see ROADMAP.md")


def _mix(a, b, w):
    """GLSL mix(a, b, w) = a (1 - w) + b w."""
    return a * (1.0 - w) + b * w


def _apply_bounces(scene: Scene, dirs, hit, color, depth: int, recurse,
                   bounce_mask: tuple = (True, True), mat_rows=None):
    """Reflection and refraction child traces blended with
    mix(mix(phong, refl, reflectivity), refr, transparency).
    recurse(origins, dirs, depth, active) -> the child rays' colors; active
    marks rays whose child can contribute (parent hit with a positive branch
    weight), which the culled child path turns into bounce cones.
    bounce_mask: static (has_refl, has_refr); a False entry skips that
    branch (shading.static_bounce_mask shows it contributes nothing).
    mat_rows: the (R, 20) material rows routed through the survivor lists."""
    has_refl, has_refr = bounce_mask
    mat = (materials_from_rows(scene, mat_rows) if mat_rows is not None
           else gather_materials(scene, hit.material_id))

    if has_refl:
        refl_org = hit.p + hit.n * BOUNCE_EPS
        refl_dir = reflect(dirs, hit.n)
        do_refl = hit.hit & (mat.reflectivity > 0.0)
        refl_color = recurse(refl_org, refl_dir, depth - 1, do_refl)
        color = torch.where(do_refl[:, None],
                            _mix(color, refl_color,
                                 mat.reflectivity[:, None]), color)

    if has_refr:
        refr_org = hit.p - hit.n * BOUNCE_EPS
        ratio = torch.where(hit.inside, mat.refraction_index / AIR_IOR,
                            AIR_IOR / mat.refraction_index)
        refr_dir = refract(dirs, hit.n, ratio[:, None])
        do_refr = hit.hit & (mat.transparency > 0.0)
        refr_color = recurse(refr_org, refr_dir, depth - 1, do_refr)
        color = torch.where(do_refr[:, None],
                            _mix(color, refr_color,
                                 mat.transparency[:, None]), color)
    return color


def _trace_child_culled(scene: Scene, origins, dirs, active, depth: int,
                        child_cull: tuple, shadow_lights: tuple | None,
                        bounce_mask: tuple):
    """One bounce level through the secondary-ray culled path (bounce-cone
    broad phase, kernel 2 with its hot launch, kernel B, survivor-routed
    materials, plain-torch shade), recursing into deeper levels with the
    same child spec. child_cull = (tile_p, kp, ks, hot_m, kb, ksb, hot_p).
    Returns (colors (R, 3), overflow summed over this level and below)."""
    tile_p, kp, ks, hot_m, kb, ksb = parse_cull_spec(child_cull)
    hit, occ, aux = bounce_culled_geometry_op(
        scene, origins, dirs, active, tile_p, kp, ks, shadow_lights, hot_m,
        kb, ksb, hot_p=cull_hot_p(child_cull))
    mat_rows = culled_material_rows(scene, hit, aux, tile_p)
    color = phong_shade_lit(scene, dirs, hit, occ, mat_rows=mat_rows)
    color, ovf = _culled_bounces(scene, dirs, hit, color, depth, mat_rows,
                                 child_cull, shadow_lights, bounce_mask,
                                 cull_overflow_count(aux))
    return torch.where(hit.hit[:, None], color, 0.0), ovf


def _culled_bounces(scene: Scene, dirs, hit, color, depth: int, mat_rows,
                    child_cull: tuple, shadow_lights: tuple | None,
                    bounce_mask: tuple, ovf=None):
    """The bounce levels below a culled trace (none at depth 0): the
    children through _trace_child_culled, blended into color. Returns
    (color, ovf plus every child level's overflow); ovf None counts only
    the children's (None when no child was traced)."""
    ovfs = [] if ovf is None else [ovf]

    def recurse(o, d, dd, act):
        c, child_ovf = _trace_child_culled(scene, o, d, act, dd, child_cull,
                                           shadow_lights, bounce_mask)
        ovfs.append(child_ovf)
        return c

    if depth > 0:
        color = _apply_bounces(scene, dirs, hit, color, depth, recurse,
                               bounce_mask, mat_rows=mat_rows)
    return color, (sum(ovfs[1:], ovfs[0]) if ovfs else None)


def trace_rays_fast(scene: Scene, origins, dirs, depth: int = 0,
                    engine: str = ENGINE, cull: tuple | None = None,
                    shadow_lights: tuple | None = None,
                    with_cull_stats: bool = False,
                    bounce_mask: tuple | None = None,
                    child_cull: tuple | None = None):
    """Trace tile-major rays (R, 3) sharing one origin: culled narrow phase,
    survivor-routed materials, fused shade, and with depth > 0 the bounce
    children. cull = (tile_p, kp, ks[, hot_m[, kb, ksb]]); child_cull =
    (tile_p, kp, ks, hot_m, kb, ksb[, hot_p]), needed when depth > 0.
    bounce_mask: static (has_refl, has_refr); None reads the material table
    on the host (static_bounce_mask). Returns colors (R, 3), black on
    misses, and with with_cull_stats also a device int32 scalar counting
    (tile, list) slots that overflowed their static K over every level."""
    _check_slice(engine, depth, child_cull)
    if cull is None:
        raise ValueError(
            f"engine='{engine}' needs cull=(tile_p, kp, ks[, hot_m[, kb, "
            "ksb]])")
    tile_p, kp, ks, hot_m, kb, ksb = parse_cull_spec(cull)
    hit, occ, aux = culled_geometry_op(scene, origins, dirs, tile_p, kp, ks,
                                       shadow_lights, hot_m, kb, ksb)
    mat_rows = culled_material_rows(scene, hit, aux, tile_p)
    color = shade_fused(scene, dirs, hit, occ, mat_rows)
    if depth > 0 and bounce_mask is None:
        bounce_mask = static_bounce_mask(scene)
    color, child_ovf = _culled_bounces(scene, dirs, hit, color, depth,
                                       mat_rows, child_cull, shadow_lights,
                                       bounce_mask)
    color = torch.where(hit.hit[:, None], color, 0.0)
    if with_cull_stats:
        ovf = cull_overflow_count(aux)
        return color, ovf if child_ovf is None else ovf + child_ovf
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
           with_cull_stats: bool = False, device=None,
           bounce_mask: tuple | None = None,
           child_cull: tuple | None = None):
    """Render an (H, W, 3) image on ``device`` (default: the camera's).

    cull = ((tile_h, tile_w), kp, ks[, hot_m[, kb, ksb]]) — size it with
    ops/accel.suggest_cull_config (counts above K drop objects and are
    reported through with_cull_stats). depth > 0 needs child_cull =
    ((tile_h, tile_w), kp, ks, hot_m, kb, ksb[, hot_p]) with the parent's
    tile, sized by ops/accel.suggest_child_cull_config. shadow_lights and
    bounce_mask: static masks; None reads the light (material) table on
    the host, which waits for the device — pass them to keep the frame
    sync-free. with_cull_stats: return (image, overflow) where overflow is
    a device int32 scalar counting K overflows over every bounce level."""
    _check_slice(engine, depth, child_cull)
    if cull is None:
        raise ValueError(
            f"engine='{engine}' needs cull=((th, tw), kp, ks[, hot_m[, kb, "
            "ksb]])")
    device = (torch.device(device) if device is not None
              else camera.position.device)
    _check_device(scene, camera, device)
    if shadow_lights is None:
        shadow_lights = static_shadow_mask(scene)
    if bounce_mask is None:
        bounce_mask = static_bounce_mask(scene) if depth > 0 \
            else (True, True)
    (th, tw), kp, ks, hot_m, kb, ksb = parse_cull_spec(cull)
    cc = None
    if depth > 0:
        (cth, ctw), ckp, cks, chot, ckb, cksb = parse_cull_spec(child_cull)
        if (cth, ctw) != (th, tw):
            raise ValueError(
                f"child_cull tile {(cth, ctw)} must match the cull tile "
                f"{(th, tw)}: children inherit the parent's tile-major ray "
                "order")
        cc = (cth * ctw, ckp, cks, chot, ckb, cksb, cull_hot_p(child_cull))
    origins, dirs = generate_rays(camera, height, width)
    o = tile_image(origins, th, tw).reshape(-1, 3)
    d = tile_image(dirs, th, tw).reshape(-1, 3)
    out = trace_rays_fast(scene, o, d, depth, engine=engine,
                          cull=(th * tw, kp, ks, hot_m, kb, ksb),
                          shadow_lights=shadow_lights,
                          with_cull_stats=with_cull_stats,
                          bounce_mask=bounce_mask, child_cull=cc)
    if with_cull_stats:
        colors, ovf = out
        return untile_image(colors, height, width, th, tw), ovf
    return untile_image(out, height, width, th, tw)
