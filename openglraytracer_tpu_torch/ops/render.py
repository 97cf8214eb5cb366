"""The renderer: ``render(scene, camera) -> image`` for the dense engines
'xla' ('auto'), 'autodiff' and 'pallas', and the culled engines 'culled'
and culled_pallas.

Port of ``openglraytracer_tpu/ops/render.py`` (``trace_rays``,
``trace_rays_fast``, ``pick_tracer``, ``render``, ``_apply_bounces``,
``_trace_child_culled``, ``_dfs_schedule``, ``trace_rays_stack`` with its
single-branch chains, ``trace_rays_mirror`` and the engine and bounce
branches of ``_render_jit``). There
is no jit: these are plain functions that enqueue device work and never
wait for the device, so a frame (raygen -> image) runs without a host sync
once the cull specs and the static light and bounce masks are known; they
are computed on the host, once, outside the frame.

The engines, named for the reference's contracts:

  * ``xla`` (and ``auto``, which means ``xla``, the default), the plain
    dense engine: every ray against every object in chunks of
    ``chunk_size`` objects in plain PyTorch (ops/intersect.py), with the
    analytic winner backward (ops/dense.py geometry_op), rays in raster
    order, shaded by the plain-torch ``phong_shade_lit``. Bounce children
    recurse through the same engine.
  * ``autodiff``: the same forward (``trace_rays``: ``closest_hit`` and
    ``phong_shade`` with its per-light ``any_hit`` queries), differentiated
    by autograd straight through it: the gradient reference.
  * ``pallas``, the dense kernel engine: as ``xla``, with the geometry in
    one kernel (kernel 7, ops/dense.py).
  * ``culled``, the XLA culled engine: the cone broad phase, then the
    survivor-list narrow phase in plain PyTorch (ops/accel.py
    ``culled_geometry``; the compaction kernel for masks of 1024 objects
    or more), shaded by ``phong_shade_lit``, rays in tile-major order. Its
    bounce children take the secondary-ray culled path with ``child_cull``
    (bounce cones, no hot-primary pass: size the child spec with
    ``suggest_child_cull_config(hot_primary=False)``), and are traced
    densely on ``xla`` without it.
  * ``culled_pallas``: the same broad phase, then the survivor-list
    narrow-phase kernels, then the fused shade kernel (ops/culled.py,
    ops/shade.py; ``fused_shade=False`` shades with ``phong_shade_lit``).
    Its bounce children take the secondary-ray culled path with
    ``child_cull`` (bounce cones, kernel 2 with its hot launch, kernel B)
    and are shaded by ``phong_shade_lit``; without ``child_cull`` they are
    traced densely on ``xla``.

Bounces (depth > 0) run, with ``bounce='tree'`` (the default), the
reference's static tree unroll: each level's reflection and refraction
children are traced for all rays and blended
``mix(mix(phong, refl, reflectivity), refr, transparency)``. With
``bounce='stack'`` they run the stack engine ``trace_rays_stack``: one cast
a step over the tree's static depth-first schedule, the blend linearised
into a running weighted sum, each step under ``torch.utils.checkpoint``
when autograd records, so that a backward holds O(depth) rays, not the
tree's every node. On the culled engines every step takes the
secondary-ray culled path with one spec
(``accel.suggest_stack_cull_config``).
``mirror_only`` traces the reflection chain alone (``trace_rays_mirror``)
on the dense engines.

Every engine is differentiable: gradients of the image flow to the
spheres, boxes and planes through the analytic winner backward of each
engine (ops/geometry.winner_backward), or through autograd for 'autodiff',
and to the materials and lights through the shade. A caller that only
renders wraps the call in ``torch.no_grad()``.
"""

from __future__ import annotations

import functools

import torch

from openglraytracer_tpu_torch.models.scene import AIR_IOR, Camera, Scene
from openglraytracer_tpu_torch.ops import accel, culled
from openglraytracer_tpu_torch.ops.accel import (cull_hot_p,
                                                 cull_overflow_count,
                                                 culled_material_rows,
                                                 parse_cull_spec, tile_image,
                                                 untile_image)
from openglraytracer_tpu_torch.ops.dense import geometry_op
from openglraytracer_tpu_torch.ops.intersect import (closest_hit,
                                                     maybe_checkpoint)
from openglraytracer_tpu_torch.ops.raygen import generate_rays
from openglraytracer_tpu_torch.ops.shade import shade_fused
from openglraytracer_tpu_torch.ops.shading import (gather_materials,
                                                   materials_from_rows,
                                                   phong_shade,
                                                   phong_shade_lit,
                                                   static_bounce_mask,
                                                   static_shadow_mask)
from openglraytracer_tpu_torch.ops.transforms import reflect, refract

# the culled engines: the narrow phase in plain PyTorch, and in kernels
CULLED_PALLAS = "culled_pallas"
CULLED = ("culled", CULLED_PALLAS)
# the dense engines (every ray against every object, no cull spec), then
# the culled ones
ENGINES = ("auto", "xla", "autodiff", "pallas") + CULLED
BOUNCE_EPS = 1.0e-3  # reflection/refraction origin offset along the normal


def _check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise NotImplementedError(
            f"engine '{engine}' is not yet ported; this package renders "
            f"with engines {ENGINES} only; see ROADMAP.md")


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
                        bounce_mask: tuple, pallas: bool):
    """One bounce level through the secondary-ray culled path (bounce-cone
    broad phase, survivor-list narrow phase, survivor-routed materials,
    plain-torch shade), recursing into deeper levels with the same child
    spec. child_cull = (tile_p, kp, ks, hot_m, kb, ksb[, hot_p]). pallas:
    the narrow phase on kernel 2 (with its hot launch over the hot_p
    budget) and kernel B; else engine 'culled''s plain-PyTorch narrow
    phase, which has no hot-primary pass (hot_p is not used). Returns
    (colors (R, 3), overflow summed over this level and below)."""
    tile_p, kp, ks, hot_m, kb, ksb = parse_cull_spec(child_cull)
    if pallas:
        hit, occ, aux = culled.bounce_culled_geometry_op(
            scene, origins, dirs, active, tile_p, kp, ks, shadow_lights,
            hot_m, kb, ksb, hot_p=cull_hot_p(child_cull))
    else:
        hit, occ, aux = accel.bounce_culled_geometry_op(
            scene, origins, dirs, active, tile_p, kp, ks, shadow_lights,
            hot_m, kb, ksb)
    mat_rows = culled_material_rows(scene, hit, aux, tile_p)
    color = phong_shade_lit(scene, dirs, hit, occ, mat_rows=mat_rows)
    color, ovf = _culled_bounces(scene, dirs, hit, color, depth, mat_rows,
                                 child_cull, shadow_lights, bounce_mask,
                                 pallas, cull_overflow_count(aux))
    return torch.where(hit.hit[:, None], color, 0.0), ovf


def _culled_bounces(scene: Scene, dirs, hit, color, depth: int, mat_rows,
                    child_cull: tuple | None, shadow_lights: tuple | None,
                    bounce_mask: tuple, pallas: bool, ovf=None,
                    chunk_size: int = 512):
    """The bounce levels below a culled trace (none at depth 0), blended
    into color: the children through _trace_child_culled (on the kernels
    with pallas), or with child_cull None densely on engine 'xla'
    (chunk_size objects a chunk), as the reference does. Returns (color,
    ovf plus every culled child level's overflow); ovf None counts only the
    children's (None when no culled child was traced)."""
    ovfs = [] if ovf is None else [ovf]

    def recurse(o, d, dd, act):
        if child_cull is None:
            return _trace_dense(scene, o, d, dd, "xla", chunk_size,
                                shadow_lights, bounce_mask)
        c, child_ovf = _trace_child_culled(scene, o, d, act, dd, child_cull,
                                           shadow_lights, bounce_mask,
                                           pallas)
        ovfs.append(child_ovf)
        return c

    if depth > 0:
        color = _apply_bounces(scene, dirs, hit, color, depth, recurse,
                               bounce_mask, mat_rows=mat_rows)
    return color, (sum(ovfs[1:], ovfs[0]) if ovfs else None)


def trace_rays(scene: Scene, origins, dirs, depth: int = 0,
               chunk_size: int = 512, remat: bool = False,
               bounce_mask: tuple | None = None):
    """Engine 'autodiff': trace rays (R, 3) through closest_hit and
    phong_shade (every light casts its shadow ray), with depth > 0 the
    bounce children, differentiated by autograd straight through the
    chunked object scan. Returns colors (R, 3), black on misses.
    remat: each object chunk under torch.utils.checkpoint while autograd
    records (memory for recompute; the same values and gradients).
    bounce_mask None reads the material table on the host."""
    if bounce_mask is None:
        bounce_mask = static_bounce_mask(scene)
    hit = closest_hit(scene, origins, dirs, chunk_size=chunk_size,
                      remat=remat)
    color = phong_shade(scene, dirs, hit, chunk_size=chunk_size, remat=remat)
    if depth > 0:
        color = _apply_bounces(
            scene, dirs, hit, color, depth,
            lambda o, d, dd, _act: trace_rays(scene, o, d, dd, chunk_size,
                                              remat, bounce_mask),
            bounce_mask)
    return torch.where(hit.hit[:, None], color, 0.0)


def trace_rays_fast(scene: Scene, origins, dirs, depth: int = 0,
                    chunk_size: int = 512, engine: str = "xla",
                    cull: tuple | None = None,
                    shadow_lights: tuple | None = None,
                    with_cull_stats: bool = False,
                    bounce_mask: tuple | None = None,
                    child_cull: tuple | None = None,
                    fused_shade: bool = True):
    """Trace rays (R, 3) and shade them, with depth > 0 the bounce children,
    with the analytic winner backward.

    engine 'xla' (the default; 'auto' and 'autodiff' run it too, as in the
    reference) and 'pallas': any rays; the dense geometry (plain PyTorch in
    chunks of chunk_size objects, or kernel 7), phong_shade_lit, children
    through the same engine; cull and child_cull are not used.
    engines 'culled' and 'culled_pallas': tile-major rays sharing one
    origin; the culled narrow phase (plain PyTorch, or the kernels),
    survivor-routed materials, then on culled_pallas with fused_shade (the
    default) the fused shade kernel, else phong_shade_lit. cull = (tile_p,
    kp, ks[, hot_m[, kb, ksb]]); child_cull = (tile_p, kp, ks, hot_m, kb,
    ksb[, hot_p]) traces the bounce children on the same engine's culled
    path ('culled' has no hot-primary pass and ignores hot_p), None traces
    them densely on 'xla'.

    shadow_lights: static per-light bools (engines 'xla' and the culled
    ones; kernel 7 casts every light); None casts every light.
    bounce_mask: static (has_refl, has_refr); None reads the material table
    on the host (static_bounce_mask). Returns colors (R, 3), black on
    misses, and with with_cull_stats also a device int32 scalar counting
    (tile, list) slots that overflowed their static K over every culled
    level (always 0 for the dense engines, which drop nothing)."""
    _check_engine(engine)
    if engine not in CULLED:
        return _trace_dense(scene, origins, dirs, depth, engine, chunk_size,
                            shadow_lights, bounce_mask, with_cull_stats)
    if cull is None:
        raise ValueError(
            f"engine='{engine}' needs cull=(tile_p, kp, ks[, hot_m[, kb, "
            "ksb]])")
    pallas = engine == CULLED_PALLAS
    tile_p, kp, ks, hot_m, kb, ksb = parse_cull_spec(cull)
    geometry_op_ = (culled.culled_geometry_op if pallas
                    else accel.culled_geometry_op)
    hit, occ, aux = geometry_op_(scene, origins, dirs, tile_p, kp, ks,
                                 shadow_lights, hot_m, kb, ksb)
    mat_rows = culled_material_rows(scene, hit, aux, tile_p)
    if pallas and fused_shade:
        color = shade_fused(scene, dirs, hit, occ, mat_rows)
    else:
        color = phong_shade_lit(scene, dirs, hit, occ, mat_rows=mat_rows)
    if depth > 0 and bounce_mask is None:
        bounce_mask = static_bounce_mask(scene)
    color, child_ovf = _culled_bounces(scene, dirs, hit, color, depth,
                                       mat_rows, child_cull, shadow_lights,
                                       bounce_mask, pallas,
                                       chunk_size=chunk_size)
    color = torch.where(hit.hit[:, None], color, 0.0)
    if with_cull_stats:
        ovf = cull_overflow_count(aux)
        return color, ovf if child_ovf is None else ovf + child_ovf
    return color


def _trace_dense(scene: Scene, origins, dirs, depth: int, engine: str,
                 chunk_size: int, shadow_lights: tuple | None,
                 bounce_mask: tuple | None, with_cull_stats: bool = False):
    """trace_rays_fast for the dense engines (the reference's non-culled
    branch): geometry_op on kernel 7 for 'pallas' and in plain PyTorch for
    the others, phong_shade_lit with materials gathered by id, and the
    children through the same engine."""
    geo = "pallas" if engine == "pallas" else "xla"
    hit, occ = geometry_op(scene, origins, dirs, geo, chunk_size,
                           shadow_lights)
    color = phong_shade_lit(scene, dirs, hit, occ)
    if depth > 0:
        if bounce_mask is None:
            bounce_mask = static_bounce_mask(scene)
        color = _apply_bounces(
            scene, dirs, hit, color, depth,
            lambda o, d, dd, _act: _trace_dense(scene, o, d, dd, geo,
                                                chunk_size, shadow_lights,
                                                bounce_mask),
            bounce_mask)
    color = torch.where(hit.hit[:, None], color, 0.0)
    if with_cull_stats:     # the dense engines drop no object
        return color, torch.zeros((), dtype=torch.int32,
                                  device=color.device)
    return color


def pick_tracer(scene: Scene, engine: str = "auto",
                shadow_lights: tuple | None = None,
                bounce_mask: tuple | None = None):
    """The trace function of a dense engine: tracer(scene, origins, dirs,
    depth=0, chunk_size=512, remat=False) -> colors (remat reaches the
    chunk scan of 'autodiff' only, as in the reference).
      'auto'     -> 'xla'
      'xla'      -> plain PyTorch forward and the analytic O(R) backward
      'pallas'   -> kernel 7 forward and the same analytic backward
      'autodiff' -> the plain forward differentiated by autograd (the
                    gradient reference)
    scene is unused, as in the reference's signature (the tracer takes its
    own)."""
    _check_engine(engine)
    if engine in CULLED:
        raise ValueError(f"pick_tracer: engine '{engine}' needs a cull "
                         "spec; call trace_rays_fast or render with cull")
    if engine == "autodiff":
        return lambda s, o, d, depth=0, chunk_size=512, remat=False: \
            trace_rays(s, o, d, depth, chunk_size=chunk_size, remat=remat,
                       bounce_mask=bounce_mask)
    engine = "xla" if engine == "auto" else engine
    return lambda s, o, d, depth=0, chunk_size=512, remat=False: \
        trace_rays_fast(s, o, d, depth, chunk_size=chunk_size, engine=engine,
                        shadow_lights=shadow_lights, bounce_mask=bounce_mask)


def _dfs_schedule(depth: int):
    """Static preorder schedule of the full reflection/refraction binary
    tree of the given depth: one step per node, 2^(depth+1) - 1 in all.

    Each step is (source_slot, level): source_slot -1 means the node's ray
    is the previous step's reflection child (carried directly); s >= 0
    means the pending refraction frame at stack slot s (a node at level s
    stores its refraction child there). The stack machine's depth-first
    order, fixed before the trace because the tree's shape is static."""
    steps = [(-1, 0)]
    sim_stack: list[int] = []
    level = 0
    total = 2 ** (depth + 1) - 1
    while len(steps) < total:
        if level < depth:
            sim_stack.append(level)
            level += 1
            steps.append((-1, level))       # descend the reflection child
        else:
            slot = sim_stack.pop()
            level = slot + 1
            steps.append((slot, level))     # pop the refraction child
    return steps


def _chain_schedule(depth: int, refl_branch: bool):
    """The schedule of a tree with one live branch, a chain of depth + 1
    casts: the reflection chain carries each child to the next step, the
    refraction chain pops the frame the level above stored."""
    if refl_branch:
        return [(-1, level) for level in range(depth + 1)]
    return [(-1, 0)] + [(level - 1, level) for level in range(1, depth + 1)]


def _stack_node(scene: Scene, cast, refl: bool, refr: bool, o, d, w):
    """One step of the stack engine: cast (o, d) of weight w (R, 1); the
    node's contribution w (1 - w_refl)(1 - w_refr) color, where w_refl and
    w_refr are the hit's reflectivity and transparency (0 on a miss) for
    the live branches refl and refr; its reflection child (o, d, w w_refl
    (1 - w_refr)) and refraction child (o, d, w w_refr), None for a branch
    not traced; and the step's overflow count."""
    color, hit, ovf = cast(o, d, w)
    mat = gather_materials(scene, hit.material_id)
    keep = w
    if refl:
        w_refl = torch.where(hit.hit & (mat.reflectivity > 0.0),
                             mat.reflectivity, 0.0)[:, None]
        keep = keep * (1.0 - w_refl)
    if refr:
        w_refr = torch.where(hit.hit & (mat.transparency > 0.0),
                             mat.transparency, 0.0)[:, None]
        keep = keep * (1.0 - w_refr)
    refl_child = refr_child = None
    if refl:
        w_child = w * w_refl
        if refr:
            w_child = w_child * (1.0 - w_refr)
        refl_child = (hit.p + hit.n * BOUNCE_EPS, reflect(d, hit.n), w_child)
    if refr:
        ratio = torch.where(hit.inside, mat.refraction_index / AIR_IOR,
                            AIR_IOR / mat.refraction_index)
        refr_child = (hit.p - hit.n * BOUNCE_EPS,
                      refract(d, hit.n, ratio[:, None]), w * w_refr)
    return keep * color, refl_child, refr_child, ovf


def _trace_schedule(scene: Scene, origins, dirs, depth: int, cast,
                    bounce_mask: tuple, steps):
    """Run a static schedule of (source_slot, level) steps (_dfs_schedule,
    or _chain_schedule for one live branch) through cast(o, d, w) ->
    (color, hit, overflow): each node adds its contribution to the
    running sum, carries its reflection child to the next step and stores
    its refraction child at the slot of its level. The stack is a Python
    list of depth + 1 frames, not a tensor written in place, so autograd
    saves nothing that a later step overwrites. Returns (colors (R, 3),
    the overflow summed over every step)."""
    has_refl, has_refr = bounce_mask
    r = origins.shape[0]
    carry = (origins, dirs,
             torch.ones((r, 1), dtype=origins.dtype, device=origins.device))
    stack = [None] * (depth + 1)
    accum = torch.zeros((r, 3), dtype=origins.dtype, device=origins.device)
    ovf = None
    for src, level in steps:
        o, d, w = carry if src < 0 else stack[src]
        leaf = level >= depth
        contrib, carry, stack[level], step_ovf = maybe_checkpoint(
            lambda o, d, w, leaf=leaf: _stack_node(
                scene, cast, has_refl and not leaf, has_refr and not leaf,
                o, d, w), o, d, w)
        accum = accum + contrib
        ovf = step_ovf if ovf is None else ovf + step_ovf
    return accum, ovf


def trace_rays_stack(scene: Scene, origins, dirs, depth: int,
                     chunk_size: int = 512, engine: str = "xla",
                     shadow_lights: tuple | None = None,
                     bounce_mask: tuple | None = None,
                     cull: tuple | None = None,
                     with_cull_stats: bool = False):
    """The full reflection and refraction bounce tree of (R, 3) rays, one
    cast per node in depth-first order, holding only a stack of depth + 1
    pending refraction frames: the stack machine of the reference's GLSL
    with its order fixed before the trace.

    The blend mix(mix(phong, refl, rho), refr, tau) linearises over the
    tree: each node adds throughput (1 - rho')(1 - tau') phong, and its
    edges carry rho'(1 - tau') (reflection) and tau' (refraction), where
    rho' = rho [hit & rho > 0] and tau' = tau [hit & tau > 0], both 0 at
    the leaves. A total-internal-reflection child has the zero direction
    and misses (black); children of misses weigh 0. The image equals the
    tree's (trace_rays_fast) to rounding: the same node colours summed in
    another order. With one statically live branch (bounce_mask) the tree
    is a chain of depth + 1 casts; at depth 0, or with none, it is one
    trace_rays_fast cast.

    engine 'xla' ('auto') or 'pallas' (kernel 7) with cull None: the dense
    geometry_op and phong_shade_lit, as the tree. engines 'culled' and
    'culled_pallas' with cull = (tile_p, kp, ks, hot_m, kb, ksb, hot_p):
    every step, the root included, takes the secondary-ray culled path
    (bounce cones over the step's live rays, survivor-routed materials):
    on culled_pallas kernel 2 cold and, on the hot_p budget, hot, and
    kernel B; on 'culled' the plain-PyTorch narrow phase, which has no
    hot-primary pass (hot_p is not used, and a list the deep bundles
    outgrow is counted as overflow). Rays in tile-major order, which every
    step keeps. Size the spec with accel.suggest_stack_cull_config.
    with_cull_stats: also return the overflow summed over every step (a
    device int32 scalar, 0 on the dense engines). Under autograd each step
    runs under torch.utils.checkpoint and is recomputed in the backward."""
    _check_engine(engine)
    if engine == "autodiff":
        raise ValueError("trace_rays_stack supports engines 'xla' ('auto'), "
                         "'pallas' and, with cull, 'culled' and "
                         "'culled_pallas'; not 'autodiff'")
    if (cull is not None) != (engine in CULLED):
        raise ValueError(f"engine '{engine}' with cull={cull}: a cull spec "
                         "goes with engines 'culled' and 'culled_pallas' "
                         "and only with them")
    if bounce_mask is None:
        bounce_mask = static_bounce_mask(scene)
    has_refl, has_refr = bounce_mask

    if cull is not None:
        tile_p, kp, ks, hot_m, kb, ksb = parse_cull_spec(cull)
        if isinstance(tile_p, tuple):
            tile_p = tile_p[0] * tile_p[1]
        if engine == CULLED_PALLAS:
            bounce_op = functools.partial(culled.bounce_culled_geometry_op,
                                          hot_p=cull_hot_p(cull))
        else:
            bounce_op = accel.bounce_culled_geometry_op

        def cast(o, d, w):
            hit, occ, aux = bounce_op(
                scene, o, d, w[:, 0] > 0.0, tile_p, kp, ks, shadow_lights,
                hot_m, kb, ksb)
            mat_rows = culled_material_rows(scene, hit, aux, tile_p)
            color = phong_shade_lit(scene, d, hit, occ, mat_rows=mat_rows)
            return (torch.where(hit.hit[:, None], color, 0.0), hit,
                    cull_overflow_count(aux))
    else:
        geo = "pallas" if engine == "pallas" else "xla"

        def cast(o, d, w):
            hit, occ = geometry_op(scene, o, d, geo, chunk_size,
                                   shadow_lights)
            color = phong_shade_lit(scene, d, hit, occ)
            return (torch.where(hit.hit[:, None], color, 0.0), hit,
                    torch.zeros((), dtype=torch.int32, device=o.device))

    if depth == 0 or not (has_refl or has_refr):
        if cull is None:
            return trace_rays_fast(scene, origins, dirs, 0,
                                   chunk_size=chunk_size, engine=geo,
                                   shadow_lights=shadow_lights,
                                   with_cull_stats=with_cull_stats)
        steps, bounce_mask = [(-1, 0)], (False, False)
    elif has_refl and has_refr:
        steps = _dfs_schedule(depth)
    else:
        steps = _chain_schedule(depth, has_refl)
    colors, ovf = _trace_schedule(scene, origins, dirs, depth, cast,
                                  bounce_mask, steps)
    return (colors, ovf) if with_cull_stats else colors


def _mirror_step(scene: Scene, chunk_size: int, remat: bool, last: bool, o,
                 d, throughput, accum):
    """One level of trace_rays_mirror: (o, d, throughput, accum) of the
    next level; a ray that does not reflect keeps its origin and
    direction, at throughput 0."""
    hit = closest_hit(scene, o, d, chunk_size=chunk_size, remat=remat)
    phong = phong_shade(scene, d, hit, chunk_size=chunk_size, remat=remat)
    phong = torch.where(hit.hit[:, None], phong, 0.0)
    refl = torch.index_select(scene.materials.reflectivity, 0,
                              hit.material_id)
    do_refl = hit.hit & (refl > 0.0) & (not last)
    weight = torch.where(do_refl, refl, 0.0)[:, None]
    accum = accum + throughput * phong * (1.0 - weight)
    o = torch.where(do_refl[:, None], hit.p + hit.n * BOUNCE_EPS, o)
    d = torch.where(do_refl[:, None], reflect(d, hit.n), d)
    return o, d, throughput * weight, accum


def trace_rays_mirror(scene: Scene, origins, dirs, depth: int,
                      chunk_size: int = 512, remat: bool = True):
    """The reflection-only bounce chain of (R, 3) rays, depth + 1 casts
    through closest_hit and phong_shade (every light casts): each level
    adds throughput (1 - rho') phong and passes throughput rho' on. Equal
    to the tree when no material is transparent; refraction is ignored.
    remat (the default, as in the reference): while autograd records, run
    each step, and each object chunk in it, under torch.utils.checkpoint.
    Returns colors (R, 3)."""
    r = origins.shape[0]
    carry = (origins, dirs,
             torch.ones((r, 1), dtype=origins.dtype, device=origins.device),
             torch.zeros((r, 3), dtype=origins.dtype, device=origins.device))
    for level in range(depth + 1):
        step = functools.partial(_mirror_step, scene, chunk_size, remat,
                                 level >= depth)
        carry = (maybe_checkpoint(step, *carry) if remat
                 else step(*carry))
    return carry[3]


def _check_device(scene: Scene, camera: Camera, device: torch.device):
    for part in (*scene, camera):
        for x in part:
            if x.device != device:
                raise ValueError(f"scene and camera must be on {device}; "
                                 f"found a tensor on {x.device}")


def render(scene: Scene, camera: Camera, height: int, width: int,
           depth: int = 0, chunk_size: int = 512, remat: bool = False,
           row_block: int | None = None, mirror_only: bool = False,
           engine: str = "auto", cull: tuple | None = None,
           shadow_lights: tuple | None = None, bounce: str = "tree",
           with_cull_stats: bool = False, bounce_mask: tuple | None = None,
           child_cull: tuple | None = None, fused_shade: bool = True,
           device=None):
    """Render an (H, W, 3) image on ``device`` (default: the camera's).
    The parameters are the reference's, in its order, with ``device``
    last. remat: on 'autodiff' and mirror_only, each object chunk (and
    mirror step) runs under torch.utils.checkpoint while autograd records,
    trading memory for recompute; the analytic-backward engines keep O(R)
    residuals already and ignore it, as in the reference.

    The dense engines ('auto' = 'xla', the default; 'autodiff'; 'pallas')
    trace the rays in raster order, at any depth, with no cull spec:
    chunk_size objects a chunk ('xla', 'autodiff'), and with row_block the
    image in blocks of row_block rows (it must divide height), which bounds
    the memory of a trace. The culled engines 'culled' and 'culled_pallas'
    need cull = ((tile_h, tile_w), kp, ks[, hot_m[, kb, ksb]]) — size it
    with ops/accel.suggest_cull_config (counts above K drop objects and
    are reported through with_cull_stats) — and take no row_block (they
    are tile-blocked already). At depth > 0 their children are traced on
    the culled path with child_cull = ((tile_h, tile_w), kp, ks, hot_m,
    kb, ksb[, hot_p]) with the parent's tile, sized by
    ops/accel.suggest_child_cull_config (with hot_primary=False for
    'culled', whose children have no hot-primary pass), and densely on
    'xla' without it. fused_shade: culled_pallas shades its primary rays
    with the fused shade kernel (the default), or with phong_shade_lit;
    'culled' always with phong_shade_lit.
    shadow_lights and bounce_mask: static masks; None reads the light
    (material) table on the host, which waits for the device — pass them
    to keep the frame sync-free ('pallas' and 'autodiff' cast every light
    and read no light mask). with_cull_stats: return (image, overflow)
    where overflow is a device int32 scalar counting K overflows over every
    culled level (0 for the dense engines).

    bounce: 'tree' (the static unroll) or 'stack' (trace_rays_stack: one
    cast a tree node in depth-first order, O(depth) rays held in a
    backward) on every engine but 'autodiff'. On the culled engines the
    stack traces every step, the root included, on the secondary-ray path
    with the one spec cull = ((tile_h, tile_w), kp, ks, hot_m, kb, ksb,
    hot_p) of ops/accel.suggest_stack_cull_config; child_cull is not used
    there. mirror_only: the dense engines trace the reflection chain alone
    (trace_rays_mirror, through closest_hit and phong_shade whatever the
    engine, refraction ignored); the culled engines ignore it, as the
    reference does."""
    device = (torch.device(device) if device is not None
              else camera.position.device)
    _check_device(scene, camera, device)
    origins, dirs = generate_rays(camera, height, width)
    return render_rays(scene, origins, dirs, depth=depth,
                       chunk_size=chunk_size, remat=remat,
                       row_block=row_block, mirror_only=mirror_only,
                       engine=engine, cull=cull, shadow_lights=shadow_lights,
                       bounce=bounce, with_cull_stats=with_cull_stats,
                       bounce_mask=bounce_mask, child_cull=child_cull,
                       fused_shade=fused_shade)


def render_rays(scene: Scene, origins, dirs, depth: int = 0,
                chunk_size: int = 512, remat: bool = False,
                row_block: int | None = None, mirror_only: bool = False,
                engine: str = "auto", cull: tuple | None = None,
                shadow_lights: tuple | None = None, bounce: str = "tree",
                with_cull_stats: bool = False,
                bounce_mask: tuple | None = None,
                child_cull: tuple | None = None, fused_shade: bool = True):
    """render after ray generation: the (h, w, 3) image of the (h, w, 3)
    primary rays origins and dirs, on their device, with render's
    arguments (a tile of an image is rendered so, from its own rays, by
    parallel/sharded.render_tile)."""
    height, width = origins.shape[:2]
    device = origins.device
    _check_engine(engine)
    if bounce not in ("tree", "stack"):
        raise ValueError(f"bounce '{bounce}': 'tree' or 'stack'")
    stack = bounce == "stack" and not mirror_only
    if stack and engine == "autodiff":
        raise ValueError("bounce='stack' supports engines 'auto', 'xla', "
                         "'pallas', 'culled' and 'culled_pallas', not "
                         "'autodiff'")
    if shadow_lights is None and engine in ("auto", "xla") + CULLED:
        shadow_lights = static_shadow_mask(scene)
    if bounce_mask is None:
        bounce_mask = static_bounce_mask(scene) if depth > 0 \
            else (True, True)
    if engine not in CULLED:
        if stack:
            def tracer(s, o, d, depth, chunk_size=512, remat=False):
                return trace_rays_stack(s, o, d, depth, chunk_size=chunk_size,
                                        engine=engine,
                                        shadow_lights=shadow_lights,
                                        bounce_mask=bounce_mask)
        elif mirror_only:
            tracer = trace_rays_mirror
        else:
            tracer = pick_tracer(scene, engine, shadow_lights, bounce_mask)
        o, d = origins.reshape(-1, 3), dirs.reshape(-1, 3)
        if row_block is None or row_block >= height:
            colors = tracer(scene, o, d, depth, chunk_size=chunk_size,
                            remat=remat)
        else:
            if height % row_block:
                raise ValueError(f"row_block {row_block} must divide the "
                                 f"height {height}")
            n = row_block * width
            colors = torch.cat([tracer(scene, o[i:i + n], d[i:i + n], depth,
                                       chunk_size=chunk_size, remat=remat)
                                for i in range(0, o.shape[0], n)])
        img = colors.reshape(height, width, 3)
        if with_cull_stats:     # the dense engines drop no object
            return img, torch.zeros((), dtype=torch.int32, device=device)
        return img
    if cull is None:
        raise ValueError(
            f"engine='{engine}' needs cull=((th, tw), kp, ks[, hot_m[, kb, "
            "ksb]])")
    if row_block is not None:
        raise ValueError(
            f"row_block is not supported with engine='{engine}' (the culled "
            "path is already tile-blocked); drop it or use engine='xla'")
    (th, tw), kp, ks, hot_m, kb, ksb = parse_cull_spec(cull)
    o = tile_image(origins, th, tw).reshape(-1, 3)
    d = tile_image(dirs, th, tw).reshape(-1, 3)
    if stack:
        out = trace_rays_stack(scene, o, d, depth, engine=engine,
                               shadow_lights=shadow_lights,
                               bounce_mask=bounce_mask,
                               cull=(th * tw, kp, ks, hot_m, kb, ksb,
                                     cull_hot_p(cull)),
                               with_cull_stats=with_cull_stats)
    else:
        cc = None
        if depth > 0 and child_cull is not None:
            (cth, ctw), ckp, cks, chot, ckb, cksb = parse_cull_spec(
                child_cull)
            if (cth, ctw) != (th, tw):
                raise ValueError(
                    f"child_cull tile {(cth, ctw)} must match the cull tile "
                    f"{(th, tw)}: children inherit the parent's tile-major "
                    "ray order")
            cc = (cth * ctw, ckp, cks, chot, ckb, cksb,
                  cull_hot_p(child_cull))
        out = trace_rays_fast(scene, o, d, depth, chunk_size=chunk_size,
                              engine=engine,
                              cull=(th * tw, kp, ks, hot_m, kb, ksb),
                              shadow_lights=shadow_lights,
                              with_cull_stats=with_cull_stats,
                              bounce_mask=bounce_mask, child_cull=cc,
                              fused_shade=fused_shade)
    if with_cull_stats:
        colors, ovf = out
        return untile_image(colors, height, width, th, tw), ovf
    return untile_image(out, height, width, th, tw)
