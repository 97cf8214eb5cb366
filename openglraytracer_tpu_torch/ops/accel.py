"""Broad-phase acceleration: tile-cone culling for primary, shadow and
bounce rays, and the XLA culled engine 'culled'.

Port of ``openglraytracer_tpu/ops/accel.py``: the tile layout, the
conservative cone tests (the bounce cones of secondary-ray bundles
included), survivor compaction (the compaction kernel for wide masks), the
culled broad phase that both culled engines and both sizing passes share
(``_primary_lists``, ``_shadow_lists``, their masks' counts and
``_cull_aux``), the survivor tables and records, survivor-routed material
rows, the narrow phase of engine 'culled' in plain PyTorch
(``culled_geometry``: the sphere quadratic and the box slab test over
(tiles, survivors, pixels), its dense hot-tile shadow pass,
``culled_geometry_op`` and ``bounce_culled_geometry_op``), the
tile-structured analytic backward that both culled engines share
(``_culled_bwd``, run by ``_CulledGeometryOp``) and the host-side sizing
of the primary and bounce-child cull specs and the overflow recount.

  1. Partition the image into pixel tiles. All primary rays of a tile share
     the camera origin and span a narrow cone: axis = mean direction,
     cos(half-angle) = min over the tile of dot(axis, dir).
  2. Conservatively test every sphere (and every box's bounding sphere)
     against every tile cone.
  3. Compact each tile's survivors to a static top-K list in ascending
     object order (first-object-wins ties are preserved) and scan only those
     in the narrow phase: here for engine 'culled', in ``ops/culled.py``'s
     kernels for culled_pallas.
  4. Shadow rays get the same per light: apex at the light, the cone holds
     the tile's bounding box of shadow-ray origins.

Culling is conservative; the one approximation is the static K. A tile whose
true survivor count exceeds K drops objects, and the counts are returned so
that the overflow is never silent (``cull_overflow_count``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from openglraytracer_tpu_torch import kernels
from openglraytracer_tpu_torch.models.scene import MISS_T, Scene
from openglraytracer_tpu_torch.ops.geometry import (_GEOMETRY_LEAVES, _N_HIT,
                                                    _with_leaves,
                                                    box_rotation,
                                                    component_dot,
                                                    plane_grads, sum_dot,
                                                    winner_backward,
                                                    winner_scatter)
from openglraytracer_tpu_torch.ops.intersect import (_DIV_EPS, _SQRT_EPS,
                                                     INF_T, Hit, _dot3,
                                                     _fold_chunk, _init_best,
                                                     _safe_div, _safe_sqrt,
                                                     plane_candidates)
from openglraytracer_tpu_torch.ops.shading import SHADOW_EPS, material_table
from openglraytracer_tpu_torch.utils.profiling import span

_BBOX_MARGIN = 1.0e-3  # fp slack when bounding shadow origins


# ---------------------------------------------------------------------------
# Image <-> tile layout
# ---------------------------------------------------------------------------

def tile_image(x, th: int, tw: int):
    """(H, W, C) -> (T, P, C) tile-major, P = th*tw. H % th == W % tw == 0."""
    h, w, c = x.shape
    if h % th or w % tw:
        raise ValueError(f"tile {th}x{tw} must divide the image {w}x{h}")
    return (x.reshape(h // th, th, w // tw, tw, c)
            .permute(0, 2, 1, 3, 4)
            .reshape((h // th) * (w // tw), th * tw, c))


def untile_image(y, height: int, width: int, th: int, tw: int):
    """Inverse of tile_image for flat (T*P, C) data -> (H, W, C)."""
    c = y.shape[-1]
    return (y.reshape(height // th, width // tw, th, tw, c)
            .permute(0, 2, 1, 3, 4)
            .reshape(height, width, c))


# ---------------------------------------------------------------------------
# Cones and the conservative sphere-vs-cone test
# ---------------------------------------------------------------------------

def tile_cones(dirs):
    """dirs (T, P, 3) unit -> (axis (T, 3), cos_half (T,))."""
    s = torch.sum(dirs, dim=1)
    axis = s * torch.rsqrt(torch.clamp(torch.sum(s * s, -1, keepdim=True),
                                       min=_SQRT_EPS))
    cos_half = torch.amin(torch.sum(axis[:, None, :] * dirs, -1), dim=1)
    return axis, torch.clamp(cos_half, -1.0, 1.0)


def sphere_vs_cone(apex, axis, cos_half, centers, radii, max_dist=None,
                   expand=None):
    """Conservative overlap of spheres with per-tile cones.

    apex (T, 3) or (3,); axis (T, 3); cos_half (T,); centers (N, 3);
    radii (N,); optional max_dist (T,) range prune (occluder center within
    max_dist + r of the apex). Returns (T, N) bool.

    angle(axis, v) <= half + asin(r/|v|) is evaluated as
    cos(angle) >= cos(half)*cos(asin) - sin(half)*sin(asin) with
    sin(asin) = r/|v| — no trig. A cone with cos_half <= 0 keeps everything.

    expand (T,): per-tile Minkowski expansion of every radius, for bundles
    whose origins span a box rather than a point (a ray from any point of a
    box B hits S iff the ray from B's center hits S dilated by B's
    half-diagonal).
    """
    apex = torch.atleast_2d(apex)                        # (T or 1, 3)
    vx = centers[None, :, 0] - apex[:, 0:1]              # (T, N)
    vy = centers[None, :, 1] - apex[:, 1:2]
    vz = centers[None, :, 2] - apex[:, 2:3]
    d2 = vx * vx + vy * vy + vz * vz
    inv_d = torch.rsqrt(torch.clamp(d2, min=_SQRT_EPS))
    ca = (axis[:, 0:1] * vx + axis[:, 1:2] * vy + axis[:, 2:3] * vz) * inv_d

    r_eff = radii[None, :] if expand is None \
        else radii[None, :] + expand[:, None]            # (T or 1, N)
    inside = d2 <= r_eff * r_eff                         # apex inside sphere
    sin_r = torch.clamp(r_eff * inv_d, max=1.0)
    cos_r = torch.sqrt(torch.clamp(1.0 - sin_r * sin_r, min=0.0))
    ch = cos_half[:, None]
    sh = torch.sqrt(torch.clamp(1.0 - ch * ch, min=0.0))
    keep = ca >= ch * cos_r - sh * sin_r
    keep = keep | inside | (ch <= 0.0)
    if max_dist is not None:
        keep = keep & (torch.sqrt(d2) - r_eff <= max_dist[:, None])
    return keep


def bounce_cones(origins_t, dirs_t, active_t):
    """Conservative per-tile cone of a secondary-ray bundle (the reflection
    or refraction children of a culled trace). There is no shared apex, so
    the bundle is bounded by the box of its active origins (apex = the box
    center, Minkowski expansion rho = its half-diagonal) plus a direction
    cone over the active rays.

    origins_t, dirs_t (T, P, 3); active_t (T, P): rays that can contribute
    (parent hit with a positive branch weight and a nonzero direction; the
    zero vector of a totally internally reflected refract() misses
    everything and must not open the cone).
    Returns (apex (T, 3), axis (T, 3), cos_half (T,), rho (T,),
    empty (T,)); tiles with no active ray are empty (keep nothing)."""
    am = active_t[..., None]
    bmin = torch.amin(torch.where(am, origins_t, INF_T), dim=1) - _BBOX_MARGIN
    bmax = torch.amax(torch.where(am, origins_t, -INF_T), dim=1) \
        + _BBOX_MARGIN
    apex = 0.5 * (bmin + bmax)
    rho = 0.5 * torch.sqrt(torch.clamp(
        torch.sum(torch.square(bmax - bmin), -1), min=_SQRT_EPS))

    s = torch.sum(torch.where(am, dirs_t, 0.0), dim=1)
    axis = s * torch.rsqrt(torch.clamp(torch.sum(s * s, -1, keepdim=True),
                                       min=_SQRT_EPS))
    dots = torch.sum(axis[:, None, :] * dirs_t, -1)
    cos_half = torch.amin(torch.where(active_t, dots, 1.0), dim=1)
    empty = ~torch.any(active_t, dim=1)
    return apex, axis, torch.clamp(cos_half, -1.0, 1.0), rho, empty


# Masks at least this wide go to the compaction kernel on the card; below
# it torch.topk's fixed cost is lower (the reference's own threshold,
# openglraytracer_tpu/ops/pallas_compact.py MIN_N_FOR_KERNEL).
MIN_N_FOR_KERNEL = 1024


def compact_mask_plain(mask, k: int):
    """Plain version of the compaction kernel: torch.topk over the key
    (N - i) * mask, which returns survivors in ascending id order.
    Arguments and results as compact_mask, except that idx is unspecified
    where ~valid."""
    n = mask.shape[-1]
    key = torch.where(mask, torch.arange(n, 0, -1, dtype=torch.int32,
                                         device=mask.device)[None, :], 0)
    vals, idx = torch.topk(key, min(k, n), dim=-1)
    return (idx.to(torch.int32), vals > 0,
            torch.sum(mask, dim=-1, dtype=torch.int32))


@torch.no_grad()
@kernels.wrapper
def compact_mask(mask, k: int):
    """Dense top-K compaction of a (T, N) bool mask.

    Returns (idx (T, K) int32 ascending among survivors, valid (T, K) bool,
    count (T,) int32 true survivor totals — count > K means overflow),
    K = min(k, N). Consumers gate idx on valid. A mask at least
    MIN_N_FOR_KERNEL wide on a CUDA device runs the compaction kernel
    (csrc/compact_mask.cu, idx 0 where ~valid); narrower masks and CPU
    tensors run compact_mask_plain."""
    n = mask.shape[-1]
    if n < MIN_N_FOR_KERNEL or kernels.on_cpu(mask):
        return compact_mask_plain(mask, k)
    dev = mask.device
    mask = mask.contiguous()
    t_rows, k_eff = mask.shape[0], min(k, n)
    kernels.check("mask", mask, dev, torch.bool, (t_rows, n))
    idx = torch.empty((t_rows, k_eff), dtype=torch.int32, device=dev)
    valid = torch.empty((t_rows, k_eff), dtype=torch.bool, device=dev)
    count = torch.empty((t_rows,), dtype=torch.int32, device=dev)
    kernels.launch("oglrt_compact_mask", dev, mask, t_rows, n, k_eff, idx,
                   valid, count)
    kernels.LAUNCHES["compact_mask"] += 1
    return idx, valid, count


def box_bounding_spheres(scene: Scene):
    """Conservative world-space bounding spheres of the scene's OBBs:
    center = position + R * (mins+maxs)/2, radius = |maxs - mins| / 2.
    Returns (centers (M, 3), radii (M,))."""
    from openglraytracer_tpu_torch.ops.transforms import euler_rotation_3x3b

    b = scene.boxes
    rot = euler_rotation_3x3b(b.angles)                     # (M, 3, 3)
    mid = 0.5 * (b.mins + b.maxs)
    mx = rot[:, 0, 0] * mid[:, 0] + rot[:, 0, 1] * mid[:, 1] \
        + rot[:, 0, 2] * mid[:, 2]
    my = rot[:, 1, 0] * mid[:, 0] + rot[:, 1, 1] * mid[:, 1] \
        + rot[:, 1, 2] * mid[:, 2]
    mz = rot[:, 2, 0] * mid[:, 0] + rot[:, 2, 1] * mid[:, 1] \
        + rot[:, 2, 2] * mid[:, 2]
    centers = b.position + torch.stack([mx, my, mz], dim=-1)
    radii = 0.5 * torch.sqrt(torch.clamp(
        torch.sum(torch.square(b.maxs - b.mins), dim=-1), min=_SQRT_EPS))
    return centers, radii


def shadow_tile_cones(shadow_org, hit_mask, tile_p: int, lpos):
    """Per-tile shadow cone for one light: apex = light, cone contains the
    tile's bounding box of shadow-ray origins, plus the range prune.
    Returns (axis (T, 3), cos_half (T,), max_d (T,), empty (T,)) — empty
    tiles (no hits) keep nothing."""
    dtype = shadow_org.dtype
    t_tiles = shadow_org.shape[0] // tile_p
    so_t = shadow_org.reshape(t_tiles, tile_p, 3)
    hit_t = hit_mask.reshape(t_tiles, tile_p)
    bmin = torch.amin(torch.where(hit_t[..., None], so_t, INF_T),
                      dim=1) - _BBOX_MARGIN                # (T, 3)
    bmax = torch.amax(torch.where(hit_t[..., None], so_t, -INF_T),
                      dim=1) + _BBOX_MARGIN
    empty = ~torch.any(hit_t, dim=1)                       # (T,)
    # 8 bbox corners (T, 8, 3); corner c takes bmax on axis a iff bit a of c
    bits = torch.arange(8, device=shadow_org.device)[:, None] \
        >> torch.arange(3, device=shadow_org.device)[None, :]
    sel_corner = (bits & 1).to(dtype)
    corners = bmin[:, None, :] * (1.0 - sel_corner) \
        + bmax[:, None, :] * sel_corner

    cvec = corners - lpos                                  # (T, 8, 3)
    clen = torch.sqrt(torch.clamp(torch.sum(cvec * cvec, -1),
                                  min=_SQRT_EPS))
    cdir = cvec / clen[..., None]
    axis_s = torch.sum(cdir, dim=1)
    axis_s = axis_s * torch.rsqrt(torch.clamp(
        torch.sum(axis_s * axis_s, -1, keepdim=True), min=_SQRT_EPS))
    cos_s = torch.amin(torch.sum(axis_s[:, None, :] * cdir, -1), dim=1)
    max_d = torch.amax(clen, dim=1)
    return axis_s, torch.clamp(cos_s, -1.0, 1.0), max_d, empty


def _segment_occluded(so_t, p_t, lpos, scx, scy, scz, sr, valid):
    """Sqrt-free shadow-segment occlusion for batched tiles — what kernel
    B computes on a hot (tile, light) pair over the scene's spheres, and
    the plain version of that. so_t, p_t: (B, P, 3) cast origins / hit
    points; sphere params (B, K) or (1, K); valid likewise. Returns (B, P)
    bool. The segment is light - p while the cast origin is the offset
    so_t; candidates are laid out (B, K, P)."""
    tlx = (lpos[0] - p_t[..., 0])[:, None, :]              # (B, 1, P)
    tly = (lpos[1] - p_t[..., 1])[:, None, :]
    tlz = (lpos[2] - p_t[..., 2])[:, None, :]
    qa = tlx * tlx + tly * tly + tlz * tlz                 # (B, 1, P)
    socx = so_t[..., 0][:, None, :] - scx[:, :, None]      # (B, K, P)
    socy = so_t[..., 1][:, None, :] - scy[:, :, None]
    socz = so_t[..., 2][:, None, :] - scz[:, :, None]
    qb = 2.0 * (tlx * socx + tly * socy + tlz * socz)
    qcs = socx * socx + socy * socy + socz * socz \
        - (sr * sr)[:, :, None]
    f_end = qa + qb + qcs
    inside_src = qcs < 0.0
    blocked_in = inside_src & (f_end > 0.0)
    disc_ok = qb * qb >= 4.0 * qa * qcs
    vertex_in = (qb < 0.0) & (-qb < 2.0 * qa)
    blocked = torch.where(inside_src, blocked_in,
                          (f_end < 0.0) | (disc_ok & vertex_in))
    blocked = blocked & (qa > _DIV_EPS) & valid[:, :, None]
    return torch.any(blocked, dim=1)


def _top_tiles(counts, m: int):
    """Ids of the m largest counts, ties to the lower tile id (the order
    the reference's top_k keeps): the hot tiles of a light."""
    t_tiles = counts.shape[0]
    order = torch.arange(t_tiles, 0, -1, device=counts.device)
    _, ids = torch.topk(counts.long() * t_tiles + order - 1, m)
    return ids


# ---------------------------------------------------------------------------
# Survivor tables and records
# ---------------------------------------------------------------------------

def _sphere_table(scene: Scene):
    """(N, 6) [cx cy cz r mat gid] — ids as exact small floats."""
    c = scene.spheres.center
    n = scene.spheres.count
    return torch.cat([
        c, scene.spheres.radius[:, None],
        scene.spheres.material_id.to(c.dtype)[:, None],
        torch.arange(n, dtype=c.dtype, device=c.device)[:, None],
    ], dim=-1)


def _box_table(scene: Scene):
    """(M, 20) [mins(3) maxs(3) pos(3) rot(9) mat gid] — ids as exact small
    floats; gid is the GLOBAL object index (spheres precede boxes)."""
    from openglraytracer_tpu_torch.ops.transforms import euler_rotation_3x3b

    b = scene.boxes
    m = b.count
    dtype = b.mins.dtype
    rot = euler_rotation_3x3b(b.angles).reshape(m, 9)
    n_sph = scene.spheres.count
    return torch.cat([
        b.mins, b.maxs, b.position, rot,
        b.material_id.to(dtype)[:, None],
        (n_sph + torch.arange(m, dtype=dtype, device=b.mins.device))[:, None],
    ], dim=-1)


def _gather_tile_rows(table, idx):
    """table (N, F), idx (T, K) -> (T, K, F)."""
    return torch.index_select(table, 0, idx.reshape(-1)).reshape(
        idx.shape + (table.shape[-1],))


class CullAux(NamedTuple):
    """Survivor lists + counts (counts are diagnostics: count > K = overflow)."""
    p_idx: torch.Tensor      # (T, Kp) primary survivor SPHERE ids
    p_valid: torch.Tensor    # (T, Kp)
    p_count: torch.Tensor    # (T,)
    s_count: torch.Tensor    # (L, T)
    s_overflow: torch.Tensor  # (L,) cold tiles whose occluders exceeded Ks
    j_local: torch.Tensor    # (T, P) winning sphere survivor slot (-1 = other)
    b_idx: torch.Tensor      # (T, Kb) primary survivor BOX ids (local 0..M)
    b_valid: torch.Tensor    # (T, Kb)
    b_count: torch.Tensor    # (T,)
    sb_count: torch.Tensor   # (L, T) shadow box survivor counts
    sb_overflow: torch.Tensor  # (L,) tiles whose box occluders exceeded Ksb
    jb_local: torch.Tensor   # (T, P) winning box survivor slot (-1 = other)


def parse_cull_spec(cull):
    """Normalize a cull spec ``(tile, kp, ks[, hot_m[, kb, ksb]])`` to a
    6-tuple. ``tile`` is (th, tw) at the image level or tile_p once tiled;
    kb/ksb = 0 mean dense boxes (Kb = Ksb = M)."""
    tile, kp, ks = cull[:3]
    hot_m = cull[3] if len(cull) > 3 else 0
    kb = cull[4] if len(cull) > 4 else 0
    ksb = cull[5] if len(cull) > 5 else 0
    return tile, kp, ks, hot_m, kb, ksb


def cull_hot_p(cull) -> int:
    """The optional 7th spec element: the hot-PRIMARY tile budget of a
    bounce-child spec. Tiles whose bounce cone keeps more objects than Kp
    run a dense pass over the global object table instead of a per-tile
    survivor list (kernel 2's hot launch), so Kp can be a quantile of the
    counts instead of their max. 0 = no hot-primary pass."""
    return cull[6] if len(cull) > 6 else 0


def cull_overflow_count(aux: CullAux) -> torch.Tensor:
    """Device int32 scalar: number of (tile, list) slots whose true survivor
    count exceeded the static K actually used — renders where objects were
    DROPPED. s_overflow/sb_overflow already exclude hot tiles (they scan
    every sphere)."""
    kp_eff = aux.p_idx.shape[-1]
    kb_eff = aux.b_idx.shape[-1]
    ovf = torch.sum(aux.p_count > kp_eff, dtype=torch.int32)
    ovf = ovf + torch.sum(aux.s_overflow, dtype=torch.int32)
    if kb_eff:
        ovf = ovf + torch.sum(aux.b_count > kb_eff, dtype=torch.int32)
        ovf = ovf + torch.sum(aux.sb_overflow, dtype=torch.int32)
    return ovf


# ---------------------------------------------------------------------------
# The culled broad phase: what a tile's cone keeps, built here for both
# culled engines (their lists) and both sizing passes (their counts)
# ---------------------------------------------------------------------------

class _Cones(NamedTuple):
    """A batch of tiles' cones, as sphere_vs_cone takes them; a tile whose
    tile_valid is False keeps nothing."""
    apex: torch.Tensor
    axis: torch.Tensor
    cos_half: torch.Tensor
    max_dist: torch.Tensor | None = None
    expand: torch.Tensor | None = None
    tile_valid: torch.Tensor | None = None


def _cull_mask(cones: _Cones, centers, radii):
    """(T, N) bool: the bounding spheres each tile's cone keeps, the mask
    that the sizing passes sum and _dense_compact compacts."""
    mask = sphere_vs_cone(cones.apex, cones.axis, cones.cos_half, centers,
                          radii, max_dist=cones.max_dist,
                          expand=cones.expand)
    if cones.tile_valid is not None:
        mask = mask & cones.tile_valid[:, None]
    return mask


def _dense_compact(cones: _Cones, centers, radii, k: int):
    return compact_mask(_cull_mask(cones, centers, radii), k)


def _box_k(k: int, n_box: int) -> int:
    """A box list's width: k clipped to the box count, 0 = every box."""
    return min(k, n_box) if k > 0 else n_box


def _cull_objects(scene: Scene):
    """(spheres, boxes): the (centers, radii) the broad phase tests of each
    kind, the boxes' bounding spheres; None for a kind the scene lacks."""
    return ((scene.spheres.center, scene.spheres.radius)
            if scene.spheres.count else None,
            box_bounding_spheres(scene) if scene.boxes.count else None)


def _primary_cones(origins, dirs, tile_p: int, active=None) -> _Cones:
    """The tile cones of rays (R, 3) in tile-major order: shared mode
    (active None, one origin) tile_cones; secondary mode bounce_cones over
    the active rays with a nonzero direction (the refract() of total
    internal reflection cannot open a cone)."""
    t_tiles = origins.shape[0] // tile_p
    dirs_t = dirs.reshape(t_tiles, tile_p, 3)
    if active is None:
        with span("broad_phase", "tile_cones"):
            axis, cos_half = tile_cones(dirs_t)
        return _Cones(origins[0], axis, cos_half)
    act = active & (torch.sum(dirs * dirs, -1) > _DIV_EPS)
    apex, axis, cos_half, rho, empty = bounce_cones(
        origins.reshape(t_tiles, tile_p, 3), dirs_t,
        act.reshape(t_tiles, tile_p))
    return _Cones(apex, axis, cos_half, expand=rho, tile_valid=~empty)


def _shadow_cones(shadow_org, hit_mask, tile_p: int, lpos) -> _Cones:
    with span("broad_phase", "shadow_tile_cones"):
        axis, cos_half, max_d, empty = shadow_tile_cones(
            shadow_org, hit_mask, tile_p, lpos)
    return _Cones(lpos, axis, cos_half, max_dist=max_d, tile_valid=~empty)


def _survivor_counts(objects, cones: _Cones, zero):
    """(spheres (T,), boxes (T,)) int32 sums of the masks the engines
    compact; zero for a kind the scene lacks."""
    return tuple(zero if obj is None else torch.sum(
        _cull_mask(cones, *obj), dim=-1, dtype=torch.int32)
        for obj in objects)


def _primary_lists(objects, cones: _Cones, kp: int, kb: int, zero_c):
    """(p_idx, p_valid, p_count, b_idx, b_valid, b_count): the tiles'
    sphere lists at cap kp and box lists at cap kb (0 = every box); empty
    lists and the zero counts zero_c (T,) for a kind the scene lacks."""
    n_box = 0 if objects[1] is None else objects[1][1].shape[0]
    out = ()
    for obj, k in zip(objects, (kp, _box_k(kb, n_box))):
        if obj is None:
            out += tuple(torch.zeros((zero_c.shape[0], 0), dtype=dt,
                                     device=zero_c.device)
                         for dt in (torch.int32, torch.bool)) + (zero_c,)
            continue
        with span("broad_phase", "_dense_compact"):
            out += _dense_compact(cones, *obj, k)
    return out


class _ShadowLists(NamedTuple):
    """One light's shadow lists and what the engine's narrow phase made of
    each (s_narrow, sb_narrow); None where the light does not cast or the
    scene lacks the kind. hot_ids, is_hot: the hot tiles, else None."""
    s_idx: torch.Tensor | None
    s_valid: torch.Tensor | None
    s_count: torch.Tensor
    s_overflow: torch.Tensor
    hot_ids: torch.Tensor | None
    is_hot: torch.Tensor | None
    sb_idx: torch.Tensor | None
    sb_valid: torch.Tensor | None
    sb_count: torch.Tensor
    sb_overflow: torch.Tensor
    s_narrow: object = None
    sb_narrow: object = None


def _shadow_lists(objects, shadow_org, hit_mask, tile_p: int, lpos, ks: int,
                  ksb: int, hot_m: int, zero_c, zero_o,
                  narrow=(None, None)) -> _ShadowLists:
    """One light's shadow lists at the hit points. lpos None (the light
    does not cast): the zero counts zero_c (T,) and overflows zero_o ().
    Spheres at cap ks: with hot_m > 0 the hot_m tiles with the most sphere
    survivors scan every sphere in the narrow phase, so the overflow counts
    the other tiles only. Boxes at cap ksb (0 = every box). narrow: per
    kind, None or f(idx, valid, count), run on the list as soon as it is
    built."""
    if lpos is None:
        return _ShadowLists(None, None, zero_c, zero_o, None, None, None,
                            None, zero_c, zero_o)
    sph, box = objects
    cones = _shadow_cones(shadow_org, hit_mask, tile_p, lpos)
    s_idx = s_valid = hot_ids = is_hot = sb_idx = sb_valid = None
    s_made = sb_made = None
    s_cnt, s_ovf, sb_cnt, sb_ovf = zero_c, zero_o, zero_c, zero_o
    if sph is not None:
        with span("broad_phase", "_dense_compact"):
            s_idx, s_valid, s_cnt = _dense_compact(cones, *sph, ks)
        if narrow[0] is not None:
            s_made = narrow[0](s_idx, s_valid, s_cnt)
        if hot_m > 0:
            hot_ids = _top_tiles(s_cnt, hot_m)
            is_hot = torch.zeros(zero_c.shape, dtype=torch.bool,
                                 device=zero_c.device).index_fill(
                                     0, hot_ids, True)
            # cold tiles above ks dropped occluders: never silent
            s_ovf = torch.sum((s_cnt > ks) & ~is_hot, dtype=torch.int32)
        else:
            s_ovf = torch.sum(s_cnt > ks, dtype=torch.int32)
    if box is not None:
        ksb = _box_k(ksb, box[1].shape[0])
        with span("broad_phase", "_dense_compact"):
            sb_idx, sb_valid, sb_cnt = _dense_compact(cones, *box, ksb)
        if narrow[1] is not None:
            sb_made = narrow[1](sb_idx, sb_valid, sb_cnt)
        sb_ovf = torch.sum(sb_cnt > ksb, dtype=torch.int32)
    return _ShadowLists(s_idx, s_valid, s_cnt, s_ovf, hot_ids, is_hot,
                        sb_idx, sb_valid, sb_cnt, sb_ovf, s_made, sb_made)


def _shadow_counts(scene: Scene, objects, hit: Hit, tile_p: int,
                   shadow_lights: tuple | None, zero):
    """(spheres (L, T), boxes (L, T)) int32: each light's shadow survivor
    counts at hit's points, the masks _shadow_lists compacts; zero (T,) for
    a light that does not cast."""
    shadow_org = hit.p + hit.n * SHADOW_EPS
    cols = []
    for li in range(scene.lights.count):
        if shadow_lights is not None and not shadow_lights[li]:
            cols.append((zero, zero))
            continue
        cones = _shadow_cones(shadow_org, hit.hit, tile_p,
                              scene.lights.position[li])
        cols.append(_survivor_counts(objects, cones, zero))
    if not cols:
        return (torch.zeros((0, zero.shape[0]), dtype=torch.int32,
                            device=zero.device),) * 2
    return tuple(torch.stack(c) for c in zip(*cols))


def _winner_mask(gid_t, hit_t, lo: int, n_obj: int):
    """Which of the objects [lo, lo + n_obj) win a ray of each tile, from
    the winners' ids and the hit mask (T, P): (wm (T, n_obj) bool, win
    (T, P) a ray's winner is one of them, loc (T, P) int64 its id - lo)."""
    win = hit_t & (gid_t >= lo) & (gid_t < lo + n_obj)
    loc = torch.clamp(gid_t - lo, 0, n_obj - 1).long()
    wm = torch.zeros((gid_t.shape[0], n_obj), dtype=torch.int32,
                     device=gid_t.device).scatter_reduce(
                         1, loc, win.to(torch.int32), "amax") > 0
    return wm, win, loc


def _cull_aux(lists, shadows, j_local, jb_local) -> CullAux:
    """CullAux from _primary_lists' six lists, one _ShadowLists a light and
    the winner slots."""
    t_tiles, device = lists[2].shape[0], lists[2].device

    def per_light(field, shape):
        if not shadows:
            return torch.zeros(shape, dtype=torch.int32, device=device)
        return torch.stack([getattr(sl, field) for sl in shadows])

    return CullAux(*lists[:3], per_light("s_count", (0, t_tiles)),
                   per_light("s_overflow", (0,)), j_local, *lists[3:],
                   per_light("sb_count", (0, t_tiles)),
                   per_light("sb_overflow", (0,)), jb_local)


def _select_winner_rows(surv_rows, j_local, rows):
    """rows (T, P, F) with each ray whose survivor slot j_local >= 0 set to
    surv_rows[t, j_local] — an index gather through the (T, K) list."""
    f = surv_rows.shape[-1]
    win = torch.gather(surv_rows, 1,
                       j_local.clamp(min=0).long()[..., None].expand(
                           -1, -1, f))
    return torch.where((j_local >= 0)[..., None], win, rows)


def _route_material_rows(table, r_total: int, tile_p: int, sph_mid, j_local,
                         box_mid, jb_local, pln_mid, is_pln, pid):
    """culled_material_rows' routing of the material table (K, 20) to the
    rays: each ray's winning survivor row by its slot (sph_mid / box_mid
    (T, Kp / Kb): the survivors' material ids; None for an absent kind),
    then its plane's row where is_pln (pln_mid (NP,): the planes' material
    ids; pid (R,) each ray's plane). Rows of other rays are zero."""
    t_tiles = r_total // tile_p
    rows = torch.zeros((t_tiles, tile_p, table.shape[-1]), dtype=table.dtype,
                       device=table.device)
    if sph_mid is not None:
        rows = _select_winner_rows(_gather_tile_rows(table, sph_mid),
                                   j_local, rows)
    if box_mid is not None:
        rows = _select_winner_rows(_gather_tile_rows(table, box_mid),
                                   jb_local, rows)
    rows = rows.reshape(r_total, -1)
    if pln_mid is not None:
        pln_rows = torch.index_select(table, 0, pln_mid)       # (NP, 20)
        rows = torch.where(is_pln[:, None],
                           torch.index_select(pln_rows, 0, pid), rows)
    return rows


class _MaterialRowsOp(torch.autograd.Function):
    """The routing of culled_material_rows as one op of the material table.
    Forward: _route_material_rows, the same ops and values. Backward: its
    transpose on geometry.winner_scatter, each ray's (R, 20) cotangent
    added into the table row of its plane's material, else its box's, else
    its sphere's, summed per block of a tile by the kernel first;
    autograd's own transposes of the gathers add every ray's row with an
    atomic a column (index_add_, scatter_add) into a few rows."""

    @staticmethod
    def forward(ctx, table, r_total, tile_p, *idx):
        ctx.save_for_backward(*idx)
        ctx.n_rows = table.shape[0]
        return _route_material_rows(table, r_total, tile_p, *idx)

    @staticmethod
    def backward(ctx, g):
        sph_mid, j_local, box_mid, jb_local, pln_mid, is_pln, pid = \
            ctx.saved_tensors
        g = g.contiguous()
        g_table = torch.zeros((ctx.n_rows, g.shape[-1]), dtype=g.dtype,
                              device=g.device)
        planes = (None,) * 4
        if pln_mid is not None:
            planes = (g, torch.where(is_pln, pid, -1).to(torch.int32),
                      pln_mid, g_table)
        with span("backward", "scatter_material_rows"):
            if box_mid is not None:
                winner_scatter(g, jb_local, box_mid, g_table, *planes)
                planes = (None,) * 4
                if sph_mid is not None:
                    # a ray whose winner is a box or a plane is no sphere's
                    other = jb_local >= 0
                    if is_pln is not None:
                        other = other | is_pln.reshape(other.shape)
                    j_local = torch.where(other, -1, j_local)
            if sph_mid is not None:
                winner_scatter(g, j_local, sph_mid, g_table, *planes)
                planes = (None,) * 4
            if planes[1] is not None:
                winner_scatter(None, None, None, None, *planes)
        return (g_table, None, None) + (None,) * 7


def culled_material_rows(scene: Scene, hit: Hit, aux: CullAux, tile_p: int):
    """Per-ray packed material rows (R, 20) routed through the tile survivor
    lists: gather materials for the (T, K) survivors, pick each ray's winner
    row by its survivor slot, and patch plane winners from the plane table.
    Rays that hit nothing get zero rows. The material table's gradient,
    where it has one, goes back through _MaterialRowsOp."""
    r_total = hit.t.shape[0]
    n_sph = scene.spheres.count
    n_box = scene.boxes.count
    table = material_table(scene)                           # (K, 20)

    sph_mid = box_mid = pln_mid = is_pln = pid = None
    if n_sph:
        sph_mid = _gather_tile_rows(scene.spheres.material_id[:, None],
                                    aux.p_idx)[..., 0]
    if n_box:
        box_mid = _gather_tile_rows(scene.boxes.material_id[:, None],
                                    aux.b_idx)[..., 0]
    pln = scene.planes
    if pln.count:
        pln_mid = pln.material_id
        is_pln = hit.hit & (hit.obj_id >= n_sph + n_box)
        pid = torch.clamp(hit.obj_id - n_sph - n_box, 0, pln.count - 1)
    return _MaterialRowsOp.apply(table, r_total, tile_p, sph_mid,
                                 aux.j_local, box_mid, aux.jb_local, pln_mid,
                                 is_pln, pid)


# ---------------------------------------------------------------------------
# Tile-structured analytic backward of the culled narrow phase
# ---------------------------------------------------------------------------

def _winner_rows(table, surv_idx, j_local):
    """(T*P, F) row of each ray's winner through the (T, K) survivor list;
    zeros where j_local < 0 (the winner is of another kind)."""
    rows = _gather_tile_rows(table, surv_idx)                # (T, K, F)
    t_tiles, tile_p = j_local.shape
    zero = torch.zeros((t_tiles, tile_p, table.shape[-1]), dtype=table.dtype,
                       device=table.device)
    return _select_winner_rows(rows, j_local, zero).reshape(
        t_tiles * tile_p, -1)


def _culled_bwd(scene: Scene, origins, dirs, hit: Hit, aux: CullAux,
                tile_p: int, gt, gp, gn, need_rays: bool = False,
                hot_pass: bool = False, dot=sum_dot):
    """Analytic winner-only backward of the culled narrow phase. Port of
    ``accel._culled_bwd`` (reused verbatim by the reference's
    ``culled_pallas_geometry_op``).

    Each ray's winner parameters are gathered through the (T, K) survivor
    lists, one candidate per ray is replayed and differentiated
    (geometry.winner_backward, shared with the dense engine's backward),
    and the per-ray cotangents are added back through the same lists
    (geometry.winner_scatter).

    Winner overflow (a divergence from the reference): a ray whose winner
    is a sphere (box) but whose j_local (jb_local) is -1 lost its winner
    from the capped list (a hot tile with more distinct winners than Kp).
    It gets zero cotangents, for its winner's parameters and for its ray;
    the reference replays a sphere of radius 0 at the origin there and
    hands the ray a finite but wrong cotangent. The tile's count > K
    reports the event through cull_overflow_count. Only the hot-primary
    pass rebuilds lists that can lose a winner: hot_pass says whether the
    forward ran one.

    gt (R,), gp (R, 3), gn (R, 3): cotangents of hit.t, hit.p, hit.n. dot:
    the replay's row-wise dot product, geometry.component_dot for engine
    'culled', whose forward rounds as the dense engine 'xla''s does.
    Returns (g_center (N, 3), g_radius (N,), g_mins, g_maxs, g_position,
    g_angles (M, 3), g_normal (P, 3), g_offset (P,), g_origins, g_dirs);
    the last two are None unless need_rays."""
    sph, box = scene.spheres, scene.boxes
    n_sph, n_box = sph.count, box.count

    idx = hit.obj_id
    hm = hit.hit
    none = torch.zeros_like(hm)
    is_sph = (hm & (idx >= 0) & (idx < n_sph)) if n_sph else none
    is_box = (hm & (idx >= n_sph) & (idx < n_sph + n_box)) if n_box \
        else none

    # winner overflow: the winner fell off its capped list (see above)
    lost = None
    if hot_pass:
        lost = none
        if n_sph:
            lost = lost | (is_sph & (aux.j_local.reshape(-1) < 0))
        if n_box:
            lost = lost | (is_box & (aux.jb_local.reshape(-1) < 0))
        is_sph = is_sph & ~lost
        is_box = is_box & ~lost

    sph_rows = (_winner_rows(torch.cat([sph.center, sph.radius[:, None]], -1),
                             aux.p_idx, aux.j_local) if n_sph else None)
    box_rows = None
    if n_box:
        angles, rot_table = box_rotation(box)
        btab = torch.cat([box.mins, box.maxs, box.position,
                          rot_table.detach()], dim=-1)     # (M, 18)
        box_rows = _winner_rows(btab, aux.b_idx, aux.jb_local)

    with span("backward", "winner_backward"):
        g_sph_r, g_box_r, g_pln_r, pln_slot, go, gd = winner_backward(
            scene, origins, dirs, hit, is_sph, is_box, sph_rows, box_rows,
            gt, gp, gn, need_rays, lost, dot)

    # the planes' rows ride on the spheres' launch (else on their own)
    n_pln = scene.planes.count
    kw = dict(dtype=gt.dtype, device=gt.device)
    g_pln = torch.zeros((n_pln, 4), **kw) if n_pln else None
    planes = (g_pln_r, pln_slot, None, g_pln)
    with span("backward", "scatter_winner_rows"):
        if n_sph:
            g_sph = torch.zeros((n_sph, 4), **kw)
            winner_scatter(g_sph_r, aux.j_local, aux.p_idx, g_sph, *planes)
            planes = (None,) * 4
        if n_box:
            g_box = torch.zeros((n_box, 18), **kw)
            winner_scatter(g_box_r, aux.jb_local, aux.b_idx, g_box)
        if planes[1] is not None:
            winner_scatter(None, None, None, None, *planes)
    g_normal, g_offset = plane_grads(scene.planes, g_pln)

    if n_sph:
        g_center, g_radius = g_sph[:, :3], g_sph[:, 3]
    else:
        g_center, g_radius = torch.zeros_like(sph.center), \
            torch.zeros_like(sph.radius)

    if n_box:
        (g_angles,) = torch.autograd.grad(rot_table, angles, g_box[:, 9:18])
        g_mins, g_maxs, g_pos = g_box[:, 0:3], g_box[:, 3:6], g_box[:, 6:9]
    else:
        g_mins, g_maxs, g_pos, g_angles = (torch.zeros_like(x) for x in (
            box.mins, box.maxs, box.position, box.angles))

    return (g_center, g_radius, g_mins, g_maxs, g_pos, g_angles, g_normal,
            g_offset, go, gd)


# ---------------------------------------------------------------------------
# The XLA culled engine 'culled': the narrow phase in plain PyTorch over the
# (tiles, survivors, pixels) layout
# ---------------------------------------------------------------------------

# The narrow phase's (T, K, P) temporaries are computed a block of tiles at
# a time, at most this many elements a block: about ten of them are alive
# at once, 256 MiB each in float32. At c5_grid4096 one unblocked (T, Kp, P)
# float tensor is 1.2 GB and a shadow (T, Ks, P) one 2.1 GB, and the
# max-sized lists of the c4_mirror4096 children reach (T, N, P), 17 GB.
# Tiles are independent and the folds run over K within a tile, so the
# result is the unblocked call's bit for bit.
TILE_BLOCK_ELEMS = 1 << 26


def _tile_blocks(n_tiles: int, per_tile: int):
    """[start, stop) ranges covering n_tiles tiles of per_tile elements
    each, at most TILE_BLOCK_ELEMS elements (and at least one tile) a
    block."""
    step = max(1, TILE_BLOCK_ELEMS // max(per_tile, 1))
    return [(a, min(a + step, n_tiles)) for a in range(0, n_tiles, step)]


def _box_slab_tkp(rows, b_valid, rox, roy, roz, rdx, rdy, rdz):
    """Slab test in the (T, K, P) layout given local-space ray components
    (each (T, K, P) or broadcastable); rows (T, K, >= 18) box table rows.
    Mirrors intersect.box_candidates op for op. Returns (t (miss INF_T),
    ok, inside, the slab boundaries (t1x, t1y, t1z, t2x, t2y, t2z))."""
    one = torch.ones_like(rdx)
    ivx = _safe_div(one, rdx)
    ivy = _safe_div(one, rdy)
    ivz = _safe_div(one, rdz)
    tax = (rows[..., 0:1] - rox) * ivx                      # mins - ro
    tay = (rows[..., 1:2] - roy) * ivy
    taz = (rows[..., 2:3] - roz) * ivz
    tbx = (rows[..., 3:4] - rox) * ivx                      # maxs - ro
    tby = (rows[..., 4:5] - roy) * ivy
    tbz = (rows[..., 5:6] - roz) * ivz
    t1x, t2x = torch.minimum(tax, tbx), torch.maximum(tax, tbx)
    t1y, t2y = torch.minimum(tay, tby), torch.maximum(tay, tby)
    t1z, t2z = torch.minimum(taz, tbz), torch.maximum(taz, tbz)
    t_near = torch.maximum(t1x, torch.maximum(t1y, t1z))
    t_far = torch.minimum(t2x, torch.minimum(t2y, t2z))

    ok = (t_near < t_far) & (t_far > 0.0) & b_valid[..., None]
    inside = ok & (t_near < 0.0)
    t = torch.where(inside, t_far, t_near)
    ok = ok & (t > 0.0)
    t = torch.where(ok, t, INF_T)
    return t, ok, inside, (t1x, t1y, t1z, t2x, t2y, t2z)


def _rot_tkp(rows, vx, vy, vz, transpose: bool):
    """Rotate (T, K-or-1, P) vector components by each row's 3x3 (columns
    9:18); transpose=True applies R^T (world -> local)."""
    r = [rows[..., 9 + i:10 + i] for i in range(9)]         # (T, K, 1) each
    if transpose:
        return (r[0] * vx + r[3] * vy + r[6] * vz,
                r[1] * vx + r[4] * vy + r[7] * vz,
                r[2] * vx + r[5] * vy + r[8] * vz)
    return (r[0] * vx + r[1] * vy + r[2] * vz,
            r[3] * vx + r[4] * vy + r[5] * vz,
            r[6] * vx + r[7] * vy + r[8] * vz)


def _box_narrow(rows, b_valid, o0, dirs_t, origins_t=None):
    """Box narrow phase over tile survivors: the shared origin o0 (3,), or
    per-ray origins_t (T, P, 3) for bounce bundles; dirs_t (T, P, 3).
    Returns per candidate (t, ok, inside, world normal (3 components)) in
    the (T, Kb, P) layout, the normal picked as intersect.box_candidates
    picks it (face by equality with the winning boundary, y before z)."""
    if origins_t is None:
        wx = (o0[0] - rows[..., 6])[..., None]              # (T, Kb, 1)
        wy = (o0[1] - rows[..., 7])[..., None]
        wz = (o0[2] - rows[..., 8])[..., None]
    else:
        wx = origins_t[..., 0][:, None, :] - rows[..., 6:7]  # (T, Kb, P)
        wy = origins_t[..., 1][:, None, :] - rows[..., 7:8]
        wz = origins_t[..., 2][:, None, :] - rows[..., 8:9]
    rox, roy, roz = _rot_tkp(rows, wx, wy, wz, transpose=True)
    dx = dirs_t[..., 0][:, None, :]                         # (T, 1, P)
    dy = dirs_t[..., 1][:, None, :]
    dz = dirs_t[..., 2][:, None, :]
    rdx, rdy, rdz = _rot_tkp(rows, dx, dy, dz, transpose=True)

    t, ok, inside, bounds = _box_slab_tkp(rows, b_valid, rox, roy, roz,
                                          rdx, rdy, rdz)
    _, t1y, t1z, _, t2y, t2z = bounds
    by = torch.where(inside, t2y, t1y)
    bz = torch.where(inside, t2z, t1z)
    face_y = t == by
    face_z = (~face_y) & (t == bz)
    face_x = ~(face_y | face_z)
    rd_face = torch.where(face_y, rdy, torch.where(face_z, rdz, rdx))
    sgn = torch.where(rd_face > 0.0, -1.0, 1.0)
    nlx = torch.where(face_x, sgn, 0.0)
    nly = torch.where(face_y, sgn, 0.0)
    nlz = torch.where(face_z, sgn, 0.0)
    nwx, nwy, nwz = _rot_tkp(rows, nlx, nly, nlz, transpose=False)
    okf = ok.to(t.dtype)
    return t, ok, inside, (nwx * okf, nwy * okf, nwz * okf)


def _box_segment_occluded(rows, b_valid, so_t, p_t, lpos):
    """Box occlusion of the shadow segment: cast origin so_t (B, P, 3),
    unnormalized direction light - p_t. Blocked iff the slab hit has t in
    (0, 1), as the dense engine's box_candidates and t < 1. Returns (B, P)
    bool."""
    wx = so_t[..., 0][:, None, :] - rows[..., 6:7]          # (B, K, P)
    wy = so_t[..., 1][:, None, :] - rows[..., 7:8]
    wz = so_t[..., 2][:, None, :] - rows[..., 8:9]
    rox, roy, roz = _rot_tkp(rows, wx, wy, wz, transpose=True)
    tlx = (lpos[0] - p_t[..., 0])[:, None, :]
    tly = (lpos[1] - p_t[..., 1])[:, None, :]
    tlz = (lpos[2] - p_t[..., 2])[:, None, :]
    rdx, rdy, rdz = _rot_tkp(rows, tlx, tly, tlz, transpose=True)
    t, ok, _, _ = _box_slab_tkp(rows, b_valid, rox, roy, roz, rdx, rdy, rdz)
    return torch.any(ok & (t < 1.0), dim=1)


def _sphere_narrow(rows, valid, o0, dirs_t, origins_t=None):
    """Sphere narrow phase over tile survivors, the reference's arithmetic
    op for op (each op rounded once, the square root correctly rounded): a
    reformulation, qa = 1 for unit directions say, rounds apart and flips
    the sign of the discriminant on tangent grazes. rows (T, K, >= 4)
    [c(3) r]; valid (T, K); o0 (3,) the shared origin, or origins_t
    (T, P, 3) per ray; dirs_t (T, P, 3). Returns (t (T, K, P), INF_T where
    nothing is hit, inside (T, K, P)). The (T, K, P) temporaries are
    overwritten in place: the caller runs without autograd."""
    cx, cy, cz, rad = rows[..., 0], rows[..., 1], rows[..., 2], rows[..., 3]
    if origins_t is None:
        ocx = (o0[0] - cx)[:, :, None]                      # (T, K, 1)
        ocy = (o0[1] - cy)[:, :, None]
        ocz = (o0[2] - cz)[:, :, None]
    else:                    # (T, 1, P) - (T, K, 1) -> (T, K, P)
        ocx = origins_t[..., 0][:, None, :] - cx[:, :, None]
        ocy = origins_t[..., 1][:, None, :] - cy[:, :, None]
        ocz = origins_t[..., 2][:, None, :] - cz[:, :, None]
    qc = ocx * ocx + ocy * ocy + ocz * ocz - (rad * rad)[:, :, None]
    dx = dirs_t[..., 0][:, None, :]                         # (T, 1, P)
    dy = dirs_t[..., 1][:, None, :]
    dz = dirs_t[..., 2][:, None, :]
    qa = dx * dx + dy * dy + dz * dz                        # (T, 1, P)
    qb = dx * ocx                                           # (T, K, P)
    qb += dy * ocy
    qb += dz * ocz
    qb *= 2.0
    del ocx, ocy, ocz
    qd = qb * qb
    qd -= 4.0 * qa * qc
    del qc
    ok = qd >= 0.0
    ok &= qa > _DIV_EPS
    ok &= valid[:, :, None]
    sq = torch.where(ok, _safe_sqrt(qd), 0.0)
    del qd
    inv_2qa = _safe_div(0.5, qa)
    qb.neg_()                                               # -qb
    t_near = qb + sq
    t_near *= inv_2qa                                       # t1
    qb -= sq
    qb *= inv_2qa                                           # t2
    del sq
    t_far = torch.maximum(t_near, qb)
    torch.minimum(t_near, qb, out=t_near)
    del qb
    ok &= t_far >= 0.0
    inside = t_near < 0.0
    inside &= ok
    t = torch.where(inside, t_far, t_near, out=t_near)
    del t_far
    ok &= t > 0.0
    t.masked_fill_(~ok, INF_T)
    return t, inside


def _first_min_k(t):
    """(min over axis 1, the first index attaining it) of (T, K, P)."""
    k = t.shape[1]
    tc = torch.amin(t, dim=1)                               # (T, P)
    iota = torch.arange(k, dtype=torch.int32, device=t.device)[None, :, None]
    j = torch.amin(torch.where(t == tc[:, None, :], iota, k), dim=1)
    return tc, j


def _take_kp(x, j):
    """x (T, K, P) at slot j (T, P) -> (T, P); zero (False) where j is past
    the list (no slot attains the minimum: a NaN candidate), as the
    reference's one-hot sum gives."""
    k = x.shape[1]
    got = torch.gather(x, 1, j.clamp(max=k - 1).long()[:, None, :])[:, 0]
    return got & (j < k) if got.dtype == torch.bool \
        else torch.where(j < k, got, 0.0)


def _take_rows(rows, j):
    """rows (T, K, F) at slot j (T, P) -> (T, P, F); zero past the list."""
    k, f = rows.shape[1], rows.shape[2]
    idx = j.clamp(max=k - 1).long()[..., None].expand(-1, -1, f)
    return torch.where((j < k)[..., None], torch.gather(rows, 1, idx), 0.0)


@torch.no_grad()
def culled_geometry(scene: Scene, origins, dirs, tile_p: int, kp: int,
                    ks: int, shadow_lights: tuple | None = None,
                    hot_m: int = 0, kb: int = 0, ksb: int = 0, active=None):
    """Closest hit and all-light occlusion with tile-cone culling, the
    narrow phase in plain PyTorch: engine 'culled'. Port of
    ``accel.culled_geometry``. The kernel engine's counterpart is
    ``ops/culled.py culled_geometry`` (culled_pallas).

    origins, dirs (R, 3) in tile-major order (tile_image), R = T * tile_p;
    every origin is the same point (primary pinhole rays) unless ``active``
    is given; dirs unit. kp/ks sphere survivor caps, kb/ksb box caps (0 =
    every box). shadow_lights: static per-light bools, False skips that
    light's shadow pass (None = all cast). hot_m > 0: per light, the hot_m
    tiles with the most sphere survivors test every sphere of the scene
    (the reference's dense hot pass), so ks may be a quantile of the
    counts.

    active (R,) bool: secondary mode for bounce children: per-ray origins,
    the bounce-cone broad phase (origin-box apex, Minkowski-expanded
    objects; zero-direction rays, the refract() of total internal
    reflection, cannot open a cone), and inactive rays forced to miss.
    There is no hot-primary pass here: size child lists from the maximum
    counts (suggest_child_cull_config(hot_primary=False)).

    The narrow phase runs over (tiles, survivors, pixels), a block of
    tiles at a time (TILE_BLOCK_ELEMS). Its winner: the minimum t, on a
    tie the first survivor in ascending id order; a box wins only on a
    strictly smaller t, a plane loses ties. Returns (Hit (R,), occluded
    (R, L) bool, CullAux)."""
    r_total = origins.shape[0]
    t_tiles = r_total // tile_p
    dtype, device = origins.dtype, origins.device
    n_sph = scene.spheres.count
    n_box = scene.boxes.count
    n_lights = scene.lights.count
    centers, radii = scene.spheres.center, scene.spheres.radius
    shared = active is None
    o0 = origins[0]
    zero_c = torch.zeros((t_tiles,), dtype=torch.int32, device=device)

    # ---- broad phase: dense per-tile compaction
    dirs_t = dirs.reshape(t_tiles, tile_p, 3)
    origins_t = None if shared else origins.reshape(t_tiles, tile_p, 3)
    objects = _cull_objects(scene)
    lists = _primary_lists(objects, _primary_cones(origins, dirs, tile_p,
                                                   active), kp, kb, zero_c)
    p_idx, p_valid, p_count, b_idx, b_valid, b_count = lists
    if n_sph:
        rows = _gather_tile_rows(_sphere_table(scene), p_idx)  # (T, Kp, 6)
    if n_box:
        btab = _box_table(scene)
        brows = _gather_tile_rows(btab, b_idx)              # (T, Kb, 20)
    kp_eff, kb_eff = p_idx.shape[-1], b_idx.shape[-1]

    # ---- narrow phase, a block of tiles at a time: the sphere winner, then
    # the box winner merged in global-id order (spheres precede boxes, so a
    # box wins only on a strictly smaller t)
    t_flat = torch.full((r_total,), INF_T, dtype=dtype, device=device)
    n = torch.zeros((r_total, 3), dtype=dtype, device=device)
    in_flat = torch.zeros((r_total,), dtype=torch.bool, device=device)
    mat_flat = torch.zeros((r_total,), dtype=torch.int32, device=device)
    gid_flat = torch.full((r_total,), -1, dtype=torch.int32, device=device)
    j_local = torch.full((t_tiles, tile_p), -1, dtype=torch.int32,
                         device=device)
    jb_local = torch.full_like(j_local, -1)
    for a, e in _tile_blocks(t_tiles, max(kp_eff, kb_eff) * tile_p):
        ra, re = a * tile_p, e * tile_p
        d_b = dirs_t[a:e]
        o_b = None if shared else origins_t[a:e]
        if n_sph:
            t, inside = _sphere_narrow(rows[a:e], p_valid[a:e], o0, d_b, o_b)
            tc, j = _first_min_k(t)
            ic = _take_kp(inside, j)
            del t, inside
            win = _take_rows(rows[a:e], j)                     # (B, P, 6)
            hit_s = tc < MISS_T
            t_b = tc.reshape(-1)
            in_b = ic.reshape(-1)
            mat_b = win[..., 4].reshape(-1).to(torch.int32)
            gid_b = win[..., 5].reshape(-1).to(torch.int32)
            jl_b = torch.where(hit_s, j, -1)
            # the sphere normal from the winning center, rounded as the
            # dense engine 'xla' rounds it (intersect.closest_hit_sp:
            # o - c + t d), as the reference's culled and dense engines
            # share one formula: their children start alike
            hs = hit_s.reshape(-1)
            ts = torch.where(hs, t_b, 0.0)
            u = (origins[ra:re] - win[..., 0:3].reshape(-1, 3)) \
                + ts[:, None] * dirs[ra:re]
            inv_len = torch.rsqrt(torch.clamp(
                _dot3(u[:, 0], u[:, 1], u[:, 2], u[:, 0], u[:, 1], u[:, 2]),
                min=_SQRT_EPS))
            sgn = torch.where(in_b, -inv_len, inv_len) * hs.to(dtype)
            n_b = u * sgn[:, None]
        else:
            t_b = t_flat[ra:re]
            n_b, in_b = n[ra:re], in_flat[ra:re]
            mat_b, gid_b, jl_b = mat_flat[ra:re], gid_flat[ra:re], \
                j_local[a:e]
        jbl_b = jb_local[a:e]
        if n_box:
            br = brows[a:e]
            tb, _, insb, (nbx, nby, nbz) = _box_narrow(br, b_valid[a:e], o0,
                                                       d_b, o_b)
            tbc, jb = _first_min_k(tb)
            icb = _take_kp(insb, jb).reshape(-1)
            nb = torch.stack([_take_kp(x, jb).reshape(-1)
                              for x in (nbx, nby, nbz)], dim=-1)
            winb = _take_rows(br[..., 18:20], jb)              # (B, P, 2)
            tb_flat = tbc.reshape(-1)
            use_box = tb_flat < t_b
            ub_t = use_box.reshape(e - a, tile_p)
            t_b = torch.where(use_box, tb_flat, t_b)
            n_b = torch.where(use_box[:, None], nb, n_b)
            in_b = torch.where(use_box, icb, in_b)
            mat_b = torch.where(use_box, winb[..., 0].reshape(-1).to(
                torch.int32), mat_b)
            gid_b = torch.where(use_box, winb[..., 1].reshape(-1).to(
                torch.int32), gid_b)
            jl_b = torch.where(ub_t, -1, jl_b)
            jbl_b = torch.where(ub_t & (tbc < MISS_T), jb, -1)
        t_flat[ra:re], n[ra:re], in_flat[ra:re] = t_b, n_b, in_b
        mat_flat[ra:re], gid_flat[ra:re] = mat_b, gid_b
        j_local[a:e], jb_local[a:e] = jl_b, jbl_b

    # ---- planes: dense (a tiny count), merged with objects first on ties
    pln = scene.planes
    if pln.count:
        tpl, npl, _ = plane_candidates(
            origins, dirs, pln.normal, pln.offset,
            torch.ones((pln.count,), dtype=torch.bool, device=device))
        bp = _fold_chunk(_init_best(r_total, origins), tpl, npl,
                         torch.zeros_like(tpl, dtype=torch.bool),
                         pln.material_id, n_sph + n_box, 0)
        sw = t_flat <= bp.t
        t_flat = torch.where(sw, t_flat, bp.t)
        n = torch.where(sw[:, None], n, bp.n)
        in_flat = torch.where(sw, in_flat, bp.inside)
        mat_flat = torch.where(sw, mat_flat, bp.material_id)
        gid_flat = torch.where(sw, gid_flat, bp.obj_id)
        sw_t = sw.reshape(t_tiles, tile_p)
        j_local = torch.where(sw_t, j_local, -1)
        jb_local = torch.where(sw_t, jb_local, -1)

    if not shared:
        # inactive secondary rays are misses (their colors carry no bounce
        # weight; the miss keeps them out of the shadow cones below)
        t_flat = torch.where(active, t_flat, INF_T)
        act_full = active.reshape(t_tiles, tile_p)
        j_local = torch.where(act_full, j_local, -1)
        jb_local = torch.where(act_full, jb_local, -1)

    hit_mask = t_flat < MISS_T
    t_for_p = torch.where(hit_mask, t_flat, 0.0)
    p = origins + t_for_p[:, None] * dirs
    hit = Hit(t=t_flat, p=p, n=n, inside=in_flat & hit_mask,
              material_id=torch.where(hit_mask, mat_flat, 0),
              obj_id=torch.where(hit_mask, gid_flat, -1), hit=hit_mask)

    # ---- shadows: per light, a cone from the light over each tile's box of
    # hit points; sphere and box occluders through their survivor lists, the
    # hot_m tiles with the most sphere survivors over every sphere
    shadow_org = hit.p + hit.n * SHADOW_EPS
    so_t = shadow_org.reshape(t_tiles, tile_p, 3)
    p_t = hit.p.reshape(t_tiles, tile_p, 3)
    occ_cols, shadows = [], []
    zero_o = torch.zeros((), dtype=torch.int32, device=device)
    for li in range(n_lights):
        lit = shadow_lights is None or shadow_lights[li]
        lpos = scene.lights.position[li]
        sl = _shadow_lists(objects, shadow_org, hit_mask, tile_p,
                           lpos if lit else None, ks, ksb, hot_m, zero_c,
                           zero_o)
        shadows.append(sl)
        if not lit:
            occ_cols.append(torch.zeros((r_total,), dtype=torch.bool,
                                        device=device))
            continue
        occ_t = torch.zeros((t_tiles, tile_p), dtype=torch.bool,
                            device=device)
        if n_sph:
            srows = _gather_tile_rows(torch.cat([centers, radii[:, None]],
                                                -1), sl.s_idx)
            for a, e in _tile_blocks(t_tiles, sl.s_idx.shape[-1] * tile_p):
                sr = srows[a:e]
                occ_t[a:e] = _segment_occluded(
                    so_t[a:e], p_t[a:e], lpos, sr[..., 0], sr[..., 1],
                    sr[..., 2], sr[..., 3], sl.s_valid[a:e])
            if sl.hot_ids is not None:
                # the hot tiles test every sphere, so ks need only cover
                # the other tiles
                every = torch.ones((1, n_sph), dtype=torch.bool,
                                   device=device)
                occ_h = torch.cat([_segment_occluded(
                    so_t[ids], p_t[ids], lpos, centers[None, :, 0],
                    centers[None, :, 1], centers[None, :, 2],
                    radii[None, :], every)
                    for ids in (sl.hot_ids[a:e] for a, e in _tile_blocks(
                        sl.hot_ids.shape[0], n_sph * tile_p))])
                occ_t = occ_t.index_copy(0, sl.hot_ids, occ_h)
        if n_box:
            sbrows = _gather_tile_rows(btab, sl.sb_idx)
            for a, e in _tile_blocks(t_tiles, sl.sb_idx.shape[-1] * tile_p):
                occ_t[a:e] |= _box_segment_occluded(
                    sbrows[a:e], sl.sb_valid[a:e], so_t[a:e], p_t[a:e], lpos)
        occ = occ_t.reshape(-1)
        if pln.count:
            tpl, _, _ = plane_candidates(
                shadow_org, lpos[None, :] - hit.p, pln.normal, pln.offset,
                torch.ones((pln.count,), dtype=torch.bool, device=device),
                with_normals=False)
            occ = occ | torch.any(tpl < 1.0, dim=-1)
        occ_cols.append(occ)

    occluded = (torch.stack(occ_cols, dim=-1) if n_lights
                else torch.zeros((r_total, 0), dtype=torch.bool,
                                 device=device))
    aux = _cull_aux(lists, shadows, j_local, jb_local)
    return hit, occluded, aux


# ---------------------------------------------------------------------------
# The differentiable ops: a culled engine's forward, the analytic winner
# backward
# ---------------------------------------------------------------------------

class _CulledGeometryOp(torch.autograd.Function):
    """The differentiable op of both culled engines. Forward: the engine's
    geometry(scene, origins, dirs, active) -> (Hit, occluded, CullAux),
    run without autograd (this module's culled_geometry for 'culled',
    ops/culled.py's for culled_pallas). Backward: _culled_bwd. Takes the
    forward, the scene (for its non-differentiable columns), tile_p,
    whether the forward ran the hot-primary pass (kernel 2's, which
    rebuilds winner lists), the replay's dot product, the active mask of
    secondary mode (None in shared mode; it gets no cotangent), the
    geometry leaves of
    _GEOMETRY_LEAVES and the rays; returns the Hit fields, the occlusion
    and the CullAux fields, of which only t, p and n are
    differentiable."""

    @staticmethod
    def forward(ctx, geometry, scene, tile_p, hot_pass, dot, active,
                *tensors):
        leaves, (origins, dirs) = tensors[:-2], tensors[-2:]
        scene = _with_leaves(scene, leaves)
        hit, occ, aux = geometry(scene, origins, dirs, active)
        ctx.mark_non_differentiable(*hit[3:], occ, *aux)
        ctx.save_for_backward(*tensors, hit.inside, hit.obj_id, hit.hit,
                              aux.p_idx, aux.j_local, aux.b_idx,
                              aux.jb_local)
        ctx.scene, ctx.tile_p, ctx.hot_pass, ctx.dot = (scene, tile_p,
                                                        hot_pass, dot)
        return (*hit, occ, *aux)

    @staticmethod
    def backward(ctx, gt, gp, gn, *_):
        saved = ctx.saved_tensors
        n_in = len(_GEOMETRY_LEAVES) + 2
        leaves, (origins, dirs) = saved[:n_in - 2], saved[n_in - 2:n_in]
        inside, obj_id, hit_mask, p_idx, j_local, b_idx, jb_local = \
            saved[n_in:]
        scene = _with_leaves(ctx.scene, leaves)
        hit = Hit(t=None, p=None, n=None, inside=inside, material_id=None,
                  obj_id=obj_id, hit=hit_mask)
        aux = CullAux(**{f: None for f in CullAux._fields})._replace(
            p_idx=p_idx, j_local=j_local, b_idx=b_idx, jb_local=jb_local)
        need = ctx.needs_input_grad[6:]
        grads = _culled_bwd(scene, origins, dirs, hit, aux, ctx.tile_p,
                            gt, gp, gn, need_rays=any(need[-2:]),
                            hot_pass=ctx.hot_pass, dot=ctx.dot)
        return (None,) * 6 + tuple(g if want else None
                                   for g, want in zip(grads, need))


def _apply_op(geometry, scene: Scene, origins, dirs, tile_p: int,
              active=None, hot_pass: bool = False, dot=sum_dot):
    """(Hit, occluded, CullAux) of geometry(scene, origins, dirs, active)
    with the analytic winner backward (_CulledGeometryOp)."""
    leaves = [getattr(getattr(scene, part), field)
              for part, field in _GEOMETRY_LEAVES]
    out = _CulledGeometryOp.apply(geometry, scene, tile_p, hot_pass, dot,
                                  active, *leaves, origins, dirs)
    return (Hit(*out[:_N_HIT]), out[_N_HIT], CullAux(*out[_N_HIT + 1:]))


def culled_geometry_op(scene: Scene, origins, dirs, tile_p: int, kp: int,
                       ks: int, shadow_lights: tuple | None = None,
                       hot_m: int = 0, kb: int = 0, ksb: int = 0):
    """culled_geometry (engine 'culled') with the analytic backward of the
    reference's ``accel.culled_geometry_op``: gradients of hit.t, hit.p and
    hit.n flow to the spheres' center and radius, the boxes' mins, maxs,
    position and angles, the planes' normal and offset, and the rays. The
    winner replay sums its dot products as the forward does
    (geometry.component_dot), as the dense engine 'xla''s replay does.
    Arguments and results as culled_geometry."""
    return _apply_op(
        lambda s, o, d, _act: culled_geometry(s, o, d, tile_p, kp, ks,
                                              shadow_lights, hot_m, kb, ksb),
        scene, origins, dirs, tile_p, dot=component_dot)


def bounce_culled_geometry_op(scene: Scene, origins, dirs, active,
                              tile_p: int, kp: int, ks: int,
                              shadow_lights: tuple | None = None,
                              hot_m: int = 0, kb: int = 0, ksb: int = 0):
    """culled_geometry in secondary mode (per-ray origins, the active mask;
    no hot-primary pass) with the same analytic backward, which never
    assumed a shared origin: the reference's
    ``accel.bounce_culled_geometry_op``, the bounce children of engine
    'culled'. active gets no cotangent."""
    return _apply_op(
        lambda s, o, d, act: culled_geometry(s, o, d, tile_p, kp, ks,
                                             shadow_lights, hot_m, kb, ksb,
                                             active=act),
        scene, origins, dirs, tile_p, active, dot=component_dot)


# ---------------------------------------------------------------------------
# Host-side K sizing
# ---------------------------------------------------------------------------

@torch.no_grad()
def cull_counts(scene: Scene, camera, height: int, width: int,
                tile=(32, 32), shadow_lights: tuple | None = None):
    """Per-tile survivor counts for K sizing: (primary (T,), shadow (L, T),
    box-primary (T,), box-shadow (L, T)).

    Two passes: (1) primary-cone mask sums, (2) a narrow-phase pass at the
    just-measured kp — shadows disabled — to get hit positions, from which
    the per-light shadow-cone mask sums follow. The hit pass is engine
    'culled''s culled_geometry, as in the reference."""
    from openglraytracer_tpu_torch.ops.raygen import generate_rays

    th, tw = tile
    origins, dirs = generate_rays(camera, height, width)
    o = tile_image(origins, th, tw).reshape(-1, 3)
    d = tile_image(dirs, th, tw).reshape(-1, 3)
    tile_p = th * tw
    n = max(int(scene.spheres.count), 1)
    n_lights = scene.lights.count
    zero = torch.zeros((o.shape[0] // tile_p,), dtype=torch.int32,
                       device=o.device)
    objects = _cull_objects(scene)
    p_count, pb_count = _survivor_counts(
        objects, _primary_cones(o, d, tile_p), zero)
    kp0 = min(n, max(8, int(torch.max(p_count))))

    no_shadows = tuple([False] * n_lights)
    hit, _, _ = culled_geometry(scene, o, d, tile_p, kp0, 8, no_shadows)
    s_count, sb_count = _shadow_counts(scene, objects, hit, tile_p,
                                       shadow_lights, zero)
    return p_count, s_count, pb_count, sb_count


def suggest_cull_sizes(scene: Scene, camera, height: int, width: int,
                       tile=(32, 32), headroom: float = 1.5,
                       min_k: int = 8,
                       shadow_lights: tuple | None = None) -> tuple[int, int]:
    """(kp, ks) with headroom over the observed maximum survivor counts,
    rounded up to a multiple of 8 and clipped to N. Lights that
    shadow_lights disables (default: static_shadow_mask) do not size ks.
    Sphere sizes only: box lists stay dense (use suggest_cull_config for
    box-aware specs). Runs on the host: call it once, outside a frame."""
    if shadow_lights is None:
        from openglraytracer_tpu_torch.ops.shading import static_shadow_mask
        shadow_lights = static_shadow_mask(scene)
    p_count, s_count, _, _ = (x.cpu().numpy() for x in cull_counts(
        scene, camera, height, width, tile, shadow_lights))
    n = int(scene.spheres.count)

    def size(c):
        k = int(np.ceil(float(np.max(c)) * headroom))
        return max(min_k, min(n, -(-k // 8) * 8))

    ks = size(s_count) if s_count.size else min_k
    return size(p_count), ks


def check_cull_overflow(scene: Scene, camera, height: int, width: int,
                        cull, shadow_lights: tuple | None = None):
    """Recount survivors for the current scene against a fixed cull spec
    ``((th, tw), kp, ks[, hot_m[, kb, ksb]])``: None when the spec still
    covers every tile, else a dict of the observed maxima and re-suggested
    sizes. Advisory and host-side (the fit loop calls it at log points
    after the device-side overflow counter fired)."""
    (th, tw), kp, ks, hot_m, kb, ksb = parse_cull_spec(cull)
    p_count, s_count, pb_count, sb_count = (
        x.cpu().numpy() for x in cull_counts(scene, camera, height, width,
                                             (th, tw), shadow_lights))
    n_box = int(scene.boxes.count)
    kb, ksb = _box_k(kb, n_box), _box_k(ksb, n_box)
    max_p = int(np.max(p_count))
    if s_count.size:
        counts = np.sort(s_count, axis=-1)[:, ::-1]         # (L, T) desc
        # hot tiles scan every sphere: only the (hot_m+1)-th largest count
        # onward must fit in ks
        cold_max = int(counts[:, min(hot_m, counts.shape[-1] - 1)].max()) \
            if hot_m < counts.shape[-1] else 0
    else:
        cold_max = 0
    max_pb = int(np.max(pb_count)) if n_box else 0
    max_sb = int(np.max(sb_count)) if (n_box and sb_count.size) else 0
    if max_p <= kp and cold_max <= ks and max_pb <= kb and max_sb <= ksb:
        return None
    return {"max_primary": max_p, "kp": kp,
            "max_shadow_cold": cold_max, "ks": ks,
            "max_box_primary": max_pb, "kb": kb,
            "max_box_shadow": max_sb, "ksb": ksb,
            "suggest_kp": max(kp, -(-max_p // 8) * 8),
            "suggest_ks": max(ks, -(-cold_max // 8) * 8),
            "suggest_kb": max(kb, max_pb),
            "suggest_ksb": max(ksb, max_sb)}


def suggest_cull_config(scene: Scene, camera, height: int, width: int,
                        tile=(32, 32), headroom: float = 1.5,
                        min_k: int = 8,
                        shadow_lights: tuple | None = None,
                        hot: bool = True):
    """Full cull spec — ((th, tw), kp, ks, hot_m) for sphere/plane scenes,
    ((th, tw), kp, ks, hot_m, kb, ksb) when the scene has OBBs — with the
    hot-tile shadow strategy: sweep M over a small grid and pick the
    (ks(M), M) minimizing the modeled narrow-phase cost T*max(ks, 64) + M*N
    per light, where ks(M) is the max over the COLD tiles (the (M+1)-th
    largest count). Box sizes are max-count based. hot=False sizes ks from
    the global max with hot_m = 0. Runs on the host: call it once, outside
    a frame."""
    if shadow_lights is None:
        from openglraytracer_tpu_torch.ops.shading import static_shadow_mask
        shadow_lights = static_shadow_mask(scene)
    p_count, s_count, pb_count, sb_count = cull_counts(
        scene, camera, height, width, tile, shadow_lights)
    return _spec_from_counts(scene, p_count, s_count, pb_count, sb_count,
                             tile, headroom, min_k, hot)


def _spec_from_counts(scene: Scene, p_count, s_count, pb_count, sb_count,
                      tile, headroom: float, min_k: int, hot: bool = True,
                      hot_primary: bool = False, w_count=None):
    """Size a cull spec from measured survivor counts (shared by
    suggest_cull_config and suggest_child_cull_config).

    hot_primary=True (bounce-child specs): also size a hot-primary tile
    budget, appended as the 7th element, with the quantile/cost model of
    the shadow lists: Kp becomes a quantile cap and the hot_p over-cap
    tiles take kernel 2's hot launch over the global table (see
    cull_hot_p). Its m grid reaches T/2, since bounce counts are far
    heavier-tailed than shadow counts. w_count (T,), the measured
    distinct-winner counts, floors Kp so that the winner lists the hot pass
    rebuilds do not overflow at the measured frame."""
    n = int(scene.spheres.count)
    n_box = int(scene.boxes.count)
    p_count, s_count, pb_count, sb_count = (
        x.cpu().numpy() for x in (p_count, s_count, pb_count, sb_count))

    def rounded(k):
        return max(min_k, min(n, -(-int(np.ceil(k * headroom)) // 8) * 8))

    def box_spec():
        if not n_box:
            return (0, 0) if hot_primary else ()
        kb = max(1, min(n_box, int(np.ceil(int(np.max(pb_count))
                                           * headroom))))
        max_sb = int(np.max(sb_count)) if sb_count.size else 0
        ksb = max(1, min(n_box, int(np.ceil(max_sb * headroom))))
        return (kb, ksb)

    hot_p = 0
    if hot_primary and n:
        counts_p = np.sort(p_count)[::-1]                    # (T,) desc
        t_tiles = counts_p.shape[0]
        w = None if w_count is None else w_count.cpu().numpy()
        w_floor = rounded(int(np.max(w))) if w is not None and w.size \
            else min_k
        best = None
        for m in [0] + [max(1, t_tiles // f) for f in (64, 32, 16, 8, 4, 2)]:
            kp_m = int(counts_p[min(m, t_tiles - 1)]) if m < t_tiles else 0
            kp_m = max(rounded(kp_m), w_floor)
            # the shadow model's units: per-tile list work (64-lane floor)
            # plus m dense scans of all N
            cost = t_tiles * max(kp_m, 64) + m * n
            if best is None or cost < best[0]:
                best = (cost, kp_m, m)
        _, kp, hot_p = best
    else:
        kp = rounded(int(np.max(p_count))) if n else min_k
    tail = (hot_p,) if hot_primary else ()
    if not s_count.size:
        return (tile, kp, min_k, 0) + box_spec() + tail

    if not hot:
        ks = rounded(int(np.max(s_count)))
        return (tile, kp, ks, 0) + box_spec() + tail

    counts = np.sort(s_count, axis=-1)[:, ::-1]              # (L, T) desc
    t_tiles = counts.shape[-1]
    best = None
    for m in [0] + [max(1, t_tiles // f) for f in (64, 32, 16, 8)]:
        ks_m = int(counts[:, min(m, t_tiles - 1)].max()) if m < t_tiles \
            else 0
        ks_m = rounded(ks_m)
        # the reference measured its narrow phase flat below K ~ 64, so
        # reductions below that never pay for the hot pass; the port keeps
        # the same model so that both packages size identical specs
        cost = t_tiles * max(ks_m, 64) + m * n
        if best is None or cost < best[0]:
            best = (cost, ks_m, m)
    _, ks, hot_m = best
    if n == 0:
        hot_m = 0                       # the hot pass is a sphere-only path
    return (tile, kp, ks, hot_m) + box_spec() + tail


@torch.no_grad()
def bounce_cull_counts(scene: Scene, camera, height: int, width: int,
                       cull, shadow_lights: tuple | None = None):
    """Per-tile survivor counts of the bounce children of a culled trace,
    the sizing pass of secondary-ray culling.

    Traces the primaries once (shadows off) with the parent spec ``cull``,
    spawns the reflection and (when a material is transparent) refraction
    bundles, and measures (1) the bounce-cone sphere/box survivor counts and
    (2) from an exact child pass at Kp = the measured maximum, the children's
    per-light shadow-cone counts and distinct-winner counts. Counts are the
    elementwise maximum over the live branches, so one child spec covers
    both. Returns (p_count (T,), s_count (L, T), pb_count (T,),
    sb_count (L, T), w_count (T,), wb_count (T,)).

    Counts are measured at bounce level 1; deeper levels reuse the spec, and
    their overflow counters report any level that outgrows it. The hit
    passes are engine 'culled''s culled_geometry, as in the reference."""
    from openglraytracer_tpu_torch.models.scene import AIR_IOR
    from openglraytracer_tpu_torch.ops.raygen import generate_rays
    from openglraytracer_tpu_torch.ops.render import BOUNCE_EPS
    from openglraytracer_tpu_torch.ops.shading import static_bounce_mask
    from openglraytracer_tpu_torch.ops.transforms import reflect, refract

    (th, tw), kp, ks, hot_m, kb, ksb = parse_cull_spec(cull)
    tile_p = th * tw
    origins, dirs = generate_rays(camera, height, width)
    o = tile_image(origins, th, tw).reshape(-1, 3)
    d = tile_image(dirs, th, tw).reshape(-1, 3)
    n_sph = int(scene.spheres.count)
    n_box = int(scene.boxes.count)
    t_tiles = o.shape[0] // tile_p
    no_shadows = tuple([False] * scene.lights.count)
    has_refl, has_refr = static_bounce_mask(scene)
    zero = torch.zeros((t_tiles,), dtype=torch.int32, device=o.device)
    objects = _cull_objects(scene)

    def bundle_counts(co, cd, active):
        return _survivor_counts(
            objects, _primary_cones(co, cd, tile_p, active), zero)

    hit, _, _ = culled_geometry(scene, o, d, tile_p, kp, 8, no_shadows, 0,
                                kb, ksb)
    mat_id = hit.material_id.long()
    p_count = pb_count = zero
    bundles = []
    if has_refl:
        refl = scene.materials.reflectivity[mat_id]
        active = hit.hit & (refl > 0.0)
        co = hit.p + hit.n * BOUNCE_EPS
        cd = reflect(d, hit.n)
        p_count, pb_count = bundle_counts(co, cd, active)
        bundles.append((active, co, cd))
    if has_refr:
        active_r = hit.hit & (scene.materials.transparency[mat_id] > 0.0)
        ior = scene.materials.refraction_index[mat_id]
        ratio = torch.where(hit.inside, ior / AIR_IOR, AIR_IOR / ior)
        co_r = hit.p - hit.n * BOUNCE_EPS
        cd_r = refract(d, hit.n, ratio[:, None])
        pc_r, pb_r = bundle_counts(co_r, cd_r, active_r)
        p_count = torch.maximum(p_count, pc_r)
        pb_count = torch.maximum(pb_count, pb_r)
        bundles.append((active_r, co_r, cd_r))
    kp_c = min(max(n_sph, 1), max(8, int(torch.max(p_count))))
    kb_c = max(1, int(torch.max(pb_count))) if n_box else 0

    def distinct(gid_t, hm_t, lo, n_obj):
        """(T,) number of distinct winners among objects [lo, lo + n_obj)."""
        if not n_obj:
            return zero
        return torch.sum(_winner_mask(gid_t, hm_t, lo, n_obj)[0], dim=-1,
                         dtype=torch.int32)

    def child_shadow_counts(co, cd, active):
        hit, _, _ = culled_geometry(scene, co, cd, tile_p, kp_c, 8,
                                    no_shadows, 0, kb_c, 1, active=active)
        gid_t = hit.obj_id.reshape(t_tiles, tile_p)
        hm_t = hit.hit.reshape(t_tiles, tile_p)
        return _shadow_counts(scene, objects, hit, tile_p, shadow_lights,
                              zero) + (distinct(gid_t, hm_t, 0, n_sph),
                                       distinct(gid_t, hm_t, n_sph, n_box))

    # shadow counts from each live branch's own child hit points
    s_count = sb_count = w_count = wb_count = None
    for active, co, cd in bundles:
        counts = child_shadow_counts(co, cd, active)
        if s_count is None:
            s_count, sb_count, w_count, wb_count = counts
        else:
            s_count, sb_count, w_count, wb_count = (
                torch.maximum(a, b) for a, b in zip(
                    (s_count, sb_count, w_count, wb_count), counts))
    if s_count is None:   # no live bounce branch
        s_count = sb_count = torch.zeros((0, t_tiles), dtype=torch.int32,
                                         device=o.device)
        w_count = wb_count = zero
    return p_count, s_count, pb_count, sb_count, w_count, wb_count


def suggest_child_cull_config(scene: Scene, camera, height: int, width: int,
                              cull, headroom: float = 1.5, min_k: int = 8,
                              shadow_lights: tuple | None = None,
                              hot_primary: bool = True):
    """Cull spec of the bounce children of a culled trace: measure the
    bounce-bundle survivor counts
    (bounce_cull_counts) and size them as the primary spec is sized.
    ``cull`` is the parent spec, whose tile the children inherit (they keep
    the parent's tile-major ray order).

    hot_primary=True (the default, the sizing of culled_pallas children):
    ((th, tw), kp, ks, hot_m, kb, ksb, hot_p), Kp a quantile cap plus a
    budget of hot_p over-cap tiles for kernel 2's hot launch.
    hot_primary=False, for the children of engine 'culled'
    (accel.bounce_culled_geometry_op, which has no hot-primary pass): a
    spec of suggest_cull_config's form, Kp from the maximum count, so that
    no list truncates. Runs on the host: call it once, outside a frame."""
    if shadow_lights is None:
        from openglraytracer_tpu_torch.ops.shading import static_shadow_mask
        shadow_lights = static_shadow_mask(scene)
    tile = parse_cull_spec(cull)[0]
    p_count, s_count, pb_count, sb_count, w_count, _ = bounce_cull_counts(
        scene, camera, height, width, cull, shadow_lights)
    return _spec_from_counts(scene, p_count, s_count, pb_count, sb_count,
                             tile, headroom, min_k, hot_primary=hot_primary,
                             w_count=w_count)


def suggest_stack_cull_config(scene: Scene, camera, height: int, width: int,
                              tile: tuple, headroom: float = 1.5,
                              shadow_lights: tuple | None = None):
    """Cull spec ((th, tw), kp, ks, 0, kb, ksb, hot_p) that covers every
    step of the culled stack engine (render.trace_rays_stack with cull):
    the elementwise maximum of the primary spec (hot=False) and the depth-1
    bounce-child spec, with hot_m 0 (the hot shadow tiles are sized from
    primary hits and do not carry over to bounce bundles). hot_p is every
    tile when the child spec has a hot budget at all: deep refractive
    bundles outgrow the depth-1 measurement, and kernel 2's hot launch is
    gated by each tile's count, so a tile under the cap scans no row. Kp is
    then floored at min(N, tile_h tile_w), since a tile of that many rays
    hits at most that many distinct objects, so no winner list overflows
    at any depth. Deeper bundles are usually narrower than depth 1's; the
    per-step overflow count stays the check. Runs on the host: call it
    once, outside a frame."""
    prim = suggest_cull_config(scene, camera, height, width, tile,
                               headroom=headroom, hot=False,
                               shadow_lights=shadow_lights)
    child = suggest_child_cull_config(scene, camera, height, width, prim,
                                      headroom=headroom,
                                      shadow_lights=shadow_lights)
    _, pkp, pks, _, pkb, pksb = parse_cull_spec(prim)
    _, ckp, cks, _, ckb, cksb = parse_cull_spec(child)
    t_tiles = (height // tile[0]) * (width // tile[1])
    hot_p = t_tiles if cull_hot_p(child) else 0
    kp = max(pkp, ckp)
    if hot_p:
        kp = max(kp, min(int(scene.spheres.count), tile[0] * tile[1]))
    return (tile, kp, max(pks, cks), 0, max(pkb, ckb), max(pksb, cksb),
            hot_p)
