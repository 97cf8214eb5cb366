"""Broad-phase acceleration: tile-cone culling for primary and shadow rays.

Port of the parts of ``openglraytracer_tpu/ops/accel.py`` that engine
``culled_pallas`` runs: the tile layout, the conservative cone tests, top-K
survivor compaction, the survivor tables and records, the dense hot-tile
shadow pass, survivor-routed material rows and the host-side sizing of the
cull spec.

  1. Partition the image into pixel tiles. All primary rays of a tile share
     the camera origin and span a narrow cone: axis = mean direction,
     cos(half-angle) = min over the tile of dot(axis, dir).
  2. Conservatively test every sphere (and every box's bounding sphere)
     against every tile cone.
  3. Compact each tile's survivors to a static top-K list in ascending
     object order (first-object-wins ties are preserved) and scan only those
     in the narrow phase (``ops/culled.py``).
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

from openglraytracer_tpu_torch.models.scene import Scene
from openglraytracer_tpu_torch.ops.intersect import (_DIV_EPS, _SQRT_EPS,
                                                     INF_T, Hit)
from openglraytracer_tpu_torch.ops.shading import SHADOW_EPS, material_table

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


def sphere_vs_cone(apex, axis, cos_half, centers, radii, max_dist=None):
    """Conservative overlap of spheres with per-tile cones.

    apex (T, 3) or (3,); axis (T, 3); cos_half (T,); centers (N, 3);
    radii (N,); optional max_dist (T,) range prune (occluder center within
    max_dist + r of the apex). Returns (T, N) bool.

    angle(axis, v) <= half + asin(r/|v|) is evaluated as
    cos(angle) >= cos(half)*cos(asin) - sin(half)*sin(asin) with
    sin(asin) = r/|v| — no trig. A cone with cos_half <= 0 keeps everything.
    """
    apex = torch.atleast_2d(apex)                        # (T or 1, 3)
    vx = centers[None, :, 0] - apex[:, 0:1]              # (T, N)
    vy = centers[None, :, 1] - apex[:, 1:2]
    vz = centers[None, :, 2] - apex[:, 2:3]
    d2 = vx * vx + vy * vy + vz * vz
    inv_d = torch.rsqrt(torch.clamp(d2, min=_SQRT_EPS))
    ca = (axis[:, 0:1] * vx + axis[:, 1:2] * vy + axis[:, 2:3] * vz) * inv_d

    r_eff = radii[None, :]
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


def compact_mask(mask, k: int):
    """Dense top-K compaction of a (T, N) bool mask.

    Returns (idx (T, K) int32 ascending among survivors, valid (T, K) bool,
    count (T,) int32 true survivor totals — count > K means overflow).
    idx is unspecified where ~valid (consumers gate on valid). The key
    (N - i) * mask makes top-K return survivors in ascending id order."""
    n = mask.shape[-1]
    key = torch.where(mask, torch.arange(n, 0, -1, dtype=torch.int32,
                                         device=mask.device)[None, :], 0)
    vals, idx = torch.topk(key, min(k, n), dim=-1)
    return (idx.to(torch.int32), vals > 0,
            torch.sum(mask, dim=-1, dtype=torch.int32))


def _dense_compact(apex, axis, cos_half, centers, radii, k,
                   max_dist=None, tile_valid=None):
    mask = sphere_vs_cone(apex, axis, cos_half, centers, radii,
                          max_dist=max_dist)
    if tile_valid is not None:
        mask = mask & tile_valid[:, None]
    return compact_mask(mask, k)


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


def shadow_cull_mask(scene: Scene, shadow_org, hit_mask, tile_p: int, lpos,
                     centers=None, radii=None):
    """Conservative per-tile occluder mask (T, N) for one light; empty tiles
    (no hits) keep nothing. centers/radii default to the scene's spheres;
    pass box bounding spheres to cull OBB occluders."""
    axis_s, cos_s, max_d, empty = shadow_tile_cones(shadow_org, hit_mask,
                                                    tile_p, lpos)
    if centers is None:
        centers, radii = scene.spheres.center, scene.spheres.radius
    smask = sphere_vs_cone(lpos, axis_s, cos_s, centers, radii,
                           max_dist=max_d)
    return smask & (~empty)[:, None]


def _segment_occluded(so_t, p_t, lpos, scx, scy, scz, sr, valid):
    """Sqrt-free shadow-segment occlusion for batched tiles — the dense
    pass over hot shadow tiles. so_t, p_t: (B, P, 3) cast origins / hit
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


def cull_overflow_count(aux: CullAux) -> torch.Tensor:
    """Device int32 scalar: number of (tile, list) slots whose true survivor
    count exceeded the static K actually used — renders where objects were
    DROPPED. s_overflow/sb_overflow already exclude hot tiles (they get
    dense passes)."""
    kp_eff = aux.p_idx.shape[-1]
    kb_eff = aux.b_idx.shape[-1]
    ovf = torch.sum(aux.p_count > kp_eff, dtype=torch.int32)
    ovf = ovf + torch.sum(aux.s_overflow, dtype=torch.int32)
    if kb_eff:
        ovf = ovf + torch.sum(aux.b_count > kb_eff, dtype=torch.int32)
        ovf = ovf + torch.sum(aux.sb_overflow, dtype=torch.int32)
    return ovf


def _select_winner_rows(surv_rows, j_local, rows):
    """rows (T, P, F) with each ray whose survivor slot j_local >= 0 set to
    surv_rows[t, j_local] — an index gather through the (T, K) list."""
    f = surv_rows.shape[-1]
    win = torch.gather(surv_rows, 1,
                       j_local.clamp(min=0).long()[..., None].expand(
                           -1, -1, f))
    return torch.where((j_local >= 0)[..., None], win, rows)


def culled_material_rows(scene: Scene, hit: Hit, aux: CullAux, tile_p: int):
    """Per-ray packed material rows (R, 20) routed through the tile survivor
    lists: gather materials for the (T, K) survivors, pick each ray's winner
    row by its survivor slot, and patch plane winners from the plane table.
    Rays that hit nothing get zero rows."""
    r_total = hit.t.shape[0]
    t_tiles = r_total // tile_p
    n_sph = scene.spheres.count
    n_box = scene.boxes.count
    table = material_table(scene)                           # (K, 20)

    rows = torch.zeros((t_tiles, tile_p, table.shape[-1]), dtype=table.dtype,
                       device=table.device)
    if n_sph:
        surv_mid = _gather_tile_rows(scene.spheres.material_id[:, None],
                                     aux.p_idx)[..., 0]
        rows = _select_winner_rows(_gather_tile_rows(table, surv_mid),
                                   aux.j_local, rows)
    if n_box:
        surv_mid_b = _gather_tile_rows(scene.boxes.material_id[:, None],
                                       aux.b_idx)[..., 0]
        rows = _select_winner_rows(_gather_tile_rows(table, surv_mid_b),
                                   aux.jb_local, rows)
    rows = rows.reshape(r_total, -1)

    pln = scene.planes
    if pln.count:
        pln_rows = torch.index_select(table, 0, pln.material_id)  # (P, 20)
        is_pln = hit.hit & (hit.obj_id >= n_sph + n_box)
        pid = torch.clamp(hit.obj_id - n_sph - n_box, 0, pln.count - 1)
        rows = torch.where(is_pln[:, None],
                           torch.index_select(pln_rows, 0, pid), rows)
    return rows


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
    the per-light shadow-cone mask sums follow. The hit pass is this
    package's own narrow phase (``ops/culled.py``: the primary-hit kernel
    on a CUDA device, its plain version on the CPU)."""
    from openglraytracer_tpu_torch.ops.culled import culled_geometry
    from openglraytracer_tpu_torch.ops.raygen import generate_rays

    th, tw = tile
    origins, dirs = generate_rays(camera, height, width)
    o = tile_image(origins, th, tw).reshape(-1, 3)
    d = tile_image(dirs, th, tw).reshape(-1, 3)
    tile_p = th * tw
    n_sph = int(scene.spheres.count)
    n_box = int(scene.boxes.count)
    n = max(n_sph, 1)
    n_lights = scene.lights.count
    t_tiles = o.shape[0] // tile_p

    axis, cos_half = tile_cones(d.reshape(-1, tile_p, 3))
    zero = torch.zeros((t_tiles,), dtype=torch.int32, device=o.device)
    p_count = zero
    if n_sph:
        p_count = torch.sum(sphere_vs_cone(o[0], axis, cos_half,
                                           scene.spheres.center,
                                           scene.spheres.radius),
                            dim=-1, dtype=torch.int32)
    pb_count = zero
    if n_box:
        bc, br = box_bounding_spheres(scene)
        pb_count = torch.sum(sphere_vs_cone(o[0], axis, cos_half, bc, br),
                             dim=-1, dtype=torch.int32)
    kp0 = min(n, max(8, int(torch.max(p_count))))

    no_shadows = tuple([False] * n_lights)
    hit, _, _ = culled_geometry(scene, o, d, tile_p, kp0, 8, no_shadows)
    shadow_org = hit.p + hit.n * SHADOW_EPS
    cols = []
    bcols = []
    for li in range(n_lights):
        if shadow_lights is not None and not shadow_lights[li]:
            cols.append(zero)
            bcols.append(zero)
            continue
        lpos = scene.lights.position[li]
        if n_sph:
            smask = shadow_cull_mask(scene, shadow_org, hit.hit, tile_p, lpos)
            cols.append(torch.sum(smask, dim=-1, dtype=torch.int32))
        else:
            cols.append(zero)
        if n_box:
            bmask = shadow_cull_mask(scene, shadow_org, hit.hit, tile_p,
                                     lpos, centers=bc, radii=br)
            bcols.append(torch.sum(bmask, dim=-1, dtype=torch.int32))
        else:
            bcols.append(zero)
    empty = torch.zeros((0, t_tiles), dtype=torch.int32, device=o.device)
    s_count = torch.stack(cols) if cols else empty
    sb_count = torch.stack(bcols) if bcols else empty
    return p_count, s_count, pb_count, sb_count


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
                      tile, headroom: float, min_k: int, hot: bool = True):
    """Size a cull spec from measured survivor counts. (The reference's
    hot-PRIMARY sizing for bounce bundles is not ported yet.)"""
    n = int(scene.spheres.count)
    n_box = int(scene.boxes.count)
    p_count, s_count, pb_count, sb_count = (
        x.cpu().numpy() for x in (p_count, s_count, pb_count, sb_count))

    def rounded(k):
        return max(min_k, min(n, -(-int(np.ceil(k * headroom)) // 8) * 8))

    def box_spec():
        if not n_box:
            return ()
        kb = max(1, min(n_box, int(np.ceil(int(np.max(pb_count))
                                           * headroom))))
        max_sb = int(np.max(sb_count)) if sb_count.size else 0
        ksb = max(1, min(n_box, int(np.ceil(max_sb * headroom))))
        return (kb, ksb)

    kp = rounded(int(np.max(p_count))) if n else min_k
    if not s_count.size:
        return (tile, kp, min_k, 0) + box_spec()

    if not hot:
        ks = rounded(int(np.max(s_count)))
        return (tile, kp, ks, 0) + box_spec()

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
    return (tile, kp, ks, hot_m) + box_spec()
