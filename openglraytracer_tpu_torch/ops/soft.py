"""Soft-coverage differentiable forward: the silhouette-aware fit path.

Port of ``openglraytracer_tpu/ops/soft.py``. The hard engines' gradients
are straight-through at a silhouette: a sphere's coverage carries no
derivative, so a fit cannot see coverage mismatch. This forward smooths it
(SoftRas-style):

  * Coverage: ``alpha_i = sigmoid((1 - (d_perp/r)^2) / bw)`` per sphere,
    the hard test ``d_perp < r`` as ``bw -> 0`` (the logit is normalised by
    r^2, so one bandwidth serves every sphere size).
  * Depth: ``w_i = alpha_i * exp(-t_i / gamma)`` normalised over spheres,
    planes and the background, the nearest hit as ``gamma -> 0``; the
    exponents are taken relative to the per-ray least t, so none
    overflows.
  * Shading: the Phong ADS terms of shading.phong_core (with the
    reference's rgb * alpha), without shadows: a soft fit compares soft
    renders against soft-rendered targets at the same (bw, gamma), for
    which the true scene is an exact optimum.
  * Primitives: spheres and planes. Boxes raise.

At 4096 spheres a dense (R x N) pass is too big; the broad phase reuses the
tile cones of ops/accel.py with every radius inflated to cover the
sigmoid's support (``expand_factor``), compacted to per-tile survivor lists
(``compact_mask``: the compaction kernel for masks of 1024 spheres or more
on the GPU) under the culled engines' never-silent overflow count. Tiles
run in blocks of ``tile_block`` (by default as many as fit ``block_pairs``
ray-sphere pairs), each under ``torch.utils.checkpoint`` while autograd
records, so a step holds one block's (B, P, K) working set. Every block
launches the same ~1,400 elementwise operations over its forward, its
recompute and its backward, so fewer, larger blocks trade device memory
(~340 bytes a pair while a block's backward runs) for launches.

Traced (utils/profiling.py, while a profiler records): the broad phase's
spans ``broad_phase/soft_tile_cones`` and ``broad_phase/soft_compact``, a
block's forward ``soft_composite/block`` and its recompute in the backward
``soft_composite/recompute``; counters ``soft_rays``, ``soft_kept_pairs``
(valid survivor slots times their tile's rays; every pair on the dense
pass) and ``soft_live_pairs`` (ray-sphere pairs whose coverage is non-zero
after the cut and the front gate, counted in the forward only).
"""

from __future__ import annotations

import math

import torch

from openglraytracer_tpu_torch.models.scene import Scene
from openglraytracer_tpu_torch.ops.intersect import (_safe_normalize,
                                                     _safe_sqrt,
                                                     maybe_checkpoint)
from openglraytracer_tpu_torch.ops.shading import _safe_pow, material_table
from openglraytracer_tpu_torch.utils.profiling import count, span, tracing

# alpha = sigmoid(logit) is ~3e-4 at logit = -8: inflating every radius so
# the cone cull keeps spheres down to that alpha bounds the compositing
# error of culling at ~1e-3 in the darkest channel, below fit-loss noise.
_LOGIT_REACH = 8.0
_T_EPS = 1.0e-3          # front-facing gate
# Coverage below this is cut to exactly zero: the depth softmax would
# otherwise let an alpha ~ 1e-9 sphere win a pixel once the background's
# weight underflows (a halo, and a 1/den blowup, NaN in the backward at
# float32), and it bounds the error of the expanded-radius cull.
_ALPHA_CUT = 1.0e-3
# ray-sphere pairs a culled block holds by default (~2.9 GB of a block's
# backward at ~340 bytes a pair)
BLOCK_PAIRS = 1 << 23


def _max(x, c: float):
    """jnp.maximum(x, c): torch.maximum splits the gradient at a tie as
    JAX does (clamp would pass all of it); the constant is filled on x's
    device, so no host copy."""
    return torch.maximum(x, x.new_full((), c))


def _min(x, c: float):
    return torch.minimum(x, x.new_full((), c))


def expand_factor(bw: float) -> float:
    """Radius inflation covering the sigmoid's support: alpha(logit=-8)
    is negligible, and (d/r)^2 = 1 + 8 bw there."""
    return math.sqrt(1.0 + _LOGIT_REACH * float(bw))


def suggest_soft_cull(scene: Scene, camera, height: int, width: int,
                      tile: tuple, bw: float, headroom: float = 1.5):
    """Size the soft broad phase: the largest per-tile survivor count with
    bw-expanded radii, times headroom (a moving fit scene can outgrow it),
    rounded up to a multiple of 32 and at most N. Reads the counts on the
    host. Returns ((th, tw), k)."""
    from openglraytracer_tpu_torch.ops.accel import (sphere_vs_cone,
                                                     tile_cones, tile_image)
    from openglraytracer_tpu_torch.ops.raygen import generate_rays
    th, tw = tile
    origins, dirs = generate_rays(camera, height, width)
    axis, cos_half = tile_cones(tile_image(dirs, th, tw))
    apex = origins.reshape(-1, 3)[0]
    mask = sphere_vs_cone(apex, axis, cos_half, scene.spheres.center,
                          scene.spheres.radius * expand_factor(bw))
    kmax = int(torch.amax(torch.sum(mask, dim=-1)))
    k = max(32, -(-int(math.ceil(kmax * headroom)) // 32) * 32)
    return (th, tw), min(k, int(scene.spheres.count))


def _phong_terms(m_rows, lights, px, py, pz, nx, ny, nz, dx, dy, dz):
    """Shadowless Phong ADS over component tensors of any broadcastable
    shape (...,). m_rows (..., 20) packed material_table rows. Returns
    (r, g, b) composited as phong.rgb * phong.a."""
    m_amb = m_rows[..., 0:4]
    m_diff = m_rows[..., 4:8]
    m_spec = m_rows[..., 8:12]
    m_emis = m_rows[..., 12:16]
    m_shin = m_rows[..., 16]

    inv = torch.rsqrt(_max(dx * dx + dy * dy + dz * dz, 1e-20))
    vx, vy, vz = -dx * inv, -dy * inv, -dz * inv        # view dir

    acc = m_amb.new_zeros(m_amb.shape[:-1] + (4,))
    for j in range(lights.position.shape[0]):
        lp = lights.position[j]
        acc = acc + lights.ambient[j] * m_amb
        tlx, tly, tlz = lp[0] - px, lp[1] - py, lp[2] - pz
        linv = torch.rsqrt(_max(tlx * tlx + tly * tly + tlz * tlz, 1e-20))
        lx, ly, lz = tlx * linv, tly * linv, tlz * linv
        cos_t = lx * nx + ly * ny + lz * nz
        # light_ref = normalize(reflect(-light_dir, n)) = 2 cos_t n - l
        rx, ry, rz = (2 * cos_t * nx - lx, 2 * cos_t * ny - ly,
                      2 * cos_t * nz - lz)
        rinv = torch.rsqrt(_max(rx * rx + ry * ry + rz * rz, 1e-20))
        cos_p = (rx * vx + ry * vy + rz * vz) * rinv
        acc = acc + lights.diffuse[j] * m_diff * _max(cos_t, 0.0)[..., None]
        acc = acc + lights.specular[j] * m_spec \
            * _safe_pow(cos_p, m_shin)[..., None]
    acc = acc + m_emis
    out = acc[..., :3] * acc[..., 3:4]
    return out[..., 0], out[..., 1], out[..., 2]


def _composite_block(scene: Scene, mat_tab, o, d, sph_rows, sph_valid,
                     bw: float, gamma: float, t_bg: float,
                     count_live: bool = False):
    """Soft composite of one block. o, d: (B, P, 3); sph_rows (B, K, 6)
    [cx cy cz r mat gid] survivor rows (or (1, N, 6) dense); sph_valid
    (B, K). Returns (B, P, 3). count_live: add the block's live pairs to
    the soft_live_pairs counter while tracing (its forward, not a
    recompute)."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]          # (B, P)
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]

    cx = sph_rows[..., 0][:, None, :]                     # (B, 1, K)
    cy = sph_rows[..., 1][:, None, :]
    cz = sph_rows[..., 2][:, None, :]
    rr = sph_rows[..., 3][:, None, :]
    ocx = ox[..., None] - cx                              # (B, P, K)
    ocy = oy[..., None] - cy
    ocz = oz[..., None] - cz
    b = ocx * dx[..., None] + ocy * dy[..., None] + ocz * dz[..., None]
    oc2 = ocx * ocx + ocy * ocy + ocz * ocz
    r2 = _max(rr * rr, 1e-12)
    disc = r2 - (oc2 - b * b)                             # r^2 - d_perp^2
    alpha = torch.sigmoid(disc / (bw * r2))
    # _safe_sqrt keeps the silhouette derivative finite (sqrt(max(disc, 0))
    # gives 0 * inf = NaN in the backward exactly on the silhouette)
    t_hit = -b - _safe_sqrt(disc)                         # closest approach
    front = (t_hit > _T_EPS) & sph_valid[:, None, :]      # on miss (disc<0)
    alpha = torch.where(front & (alpha > _ALPHA_CUT), alpha, 0.0)
    if count_live and tracing():
        count("soft_live_pairs", torch.count_nonzero(alpha))
    t_sph = _min(_max(t_hit, _T_EPS), t_bg)

    # sphere shading at p = o + t d, n = (p - c) / |p - c|
    px = ox[..., None] + t_sph * dx[..., None]
    py = oy[..., None] + t_sph * dy[..., None]
    pz = oz[..., None] + t_sph * dz[..., None]
    nx_, ny_, nz_ = px - cx, py - cy, pz - cz
    ninv = torch.rsqrt(_max(nx_ * nx_ + ny_ * ny_ + nz_ * nz_, 1e-20))
    mat_ids = sph_rows[..., 4].to(torch.int64)            # exact small floats
    m_sph = torch.index_select(mat_tab, 0, mat_ids.reshape(-1)).reshape(
        mat_ids.shape + (mat_tab.shape[-1],))[:, None]    # (B, 1, K, 20)
    sr, sg, sb = _phong_terms(m_sph, scene.lights, px, py, pz,
                              nx_ * ninv, ny_ * ninv, nz_ * ninv,
                              dx[..., None], dy[..., None], dz[..., None])

    # planes: hard coverage (plane geometry is never a soft-fit trainable)
    pls = scene.planes
    t_pl_list, col_pl_list = [], []
    for i in range(pls.count):
        n_unit = _safe_normalize(pls.normal[i])
        nd = n_unit[0] * dx + n_unit[1] * dy + n_unit[2] * dz     # (B, P)
        no = n_unit[0] * ox + n_unit[1] * oy + n_unit[2] * oz
        off = pls.offset[i] * torch.rsqrt(
            _max(torch.sum(pls.normal[i] ** 2), 1e-20))
        t = (off - no) / torch.where(torch.abs(nd) < 1e-9,
                                     torch.where(nd < 0, -1e-9, 1e-9), nd)
        hit = (torch.abs(nd) > 1e-9) & (t > _T_EPS)
        t = _min(_max(t, _T_EPS), t_bg)
        ppx, ppy, ppz = ox + t * dx, oy + t * dy, oz + t * dz
        sgn = torch.where(nd > 0.0, -1.0, 1.0)
        m_pl = torch.index_select(mat_tab, 0,
                                  pls.material_id[i:i + 1].long())[0]
        pr, pg, pb = _phong_terms(m_pl, scene.lights, ppx, ppy, ppz,
                                  sgn * n_unit[0], sgn * n_unit[1],
                                  sgn * n_unit[2], dx, dy, dz)
        t_pl_list.append(torch.where(hit, t, t_bg))
        col_pl_list.append((torch.where(hit, pr, 0.0),
                            torch.where(hit, pg, 0.0),
                            torch.where(hit, pb, 0.0),
                            hit.to(t.dtype)))

    # softmax over depth, stabilised by the per-ray least t over LIVE
    # elements (alpha > 0): a dead sphere can sit nearer than t_min, where
    # the raw exponent is positive; the clamp zeroes exactly those, so no
    # 0 * exp(+inf) NaN and no approximation of any live weight
    t_eff = torch.where(alpha > 0.0, t_sph, t_bg)
    t_min = torch.amin(t_eff, dim=-1)                     # (B, P)
    for t_pl in t_pl_list:
        t_min = torch.minimum(t_min, t_pl)
    t_min = _min(t_min, t_bg)

    w_sph = alpha * torch.exp(_min((t_min[..., None] - t_sph) / gamma, 0.0))
    den = torch.sum(w_sph, dim=-1)
    num_r = torch.sum(w_sph * sr, dim=-1)
    num_g = torch.sum(w_sph * sg, dim=-1)
    num_b = torch.sum(w_sph * sb, dim=-1)
    for t_pl, (pr, pg, pb, a_pl) in zip(t_pl_list, col_pl_list):
        w = a_pl * torch.exp((t_min - t_pl) / gamma)
        den = den + w
        num_r = num_r + w * pr
        num_g = num_g + w * pg
        num_b = num_b + w * pb
    w_bg = torch.exp((t_min - t_bg) / gamma)              # bg color = black
    den = den + w_bg
    inv = 1.0 / _max(den, 1e-20)
    return torch.stack([num_r * inv, num_g * inv, num_b * inv], dim=-1)


def soft_render_rays(scene: Scene, origins, dirs, *, bw: float, gamma: float,
                     cull=None, t_bg: float = 200.0, tile_block: int = 0,
                     block_pairs: int = BLOCK_PAIRS,
                     with_cull_stats: bool = False):
    """Soft forward over flat rays. origins/dirs (R, 3), dirs unit.

    cull: None for a dense (R x N) pass, or ((th, tw) | tile_p, k) with
    tile-major rays (accel.tile_image order) sharing one origin for the
    coned broad phase, whose (T, N) mask compacts through compact_mask
    outside the checkpointed blocks. tile_block: tiles a block (0: at most
    block_pairs ray-sphere pairs a block, dividing the tile count). Returns
    (R, 3),
    and with with_cull_stats also the overflow count, a device int32
    scalar (tiles whose survivors exceeded k; 0 on the dense pass). Never
    waits for the device."""
    from openglraytracer_tpu_torch.ops.accel import (_gather_tile_rows,
                                                     _sphere_table,
                                                     compact_mask,
                                                     sphere_vs_cone,
                                                     tile_cones)
    if scene.boxes.count:
        raise ValueError("soft forward supports spheres+planes only "
                         "(the graded fit configs); boxes have no "
                         "soft-coverage model")
    r = origins.shape[0]
    table = _sphere_table(scene)
    mat_tab = material_table(scene)
    ovf = torch.zeros((), dtype=torch.int32, device=origins.device)
    count("soft_rays", r)

    if cull is None:
        count("soft_kept_pairs", r * table.shape[0])
        valid = torch.ones((1, table.shape[0]), dtype=torch.bool,
                           device=origins.device)
        with span("soft_composite", "block"):
            out = _composite_block(scene, mat_tab, origins[None], dirs[None],
                                   table[None], valid, bw, gamma, t_bg,
                                   count_live=True)[0]
        return (out, ovf) if with_cull_stats else out

    tile, k = cull
    tile_p = tile[0] * tile[1] if isinstance(tile, tuple) else int(tile)
    if r % tile_p:
        raise ValueError(f"rays must be tile-major with tile_p {tile_p} | "
                         f"R {r}")
    t_tiles = r // tile_p
    o_t = origins.reshape(t_tiles, tile_p, 3)
    d_t = dirs.reshape(t_tiles, tile_p, 3)
    with span("broad_phase", "soft_tile_cones"):
        axis, cos_half = tile_cones(d_t)
        mask = sphere_vs_cone(origins[0], axis, cos_half,
                              scene.spheres.center,
                              scene.spheres.radius * expand_factor(bw))
    with span("broad_phase", "soft_compact"):
        idx, valid, found = compact_mask(mask, k)
        ovf = torch.sum(found > min(k, int(scene.spheres.count)),
                        dtype=torch.int32)
        rows = _gather_tile_rows(table, idx)               # (T, K, 6)
    count("soft_kept_pairs", valid, lambda v: v.sum() * tile_p)

    if tile_block <= 0:
        # bound the (B, P, K) working set by block_pairs ray-sphere pairs
        tile_block = max(1, int(block_pairs)
                         // max(tile_p * idx.shape[1], 1))
        while t_tiles % tile_block:
            tile_block -= 1

    def block_fn():
        """One block's composite; under checkpoint its second call is the
        backward's recompute."""
        ran = False

        def block(o_b, d_b, rows_b, valid_b):
            nonlocal ran
            again, ran = ran, True
            with span("soft_composite", "recompute" if again else "block"):
                return _composite_block(scene, mat_tab, o_b, d_b, rows_b,
                                        valid_b, bw, gamma, t_bg,
                                        count_live=not again)
        return block

    # under checkpoint a backward recomputes each block's forward instead
    # of holding every block's (B, P, K) intermediates
    out = torch.cat([
        maybe_checkpoint(block_fn(), o_t[s:s + tile_block],
                         d_t[s:s + tile_block], rows[s:s + tile_block],
                         valid[s:s + tile_block])
        for s in range(0, t_tiles, tile_block)]).reshape(r, 3)
    return (out, ovf) if with_cull_stats else out


def soft_render(scene: Scene, camera, height: int, width: int, *,
                bw: float = 0.05, gamma: float = 0.3, cull=None,
                t_bg: float = 200.0, block_pairs: int = BLOCK_PAIRS,
                with_cull_stats: bool = False):
    """Soft forward over the full image -> (H, W, 3) [, overflow count], on
    the camera's device. With cull = ((th, tw), k) (soft.suggest_soft_cull)
    the rays are tiled through accel.tile_image and the result untiled
    back, as in the hard culled engines, in blocks of at most block_pairs
    ray-sphere pairs (soft_render_rays)."""
    from openglraytracer_tpu_torch.ops.accel import tile_image, untile_image
    from openglraytracer_tpu_torch.ops.raygen import generate_rays
    origins, dirs = generate_rays(camera, height, width)
    if cull is None:
        out = soft_render_rays(scene, origins.reshape(-1, 3),
                               dirs.reshape(-1, 3), bw=bw, gamma=gamma,
                               cull=None, t_bg=t_bg,
                               with_cull_stats=with_cull_stats)
        img = (out[0] if with_cull_stats else out).reshape(height, width, 3)
        return (img, out[1]) if with_cull_stats else img
    (th, tw), k = cull
    o = tile_image(origins, th, tw).reshape(-1, 3)
    d = tile_image(dirs, th, tw).reshape(-1, 3)
    out = soft_render_rays(scene, o, d, bw=bw, gamma=gamma,
                           cull=((th, tw), k), t_bg=t_bg,
                           block_pairs=block_pairs,
                           with_cull_stats=with_cull_stats)
    flat = out[0] if with_cull_stats else out
    img = untile_image(flat, height, width, th, tw)
    return (img, out[1]) if with_cull_stats else img
