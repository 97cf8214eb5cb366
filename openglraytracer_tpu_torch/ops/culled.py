"""Culled narrow phase: tile survivor lists scanned by CUDA kernels.

Port of ``openglraytracer_tpu/ops/pallas_culled.py`` (named for what it is:
nothing here is Pallas). The broad phase of ``ops/accel.py``, which engine
'culled' and the sizing passes share, feeds hand-written Hopper kernels
that scan only each tile's survivors:

  torch   broad phase: tile cones -> conservative sphere-vs-cone masks ->
          survivor compaction (kernel 6, ``compact_mask``, for masks of at
          least 1024 objects) -> survivor rows gathered per tile
  kernel A (``primary_hit``, csrc/primary_hit.cu) in shared-pinhole mode
          (primary rays): the per-ray-invariant terms are precomputed into
          the rows (oc = o0 - c and qc for spheres, the local-space origin
          for boxes); closest hit over the tile's sphere rows, box rows and
          all planes
  kernel 2 (``primary_hit_ray``, the same source) in per-ray mode (bounce
          children, whose origins differ per ray): raw rows, the
          origin-relative terms per ray; and its hot launch over the global
          object table for the tiles whose bounce cone kept too many
          objects, followed by the rebuild of their winner lists
  torch   shadow cones from the hit points -> per-light survivor lists;
          the hot_m tiles with the most sphere survivors per light
  kernel B (``shadow_occlusion``, csrc/shadow_occlusion.cu): per-light
          occlusion of the unnormalized surface->light segment into the
          (R, L) occlusion, over each tile's survivor rows, then, in a
          second launch (``shadow_occlusion_hot``), on the hot (tile,
          light) pairs over every sphere of the scene
  torch   CullAux assembly

Each kernel wrapper runs its plain PyTorch version (``*_plain``, same
arguments, vectorized over rays, looping over survivor slots in the
kernel's fold order) on CPU tensors and launches the kernel on CUDA
tensors, counting launches in ``kernels.LAUNCHES``.

``culled_geometry_op`` (primary rays) and ``bounce_culled_geometry_op``
(bounce children) are the differentiable entries, the counterparts of the
reference's ``culled_pallas_geometry_op`` and
``bounce_culled_pallas_geometry_op``: the forward is ``culled_geometry``
and the backward the tile-structured winner replay of
``ops/accel.py _culled_bwd``. Only t, p and n carry gradients.
"""

from __future__ import annotations

import functools

import torch

from openglraytracer_tpu_torch import kernels
from openglraytracer_tpu_torch.models.scene import MISS_T, Scene
from openglraytracer_tpu_torch.ops.accel import (
    _apply_op,
    _box_k,
    _box_table,
    _cull_aux,
    _cull_objects,
    _gather_tile_rows,
    _primary_cones,
    _primary_lists,
    _segment_occluded,
    _shadow_lists,
    _sphere_table,
    _top_tiles,
    _winner_mask,
    compact_mask,
)
from openglraytracer_tpu_torch.ops.intersect import (_DIV_EPS, _SQRT_EPS,
                                                     INF_T, Hit,
                                                     _inv_safe)
from openglraytracer_tpu_torch.ops.shading import SHADOW_EPS
from openglraytracer_tpu_torch.ops.transforms import _fma
from openglraytracer_tpu_torch.utils.profiling import count, span

SPH_COLS, BOX_COLS, PLN_COLS = 8, 24, 16


# ---------------------------------------------------------------------------
# Kernel A: primary closest hit over survivor rows
# ---------------------------------------------------------------------------

def primary_hit_plain(dirs, sph, box, pln, cnt, tile_p: int, origins=None,
                      tile_ids=None):
    """Plain version of kernels A and 2. dirs (R, 3); sph (T, Kp, 8); box
    (T, Kb, 24); pln (P, 16); cnt (T, 2) int32 per-tile trip counts.
    Returns the raw record (t (R,), n (R, 3), inside (R,) bool,
    mat (R,) int32, gid (R,) int32, slot (R,) int32): t is INF_T where no
    candidate hit, n is unit (zero where t >= MISS_T), gid -1 and slot 0
    where nothing hit, slot -1 for planes.

    origins (R, 3) switches on per-ray mode (kernel 2): the rows hold raw
    geometry and the origin-relative terms are computed per ray (row
    layouts in csrc/primary_hit.cu). tile_ids (M,) makes it the hot launch:
    block b scans ray tile tile_ids[b] against the one global table
    sph (1, N, 8) / box (1, Nb, 24) with counts cnt (M, 2), and the M *
    tile_p results come in block order with the global row id as slot."""
    n_blk = cnt.shape[0]
    d = dirs.reshape(-1, tile_p, 3)
    o = None if origins is None else origins.reshape(-1, tile_p, 3)
    if tile_ids is not None:
        d, o = d[tile_ids.long()], o[tile_ids.long()]
        sph = sph.expand(n_blk, -1, -1)
        box = box.expand(n_blk, -1, -1)
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    if o is not None:
        ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    # the sphere quadratic's fused multiply-adds: see csrc/primary_hit.cu
    qa = _fma(dz, dz, _fma(dx, dx, dy * dy))
    qa_ok = qa > _DIV_EPS
    inv_2qa = 0.5 / torch.where(qa < _DIV_EPS, _DIV_EPS, qa)

    tb = torch.full_like(dx, INF_T)
    nx, ny, nz = (torch.zeros_like(dx) for _ in range(3))
    ins = torch.zeros_like(dx, dtype=torch.bool)
    flp = torch.zeros_like(ins)
    mat = torch.zeros_like(dx, dtype=torch.int32)
    gid = torch.full_like(mat, -1)
    slot = torch.zeros_like(mat)

    def take(upd, new, old):
        return torch.where(upd, new, old)

    for j in range(sph.shape[1]):
        row = sph[:, j, :, None]                    # (T, 8, 1)
        if o is None:
            ocx, ocy, ocz, qc = row[:, 0], row[:, 1], row[:, 2], row[:, 3]
        else:                                       # row [c(3) r^2 ...]
            ocx, ocy, ocz = ox - row[:, 0], oy - row[:, 1], oz - row[:, 2]
            qc = _fma(ocz, ocz, _fma(ocx, ocx, ocy * ocy)) - row[:, 3]
        qb = 2.0 * _fma(dz, ocz, _fma(dx, ocx, dy * ocy))
        qd = _fma(qb, qb, -(4.0 * qa * qc))
        ok = (qd >= 0.0) & qa_ok & (row[:, 6] > 0.5) \
            & (j < cnt[:, 0:1])
        sq = torch.where(ok, torch.sqrt(torch.clamp(qd, min=_SQRT_EPS)), 0.0)
        t1 = (-qb + sq) * inv_2qa
        t2 = (-qb - sq) * inv_2qa
        t_near = torch.minimum(t1, t2)
        t_far = torch.maximum(t1, t2)
        ok = ok & (t_far >= 0.0)
        is_in = ok & (t_near < 0.0)
        t = torch.where(is_in, t_far, t_near)
        ok = ok & (t > 0.0)
        t = torch.where(ok, t, INF_T)
        upd = t < tb
        tb = take(upd, t, tb)
        nx = take(upd, _fma(t, dx, ocx), nx)        # u = p - c
        ny = take(upd, _fma(t, dy, ocy), ny)
        nz = take(upd, _fma(t, dz, ocz), nz)
        ins = take(upd, is_in, ins)
        flp = take(upd, is_in, flp)
        mat = take(upd, row[:, 4].to(torch.int32), mat)
        gid = take(upd, row[:, 5].to(torch.int32), gid)
        slot = take(upd, j, slot)

    for j in range(box.shape[1]):
        row = box[:, j, :, None]                    # (T, 24, 1)
        bm0, bm1, bm2 = row[:, 0], row[:, 1], row[:, 2]
        bx0, bx1, bx2 = row[:, 3], row[:, 4], row[:, 5]
        r00, r01, r02 = row[:, 9], row[:, 10], row[:, 11]
        r10, r11, r12 = row[:, 12], row[:, 13], row[:, 14]
        r20, r21, r22 = row[:, 15], row[:, 16], row[:, 17]
        if o is None:
            rox, roy, roz = row[:, 6], row[:, 7], row[:, 8]
        else:                                       # R^T (o - pos)
            wx, wy, wz = ox - row[:, 6], oy - row[:, 7], oz - row[:, 8]
            rox = r00 * wx + r10 * wy + r20 * wz
            roy = r01 * wx + r11 * wy + r21 * wz
            roz = r02 * wx + r12 * wy + r22 * wz
        rdx = r00 * dx + r10 * dy + r20 * dz        # R^T d
        rdy = r01 * dx + r11 * dy + r21 * dz
        rdz = r02 * dx + r12 * dy + r22 * dz
        ix, iy, iz = _inv_safe(rdx), _inv_safe(rdy), _inv_safe(rdz)
        tax, tbx = (bm0 - rox) * ix, (bx0 - rox) * ix
        tay, tby = (bm1 - roy) * iy, (bx1 - roy) * iy
        taz, tbz = (bm2 - roz) * iz, (bx2 - roz) * iz
        t1x, t2x = torch.minimum(tax, tbx), torch.maximum(tax, tbx)
        t1y, t2y = torch.minimum(tay, tby), torch.maximum(tay, tby)
        t1z, t2z = torch.minimum(taz, tbz), torch.maximum(taz, tbz)
        t_near = torch.maximum(t1x, torch.maximum(t1y, t1z))
        t_far = torch.minimum(t2x, torch.minimum(t2y, t2z))
        ok = (t_near < t_far) & (t_far > 0.0) & (row[:, 20] > 0.5) \
            & (j < cnt[:, 1:2])
        is_in = ok & (t_near < 0.0)
        t = torch.where(is_in, t_far, t_near)
        ok = ok & (t > 0.0)
        t = torch.where(ok, t, INF_T)
        upd = t < tb
        # face pick: exact equality with the winning slab boundary,
        # y before z
        by = torch.where(is_in, t2y, t1y)
        bz = torch.where(is_in, t2z, t1z)
        face_y = t == by
        face_z = (~face_y) & (t == bz)
        face_x = ~(face_y | face_z)
        rd_face = torch.where(face_y, rdy, torch.where(face_z, rdz, rdx))
        sgn = torch.where(rd_face > 0.0, -1.0, 1.0)
        nlx = torch.where(face_x, sgn, 0.0)
        nly = torch.where(face_y, sgn, 0.0)
        nlz = torch.where(face_z, sgn, 0.0)
        tb = take(upd, t, tb)
        nx = take(upd, r00 * nlx + r01 * nly + r02 * nlz, nx)
        ny = take(upd, r10 * nlx + r11 * nly + r12 * nlz, ny)
        nz = take(upd, r20 * nlx + r21 * nly + r22 * nlz, nz)
        ins = take(upd, is_in, ins)
        flp = take(upd, False, flp)
        mat = take(upd, row[:, 18].to(torch.int32), mat)
        gid = take(upd, row[:, 19].to(torch.int32), gid)
        slot = take(upd, j, slot)

    for k in range(pln.shape[0]):
        row = pln[k]
        off_no = row[7]       # off - n.o0 (per-ray mode: off)
        if o is not None:
            off_no = off_no - (row[0] * ox + row[1] * oy + row[2] * oz)
        nd = row[0] * dx + row[1] * dy + row[2] * dz
        t = off_no * _inv_safe(nd)
        ok = (torch.abs(nd) > 1.0e-9) & (t > 0.0)
        t = torch.where(ok, t, INF_T)
        upd = t < tb          # strict: objects beat planes at equal t
        s = torch.where(nd > 0.0, -1.0, 1.0)
        tb = take(upd, t, tb)
        nx = take(upd, row[4] * s, nx)
        ny = take(upd, row[5] * s, ny)
        nz = take(upd, row[6] * s, nz)
        ins = take(upd, False, ins)
        flp = take(upd, False, flp)
        mat = take(upd, row[8].to(torch.int32), mat)
        gid = take(upd, row[9].to(torch.int32), gid)
        slot = take(upd, -1, slot)

    hit_f = (tb < MISS_T).to(dx.dtype)
    inv_len = torch.rsqrt(torch.clamp(nx * nx + ny * ny + nz * nz,
                                      min=_SQRT_EPS))
    sgn = torch.where(flp, -inv_len, inv_len) * hit_f
    n = torch.stack([nx * sgn, ny * sgn, nz * sgn], dim=-1)
    return (tb.reshape(-1), n.reshape(-1, 3), ins.reshape(-1),
            mat.reshape(-1), gid.reshape(-1), slot.reshape(-1))


@torch.no_grad()
@kernels.wrapper
def primary_hit(dirs, sph, box, pln, cnt, tile_p: int):
    """Kernel A (csrc/primary_hit.cu) on CUDA tensors, its plain version on
    CPU tensors; arguments and results as primary_hit_plain."""
    if kernels.on_cpu(dirs):
        return primary_hit_plain(dirs, sph, box, pln, cnt, tile_p)
    dev = dirs.device
    t_tiles, kp, kb, n_pln = cnt.shape[0], sph.shape[1], box.shape[1], \
        pln.shape[0]
    r_total = t_tiles * tile_p
    f32 = torch.float32
    kernels.check("dirs", dirs, dev, f32, (r_total, 3))
    kernels.check("sph", sph, dev, f32, (t_tiles, kp, SPH_COLS))
    kernels.check("box", box, dev, f32, (t_tiles, kb, BOX_COLS))
    kernels.check("pln", pln, dev, f32, (n_pln, PLN_COLS))
    kernels.check("cnt", cnt, dev, torch.int32, (t_tiles, 2))
    t = torch.empty(r_total, dtype=f32, device=dev)
    n = torch.empty((r_total, 3), dtype=f32, device=dev)
    inside = torch.empty(r_total, dtype=torch.bool, device=dev)
    mat, gid, slot = (torch.empty(r_total, dtype=torch.int32, device=dev)
                      for _ in range(3))
    kernels.launch("oglrt_primary_hit", dev, dirs, sph, box, pln, cnt,
                   t_tiles, tile_p, kp, kb, n_pln, t, n, inside, mat, gid,
                   slot)
    kernels.LAUNCHES["primary_hit"] += 1
    return t, n, inside, mat, gid, slot


@torch.no_grad()
@kernels.wrapper
def primary_hit_ray(dirs, origins, sph, box, pln, cnt, tile_p: int,
                    tile_ids=None):
    """Kernel 2 (csrc/primary_hit.cu, per-ray mode) on CUDA tensors, its
    plain version on CPU tensors; arguments and results as
    primary_hit_plain with origins. tile_ids None: the cold launch over the
    T tiles' survivor rows (counted as ``primary_hit_ray``); tile_ids (M,)
    int32: the hot launch over the global tables (``primary_hit_hot``)."""
    if kernels.on_cpu(dirs):
        return primary_hit_plain(dirs, sph, box, pln, cnt, tile_p,
                                 origins=origins, tile_ids=tile_ids)
    dev = dirs.device
    n_blocks, kp, kb, n_pln = cnt.shape[0], sph.shape[1], box.shape[1], \
        pln.shape[0]
    r_in = dirs.shape[0]
    f32 = torch.float32
    kernels.check("dirs", dirs, dev, f32, (r_in, 3))
    kernels.check("origins", origins, dev, f32, (r_in, 3))
    if r_in % tile_p:
        raise ValueError(f"dirs: {r_in} rays are not whole tiles of {tile_p}")
    row_tiles = n_blocks if tile_ids is None else 1
    kernels.check("sph", sph, dev, f32, (row_tiles, kp, SPH_COLS))
    kernels.check("box", box, dev, f32, (row_tiles, kb, BOX_COLS))
    kernels.check("pln", pln, dev, f32, (n_pln, PLN_COLS))
    kernels.check("cnt", cnt, dev, torch.int32, (n_blocks, 2))
    if tile_ids is None:
        if n_blocks * tile_p != r_in:
            raise ValueError(f"cnt: {n_blocks} tiles for {r_in} rays")
    else:
        kernels.check("tile_ids", tile_ids, dev, torch.int32, (n_blocks,))
    r_out = n_blocks * tile_p
    t = torch.empty(r_out, dtype=f32, device=dev)
    n = torch.empty((r_out, 3), dtype=f32, device=dev)
    inside = torch.empty(r_out, dtype=torch.bool, device=dev)
    mat, gid, slot = (torch.empty(r_out, dtype=torch.int32, device=dev)
                      for _ in range(3))
    kernels.launch("oglrt_primary_hit_ray", dev, dirs, origins, sph, box, pln,
                   cnt, tile_ids, n_blocks, tile_p, kp, kb, n_pln, t, n,
                   inside, mat, gid, slot)
    kernels.LAUNCHES["primary_hit_ray" if tile_ids is None
                     else "primary_hit_hot"] += 1
    return t, n, inside, mat, gid, slot


# ---------------------------------------------------------------------------
# Kernel B (kernel 3): per-light shadow occlusion over survivor rows, and
# over the global sphere table on the hot (tile, light) pairs
# ---------------------------------------------------------------------------

def shadow_occlusion_plain(shadow_org, hit_p, lights, light_on: tuple, ssph,
                           sbox, pln, cnt, tile_p: int, hot_ids=None,
                           spheres=None):
    """Plain version of kernel B. shadow_org, hit_p (R, 3); lights (L, 3)
    positions; light_on static per-light bools; ssph (T, L, Ks, 4) [c r]
    survivor rows (r NaN in an invalid slot); sbox (T, L, Ksb, 24); pln
    (P, 16); cnt (T, L, 2) int32 per-(tile, light) trip counts, whose sphere
    count is -1 on a hot pair. hot_ids (L, M) int32, the hot tiles of each
    lit light (None: none): a hot pair's sphere occlusion is
    accel._segment_occluded over the global table spheres (N, 4) [c r].
    Returns occluded (R, L) bool: the segment is blocked by a sphere, a box
    or a plane."""
    t_tiles = cnt.shape[0]
    so = shadow_org.reshape(t_tiles, tile_p, 3)
    hp = hit_p.reshape(t_tiles, tile_p, 3)
    sx, sy, sz = so[..., 0], so[..., 1], so[..., 2]
    none = torch.zeros_like(sx, dtype=torch.bool)
    cols = []
    for li in range(lights.shape[0]):
        if not light_on[li]:
            cols.append(none.reshape(-1))
            continue
        tlx = lights[li, 0] - hp[..., 0]
        tly = lights[li, 1] - hp[..., 1]
        tlz = lights[li, 2] - hp[..., 2]
        qa = tlx * tlx + tly * tly + tlz * tlz
        qa_ok = qa > _DIV_EPS

        occ = none
        for j in range(ssph.shape[2]):
            row = ssph[:, li, j, :, None]           # (T, 4, 1)
            socx = sx - row[:, 0]
            socy = sy - row[:, 1]
            socz = sz - row[:, 2]
            r = row[:, 3]
            qb = 2.0 * (tlx * socx + tly * socy + tlz * socz)
            qcs = socx * socx + socy * socy + socz * socz - r * r
            f_end = qa + qb + qcs
            disc_ok = qb * qb >= 4.0 * qa * qcs
            vertex_in = (qb < 0.0) & (-qb < 2.0 * qa)
            blocked = torch.where(qcs < 0.0, f_end > 0.0,
                                  (f_end < 0.0) | (disc_ok & vertex_in))
            occ = occ | (blocked & qa_ok & (j < cnt[:, li, 0:1]))

        for j in range(sbox.shape[2]):
            row = sbox[:, li, j, :, None]           # (T, 24, 1)
            r00, r01, r02 = row[:, 9], row[:, 10], row[:, 11]
            r10, r11, r12 = row[:, 12], row[:, 13], row[:, 14]
            r20, r21, r22 = row[:, 15], row[:, 16], row[:, 17]
            wx = sx - row[:, 6]
            wy = sy - row[:, 7]
            wz = sz - row[:, 8]
            rox = r00 * wx + r10 * wy + r20 * wz
            roy = r01 * wx + r11 * wy + r21 * wz
            roz = r02 * wx + r12 * wy + r22 * wz
            rdx = r00 * tlx + r10 * tly + r20 * tlz
            rdy = r01 * tlx + r11 * tly + r21 * tlz
            rdz = r02 * tlx + r12 * tly + r22 * tlz
            ix, iy, iz = _inv_safe(rdx), _inv_safe(rdy), _inv_safe(rdz)
            tax, tbx = (row[:, 0] - rox) * ix, (row[:, 3] - rox) * ix
            tay, tby = (row[:, 1] - roy) * iy, (row[:, 4] - roy) * iy
            taz, tbz = (row[:, 2] - roz) * iz, (row[:, 5] - roz) * iz
            t1 = torch.maximum(torch.minimum(tax, tbx),
                               torch.maximum(torch.minimum(tay, tby),
                                             torch.minimum(taz, tbz)))
            t2 = torch.minimum(torch.maximum(tax, tbx),
                               torch.minimum(torch.maximum(tay, tby),
                                             torch.maximum(taz, tbz)))
            ok = (t1 < t2) & (t2 > 0.0) & (row[:, 18] > 0.5) \
                & (j < cnt[:, li, 1:2])
            t = torch.where(ok & (t1 < 0.0), t2, t1)
            occ = occ | (ok & (t > 0.0) & (t < 1.0))

        for k in range(pln.shape[0]):
            row = pln[k]
            nd = row[0] * tlx + row[1] * tly + row[2] * tlz
            no = row[0] * sx + row[1] * sy + row[2] * sz
            t = (row[3] - no) * _inv_safe(nd)
            occ = occ | ((torch.abs(nd) > 1.0e-9) & (t > 0.0) & (t < 1.0))

        if hot_ids is not None:
            ids = hot_ids[li].long()
            occ_h = _segment_occluded(
                so[ids], hp[ids], lights[li], spheres[None, :, 0],
                spheres[None, :, 1], spheres[None, :, 2],
                spheres[None, :, 3],
                torch.ones((1, spheres.shape[0]), dtype=torch.bool,
                           device=spheres.device))       # (M, P)
            occ = occ.index_copy(0, ids, occ[ids] | occ_h)
        cols.append(occ.reshape(-1))
    return torch.stack(cols, dim=-1)


def _shadow_c_args(shadow_org, hit_p, lights, light_on: tuple, ssph, sbox,
                   pln, cnt, tile_p: int, hot_ids=None, spheres=None):
    """The checked arguments of kernel B's two C functions, arguments as
    shadow_occlusion_plain, ending with the output occ (R, L), allocated
    here."""
    dev = shadow_org.device
    t_tiles, n_lights = cnt.shape[0], lights.shape[0]
    ks, ksb, n_pln = ssph.shape[2], sbox.shape[2], pln.shape[0]
    r_total = t_tiles * tile_p
    f32 = torch.float32
    if len(light_on) != n_lights or n_lights > 32:
        raise ValueError(f"light_on must have one flag per light (at most "
                         f"32), got {len(light_on)} for {n_lights} lights")
    kernels.check("shadow_org", shadow_org, dev, f32, (r_total, 3))
    kernels.check("hit_p", hit_p, dev, f32, (r_total, 3))
    kernels.check("lights", lights, dev, f32, (n_lights, 3))
    kernels.check("ssph", ssph, dev, f32, (t_tiles, n_lights, ks, 4))
    kernels.check("sbox", sbox, dev, f32, (t_tiles, n_lights, ksb, BOX_COLS))
    kernels.check("pln", pln, dev, f32, (n_pln, PLN_COLS))
    kernels.check("cnt", cnt, dev, torch.int32, (t_tiles, n_lights, 2))
    n_sph = n_hot = 0
    if hot_ids is not None:
        n_sph, n_hot = spheres.shape[0], hot_ids.shape[1]
        kernels.check("hot_ids", hot_ids, dev, torch.int32,
                      (n_lights, n_hot))
        kernels.check("spheres", spheres, dev, f32, (n_sph, 4))
    for name, x in (("ssph", ssph), ("spheres", spheres)):
        if x is not None and x.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads rows as float4 and "
                             "needs a 16-byte aligned tensor")
    mask = sum(1 << li for li, on in enumerate(light_on) if on)
    occ = torch.empty((r_total, n_lights), dtype=torch.bool, device=dev)
    return (shadow_org, hit_p, lights, mask, ssph, sbox, pln, cnt, t_tiles,
            tile_p, n_lights, ks, ksb, n_pln, spheres, n_sph, hot_ids, n_hot,
            occ)


@torch.no_grad()
@kernels.wrapper
def shadow_occlusion(shadow_org, hit_p, lights, light_on: tuple, ssph, sbox,
                     pln, cnt, tile_p: int, hot_ids=None, spheres=None):
    """Kernel B (csrc/shadow_occlusion.cu) on CUDA tensors, its plain
    version on CPU tensors; arguments and results as
    shadow_occlusion_plain. Two launches: every (ray, light) but the hot
    pairs' spheres (``shadow_occlusion``), then, where hot_ids is given,
    the hot pairs' spheres (``shadow_occlusion_hot``). The sphere count of
    cnt must be -1 on the pairs that hot_ids lists: the first launch leaves
    their spheres to the second."""
    if kernels.on_cpu(shadow_org):
        return shadow_occlusion_plain(shadow_org, hit_p, lights, light_on,
                                      ssph, sbox, pln, cnt, tile_p, hot_ids,
                                      spheres)
    c_args = _shadow_c_args(shadow_org, hit_p, lights, light_on, ssph, sbox,
                            pln, cnt, tile_p, hot_ids, spheres)
    dev = shadow_org.device
    kernels.launch("oglrt_shadow_occlusion", dev, *c_args)
    kernels.LAUNCHES["shadow_occlusion"] += 1
    if hot_ids is not None:
        kernels.launch("oglrt_shadow_hot", dev, *c_args)
        kernels.LAUNCHES["shadow_occlusion_hot"] += 1
    return c_args[-1]


# ---------------------------------------------------------------------------
# Row packing (small: T*K rows)
# ---------------------------------------------------------------------------

def _pad_cols(x, width: int):
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def _primary_sphere_rows(scene: Scene, o0, p_idx, p_valid):
    """(T, Kp, 8) kernel rows from the survivor lists: oc, qc precomputed.
    qc = |oc|^2 - r^2 with the squares summed by fused multiply-adds in
    axis order, as XLA's CPU compiler contracts the reference's jitted
    jnp.sum(oc * oc, axis=-1) (rounded op by op, qc flips the sign of the
    discriminant on tangent grazes at 4096 spheres)."""
    rows = _gather_tile_rows(_sphere_table(scene), p_idx)   # (T, Kp, 6)
    oc = o0[None, None, :] - rows[..., 0:3]
    ocx, ocy, ocz = oc[..., 0], oc[..., 1], oc[..., 2]
    qc = _fma(ocz, ocz, _fma(ocy, ocy, ocx * ocx)) \
        - rows[..., 3] * rows[..., 3]
    return torch.cat([
        oc, qc[..., None], rows[..., 4:6],
        p_valid.to(rows.dtype)[..., None],
        torch.zeros_like(qc)[..., None]], dim=-1)


def _primary_box_rows(scene: Scene, o0, b_idx, b_valid):
    """(T, Kb, 24) kernel rows: mins/maxs, local-space origin, rot, ids."""
    rows = _gather_tile_rows(_box_table(scene), b_idx)      # (T, Kb, 20)
    w = o0[None, None, :] - rows[..., 6:9]                  # o0 - pos
    rot = rows[..., 9:18].reshape(rows.shape[:2] + (3, 3))
    ro = torch.sum(rot * w[..., :, None], dim=-2)           # R^T w
    out = torch.cat([
        rows[..., 0:6], ro, rows[..., 9:18], rows[..., 18:20],
        b_valid.to(rows.dtype)[..., None]], dim=-1)         # (T, Kb, 21)
    return _pad_cols(out, BOX_COLS)


def _secondary_sphere_rows(scene: Scene, p_idx, p_valid):
    """(T, Kp, 8) [c(3) r^2 mat gid valid pad]: raw geometry for the per-ray
    kernel (there is no shared origin to precompute oc and qc against)."""
    rows = _gather_tile_rows(_sphere_table(scene), p_idx)   # (T, Kp, 6)
    r2 = rows[..., 3] * rows[..., 3]
    return torch.cat([
        rows[..., 0:3], r2[..., None], rows[..., 4:6],
        p_valid.to(rows.dtype)[..., None],
        torch.zeros_like(r2)[..., None]], dim=-1)


def _secondary_box_rows(scene: Scene, b_idx, b_valid):
    """(T, Kb, 24) [mins maxs pos rot9 mat gid valid ...]: the box position
    in slots 6:9 (the per-ray kernel computes R^T (o - pos) itself)."""
    rows = _gather_tile_rows(_box_table(scene), b_idx)      # (T, Kb, 20)
    out = torch.cat([rows, b_valid.to(rows.dtype)[..., None]], dim=-1)
    return _pad_cols(out, BOX_COLS)


def _plane_table(scene: Scene, o0, n_sph: int, n_box: int):
    """(P, 16) [n(3) off un(3) off-n.o0 mat gid ...]; raw normal for the
    candidate t, unit normal for the output normal."""
    pln = scene.planes
    nrm = pln.normal
    length = torch.sqrt(torch.clamp(
        torch.sum(nrm * nrm, dim=-1, keepdim=True), min=_SQRT_EPS))
    no = torch.sum(nrm * o0[None, :], dim=-1)
    gid = n_sph + n_box + torch.arange(pln.count, dtype=nrm.dtype,
                                       device=nrm.device)
    tab = torch.cat([nrm, pln.offset[:, None], nrm / length,
                     (pln.offset - no)[:, None],
                     pln.material_id.to(nrm.dtype)[:, None], gid[:, None]],
                    dim=-1)                                  # (P, 10)
    return _pad_cols(tab, PLN_COLS)


def _shadow_spheres(scene: Scene):
    """(N, 4) [c(3) r]: kernel B's global sphere table."""
    return torch.cat([scene.spheres.center, scene.spheres.radius[:, None]],
                     dim=-1)


def _shadow_sphere_rows(scene: Scene, s_idx, s_valid):
    """(T, Ks, 4) [c(3) r], r NaN in an invalid slot."""
    rows = _gather_tile_rows(_shadow_spheres(scene), s_idx)  # (T, Ks, 4)
    # r = NaN marks an invalid slot on purpose: kernel B's sphere test is
    # false on it. The one construction exempt from checked_render's NaN
    # check (utils/debug.py), here and where the rows are stacked for
    # kernel B's wrapper, the only reader.
    with kernels.unchecked():
        r = torch.where(s_valid, rows[..., 3], torch.nan)
        return torch.cat([rows[..., :3], r[..., None]], dim=-1)


def _shadow_box_rows(scene: Scene, sb_idx, sb_valid):
    """(T, Ksb, 24) [mins maxs pos rot9 valid ...]."""
    rows = _gather_tile_rows(_box_table(scene), sb_idx)     # (T, Ksb, 20)
    out = torch.cat([rows[..., 0:18], sb_valid.to(rows.dtype)[..., None]],
                    dim=-1)
    return _pad_cols(out, BOX_COLS)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

@torch.no_grad()
def culled_geometry(scene: Scene, origins, dirs, tile_p: int, kp: int,
                    ks: int, shadow_lights: tuple | None = None,
                    hot_m: int = 0, kb: int = 0, ksb: int = 0,
                    active=None, hot_p: int = 0):
    """Culled narrow phase. Port of ``pallas_culled.culled_geometry_pallas``.

    origins/dirs (R, 3) in tile-major order (accel.tile_image); tile_p rays
    per tile; kp/ks sphere survivor caps; kb/ksb box caps (0 = all boxes);
    the hot_m tiles with the most shadow survivors per light test every
    sphere of the scene in kernel B; shadow_lights static per-light bools
    (None = all cast).

    active None: shared-pinhole mode (primary rays, one origin; kernel A).
    active (R,) bool: secondary mode for bounce children (kernel 2): per-ray
    origins, the bounce-cone broad phase (origin-box apex, Minkowski
    expanded objects; rays with a zero direction, the refract() result of
    total internal reflection, cannot open a cone) and inactive rays forced
    to miss. hot_p > 0 (secondary mode only): the hot_p tiles whose cone
    keeps more objects than Kp (or Kb) scan the global object table in
    kernel 2's hot launch instead of their lists, which is exact, and their
    lists are rebuilt as the ascending distinct winners, capped at Kp, so
    material routing and the backward treat them as cold tiles; a hot tile
    reports overflow only when its winners exceed Kp.
    Returns (Hit (R,), occluded (R, L) bool, CullAux).

    Traced (utils/profiling.py), it counts the narrow phase's work in
    shared mode: ``primary_trips``, kernel A's trip counts summed over the
    tiles (spheres and boxes); ``shadow_trips``, kernel B's summed over the
    tiles and lights (a hot tile's -1 scans every sphere); ``narrow_tiles``,
    the tiles. Every tile holds tile_p rays, so trips / tiles is the pair
    tests each ray makes."""
    with span("narrow_phase", "culled_geometry"):
        return _culled_geometry(scene, origins, dirs, tile_p, kp, ks,
                                shadow_lights, hot_m, kb, ksb, active, hot_p)


def _shadow_trips(cnt, n_sph: int):
    """Kernel B's trips from its (T, L, 2) counts: a hot tile's sphere
    count -1 scans all n_sph spheres."""
    sph = cnt[..., 0]
    return torch.where(sph < 0, n_sph, sph).sum() + cnt[..., 1].sum()


def _culled_geometry(scene: Scene, origins, dirs, tile_p: int, kp: int,
                     ks: int, shadow_lights, hot_m: int, kb: int, ksb: int,
                     active, hot_p: int):
    """culled_geometry inside its span."""
    shared = active is None
    if hot_p and shared:
        raise ValueError("hot_p is a secondary-mode (bounce bundle) feature: "
                         "pass active")
    r_total = origins.shape[0]
    t_tiles = r_total // tile_p
    dtype, device = origins.dtype, origins.device
    n_sph = scene.spheres.count
    n_box = scene.boxes.count
    n_lights = scene.lights.count
    o0 = origins[0]
    zero_c = torch.zeros((t_tiles,), dtype=torch.int32, device=device)

    # ---- broad phase (ops/accel.py): the tiles' survivor lists
    objects = _cull_objects(scene)
    p_idx, p_valid, p_count, b_idx, b_valid, b_count = _primary_lists(
        objects, _primary_cones(origins, dirs, tile_p, active), kp, kb,
        zero_c)
    kp_eff, kb_eff = p_idx.shape[-1], b_idx.shape[-1]

    def no_rows(cols):
        return torch.zeros((t_tiles, 0, cols), dtype=dtype, device=device)

    if n_sph:
        with span("narrow_phase", "pack_rows"):
            sph_rows = (_primary_sphere_rows(scene, o0, p_idx, p_valid)
                        if shared
                        else _secondary_sphere_rows(scene, p_idx, p_valid))
    else:
        sph_rows = no_rows(SPH_COLS)
    if n_box:
        with span("narrow_phase", "pack_rows"):
            box_rows = (_primary_box_rows(scene, o0, b_idx, b_valid)
                        if shared
                        else _secondary_box_rows(scene, b_idx, b_valid))
    else:
        box_rows = no_rows(BOX_COLS)

    with span("narrow_phase", "pack_rows"):
        pln_tab = _plane_table(scene, o0 if shared else torch.zeros_like(o0),
                               n_sph, n_box).contiguous()

    # ---- hot-primary tile selection: tiles whose bounce cone kept more
    # objects than the caps take the global-table launch below; the cold
    # launch skips them (trip count 0)
    hot_on = hot_p > 0 and (n_sph > 0 or n_box > 0)
    cnt_a = torch.stack([torch.clamp(p_count, max=kp_eff),
                         torch.clamp(b_count, max=kb_eff)],
                        dim=-1).to(torch.int32)
    if hot_on:
        hp_m = min(hot_p, t_tiles)
        over = torch.zeros((t_tiles,), dtype=torch.bool, device=device)
        score = zero_c
        if n_sph:
            over = over | (p_count > kp_eff)
            score = score + p_count
        if n_box and kb_eff < n_box:
            over = over | (b_count > kb_eff)
        if n_box:
            score = score + b_count
        hotp_ids = _top_tiles(torch.where(over, score, -1), hp_m)
        hotp_real = over[hotp_ids]                            # (M,)
        is_hotp = torch.zeros_like(over).index_copy(0, hotp_ids, hotp_real)
        cnt_a = torch.where(is_hotp[:, None], 0, cnt_a)

    # ---- kernel A (shared) or kernel 2 (per ray): primary narrow phase
    if shared:
        count("primary_trips", cnt_a)
        count("narrow_tiles", t_tiles)
        with span("narrow_phase", "kernel_a"):
            outs = primary_hit(dirs.contiguous(), sph_rows.contiguous(),
                               box_rows.contiguous(), pln_tab,
                               cnt_a.contiguous(), tile_p)
    else:
        outs = primary_hit_ray(dirs.contiguous(), origins.contiguous(),
                               sph_rows.contiguous(), box_rows.contiguous(),
                               pln_tab, cnt_a.contiguous(), tile_p)

    # ---- hot-primary pass: kernel 2 over the global object tables with
    # trip counts N on the truly hot tiles and 0 on the top-k slack; exact,
    # every object scanned
    if hot_on:
        def global_rows(rows_fn, n_obj, cols):
            """(1, n_obj, cols): every object as one tile's list."""
            if not n_obj:
                return torch.zeros((1, 0, cols), dtype=dtype, device=device)
            return rows_fn(scene, torch.arange(n_obj, dtype=torch.int32,
                                               device=device)[None, :],
                           torch.ones((1, n_obj), dtype=torch.bool,
                                      device=device))

        g_sph = global_rows(_secondary_sphere_rows, n_sph, SPH_COLS)
        g_box = global_rows(_secondary_box_rows, n_box, BOX_COLS)
        cnt_h = torch.stack([torch.where(hotp_real, n_sph, 0),
                             torch.where(hotp_real, n_box, 0)],
                            dim=-1).to(torch.int32)
        outs_h = primary_hit_ray(
            dirs.contiguous(), origins.contiguous(), g_sph.contiguous(),
            g_box.contiguous(), pln_tab, cnt_h, tile_p,
            tile_ids=hotp_ids.to(torch.int32))

        def hmerge(x_full, x_hot):
            x_t = x_full.reshape((t_tiles, tile_p) + x_full.shape[1:])
            x_h = x_hot.reshape((hp_m, tile_p) + x_hot.shape[1:])
            sel = hotp_real.reshape((hp_m,) + (1,) * (x_h.ndim - 1))
            return x_t.index_copy(0, hotp_ids,
                                  torch.where(sel, x_h, x_t[hotp_ids])
                                  ).reshape(x_full.shape)

        outs = tuple(hmerge(xf, xh) for xf, xh in zip(outs, outs_h))
    t_flat, n, ins, mat, gid, slot = outs

    if not shared:
        # inactive secondary rays are misses (their colors carry no bounce
        # weight; the miss keeps them out of the shadow cones below)
        t_flat = torch.where(active, t_flat, INF_T)
    hit_mask = t_flat < MISS_T
    in_flat = ins & hit_mask
    mat_flat = torch.where(hit_mask, mat, 0)
    gid_flat = torch.where(hit_mask, gid, -1)
    slot_t = slot.reshape(t_tiles, tile_p)
    is_sph_w = hit_mask & (gid_flat >= 0) & (gid_flat < n_sph)
    is_box_w = hit_mask & (gid_flat >= n_sph) & (gid_flat < n_sph + n_box)
    j_local = torch.where(is_sph_w.reshape(t_tiles, tile_p), slot_t, -1)
    jb_local = torch.where(is_box_w.reshape(t_tiles, tile_p), slot_t, -1)

    # ---- posthoc winner lists of the hot tiles: the hot launch reports
    # global row ids as slots; rebuild the ascending distinct-winner lists
    # (capped at Kp/Kb: a count above the cap is overflow the backward would
    # feel, reported through the count contract) and re-rank j_local and
    # jb_local into them
    if hot_on:
        hitm_h = hit_mask.reshape(t_tiles, tile_p)[hotp_ids] \
            & hotp_real[:, None]
        gid_h = gid_flat.reshape(t_tiles, tile_p)[hotp_ids]   # (M, P)

        def splice(full, hot_rows):
            sel = hotp_real.reshape((hp_m,) + (1,) * (full.ndim - 1))
            return full.index_copy(0, hotp_ids,
                                   torch.where(sel, hot_rows,
                                               full[hotp_ids]))

        def winner_lists(lo, n_obj, k_eff):
            wm, win, loc = _winner_mask(gid_h, hitm_h, lo, n_obj)
            w_idx, w_valid, w_cnt = compact_mask(wm, k_eff)
            rank = torch.gather(torch.cumsum(wm, 1, dtype=torch.int32), 1,
                                loc) - 1
            # ranks past the cap fall off the list: -1 ("not this list's
            # winner"); the tile's count > k reports it
            jl = torch.where(win & (rank < k_eff), rank, -1)
            return w_idx, w_valid, w_cnt, jl

        if n_sph:
            w_idx, w_valid, w_cnt, jl_h = winner_lists(0, n_sph, kp_eff)
            p_idx = splice(p_idx, w_idx)
            p_valid = splice(p_valid, w_valid)
            p_count = splice(p_count, w_cnt)
            j_local = splice(j_local, jl_h)
        if n_box:
            wb_idx, wb_valid, wb_cnt, jb_h = winner_lists(n_sph, n_box,
                                                          kb_eff)
            b_idx = splice(b_idx, wb_idx)
            b_valid = splice(b_valid, wb_valid)
            b_count = splice(b_count, wb_cnt)
            jb_local = splice(jb_local, jb_h)

    t_for_p = torch.where(hit_mask, t_flat, 0.0)
    p = origins + t_for_p[:, None] * dirs
    hit = Hit(t=t_flat, p=p, n=n, inside=in_flat,
              material_id=mat_flat, obj_id=gid_flat, hit=hit_mask)

    # ---- shadow broad phase per light + kernel B; the hot_m tiles with the
    # most sphere survivors per light scan the global sphere table in kernel
    # B instead of their lists (sphere count -1), which is exact
    shadow_org = hit.p + hit.n * SHADOW_EPS
    light_on = tuple((shadow_lights is None or bool(shadow_lights[li]))
                     for li in range(n_lights))
    ks_eff = min(ks, n_sph) if n_sph else 0
    ksb_eff = _box_k(ksb, n_box)
    hot_on = hot_m > 0 and n_sph > 0
    zero_o = torch.zeros((), dtype=torch.int32, device=device)
    shadows, ssph_rows, sbox_rows, cnt_cols, hot_rows = [], [], [], [], []

    def pack_spheres(idx, valid, cnt):
        with span("narrow_phase", "pack_rows"):
            rows = _shadow_sphere_rows(scene, idx, valid)
        return rows, torch.clamp(cnt, max=ks_eff)

    def pack_boxes(idx, valid, cnt):
        with span("narrow_phase", "pack_rows"):
            return _shadow_box_rows(scene, idx, valid)

    for li in range(n_lights):
        s_rows = torch.zeros((t_tiles, ks_eff, 4), dtype=dtype,
                             device=device)
        b_rows = torch.zeros((t_tiles, ksb_eff, BOX_COLS), dtype=dtype,
                             device=device)
        sc = zero_c
        hot_ids = torch.zeros((hot_m if hot_on else 0,), dtype=torch.int32,
                              device=device)
        sl = _shadow_lists(objects, shadow_org, hit_mask, tile_p,
                           scene.lights.position[li] if light_on[li]
                           else None, ks, ksb, hot_m, zero_c, zero_o,
                           narrow=(pack_spheres, pack_boxes))
        if sl.s_narrow is not None:
            s_rows, sc = sl.s_narrow
            if hot_on:
                hot_ids = sl.hot_ids
                sc = torch.where(sl.is_hot, -1, sc)
        if sl.sb_narrow is not None:
            b_rows = sl.sb_narrow
        shadows.append(sl)
        ssph_rows.append(s_rows)
        sbox_rows.append(b_rows)
        hot_rows.append(hot_ids.to(torch.int32))
        cnt_cols.append(torch.stack(
            [sc, torch.clamp(sl.sb_count, max=ksb_eff)], dim=-1))

    if n_lights and any(light_on):
        with span("narrow_phase", "pack_rows"):
            hot = ((torch.stack(hot_rows),
                    _shadow_spheres(scene).contiguous())
                   if hot_on else (None, None))
            with kernels.unchecked():   # the NaN radii of _shadow_sphere_rows
                ssph = torch.stack(ssph_rows, dim=1)
            sbox = torch.stack(sbox_rows, dim=1)
            cnt_b = torch.stack(cnt_cols, dim=1).to(torch.int32)
        if shared:
            count("shadow_trips", cnt_b,
                  functools.partial(_shadow_trips, n_sph=n_sph))
        with span("narrow_phase", "kernel_b"):
            occluded = shadow_occlusion(
                shadow_org, hit.p, scene.lights.position.contiguous(),
                light_on, ssph, sbox, pln_tab.contiguous(), cnt_b, tile_p,
                *hot)
    else:
        if shared:
            count("shadow_trips", 0)
        occluded = torch.zeros((r_total, n_lights), dtype=torch.bool,
                               device=device)

    aux = _cull_aux((p_idx, p_valid, p_count, b_idx, b_valid, b_count),
                    shadows, j_local, jb_local)
    return hit, occluded, aux


# ---------------------------------------------------------------------------
# Differentiable ops: forward on kernels A (2) and B, the analytic winner
# backward of ops/accel.py
# ---------------------------------------------------------------------------

def culled_geometry_op(scene: Scene, origins, dirs, tile_p: int, kp: int,
                       ks: int, shadow_lights: tuple | None = None,
                       hot_m: int = 0, kb: int = 0, ksb: int = 0):
    """culled_geometry with the analytic backward of the reference's
    ``culled_pallas_geometry_op``: gradients of hit.t, hit.p and hit.n flow
    to the spheres' center and radius, the boxes' mins, maxs, position and
    angles, the planes' normal and offset, and the rays. Arguments and
    results as culled_geometry."""
    return _apply_op(
        lambda s, o, d, _act: culled_geometry(s, o, d, tile_p, kp, ks,
                                              shadow_lights, hot_m, kb, ksb),
        scene, origins, dirs, tile_p)


def bounce_culled_geometry_op(scene: Scene, origins, dirs, active,
                              tile_p: int, kp: int, ks: int,
                              shadow_lights: tuple | None = None,
                              hot_m: int = 0, kb: int = 0, ksb: int = 0,
                              hot_p: int = 0):
    """culled_geometry in secondary mode (per-ray origins, the active mask,
    the optional hot-primary pass) with the same analytic backward: the
    winner replay never assumed a shared origin, so the cotangents of the
    children's origins and directions flow back to the parent's hit points
    and normals. The reference's ``bounce_culled_pallas_geometry_op``;
    active gets no cotangent."""
    return _apply_op(
        lambda s, o, d, act: culled_geometry(s, o, d, tile_p, kp, ks,
                                             shadow_lights, hot_m, kb, ksb,
                                             active=act, hot_p=hot_p),
        scene, origins, dirs, tile_p, active, hot_pass=hot_p > 0)
