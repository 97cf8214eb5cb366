"""Culled narrow phase: tile survivor lists scanned by two CUDA kernels.

Port of ``openglraytracer_tpu/ops/pallas_culled.py`` (named for what it is:
nothing here is Pallas). The broad phase of ``ops/accel.py`` feeds two
hand-written Hopper kernels that scan only each tile's survivors:

  torch   broad phase: tile cones -> conservative sphere-vs-cone masks ->
          top-K compaction -> survivor rows gathered per tile, with the
          per-ray-invariant terms precomputed (oc = o0 - c and qc for
          spheres, the local-space origin for boxes: primary rays share one
          pinhole origin)
  kernel A (``primary_hit``, csrc/primary_hit.cu): closest hit over the
          tile's sphere rows, box rows and all planes
  torch   shadow cones from the hit points -> per-light survivor lists
  kernel B (``shadow_occlusion``, csrc/shadow_occlusion.cu): per-light
          occlusion of the unnormalized surface->light segment, sphere
          occlusion kept apart so the hot-tile dense pass can replace it
  torch   hot-tile override and CullAux assembly

Each kernel wrapper runs its plain PyTorch version (``*_plain``, same
arguments, vectorized over rays, looping over survivor slots in the
kernel's fold order) on CPU tensors and launches the kernel on CUDA
tensors, counting launches in ``kernels.LAUNCHES``.

``culled_geometry_op`` is the differentiable entry (the counterpart of the
reference's ``culled_pallas_geometry_op``): its forward is
``culled_geometry`` and its backward the tile-structured winner replay of
``ops/accel.py _culled_bwd``. Only t, p and n carry gradients.

Only the shared-pinhole mode is ported: the per-ray-origin mode for bounce
children and the hot-primary dense pass come with the bounce slice (see
ROADMAP.md).
"""

from __future__ import annotations

import torch

from openglraytracer_tpu_torch import kernels
from openglraytracer_tpu_torch.models.scene import MISS_T, Scene
from openglraytracer_tpu_torch.ops.accel import (
    CullAux,
    _box_table,
    _culled_bwd,
    _dense_compact,
    _gather_tile_rows,
    _segment_occluded,
    _sphere_table,
    box_bounding_spheres,
    shadow_tile_cones,
    tile_cones,
)
from openglraytracer_tpu_torch.ops.intersect import (_DIV_EPS, _SQRT_EPS,
                                                     INF_T, Hit)
from openglraytracer_tpu_torch.ops.shading import SHADOW_EPS

SPH_COLS, BOX_COLS, PLN_COLS = 8, 24, 16


def _inv_safe(x):
    """Sign-preserving 1/x, |x| clamped away from 0."""
    xs = torch.where(torch.abs(x) < _DIV_EPS,
                     torch.where(x < 0, -_DIV_EPS, _DIV_EPS), x)
    return 1.0 / xs


def _fma(a, b, c):
    """a * b + c rounded once, as the kernel's fmaf: the float32 product is
    exact in float64, so only the sum rounds (the float64 -> float32 double
    rounding differs from fmaf on a tie, about once in 2^29)."""
    return (a.double() * b.double() + c.double()).float()


# ---------------------------------------------------------------------------
# Kernel A: primary closest hit over survivor rows
# ---------------------------------------------------------------------------

def primary_hit_plain(dirs, sph, box, pln, cnt, tile_p: int):
    """Plain version of kernel A. dirs (R, 3); sph (T, Kp, 8); box
    (T, Kb, 24); pln (P, 16); cnt (T, 2) int32 per-tile trip counts.
    Returns the raw record (t (R,), n (R, 3), inside (R,) bool,
    mat (R,) int32, gid (R,) int32, slot (R,) int32): t is INF_T where no
    candidate hit, n is unit (zero where t >= MISS_T), gid -1 and slot 0
    where nothing hit, slot -1 for planes."""
    t_tiles = cnt.shape[0]
    d = dirs.reshape(t_tiles, tile_p, 3)
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
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
        ocx, ocy, ocz, qc = row[:, 0], row[:, 1], row[:, 2], row[:, 3]
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
        rox, roy, roz = row[:, 6], row[:, 7], row[:, 8]
        r00, r01, r02 = row[:, 9], row[:, 10], row[:, 11]
        r10, r11, r12 = row[:, 12], row[:, 13], row[:, 14]
        r20, r21, r22 = row[:, 15], row[:, 16], row[:, 17]
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
        nd = row[0] * dx + row[1] * dy + row[2] * dz
        t = row[7] * _inv_safe(nd)
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


# ---------------------------------------------------------------------------
# Kernel B: per-light shadow occlusion over survivor rows
# ---------------------------------------------------------------------------

def shadow_occlusion_plain(shadow_org, hit_p, lights, light_on: tuple, ssph,
                           sbox, pln, cnt, tile_p: int):
    """Plain version of kernel B. shadow_org, hit_p (R, 3); lights (L, 3)
    positions; light_on static per-light bools; ssph (T, L, Ks, 8); sbox
    (T, L, Ksb, 24); pln (P, 16); cnt (T, L, 2) int32 per-(tile, light)
    trip counts. Returns (occ_s, occ_o), each (T, L, P) bool: occlusion by
    survivor spheres, and by survivor boxes or planes."""
    t_tiles = cnt.shape[0]
    so = shadow_org.reshape(t_tiles, tile_p, 3)
    hp = hit_p.reshape(t_tiles, tile_p, 3)
    sx, sy, sz = so[..., 0], so[..., 1], so[..., 2]
    none = torch.zeros_like(sx, dtype=torch.bool)
    cols_s, cols_o = [], []
    for li in range(lights.shape[0]):
        if not light_on[li]:
            cols_s.append(none)
            cols_o.append(none)
            continue
        tlx = lights[li, 0] - hp[..., 0]
        tly = lights[li, 1] - hp[..., 1]
        tlz = lights[li, 2] - hp[..., 2]
        qa = tlx * tlx + tly * tly + tlz * tlz
        qa_ok = qa > _DIV_EPS

        occ_s = none
        for j in range(ssph.shape[2]):
            row = ssph[:, li, j, :, None]           # (T, 8, 1)
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
            blocked = blocked & qa_ok & (row[:, 4] > 0.5) \
                & (j < cnt[:, li, 0:1])
            occ_s = occ_s | blocked

        occ_o = none
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
            occ_o = occ_o | (ok & (t > 0.0) & (t < 1.0))

        for k in range(pln.shape[0]):
            row = pln[k]
            nd = row[0] * tlx + row[1] * tly + row[2] * tlz
            no = row[0] * sx + row[1] * sy + row[2] * sz
            t = (row[3] - no) * _inv_safe(nd)
            occ_o = occ_o | ((torch.abs(nd) > 1.0e-9) & (t > 0.0)
                             & (t < 1.0))
        cols_s.append(occ_s)
        cols_o.append(occ_o)
    return torch.stack(cols_s, dim=1), torch.stack(cols_o, dim=1)


@torch.no_grad()
def shadow_occlusion(shadow_org, hit_p, lights, light_on: tuple, ssph, sbox,
                     pln, cnt, tile_p: int):
    """Kernel B (csrc/shadow_occlusion.cu) on CUDA tensors, its plain
    version on CPU tensors; arguments and results as
    shadow_occlusion_plain."""
    if kernels.on_cpu(shadow_org):
        return shadow_occlusion_plain(shadow_org, hit_p, lights, light_on,
                                      ssph, sbox, pln, cnt, tile_p)
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
    kernels.check("ssph", ssph, dev, f32, (t_tiles, n_lights, ks, SPH_COLS))
    kernels.check("sbox", sbox, dev, f32, (t_tiles, n_lights, ksb, BOX_COLS))
    kernels.check("pln", pln, dev, f32, (n_pln, PLN_COLS))
    kernels.check("cnt", cnt, dev, torch.int32, (t_tiles, n_lights, 2))
    mask = sum(1 << li for li, on in enumerate(light_on) if on)
    occ_s = torch.empty((t_tiles, n_lights, tile_p), dtype=torch.bool,
                        device=dev)
    occ_o = torch.empty_like(occ_s)
    kernels.launch("oglrt_shadow_occlusion", dev, shadow_org, hit_p, lights,
                   mask, ssph, sbox, pln, cnt, t_tiles, tile_p, n_lights, ks,
                   ksb, n_pln, occ_s, occ_o)
    kernels.LAUNCHES["shadow_occlusion"] += 1
    return occ_s, occ_o


# ---------------------------------------------------------------------------
# Row packing (small: T*K rows)
# ---------------------------------------------------------------------------

def _pad_cols(x, width: int):
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def _primary_sphere_rows(scene: Scene, o0, p_idx, p_valid):
    """(T, Kp, 8) kernel rows from the survivor lists: oc, qc precomputed."""
    rows = _gather_tile_rows(_sphere_table(scene), p_idx)   # (T, Kp, 6)
    oc = o0[None, None, :] - rows[..., 0:3]
    qc = torch.sum(oc * oc, dim=-1) - rows[..., 3] * rows[..., 3]
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


def _shadow_sphere_rows(scene: Scene, s_idx, s_valid):
    """(T, Ks, 8) [c(3) r valid ...]."""
    tab = torch.cat([scene.spheres.center, scene.spheres.radius[:, None]],
                    dim=-1)
    rows = _gather_tile_rows(tab, s_idx)                    # (T, Ks, 4)
    out = torch.cat([rows, s_valid.to(rows.dtype)[..., None]], dim=-1)
    return _pad_cols(out, SPH_COLS)


def _shadow_box_rows(scene: Scene, sb_idx, sb_valid):
    """(T, Ksb, 24) [mins maxs pos rot9 valid ...]."""
    rows = _gather_tile_rows(_box_table(scene), sb_idx)     # (T, Ksb, 20)
    out = torch.cat([rows[..., 0:18], sb_valid.to(rows.dtype)[..., None]],
                    dim=-1)
    return _pad_cols(out, BOX_COLS)


def _top_tiles(counts, m: int):
    """Ids of the m largest counts, ties to the lower tile id (the order
    the reference's top_k keeps)."""
    t_tiles = counts.shape[0]
    order = torch.arange(t_tiles, 0, -1, device=counts.device)
    _, ids = torch.topk(counts.long() * t_tiles + order - 1, m)
    return ids


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

@torch.no_grad()
def culled_geometry(scene: Scene, origins, dirs, tile_p: int, kp: int,
                    ks: int, shadow_lights: tuple | None = None,
                    hot_m: int = 0, kb: int = 0, ksb: int = 0,
                    active=None, hot_p: int = 0):
    """Culled narrow phase in shared-pinhole mode. Port of
    ``pallas_culled.culled_geometry_pallas``.

    origins/dirs (R, 3) in tile-major order (accel.tile_image) with one
    shared origin; tile_p rays per tile; kp/ks sphere survivor caps; kb/ksb
    box caps (0 = all boxes); hot_m hottest shadow tiles per light get the
    dense pass; shadow_lights static per-light bools (None = all cast).
    Returns (Hit (R,), occluded (R, L) bool, CullAux)."""
    if active is not None or hot_p:
        raise NotImplementedError(
            "culled_geometry: the per-ray-origin (bounce) mode and its "
            "hot-primary pass are not yet ported; see ROADMAP.md")
    r_total = origins.shape[0]
    t_tiles = r_total // tile_p
    dtype, device = origins.dtype, origins.device
    n_sph = scene.spheres.count
    n_box = scene.boxes.count
    n_lights = scene.lights.count
    o0 = origins[0]
    kb = min(kb, n_box) if kb > 0 else n_box
    ksb = min(ksb, n_box) if ksb > 0 else n_box
    zero_c = torch.zeros((t_tiles,), dtype=torch.int32, device=device)

    def no_list(cols):
        return (torch.zeros((t_tiles, 0), dtype=torch.int32, device=device),
                torch.zeros((t_tiles, 0), dtype=torch.bool, device=device),
                zero_c,
                torch.zeros((t_tiles, 0, cols), dtype=dtype, device=device))

    # ---- broad phase: dense per-tile compaction
    axis, cos_half = tile_cones(dirs.reshape(t_tiles, tile_p, 3))
    if n_sph:
        p_idx, p_valid, p_count = _dense_compact(
            o0, axis, cos_half, scene.spheres.center, scene.spheres.radius,
            kp)
        sph_rows = _primary_sphere_rows(scene, o0, p_idx, p_valid)
    else:
        p_idx, p_valid, p_count, sph_rows = no_list(SPH_COLS)
    kp_eff = p_idx.shape[-1]

    if n_box:
        bc_bs, br_bs = box_bounding_spheres(scene)
        b_idx, b_valid, b_count = _dense_compact(o0, axis, cos_half, bc_bs,
                                                 br_bs, kb)
        box_rows = _primary_box_rows(scene, o0, b_idx, b_valid)
    else:
        b_idx, b_valid, b_count, box_rows = no_list(BOX_COLS)
    kb_eff = b_idx.shape[-1]

    pln_tab = _plane_table(scene, o0, n_sph, n_box)

    # ---- kernel A: primary narrow phase
    cnt_a = torch.stack([torch.clamp(p_count, max=kp_eff),
                         torch.clamp(b_count, max=kb_eff)],
                        dim=-1).to(torch.int32).contiguous()
    t_flat, n, ins, mat, gid, slot = primary_hit(
        dirs.contiguous(), sph_rows.contiguous(), box_rows.contiguous(),
        pln_tab.contiguous(), cnt_a, tile_p)

    hit_mask = t_flat < MISS_T
    in_flat = ins & hit_mask
    mat_flat = torch.where(hit_mask, mat, 0)
    gid_flat = torch.where(hit_mask, gid, -1)
    slot_t = slot.reshape(t_tiles, tile_p)
    is_sph_w = hit_mask & (gid_flat >= 0) & (gid_flat < n_sph)
    is_box_w = hit_mask & (gid_flat >= n_sph) & (gid_flat < n_sph + n_box)
    j_local = torch.where(is_sph_w.reshape(t_tiles, tile_p), slot_t, -1)
    jb_local = torch.where(is_box_w.reshape(t_tiles, tile_p), slot_t, -1)

    t_for_p = torch.where(hit_mask, t_flat, 0.0)
    p = origins + t_for_p[:, None] * dirs
    hit = Hit(t=t_flat, p=p, n=n, inside=in_flat,
              material_id=mat_flat, obj_id=gid_flat, hit=hit_mask)

    # ---- shadow broad phase per light + kernel B
    shadow_org = hit.p + hit.n * SHADOW_EPS
    so_t = shadow_org.reshape(t_tiles, tile_p, 3)
    p_t = hit.p.reshape(t_tiles, tile_p, 3)
    light_on = tuple((shadow_lights is None or bool(shadow_lights[li]))
                     for li in range(n_lights))
    ks_eff = min(ks, n_sph) if n_sph else 0
    ksb_eff = ksb if n_box else 0
    zero_o = torch.zeros((), dtype=torch.int32, device=device)
    s_counts, s_overflow, sb_counts, sb_overflow = [], [], [], []
    ssph_rows, sbox_rows, cnt_cols = [], [], []
    hot_infos = []   # per light (is_hot (T,), occ_full (T, P)) or None
    for li in range(n_lights):
        s_cnt, s_ovf, sb_cnt, sb_ovf = zero_c, zero_o, zero_c, zero_o
        s_rows = torch.zeros((t_tiles, ks_eff, SPH_COLS), dtype=dtype,
                             device=device)
        b_rows = torch.zeros((t_tiles, ksb_eff, BOX_COLS), dtype=dtype,
                             device=device)
        hot = None
        if light_on[li]:
            lpos = scene.lights.position[li]
            axis_s, cos_s, max_d, empty_s = shadow_tile_cones(
                shadow_org, hit_mask, tile_p, lpos)
            if n_sph:
                s_idx, s_valid, s_cnt = _dense_compact(
                    lpos, axis_s, cos_s, scene.spheres.center,
                    scene.spheres.radius, ks, max_dist=max_d,
                    tile_valid=~empty_s)
                s_rows = _shadow_sphere_rows(scene, s_idx, s_valid)
                if hot_m > 0:
                    hot_ids = _top_tiles(s_cnt, hot_m)
                    c = scene.spheres.center
                    occ_h = _segment_occluded(
                        so_t[hot_ids], p_t[hot_ids], lpos,
                        c[None, :, 0], c[None, :, 1], c[None, :, 2],
                        scene.spheres.radius[None, :],
                        torch.ones((1, n_sph), dtype=torch.bool,
                                   device=device))            # (M, P)
                    is_hot = torch.zeros((t_tiles,), dtype=torch.bool,
                                         device=device).index_fill(
                                             0, hot_ids, True)
                    occ_full = torch.zeros((t_tiles, tile_p),
                                           dtype=torch.bool,
                                           device=device).index_copy(
                                               0, hot_ids, occ_h)
                    hot = (is_hot, occ_full)
                    s_ovf = torch.sum((s_cnt > ks) & ~is_hot,
                                      dtype=torch.int32)
                else:
                    s_ovf = torch.sum(s_cnt > ks, dtype=torch.int32)
            if n_box:
                sb_idx, sb_valid, sb_cnt = _dense_compact(
                    lpos, axis_s, cos_s, bc_bs, br_bs, ksb, max_dist=max_d,
                    tile_valid=~empty_s)
                b_rows = _shadow_box_rows(scene, sb_idx, sb_valid)
                sb_ovf = torch.sum(sb_cnt > ksb, dtype=torch.int32)
        s_counts.append(s_cnt)
        s_overflow.append(s_ovf)
        sb_counts.append(sb_cnt)
        sb_overflow.append(sb_ovf)
        ssph_rows.append(s_rows)
        sbox_rows.append(b_rows)
        hot_infos.append(hot)
        sc = torch.clamp(s_cnt, max=ks_eff)
        if hot is not None:
            # hot tiles' sphere occlusion is replaced by the dense pass:
            # kernel B skips their sphere scan
            sc = torch.where(hot[0], 0, sc)
        cnt_cols.append(torch.stack([sc, torch.clamp(sb_cnt, max=ksb_eff)],
                                    dim=-1))

    if n_lights and any(light_on):
        occ_s, occ_o = shadow_occlusion(
            shadow_org, hit.p, scene.lights.position.contiguous(), light_on,
            torch.stack(ssph_rows, dim=1), torch.stack(sbox_rows, dim=1),
            pln_tab.contiguous(),
            torch.stack(cnt_cols, dim=1).to(torch.int32), tile_p)
        occ_cols = []
        for li in range(n_lights):
            col_s = occ_s[:, li]
            if hot_infos[li] is not None:
                is_hot, occ_full = hot_infos[li]
                col_s = torch.where(is_hot[:, None], occ_full, col_s)
            occ_cols.append((col_s | occ_o[:, li]).reshape(-1))
        occluded = torch.stack(occ_cols, dim=-1)
    else:
        occluded = torch.zeros((r_total, n_lights), dtype=torch.bool,
                               device=device)

    def stack_or(xs, shape):
        return (torch.stack(xs) if n_lights
                else torch.zeros(shape, dtype=torch.int32, device=device))

    aux = CullAux(p_idx=p_idx, p_valid=p_valid, p_count=p_count,
                  s_count=stack_or(s_counts, (0, t_tiles)),
                  s_overflow=stack_or(s_overflow, (0,)),
                  j_local=j_local,
                  b_idx=b_idx, b_valid=b_valid, b_count=b_count,
                  sb_count=stack_or(sb_counts, (0, t_tiles)),
                  sb_overflow=stack_or(sb_overflow, (0,)),
                  jb_local=jb_local)
    return hit, occluded, aux


# ---------------------------------------------------------------------------
# Differentiable op: forward on kernels A and B, analytic winner backward
# ---------------------------------------------------------------------------

_N_HIT = len(Hit._fields)
# the scene leaves that carry gradients, in the order the op takes them
_GEOMETRY_LEAVES = (("spheres", "center"), ("spheres", "radius"),
                    ("boxes", "mins"), ("boxes", "maxs"),
                    ("boxes", "position"), ("boxes", "angles"),
                    ("planes", "normal"), ("planes", "offset"))


def _with_leaves(scene: Scene, leaves) -> Scene:
    parts = {}
    for (part, field), x in zip(_GEOMETRY_LEAVES, leaves):
        parts.setdefault(part, {})[field] = x
    return scene._replace(**{part: getattr(scene, part)._replace(**fields)
                             for part, fields in parts.items()})


class _CulledGeometryOp(torch.autograd.Function):
    """Forward: culled_geometry. Backward: accel._culled_bwd. Takes the
    scene (for its non-differentiable columns), the static arguments of
    culled_geometry, the geometry leaves of _GEOMETRY_LEAVES and the rays;
    returns the Hit fields, the occlusion and the CullAux fields, of which
    only t, p and n are differentiable."""

    @staticmethod
    def forward(ctx, scene, static, *tensors):
        leaves, (origins, dirs) = tensors[:-2], tensors[-2:]
        scene = _with_leaves(scene, leaves)
        hit, occ, aux = culled_geometry(scene, origins, dirs, *static)
        ctx.mark_non_differentiable(*hit[3:], occ, *aux)
        ctx.save_for_backward(*tensors, hit.inside, hit.obj_id, hit.hit,
                              aux.p_idx, aux.j_local, aux.b_idx,
                              aux.jb_local)
        ctx.scene, ctx.tile_p = scene, static[0]
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
        need = ctx.needs_input_grad[2:]
        grads = _culled_bwd(scene, origins, dirs, hit, aux, ctx.tile_p,
                            gt, gp, gn, need_rays=any(need[-2:]))
        return (None, None, *(g if want else None
                              for g, want in zip(grads, need)))


def culled_geometry_op(scene: Scene, origins, dirs, tile_p: int, kp: int,
                       ks: int, shadow_lights: tuple | None = None,
                       hot_m: int = 0, kb: int = 0, ksb: int = 0):
    """culled_geometry with the analytic backward of the reference's
    ``culled_pallas_geometry_op``: gradients of hit.t, hit.p and hit.n flow
    to the spheres' center and radius, the boxes' mins, maxs, position and
    angles, the planes' normal and offset, and the rays. Arguments and
    results as culled_geometry."""
    leaves = [getattr(getattr(scene, part), field)
              for part, field in _GEOMETRY_LEAVES]
    out = _CulledGeometryOp.apply(
        scene, (tile_p, kp, ks, shadow_lights, hot_m, kb, ksb), *leaves,
        origins, dirs)
    return (Hit(*out[:_N_HIT]), out[_N_HIT], CullAux(*out[_N_HIT + 1:]))
