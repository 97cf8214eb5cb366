"""Ray-primitive intersection: the plain dense engine and the numeric
guards shared by every engine.

Port of ``openglraytracer_tpu/ops/intersect.py``. The candidate tests
(``sphere_candidates``, ``box_candidates``, ``plane_candidates``, the
sqrt-free ``sphere_blocked``), the chunked running-minimum closest hit
(``closest_hit``, and ``closest_hit_sp`` for scenes without boxes), the
all-lights shadow scan ``shadow_occlusion_sp`` and the occlusion query
``any_hit`` are the engine ``'xla'`` of the reference: dense elementwise
math over (R rays x C objects) blocks, masked with ``torch.where`` and
free of branches on the data, so the whole of it is differentiable (engine
``'autodiff'`` runs autograd straight through it). Objects are scanned in
chunks of ``chunk_size`` with a running minimum, so memory is bounded at
(R, chunk), and the first object wins a tie within a chunk and, by a
strict ``<``, across chunks. Every division and square root is guarded
(the double-where pattern), so gradients stay free of NaN even for
degenerate rays.

Object ids: spheres occupy [0, N), boxes [N, N+M), planes [N+M, N+M+P) in
the global index space. The constants, ``Hit`` and the helpers
``_safe_div``, ``_inv_safe``, ``_safe_normalize``, ``_rot_apply`` and
``_rot_apply_t`` also serve the culled and dense kernel engines
(``ops/culled.py``, ``ops/dense.py``) and their winner replay
(``ops/geometry.py``); ``_inv_safe`` is the kernels' reciprocal as their
plain versions compute it (and ``transforms._fma`` their ``fmaf``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from openglraytracer_tpu_torch.models.scene import MISS_T, Scene
from openglraytracer_tpu_torch.ops.transforms import euler_rotation_3x3b

INF_T = 1.0e10
_DIV_EPS = 1.0e-12
_SQRT_EPS = 1.0e-20


class Hit(NamedTuple):
    """The reference's Collision struct, SoA over rays."""

    t: torch.Tensor         # (R,) hit distance; >= MISS_T on miss
    p: torch.Tensor         # (R, 3) world hit point
    n: torch.Tensor         # (R, 3) world unit normal (flipped when inside)
    inside: torch.Tensor    # (R,) bool — ray started inside the object
    material_id: torch.Tensor  # (R,) int32 (0 on miss)
    obj_id: torch.Tensor    # (R,) int32 global object index (-1 on miss)
    hit: torch.Tensor       # (R,) bool


def _safe_div(a, b):
    """a / b with |b| clamped away from 0 (sign-preserving)."""
    b_safe = torch.where(torch.abs(b) < _DIV_EPS,
                         torch.where(b < 0, -_DIV_EPS, _DIV_EPS), b)
    return a / b_safe


def _inv_safe(x):
    """Sign-preserving 1/x, |x| clamped away from 0."""
    xs = torch.where(torch.abs(x) < _DIV_EPS,
                     torch.where(x < 0, -_DIV_EPS, _DIV_EPS), x)
    return 1.0 / xs


def _safe_sqrt(x):
    """sqrt(max(x, eps)), correctly rounded: through float64, which rounds
    to the float32 result exactly (PyTorch's vectorized CPU sqrt is off by
    an ulp on about 1 % of float32 inputs)."""
    return torch.sqrt(torch.clamp(x, min=_SQRT_EPS).double()).to(x.dtype)


def _safe_normalize(v, dim=-1):
    n2 = torch.sum(v * v, dim=dim, keepdim=True)
    return v * torch.rsqrt(torch.clamp(n2, min=_SQRT_EPS))


# The 3-term dot products and 3x3 products are written out component by
# component, in the order of the reference, and every op rounds once, as in
# the JAX package run op by op. (Under jit, XLA's CPU compiler contracts
# some multiply-adds into fused ones, and which ones depends on the shapes:
# `dot - r * r` is contracted at 512 spheres a chunk and not at 16. The
# plain engine follows the op-by-op rounding, which is one function.)

def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _rot_apply(rot, vx, vy, vz):
    """rot: (..., 3, 3); v components broadcastable -> rotated components."""
    rx = rot[..., 0, 0] * vx + rot[..., 0, 1] * vy + rot[..., 0, 2] * vz
    ry = rot[..., 1, 0] * vx + rot[..., 1, 1] * vy + rot[..., 1, 2] * vz
    rz = rot[..., 2, 0] * vx + rot[..., 2, 1] * vy + rot[..., 2, 2] * vz
    return rx, ry, rz


def _rot_apply_t(rot, vx, vy, vz):
    """Apply rot^T (world -> local for an orthonormal rotation)."""
    rx = rot[..., 0, 0] * vx + rot[..., 1, 0] * vy + rot[..., 2, 0] * vz
    ry = rot[..., 0, 1] * vx + rot[..., 1, 1] * vy + rot[..., 2, 1] * vz
    rz = rot[..., 0, 2] * vx + rot[..., 1, 2] * vy + rot[..., 2, 2] * vz
    return rx, ry, rz


# ---------------------------------------------------------------------------
# Per-type candidate tests. Each returns (t, n, inside) with t = INF_T on a
# miss; shapes (R, C), (R, C, 3), (R, C).
# ---------------------------------------------------------------------------

def sphere_candidates(o, d, center, radius, valid, with_normals=True):
    """Ray-sphere quadratic. o, d: (R, 3); center: (C, 3); radius, valid:
    (C,). Handles unnormalized d (shadow segments) and a ray starting
    inside the sphere (t_near < 0: t_far, normal flipped)."""
    ocx = o[:, None, 0] - center[None, :, 0]            # (R, C)
    ocy = o[:, None, 1] - center[None, :, 1]
    ocz = o[:, None, 2] - center[None, :, 2]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]        # (R, 1)
    qa = _dot3(dx, dy, dz, dx, dy, dz)                  # (R, 1)
    qb = 2.0 * _dot3(dx, dy, dz, ocx, ocy, ocz)         # (R, C)
    qc = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - (radius * radius)[None, :]
    qd = qb * qb - 4.0 * qa * qc

    ok = (qd >= 0.0) & (qa > _DIV_EPS) & valid[None, :]
    sq = torch.where(ok, _safe_sqrt(qd), 0.0)
    inv_2qa = _safe_div(0.5, qa)
    t1 = (-qb + sq) * inv_2qa
    t2 = (-qb - sq) * inv_2qa
    t_near = torch.minimum(t1, t2)
    t_far = torch.maximum(t1, t2)

    ok = ok & (t_far >= 0.0)
    inside = ok & (t_near < 0.0)
    t = torch.where(inside, t_far, t_near)
    ok = ok & (t > 0.0)             # a hit needs t > 0
    t = torch.where(ok, t, INF_T)

    if not with_normals:
        return t, None, inside
    # n = normalize(o + t d - center); t masked first, so no inf * 0
    tn = torch.where(ok, t, 0.0)
    nx = ocx + tn * dx
    ny = ocy + tn * dy
    nz = ocz + tn * dz
    inv_len = torch.rsqrt(torch.clamp(_dot3(nx, ny, nz, nx, ny, nz),
                                      min=_SQRT_EPS))
    flip = torch.where(inside, -inv_len, inv_len) * ok.to(t.dtype)
    n = torch.stack([nx * flip, ny * flip, nz * flip], dim=-1)
    return t, n, inside


def box_candidates(o, d, mins, maxs, position, rot, valid,
                   with_normals=True):
    """Oriented-box slab test. o, d: (R, 3); mins/maxs/position: (C, 3);
    rot: (C, 3, 3) local -> world rotation; valid: (C,). The ray goes to
    the box frame as R^T (x - pos); the face is picked by exact equality
    with the winning slab boundary, y before z, and its normal goes back
    to the world frame by R."""
    rb = rot[None]                                      # (1, C, 3, 3)
    wx = o[:, None, 0] - position[None, :, 0]
    wy = o[:, None, 1] - position[None, :, 1]
    wz = o[:, None, 2] - position[None, :, 2]
    rox, roy, roz = _rot_apply_t(rb, wx, wy, wz)        # (R, C)
    rdx, rdy, rdz = _rot_apply_t(rb, d[:, None, 0], d[:, None, 1],
                                 d[:, None, 2])
    ro = torch.stack([rox, roy, roz], dim=-1)
    rd = torch.stack([rdx, rdy, rdz], dim=-1)

    inv_d = _safe_div(torch.ones_like(rd), rd)
    ta = (mins[None, :, :] - ro) * inv_d
    tb = (maxs[None, :, :] - ro) * inv_d
    t1 = torch.minimum(ta, tb)
    t2 = torch.maximum(ta, tb)
    t_near = torch.amax(t1, dim=-1)
    t_far = torch.amin(t2, dim=-1)

    ok = (t_near < t_far) & (t_far > 0.0) & valid[None, :]
    inside = ok & (t_near < 0.0)
    t = torch.where(inside, t_far, t_near)
    ok = ok & (t > 0.0)
    t_out = torch.where(ok, t, INF_T)

    if not with_normals:
        return t_out, None, inside

    boundary = torch.where(inside[..., None], t2, t1)   # (R, C, 3)
    ts = t[..., None]
    face = torch.where(ts == boundary[..., 1:2], 1,
                       torch.where(ts == boundary[..., 2:3], 2, 0))[..., 0]
    one_hot = (face[..., None] == torch.arange(3, device=face.device)
               ).to(t.dtype)
    rd_face = torch.sum(one_hot * rd, dim=-1, keepdim=True)
    sign = torch.where(rd_face > 0.0, -1.0, 1.0)
    n_local = one_hot * sign
    nwx, nwy, nwz = _rot_apply(rb, n_local[..., 0], n_local[..., 1],
                               n_local[..., 2])
    n = torch.stack([nwx, nwy, nwz], dim=-1)
    n = torch.where(ok[..., None], n, 0.0)
    return t_out, n, inside


def sphere_blocked(o, d, center, radius, valid, max_t=1.0):
    """Sqrt- and division-free occlusion predicate: does the segment
    o + t d, t in (0, max_t), meet the sphere? Decided from the sign
    pattern of f(t) = qa t^2 + qb t + qc:

      * qc < 0 (origin inside): the one positive root t_far is below
        max_t iff f(max_t) > 0;
      * qc >= 0 (origin outside): f changes sign in the interval
        (f(max_t) < 0), or both roots lie in it (a discriminant >= 0 and
        the vertex -qb / 2 qa in (0, max_t)).

    Equal to the sqrt-based closest-hit test except where qc == 0 (the
    origin on the surface, which the shadow offset excludes). o, d: (R, 3);
    center: (C, 3); radius, valid: (C,). Returns (R, C) bool."""
    ocx = o[:, None, 0] - center[None, :, 0]
    ocy = o[:, None, 1] - center[None, :, 1]
    ocz = o[:, None, 2] - center[None, :, 2]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    qa = _dot3(dx, dy, dz, dx, dy, dz)                  # (R, 1)
    qb = 2.0 * _dot3(dx, dy, dz, ocx, ocy, ocz)         # (R, C)
    qc = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - (radius * radius)[None, :]
    f_end = (qa * max_t + qb) * max_t + qc              # f(max_t)

    inside_src = qc < 0.0
    blocked_inside = inside_src & (f_end > 0.0)
    disc_ok = qb * qb >= 4.0 * qa * qc
    vertex_in = (qb < 0.0) & (-qb < 2.0 * qa * max_t)
    blocked_outside = (~inside_src) & ((f_end < 0.0) | (disc_ok & vertex_in))
    return ((blocked_inside | blocked_outside) & (qa > _DIV_EPS)
            & valid[None, :])


def plane_candidates(o, d, normal, offset, valid, with_normals=True):
    """Infinite plane dot(n, x) = offset, double-sided (the normal faces
    the incoming ray), never 'inside'."""
    nd = _dot3(d[:, None, 0], d[:, None, 1], d[:, None, 2],
               normal[None, :, 0], normal[None, :, 1], normal[None, :, 2])
    no = _dot3(o[:, None, 0], o[:, None, 1], o[:, None, 2],
               normal[None, :, 0], normal[None, :, 1], normal[None, :, 2])
    t = _safe_div(offset[None, :] - no, nd)
    ok = (torch.abs(nd) > 1.0e-9) & (t > 0.0) & valid[None, :]
    t_out = torch.where(ok, t, INF_T)
    inside = torch.zeros_like(ok)
    if not with_normals:
        return t_out, None, inside
    n_unit = _safe_normalize(normal)[None, :, :]
    n = torch.where(nd[..., None] > 0.0, -n_unit, n_unit)
    n = torch.where(ok[..., None], n, 0.0)
    return t_out, n, inside


# ---------------------------------------------------------------------------
# The chunked running-minimum closest hit
# ---------------------------------------------------------------------------

def _pad_to(x, n, fill=0):
    pad = n - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])


class _Best(NamedTuple):
    t: torch.Tensor
    n: torch.Tensor
    inside: torch.Tensor
    material_id: torch.Tensor
    obj_id: torch.Tensor


def _init_best(r, like):
    """The running best of r rays, a miss everywhere, on like's device."""
    return _Best(
        t=like.new_full((r,), INF_T),
        n=like.new_zeros((r, 3)),
        inside=torch.zeros((r,), dtype=torch.bool, device=like.device),
        material_id=torch.zeros((r,), dtype=torch.int32, device=like.device),
        obj_id=torch.full((r,), -1, dtype=torch.int32, device=like.device),
    )


def _first_min(t):
    """(min over the last axis, the first index that attains it)."""
    c = t.shape[-1]
    tc = torch.amin(t, dim=-1)
    iota = torch.arange(c, dtype=torch.int32, device=t.device)[None, :]
    j = torch.amin(torch.where(t == tc[:, None], iota, c), dim=-1)
    return tc, j


def _fold_chunk(best, t, n, inside, mat_ids, obj_base, chunk_start):
    """Fold an (R, C) candidate block into the running best. The first
    minimum wins a tie within the chunk and, by a strict <, across chunks.
    The winner's normal, inside flag and material are gathered by its
    index: exactly the reference's one-hot sums, and with the same
    gradient (to the winner only)."""
    tc, j = _first_min(t)
    jl = j.long()
    nc = torch.gather(n, 1, jl[:, None, None].expand(-1, 1, 3))[:, 0]
    ic = torch.gather(inside, 1, jl[:, None])[:, 0]
    mc = mat_ids[jl]
    oc = (obj_base + chunk_start + j).to(torch.int32)

    upd = tc < best.t
    return _Best(
        t=torch.where(upd, tc, best.t),
        n=torch.where(upd[:, None], nc, best.n),
        inside=torch.where(upd, ic, best.inside),
        material_id=torch.where(upd, mc.to(torch.int32), best.material_id),
        obj_id=torch.where(upd, oc, best.obj_id),
    )


def _chunk_iter(count, chunk_size):
    nchunks = max(1, -(-count // chunk_size))
    return nchunks, nchunks * chunk_size


def _chunks(count, chunk_size):
    """(padded length, chunk length) of count objects in chunks of at most
    chunk_size."""
    nchunks, padded = _chunk_iter(count, min(chunk_size, count))
    return padded, padded // nchunks


def _valid(count, padded, device):
    return _pad_to(torch.ones((count,), dtype=torch.bool, device=device),
                   padded, False)


def maybe_checkpoint(fn, *args):
    """fn(*args), under torch.utils.checkpoint while autograd records: the
    call keeps only its inputs and recomputes itself in the backward (its
    kernels launch again there). Nothing in a trace draws random numbers,
    so no RNG state is kept."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _remat(fn, remat: bool):
    """fn, or with remat fn under maybe_checkpoint (the reference's
    jax.checkpoint of each object chunk)."""
    return functools.partial(maybe_checkpoint, fn) if remat else fn


def closest_hit(scene: Scene, origins, dirs, chunk_size: int = 512,
                remat: bool = False) -> Hit:
    """Closest collision over every object of the scene, as a chunked
    running minimum. origins, dirs: (R, 3). Returns a Hit of (R,)-shaped
    fields: t = INF_T, p = the origin, n = 0, material 0 and obj_id -1 on a
    miss (a hit needs t < MISS_T). remat: while autograd records, each
    sphere and box chunk runs under torch.utils.checkpoint, so a backward
    holds the running best, not every chunk's (R, C) candidates."""
    r = origins.shape[0]
    best = _init_best(r, origins)

    def sph_chunk(best, c, rad, v, m, s):
        t, n, inside = sphere_candidates(origins, dirs, c, rad, v)
        return _fold_chunk(best, t, n, inside, m, 0, s)

    sph = scene.spheres
    if sph.count:
        padded, csize = _chunks(sph.count, chunk_size)
        center = _pad_to(sph.center, padded)
        radius = _pad_to(sph.radius, padded)
        mat = _pad_to(sph.material_id, padded)
        valid = _valid(sph.count, padded, origins.device)
        fold = _remat(sph_chunk, remat)
        for s in range(0, padded, csize):
            sl = slice(s, s + csize)
            best = fold(best, center[sl], radius[sl], valid[sl], mat[sl], s)

    box = scene.boxes
    if box.count:
        padded, csize = _chunks(box.count, chunk_size)
        rot = _pad_to(euler_rotation_3x3b(box.angles), padded)
        mins = _pad_to(box.mins, padded)
        maxs = _pad_to(box.maxs, padded)
        pos = _pad_to(box.position, padded)
        mat = _pad_to(box.material_id, padded)
        valid = _valid(box.count, padded, origins.device)

        def box_chunk(best, mn, mx, ps, rt, v, m, s):
            t, n, inside = box_candidates(origins, dirs, mn, mx, ps, rt, v)
            return _fold_chunk(best, t, n, inside, m, sph.count, s)

        fold = _remat(box_chunk, remat)
        for s in range(0, padded, csize):
            sl = slice(s, s + csize)
            best = fold(best, mins[sl], maxs[sl], pos[sl], rot[sl],
                        valid[sl], mat[sl], s)

    pln = scene.planes
    if pln.count:
        valid = _valid(pln.count, pln.count, origins.device)
        t, n, inside = plane_candidates(origins, dirs, pln.normal, pln.offset,
                                        valid)
        best = _fold_chunk(best, t, n, inside, pln.material_id,
                           sph.count + box.count, 0)

    hit = best.t < MISS_T
    t_for_p = torch.where(hit, best.t, 0.0)
    p = origins + t_for_p[:, None] * dirs
    return Hit(t=best.t, p=p, n=best.n, inside=best.inside,
               material_id=best.material_id,
               obj_id=torch.where(hit, best.obj_id, -1), hit=hit)


def closest_hit_sp(scene: Scene, origins, dirs,
                   chunk_size: int = 512) -> Hit:
    """closest_hit for scenes without boxes, with a normal-free sphere scan:
    the chunks fold (t, index, inside, material, winning centre), and the
    winner's normal is rebuilt once per ray as normalize(p - c), flipped
    inside. The same hits and the same first-object tie rule; spheres
    precede planes in the global order, so a sphere beats a plane at equal
    t."""
    if scene.boxes.count:
        raise ValueError("closest_hit_sp: sphere/plane scenes only")
    r = origins.shape[0]
    best = _init_best(r, origins)
    t_s, in_s, mat_s, idx_s = (best.t, best.inside, best.material_id,
                               best.obj_id)
    c_s = origins.new_zeros((r, 3))

    sph = scene.spheres
    if sph.count:
        padded, csize = _chunks(sph.count, chunk_size)
        center = _pad_to(sph.center, padded)
        radius = _pad_to(sph.radius, padded)
        mat = _pad_to(sph.material_id, padded)
        valid = _valid(sph.count, padded, origins.device)
        for s in range(0, padded, csize):
            sl = slice(s, s + csize)
            t, _, inside = sphere_candidates(origins, dirs, center[sl],
                                             radius[sl], valid[sl],
                                             with_normals=False)
            tc, j = _first_min(t)
            jl = j.long()
            cc = center[sl][jl]           # the winner's centre, exactly
            ic = torch.gather(inside, 1, jl[:, None])[:, 0]
            mc = mat[sl][jl]
            upd = tc < t_s
            t_s = torch.where(upd, tc, t_s)
            c_s = torch.where(upd[:, None], cc, c_s)
            in_s = torch.where(upd, ic, in_s)
            mat_s = torch.where(upd, mc.to(torch.int32), mat_s)
            idx_s = torch.where(upd, (s + j).to(torch.int32), idx_s)

    # the sphere normal: normalize(p - c), flipped inside, rounded as
    # sphere_candidates rounds it (o - c + t d), so that the children of a
    # sphere hit start alike in closest_hit and here
    hit_s = t_s < MISS_T
    ts = torch.where(hit_s, t_s, 0.0)
    u = (origins - c_s) + ts[:, None] * dirs
    inv_len = torch.rsqrt(torch.clamp(
        _dot3(u[:, 0], u[:, 1], u[:, 2], u[:, 0], u[:, 1], u[:, 2]),
        min=_SQRT_EPS))
    sgn = torch.where(in_s, -inv_len, inv_len) * hit_s.to(origins.dtype)
    n_s = u * sgn[:, None]

    pln = scene.planes
    if pln.count:
        valid = _valid(pln.count, pln.count, origins.device)
        t, n, _ = plane_candidates(origins, dirs, pln.normal, pln.offset,
                                   valid)
        bp = _fold_chunk(_init_best(r, origins), t, n,
                         torch.zeros_like(t, dtype=torch.bool),
                         pln.material_id, sph.count, 0)
        sw = t_s <= bp.t             # a sphere wins a tie with a plane
        t_s = torch.where(sw, t_s, bp.t)
        n_s = torch.where(sw[:, None], n_s, bp.n)
        in_s = torch.where(sw, in_s, bp.inside)
        mat_s = torch.where(sw, mat_s, bp.material_id)
        idx_s = torch.where(sw, idx_s, bp.obj_id)

    hit = t_s < MISS_T
    t_for_p = torch.where(hit, t_s, 0.0)
    p = origins + t_for_p[:, None] * dirs
    return Hit(t=t_s, p=p, n=n_s, inside=in_s & hit, material_id=mat_s,
               obj_id=torch.where(hit, idx_s, -1), hit=hit)


def shadow_occlusion_sp(scene: Scene, shadow_org, to_lights,
                        chunk_size: int = 512,
                        lights_mask: tuple | None = None):
    """Every light's shadow occlusion in one scan over the scene.
    shadow_org (R, 3) is shared by every light (p + 0.01 n); to_lights
    (R, L, 3) are the unnormalized segments to the lights. Returns (R, L)
    bool. The origin-to-centre vectors and the quadratic's qc depend only
    on the shared origin, so each sphere chunk computes them once for every
    light's sqrt-free predicate (as sphere_blocked). Boxes and planes get a
    dense pass per light. lights_mask: static per-light bools
    (shading.static_shadow_mask); a False light casts nothing and reports
    unoccluded."""
    r, n_lights = to_lights.shape[0], to_lights.shape[1]
    occ = [torch.zeros((r,), dtype=torch.bool, device=shadow_org.device)
           for _ in range(n_lights)]
    active = [j for j in range(n_lights)
              if lights_mask is None or lights_mask[j]]

    lx = {j: to_lights[:, j, 0:1] for j in active}          # (R, 1) each
    ly = {j: to_lights[:, j, 1:2] for j in active}
    lz = {j: to_lights[:, j, 2:3] for j in active}
    qa = {j: _dot3(lx[j], ly[j], lz[j], lx[j], ly[j], lz[j])
          for j in active}

    sph = scene.spheres
    if sph.count and active:
        padded, csize = _chunks(sph.count, chunk_size)
        center = _pad_to(sph.center, padded)
        radius = _pad_to(sph.radius, padded)
        valid = _valid(sph.count, padded, shadow_org.device)
        for s in range(0, padded, csize):
            sl = slice(s, s + csize)
            c, rad, v = center[sl], radius[sl], valid[sl]
            ocx = shadow_org[:, None, 0] - c[None, :, 0]    # (R, C)
            ocy = shadow_org[:, None, 1] - c[None, :, 1]
            ocz = shadow_org[:, None, 2] - c[None, :, 2]
            qc = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - (rad * rad)[None, :]
            inside_src = qc < 0.0
            for j in active:
                qb = 2.0 * _dot3(lx[j], ly[j], lz[j], ocx, ocy, ocz)
                f_end = qa[j] + qb + qc                     # f(1)
                blocked_in = inside_src & (f_end > 0.0)
                disc_ok = qb * qb >= 4.0 * qa[j] * qc
                vertex_in = (qb < 0.0) & (-qb < 2.0 * qa[j])
                blocked_out = (~inside_src) & ((f_end < 0.0)
                                               | (disc_ok & vertex_in))
                blocked = ((blocked_in | blocked_out) & (qa[j] > _DIV_EPS)
                           & v[None, :])
                occ[j] = occ[j] | torch.any(blocked, dim=-1)

    box = scene.boxes
    if box.count:
        rot = euler_rotation_3x3b(box.angles)
        v = _valid(box.count, box.count, shadow_org.device)
        for j in active:
            t, _, _ = box_candidates(shadow_org, to_lights[:, j, :],
                                     box.mins, box.maxs, box.position, rot,
                                     v, with_normals=False)
            occ[j] = occ[j] | torch.any(t < 1.0, dim=-1)

    pln = scene.planes
    if pln.count:
        v = _valid(pln.count, pln.count, shadow_org.device)
        for j in active:
            t, _, _ = plane_candidates(shadow_org, to_lights[:, j, :],
                                       pln.normal, pln.offset, v,
                                       with_normals=False)
            occ[j] = occ[j] | torch.any(t < 1.0, dim=-1)

    if not occ:
        return torch.zeros((r, 0), dtype=torch.bool,
                           device=shadow_org.device)
    return torch.stack(occ, dim=-1)


def any_hit(scene: Scene, origins, dirs, max_t: float = 1.0,
            chunk_size: int = 512, remat: bool = False):
    """Occlusion query: does any object meet the ray at 0 < t < max_t?
    With the unnormalized surface -> light segment and max_t = 1 this is
    the reference's shadow predicate. Returns (R,) bool. remat: each sphere
    chunk under torch.utils.checkpoint while autograd records, as the
    reference's."""
    occluded = torch.zeros((origins.shape[0],), dtype=torch.bool,
                           device=origins.device)

    def sph_chunk(occ, c, rad, v):
        blocked = sphere_blocked(origins, dirs, c, rad, v, max_t=max_t)
        return occ | torch.any(blocked, dim=-1)

    sph = scene.spheres
    if sph.count:
        padded, csize = _chunks(sph.count, chunk_size)
        center = _pad_to(sph.center, padded)
        radius = _pad_to(sph.radius, padded)
        valid = _valid(sph.count, padded, origins.device)
        fold = _remat(sph_chunk, remat)
        for s in range(0, padded, csize):
            sl = slice(s, s + csize)
            occluded = fold(occluded, center[sl], radius[sl], valid[sl])

    box = scene.boxes
    if box.count:
        rot = euler_rotation_3x3b(box.angles)
        valid = _valid(box.count, box.count, origins.device)
        t, _, _ = box_candidates(origins, dirs, box.mins, box.maxs,
                                 box.position, rot, valid, with_normals=False)
        occluded = occluded | torch.any(t < max_t, dim=-1)

    pln = scene.planes
    if pln.count:
        valid = _valid(pln.count, pln.count, origins.device)
        t, _, _ = plane_candidates(origins, dirs, pln.normal, pln.offset,
                                   valid, with_normals=False)
        occluded = occluded | torch.any(t < max_t, dim=-1)

    return occluded
