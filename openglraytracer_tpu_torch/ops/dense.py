"""The dense geometry engines: closest hit and per-light occlusion of every
ray against every object, ``'xla'`` in plain PyTorch and ``'pallas'`` in
one CUDA kernel, under one analytic backward.

Engine ``'xla'`` (``xla_geometry``) is the XLA branch of the reference's
``ops/geometry.py _forward``: ``intersect.closest_hit`` (``closest_hit_sp``
when the scene has no boxes), then the shadow origin ``p + 0.01 n`` and
``intersect.shadow_occlusion_sp`` with the static light mask.

Engine ``'pallas'`` is the port of
``openglraytracer_tpu/ops/pallas_render.py`` (``_scene_tables``,
``_geometry_kernel``, ``pallas_geometry``). Kernel 7 (``dense_hit``,
csrc/dense_hit.cu) takes every ray through:

  1. a running minimum over all N spheres, then all M oriented boxes (slab
     test in the box's frame, face pick by exact equality with the winning
     slab boundary, y before z), then all P planes, with strict ``<`` so the
     first object wins a tie and objects beat planes at equal t;
  2. the finalize: normalize the normal, flip it for a sphere hit from
     inside, zero it on a miss;
  3. for every light (no static mask: the reference kernel casts every
     light's shadow ray), occlusion of the unnormalized segment from
     ``p + 0.01 n`` to the light, t in (0, 1), by every object.

``dense_hit_plain`` is its plain PyTorch version, the same arithmetic op for
op: a Python loop over objects, elementwise over rays. The multiply-adds
that XLA's CPU compiler contracts in the reference kernel (the three-term
dot products and the sphere quadratic's discriminant) are fused
multiply-adds here too, ``fmaf`` in the kernel and ``_fma`` in the plain
version, so that t equals the JAX package's bit for bit on its CPU tests.
The normal is normalized with a correctly rounded ``1 / sqrt`` in both
versions (CUDA's ``rsqrtf`` is not), so the shadow origin rounds alike.

``dense_geometry`` assembles the ``Hit`` of ``pallas_geometry`` around the
kernel's record. ``geometry_op`` makes either engine's forward
differentiable, the port of the reference's ``ops/geometry.py
geometry_op``: its backward ``_dense_bwd`` gathers each ray's winner from
the global tables and runs the winner replay shared with the culled engine
(``ops/geometry.winner_backward``).
"""

from __future__ import annotations

import torch

from openglraytracer_tpu_torch import kernels
from openglraytracer_tpu_torch.models.scene import MISS_T, Scene
from openglraytracer_tpu_torch.ops.geometry import (_GEOMETRY_LEAVES, _N_HIT,
                                                    _with_leaves, box_rotation,
                                                    component_dot,
                                                    plane_grads, sum_dot,
                                                    winner_backward,
                                                    winner_scatter)
from openglraytracer_tpu_torch.ops.intersect import (_DIV_EPS, _SQRT_EPS,
                                                     INF_T, Hit,
                                                     _inv_safe, closest_hit,
                                                     closest_hit_sp,
                                                     shadow_occlusion_sp)
from openglraytracer_tpu_torch.ops.shading import SHADOW_EPS
from openglraytracer_tpu_torch.ops.transforms import _fma

SPH_COLS, BOX_COLS, PLN_COLS, LIGHT_COLS = 4, 18, 4, 3


def _dot3(ax, ay, az, bx, by, bz):
    """a . b as the reference kernel rounds it: fma(z, fma(x, y * y))."""
    return _fma(az, bz, _fma(ax, bx, ay * by))


def _scene_tables(scene: Scene):
    """The kernel's tables: spheres (N, 4) [c r]; boxes (M, 18) [mins maxs
    pos rot(9)], rot = euler_rotation_3x3b(angles) row-major; planes (P, 4)
    [unit normal, offset / |normal|]; lights (L, 3) positions. An empty
    primitive type gives a table of 0 rows."""
    from openglraytracer_tpu_torch.ops.transforms import euler_rotation_3x3b

    sph, box, pln = scene.spheres, scene.boxes, scene.planes
    sph_t = torch.cat([sph.center, sph.radius[:, None]], dim=-1)
    rot = euler_rotation_3x3b(box.angles).reshape(box.count, 9)
    box_t = torch.cat([box.mins, box.maxs, box.position, rot], dim=-1)
    length = torch.clamp(torch.linalg.norm(pln.normal, dim=-1, keepdim=True),
                         min=_SQRT_EPS)
    pln_t = torch.cat([pln.normal / length, pln.offset[:, None] / length],
                      dim=-1)
    return (sph_t.contiguous(), box_t.contiguous(), pln_t.contiguous(),
            scene.lights.position.contiguous())


def _box_slab(row, px, py, pz, vx, vy, vz):
    """Slab test of p + t v against one box row [mins maxs pos rot(9)]: (t,
    ok, is_in, (rdx, rdy, rdz), slab boundaries (t1x t1y t1z t2x t2y t2z))."""
    bm0, bm1, bm2, bx0, bx1, bx2, cx, cy, cz = row[:9]
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = row[9:18]
    wx, wy, wz = px - cx, py - cy, pz - cz
    # world -> local: R^T (x - pos), R^T v
    rox = _dot3(wx, wy, wz, r00, r10, r20)
    roy = _dot3(wx, wy, wz, r01, r11, r21)
    roz = _dot3(wx, wy, wz, r02, r12, r22)
    rdx = _dot3(vx, vy, vz, r00, r10, r20)
    rdy = _dot3(vx, vy, vz, r01, r11, r21)
    rdz = _dot3(vx, vy, vz, r02, r12, r22)
    ix, iy, iz = _inv_safe(rdx), _inv_safe(rdy), _inv_safe(rdz)
    tax, tbx = (bm0 - rox) * ix, (bx0 - rox) * ix
    tay, tby = (bm1 - roy) * iy, (bx1 - roy) * iy
    taz, tbz = (bm2 - roz) * iz, (bx2 - roz) * iz
    t1x, t2x = torch.minimum(tax, tbx), torch.maximum(tax, tbx)
    t1y, t2y = torch.minimum(tay, tby), torch.maximum(tay, tby)
    t1z, t2z = torch.minimum(taz, tbz), torch.maximum(taz, tbz)
    t_near = torch.maximum(t1x, torch.maximum(t1y, t1z))
    t_far = torch.minimum(t2x, torch.minimum(t2y, t2z))
    ok = (t_near < t_far) & (t_far > 0.0)
    is_in = t_near < 0.0
    t = torch.where(is_in, t_far, t_near)
    ok = ok & (t > 0.0)
    return (t, ok, is_in, (rdx, rdy, rdz), (t1x, t1y, t1z, t2x, t2y, t2z))


def _sphere_roots(row, px, py, pz, vx, vy, vz, qa, inv_2qa):
    """Quadratic of p + t v against sphere row [c r]: (t, ok, is_in, oc)."""
    ocx, ocy, ocz = px - row[0], py - row[1], pz - row[2]
    qb = 2.0 * _dot3(vx, vy, vz, ocx, ocy, ocz)
    qc = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - row[3] * row[3]
    disc = _fma(qb, qb, -(4.0 * qa * qc))
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = (sq - qb) * inv_2qa
    t2 = (-sq - qb) * inv_2qa
    t_near = torch.minimum(t1, t2)
    t_far = torch.maximum(t1, t2)
    is_in = t_near < 0.0
    t = torch.where(is_in, t_far, t_near)
    ok = (disc >= 0.0) & (t_far >= 0.0) & (t > 0.0)
    return t, ok, is_in, (ocx, ocy, ocz)


def _plane_t(row, px, py, pz, vx, vy, vz):
    """(t, nd) of p + t v against plane row [unit n, off]: a division, as
    the reference kernel."""
    nd = _dot3(row[0], row[1], row[2], vx, vy, vz)
    no = _dot3(row[0], row[1], row[2], px, py, pz)
    nd_safe = torch.where(torch.abs(nd) < _DIV_EPS,
                          torch.where(nd < 0, -_DIV_EPS, _DIV_EPS), nd)
    return (row[3] - no) / nd_safe, nd


def dense_hit_plain(origins, dirs, sph, box, pln, lights):
    """Plain version of kernel 7. origins, dirs (R, 3); the tables of
    _scene_tables. Returns t (R,) (INF_T where no object was hit; a hit
    needs t < MISS_T), n (R, 3) unit (zero on a miss), inside (R,) bool
    (False on a miss), obj_id (R,) int32 global object index (spheres,
    boxes, planes; -1 on a miss), occ (L, R) bool: light j's segment from
    p + 0.01 n is blocked (computed for every ray; a contract only where
    the ray hit)."""
    ox, oy, oz = origins.unbind(-1)
    dx, dy, dz = dirs.unbind(-1)
    n_sph, n_box = sph.shape[0], box.shape[0]
    qa = _dot3(dx, dy, dz, dx, dy, dz)
    inv_2qa = 0.5 / torch.clamp(qa, min=_DIV_EPS)

    tb = torch.full_like(ox, INF_T)
    nx, ny, nz = (torch.zeros_like(ox) for _ in range(3))
    ins = torch.zeros_like(ox, dtype=torch.bool)
    flp = torch.zeros_like(ins)
    idx = torch.zeros_like(ox, dtype=torch.int32)

    # sphere normals are kept unnormalized (p - c) with the inside flip
    # deferred to the finalize; box and plane normals are unit and oriented
    for i in range(n_sph):
        t, ok, is_in, (ocx, ocy, ocz) = _sphere_roots(
            sph[i], ox, oy, oz, dx, dy, dz, qa, inv_2qa)
        t = torch.where(ok, t, INF_T)
        upd = t < tb
        ts = torch.where(upd, t, 0.0)
        tb = torch.where(upd, t, tb)
        nx = torch.where(upd, _fma(ts, dx, ocx), nx)
        ny = torch.where(upd, _fma(ts, dy, ocy), ny)
        nz = torch.where(upd, _fma(ts, dz, ocz), nz)
        ins = torch.where(upd, is_in, ins)
        flp = torch.where(upd, is_in, flp)
        idx = torch.where(upd, i, idx)

    for i in range(n_box):
        row = box[i]
        t, ok, is_in, (rdx, rdy, rdz), (t1x, t1y, t1z, t2x, t2y, t2z) = \
            _box_slab(row, ox, oy, oz, dx, dy, dz)
        t = torch.where(ok, t, INF_T)
        upd = t < tb
        # face pick: exact equality with the winning slab boundary, y
        # before z; entry compares t1, exit t2
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
        r00, r01, r02, r10, r11, r12, r20, r21, r22 = row[9:18]
        tb = torch.where(upd, t, tb)
        # local -> world: R n_local (one-hot n_local: exact in any order)
        nx = torch.where(upd, r00 * nlx + r01 * nly + r02 * nlz, nx)
        ny = torch.where(upd, r10 * nlx + r11 * nly + r12 * nlz, ny)
        nz = torch.where(upd, r20 * nlx + r21 * nly + r22 * nlz, nz)
        ins = torch.where(upd, is_in, ins)
        flp = torch.where(upd, False, flp)
        idx = torch.where(upd, n_sph + i, idx)

    for k in range(pln.shape[0]):
        row = pln[k]
        t, nd = _plane_t(row, ox, oy, oz, dx, dy, dz)
        ok = (torch.abs(nd) > 1.0e-9) & (t > 0.0)
        t = torch.where(ok, t, INF_T)
        upd = t < tb          # strict: objects beat planes at equal t
        s = torch.where(nd > 0.0, -1.0, 1.0)    # faces the incoming ray
        tb = torch.where(upd, t, tb)
        nx = torch.where(upd, row[0] * s, nx)
        ny = torch.where(upd, row[1] * s, ny)
        nz = torch.where(upd, row[2] * s, nz)
        ins = torch.where(upd, False, ins)
        flp = torch.where(upd, False, flp)
        idx = torch.where(upd, n_sph + n_box + k, idx)

    hit = tb < MISS_T
    ts = torch.where(hit, tb, 0.0)
    inv_len = 1.0 / torch.sqrt(torch.clamp(_dot3(nx, ny, nz, nx, ny, nz),
                                           min=_SQRT_EPS))
    sgn = torch.where(flp, -inv_len, inv_len) * hit.to(ox.dtype)
    nx, ny, nz = nx * sgn, ny * sgn, nz * sgn
    px, py, pz = _fma(ts, dx, ox), _fma(ts, dy, oy), _fma(ts, dz, oz)
    # shadow origin offset along the normal
    eps = nx.new_tensor(SHADOW_EPS)
    sx, sy, sz = _fma(eps, nx, px), _fma(eps, ny, py), _fma(eps, nz, pz)

    occ = []
    for j in range(lights.shape[0]):
        # the unnormalized surface -> light segment, t in (0, 1)
        tlx, tly, tlz = lights[j, 0] - px, lights[j, 1] - py, \
            lights[j, 2] - pz
        sqa = _dot3(tlx, tly, tlz, tlx, tly, tlz)
        sinv_2qa = 0.5 / torch.clamp(sqa, min=_DIV_EPS)
        blocked = torch.zeros_like(hit)
        for i in range(n_sph):
            t, ok, _, _ = _sphere_roots(sph[i], sx, sy, sz, tlx, tly, tlz,
                                        sqa, sinv_2qa)
            blocked = blocked | (ok & (t < 1.0))
        for i in range(n_box):
            t, ok, _, _, _ = _box_slab(box[i], sx, sy, sz, tlx, tly, tlz)
            blocked = blocked | (ok & (t < 1.0))
        for k in range(pln.shape[0]):
            t, nd = _plane_t(pln[k], sx, sy, sz, tlx, tly, tlz)
            blocked = blocked | ((torch.abs(nd) > 1.0e-9) & (t > 0.0)
                                 & (t < 1.0))
        occ.append(blocked)
    occ = (torch.stack(occ) if occ
           else torch.zeros((0,) + hit.shape, dtype=torch.bool,
                            device=hit.device))
    return (tb, torch.stack([nx, ny, nz], dim=-1), ins & hit,
            torch.where(hit, idx, -1), occ)


@torch.no_grad()
@kernels.wrapper
def dense_hit(origins, dirs, sph, box, pln, lights):
    """Kernel 7 (csrc/dense_hit.cu) on CUDA tensors, its plain version on
    CPU tensors; arguments and results as dense_hit_plain."""
    if kernels.on_cpu(dirs):
        return dense_hit_plain(origins, dirs, sph, box, pln, lights)
    dev = dirs.device
    r_total = dirs.shape[0]
    n_sph, n_box, n_pln, n_lights = (sph.shape[0], box.shape[0],
                                     pln.shape[0], lights.shape[0])
    f32 = torch.float32
    kernels.check("origins", origins, dev, f32, (r_total, 3))
    kernels.check("dirs", dirs, dev, f32, (r_total, 3))
    kernels.check("sph", sph, dev, f32, (n_sph, SPH_COLS))
    kernels.check("box", box, dev, f32, (n_box, BOX_COLS))
    kernels.check("pln", pln, dev, f32, (n_pln, PLN_COLS))
    kernels.check("lights", lights, dev, f32, (n_lights, LIGHT_COLS))
    if r_total >= 2 ** 31:
        raise ValueError(f"dirs: {r_total} rays; the kernel indexes rays "
                         "with int32")
    t = torch.empty(r_total, dtype=f32, device=dev)
    n = torch.empty((r_total, 3), dtype=f32, device=dev)
    inside = torch.empty(r_total, dtype=torch.bool, device=dev)
    obj_id = torch.empty(r_total, dtype=torch.int32, device=dev)
    occ = torch.empty((n_lights, r_total), dtype=torch.bool, device=dev)
    kernels.launch("oglrt_dense_hit", dev, origins, dirs, sph, box, pln,
                   lights, r_total, n_sph, n_box, n_pln, n_lights, t, n,
                   inside, obj_id, occ)
    kernels.LAUNCHES["dense_hit"] += 1
    return t, n, inside, obj_id, occ


def dense_geometry(scene: Scene, origins, dirs):
    """Closest hit and per-light occlusion of (R, 3) rays against every
    object: (Hit, occluded (R, L) bool), the record of pallas_geometry.
    p = o + t d with t zeroed on a miss (p = o there); material_id from
    the spheres, boxes, planes material table by obj_id, 0 on a miss;
    obj_id -1 on a miss; inside only where the ray hit. Not differentiable:
    geometry_op wraps it with the analytic backward."""
    tables = [x.detach() for x in _scene_tables(scene)]
    t, n, inside, obj_id, occ = dense_hit(origins.detach().contiguous(),
                                          dirs.detach().contiguous(), *tables)
    hit = t < MISS_T
    ts = torch.where(hit, t, 0.0)
    p = origins.detach() + ts[:, None] * dirs.detach()
    mat_table = torch.cat([scene.spheres.material_id,
                           scene.boxes.material_id,
                           scene.planes.material_id])
    if mat_table.numel():
        mat = torch.index_select(mat_table, 0,
                                 torch.clamp(obj_id, min=0).long())
        mat = torch.where(hit, mat, 0)
    else:
        mat = torch.zeros_like(obj_id)
    return (Hit(t=t, p=p, n=n, inside=inside, material_id=mat,
                obj_id=obj_id, hit=hit), occ.t())


# ---------------------------------------------------------------------------
# The dense engine's differentiable op
# ---------------------------------------------------------------------------

def _dense_bwd(scene: Scene, origins, dirs, hit: Hit, gt, gp, gn,
               need_rays: bool = False, dot=sum_dot):
    """Analytic winner-only backward of the dense engine, the port of
    ``geometry._geometry_bwd``: winner rows gathered from the global tables
    by obj_id (index_select), winner_backward, and the per-ray cotangents
    added into the objects with index_add_ (the planes' with
    winner_scatter). Returns the cotangents of the leaves of
    geometry._GEOMETRY_LEAVES, then of the origins and directions (None
    unless need_rays), as accel._culled_bwd. dot: the replay's row-wise dot
    product (geometry.component_dot for engine 'xla')."""
    sph, box = scene.spheres, scene.boxes
    n_sph, n_box = sph.count, box.count
    idx = hit.obj_id
    hm = hit.hit
    none = torch.zeros_like(hm)
    is_sph = (hm & (idx < n_sph)) if n_sph else none
    is_box = (hm & (idx >= n_sph) & (idx < n_sph + n_box)) if n_box \
        else none

    sph_rows = box_rows = None
    if n_sph:
        sid = torch.clamp(idx, 0, n_sph - 1)
        sph_rows = torch.index_select(
            torch.cat([sph.center, sph.radius[:, None]], -1), 0, sid)
    if n_box:
        bid = torch.clamp(idx - n_sph, 0, n_box - 1)
        angles, rot_table = box_rotation(box)
        btab = torch.cat([box.mins, box.maxs, box.position,
                          rot_table.detach()], dim=-1)     # (M, 18)
        box_rows = torch.index_select(btab, 0, bid)

    g_sph_r, g_box_r, g_pln_r, pln_slot, go, gd = winner_backward(
        scene, origins, dirs, hit, is_sph, is_box, sph_rows, box_rows,
        gt, gp, gn, need_rays, dot=dot)
    g_pln = None
    if scene.planes.count:
        g_pln = torch.zeros((scene.planes.count, 4), dtype=gt.dtype,
                            device=gt.device)
        winner_scatter(None, None, None, None, g_pln_r, pln_slot, None, g_pln)
    g_normal, g_offset = plane_grads(scene.planes, g_pln)

    if n_sph:
        g_sph = torch.zeros((n_sph, 4), dtype=gt.dtype, device=gt.device) \
            .index_add_(0, sid, g_sph_r)
        g_center, g_radius = g_sph[:, :3], g_sph[:, 3]
    else:
        g_center, g_radius = torch.zeros_like(sph.center), \
            torch.zeros_like(sph.radius)
    if n_box:
        g_box = torch.zeros((n_box, 18), dtype=gt.dtype, device=gt.device) \
            .index_add_(0, bid, g_box_r)
        (g_angles,) = torch.autograd.grad(rot_table, angles, g_box[:, 9:18])
        g_mins, g_maxs, g_pos = g_box[:, 0:3], g_box[:, 3:6], g_box[:, 6:9]
    else:
        g_mins, g_maxs, g_pos, g_angles = (torch.zeros_like(x) for x in (
            box.mins, box.maxs, box.position, box.angles))
    return (g_center, g_radius, g_mins, g_maxs, g_pos, g_angles, g_normal,
            g_offset, go, gd)


def xla_geometry(scene: Scene, origins, dirs, chunk_size: int = 512,
                 shadow_lights: tuple | None = None):
    """Engine 'xla': (Hit, occluded (R, L) bool) of (R, 3) rays in plain
    PyTorch, objects scanned in chunks of chunk_size. shadow_lights: static
    per-light bools; a False light casts no shadow ray (unoccluded)."""
    if scene.boxes.count:
        hit = closest_hit(scene, origins, dirs, chunk_size=chunk_size)
    else:
        hit = closest_hit_sp(scene, origins, dirs, chunk_size=chunk_size)
    shadow_org = hit.p + hit.n * SHADOW_EPS
    to_lights = scene.lights.position[None, :, :] - hit.p[:, None, :]
    occ = shadow_occlusion_sp(scene, shadow_org, to_lights,
                              chunk_size=chunk_size,
                              lights_mask=shadow_lights)
    return hit, occ


class _GeometryOp(torch.autograd.Function):
    """Forward: xla_geometry (engine 'xla') or dense_geometry (kernel 7,
    engine 'pallas'). Backward: _dense_bwd. Takes the scene (for its
    non-differentiable columns), the forward as a function of (scene,
    origins, dirs), the replay's dot product, the geometry leaves of
    geometry._GEOMETRY_LEAVES and the rays; returns the Hit fields and the
    occlusion, of which only t, p and n are differentiable."""

    @staticmethod
    def forward(ctx, scene, geometry, dot, *tensors):
        leaves, (origins, dirs) = tensors[:-2], tensors[-2:]
        scene = _with_leaves(scene, leaves)
        hit, occ = geometry(scene, origins, dirs)
        ctx.mark_non_differentiable(*hit[3:], occ)
        ctx.save_for_backward(*tensors, hit.inside, hit.obj_id, hit.hit)
        ctx.scene, ctx.dot = scene, dot
        return (*hit, occ)

    @staticmethod
    def backward(ctx, gt, gp, gn, *_):
        saved = ctx.saved_tensors
        n_in = len(_GEOMETRY_LEAVES) + 2
        leaves, (origins, dirs) = saved[:n_in - 2], saved[n_in - 2:n_in]
        inside, obj_id, hit_mask = saved[n_in:]
        scene = _with_leaves(ctx.scene, leaves)
        hit = Hit(t=None, p=None, n=None, inside=inside, material_id=None,
                  obj_id=obj_id, hit=hit_mask)
        need = ctx.needs_input_grad[3:]
        grads = _dense_bwd(scene, origins, dirs, hit, gt, gp, gn,
                           need_rays=any(need[-2:]), dot=ctx.dot)
        return (None, None, None, *(g if want else None
                                    for g, want in zip(grads, need)))


def geometry_op(scene: Scene, origins, dirs, engine: str = "xla",
                chunk_size: int = 512, shadow_lights: tuple | None = None):
    """Closest hit and per-light occlusion of (R, 3) rays against every
    object, with the analytic backward: (Hit, occluded (R, L) bool).
    Gradients of hit.t, hit.p and hit.n flow to the spheres' center and
    radius, the boxes' mins, maxs, position and angles, the planes' normal
    and offset, and to the rays whenever they require grad (bounce
    children). engine 'xla' (plain PyTorch, chunk_size objects a chunk,
    shadow rays for the lights of shadow_lights only) or 'pallas' (kernel
    7, which like the reference kernel casts every light's shadow ray and so
    ignores chunk_size and shadow_lights; occlusion carries no gradient)."""
    if engine == "pallas":
        geometry, dot = dense_geometry, sum_dot
    elif engine == "xla":
        def geometry(s, o, d):
            return xla_geometry(s, o, d, chunk_size, shadow_lights)
        dot = component_dot
    else:
        raise ValueError(f"geometry_op: engine '{engine}' is not a dense "
                         "engine ('xla' or 'pallas')")
    leaves = [getattr(getattr(scene, part), field)
              for part, field in _GEOMETRY_LEAVES]
    out = _GeometryOp.apply(scene, geometry, dot, *leaves, origins, dirs)
    return Hit(*out[:_N_HIT]), out[_N_HIT]
