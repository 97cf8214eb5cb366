"""Winner replay and the analytic backward of the geometry stage.

Port of ``openglraytracer_tpu/ops/geometry.py``. The gradient of a hit
record with respect to the scene flows only through each ray's winner: the
argmin over candidates is piecewise constant and occlusion is binary. So the
backward gathers each ray's winning object, replays one candidate per ray
with the forward's discrete decisions frozen (winner, inside flag, hit mask;
``_sphere_recompute``, ``_box_recompute``, ``_plane_recompute``,
``_winner_recompute``), differentiates the replay with ``torch.autograd``
and adds the per-ray cotangents back into the objects: O(R) work, not
O(R N).

``winner_backward`` is that replay, its VJP and the masking, shared by the
two engines; each brings its own gather and scatter of the winners' rows.
The culled engine's (``ops/accel.py _culled_bwd``) runs through the (T, K)
survivor lists; the dense engine's (``ops/dense.py _dense_bwd``) through
the global object tables, with ``index_select`` and ``index_add_``.
``winner_scatter`` sums per-ray winner rows into object rows a group of
rays at a time (csrc/winner_scatter.cu on the card): the culled engine's
survivor slots, planes and material rows, and the dense engine's planes.
The scene leaves both engines' differentiable ops take
(``_GEOMETRY_LEAVES``) are defined here too, so this module depends on
neither engine.

The box replay is the slab test of the forward restricted to one box per
ray; its face pick compares the replay's t with the replay's own slab
boundaries, so it is consistent by construction. Box angles are
differentiated per box through ``euler_rotation_3x3b``, not per ray.
"""

from __future__ import annotations

import torch

from openglraytracer_tpu_torch import kernels
from openglraytracer_tpu_torch.models.scene import Scene
from openglraytracer_tpu_torch.ops.intersect import (Hit, _dot3, _rot_apply,
                                                     _rot_apply_t, _safe_div)
from openglraytracer_tpu_torch.ops.transforms import euler_rotation_3x3b


def sum_dot(a, b):
    """Row-wise a . b of (R, 3) rows by torch.sum, as the reference's
    replay sums them."""
    return torch.sum(a * b, dim=-1)


def component_dot(a, b):
    """Row-wise a . b summed as intersect._dot3 sums: the replay dot of the
    dense engine 'xla', whose forward is intersect.py. torch.sum sums in
    another order on the GPU, and at a grazing ray the discriminant is the
    difference of nearly equal terms while t's gradient goes as its
    inverse square root: one rounding apart there moves a whole leaf's
    gradient (5e-3 of its largest on the OBB world at depth 1, against
    autograd through the forward). The kernel engines' forwards round as
    their kernels do, so for them the cheaper torch.sum is as good."""
    return _dot3(a[:, 0], a[:, 1], a[:, 2], b[:, 0], b[:, 1], b[:, 2])


def _sphere_recompute(c, r, o, d, inside, dot=sum_dot):
    """Winning-sphere (t, p, n) replay; frozen inside flag selects the root.
    dot: the row-wise dot product (sum_dot or component_dot)."""
    eps = 1.0e-12
    oc = o - c
    qa = dot(d, d)
    qb = 2.0 * dot(d, oc)
    qc = dot(oc, oc) - r * r
    disc = qb * qb - 4.0 * qa * qc
    disc_safe = torch.where(disc > 0.0, disc, 1.0)
    sq = torch.where(disc > 0.0, torch.sqrt(disc_safe), 0.0)
    inv_2qa = _safe_div(torch.full_like(qa, 0.5), qa)
    t_near = (-qb - sq) * inv_2qa
    t_far = (-qb + sq) * inv_2qa
    t_s = torch.where(inside, t_far, t_near)
    p_s = o + t_s[:, None] * d
    u = p_s - c
    u_len = torch.sqrt(torch.clamp(dot(u, u), min=eps))[:, None]
    n_s = u / u_len
    n_s = torch.where(inside[:, None], -n_s, n_s)
    return t_s, p_s, n_s


def _box_recompute(bm, bx, bp, rot, o, d, inside):
    """Winning-box (t, p, n) replay: the slab test restricted to one box per
    ray. The frozen inside flag selects entry or exit; the face pick (y
    before z, exact equality with the winning slab boundary) and its sign
    are re-derived. rot (R, 3, 3) is the per-ray gathered box rotation: the
    angles -> rotation chain is differentiated per box by the caller."""
    wx = o[:, 0] - bp[:, 0]
    wy = o[:, 1] - bp[:, 1]
    wz = o[:, 2] - bp[:, 2]
    rox, roy, roz = _rot_apply_t(rot, wx, wy, wz)
    rdx, rdy, rdz = _rot_apply_t(rot, d[:, 0], d[:, 1], d[:, 2])
    ro = torch.stack([rox, roy, roz], dim=-1)           # (R, 3)
    rd = torch.stack([rdx, rdy, rdz], dim=-1)

    inv_d = _safe_div(torch.ones_like(rd), rd)
    ta = (bm - ro) * inv_d
    tb = (bx - ro) * inv_d
    t1 = torch.minimum(ta, tb)
    t2 = torch.maximum(ta, tb)
    t_near = torch.amax(t1, dim=-1)
    t_far = torch.amin(t2, dim=-1)
    t_b = torch.where(inside, t_far, t_near)
    p_b = o + t_b[:, None] * d

    # y-before-z face equality pick, as the forward
    boundary = torch.where(inside[:, None], t2, t1)     # (R, 3)
    ts = t_b[:, None]
    face = torch.where(ts == boundary[:, 1:2], 1,
                       torch.where(ts == boundary[:, 2:3], 2, 0))[:, 0]
    one_hot = (face[:, None] == torch.arange(3, device=face.device)[None, :]
               ).to(t_b.dtype)
    rd_face = torch.sum(one_hot * rd, dim=-1)
    sign = torch.where(rd_face > 0.0, -1.0, 1.0)
    n_local = one_hot * sign[:, None]
    nx, ny, nz = _rot_apply(rot, n_local[:, 0], n_local[:, 1], n_local[:, 2])
    n_b = torch.stack([nx, ny, nz], dim=-1)
    return t_b, p_b, n_b


def _plane_recompute(pn, poff, o, d, dot=sum_dot):
    eps = 1.0e-12
    nd = dot(pn, d)
    no = dot(pn, o)
    t_p = _safe_div(poff - no, nd)
    p_p = o + t_p[:, None] * d
    pn_len = torch.sqrt(torch.clamp(dot(pn, pn), min=eps))[:, None]
    n_unit = pn / pn_len
    n_p = torch.where(nd[:, None] > 0.0, -n_unit, n_unit)
    return t_p, p_p, n_p


def _winner_recompute(c, r, pn, poff, o, d, is_sph, inside, hit_mask,
                      box_params=None, is_box=None, dot=sum_dot):
    """Recompute (t, p, n) of the winning candidate from its own parameters,
    with the forward's discrete decisions (winner, inside flag, hit mask)
    frozen.

    c (R, 3), r (R,), pn (R, 3), poff (R,): winner sphere / plane params.
    box_params: optional (mins, maxs, position, rot (R, 3, 3)) of the winner
    box when the scene has boxes; is_box the per-ray box-winner mask.
    dot: the row-wise dot product of the sphere and plane replays.
    Returns t (R,), p (R, 3), n (R, 3): t = 0, p = o and n = 0 on misses."""
    t, p, n = _sphere_recompute(c, r, o, d, inside, dot)
    t_p, p_p, n_p = _plane_recompute(pn, poff, o, d, dot)

    is_sph_f = is_sph[:, None]
    t = torch.where(is_sph, t, t_p)
    p = torch.where(is_sph_f, p, p_p)
    n = torch.where(is_sph_f, n, n_p)

    if box_params is not None:
        bm, bx, bp, brot = box_params
        t_b, p_b, n_b = _box_recompute(bm, bx, bp, brot, o, d, inside)
        ib = is_box[:, None]
        t = torch.where(is_box, t_b, t)
        p = torch.where(ib, p_b, p)
        n = torch.where(ib, n_b, n)

    hm = hit_mask
    t = torch.where(hm, t, 0.0)
    p = torch.where(hm[:, None], p, o)
    n = torch.where(hm[:, None], n, 0.0)
    return t, p, n


# ---------------------------------------------------------------------------
# The shared backward: replay, VJP, masking
# ---------------------------------------------------------------------------

def box_rotation(boxes):
    """(angles, rot (M, 9)): a leaf copy of the box angles and their
    rotation table built from it under autograd, so that a caller can turn
    cotangents of the table into cotangents of the angles (the per-box
    angle chain of the backward)."""
    with torch.enable_grad():
        angles = boxes.angles.detach().requires_grad_()
        rot = euler_rotation_3x3b(angles).reshape(boxes.count, 9)
    return angles, rot


def winner_backward(scene: Scene, origins, dirs, hit: Hit, is_sph, is_box,
                    sph_rows, box_rows, gt, gp, gn, need_rays: bool,
                    lost=None, dot=sum_dot):
    """Per-ray cotangents of each ray's winner, from the cotangents gt (R,),
    gp (R, 3), gn (R, 3) of hit.t, hit.p and hit.n.

    is_sph / is_box: rays whose winner is a sphere / box (and whose winner
    row is known). sph_rows (R, 4) [c r] and box_rows (R, 18) [mins maxs
    pos rot(9)]: the gathered winner rows (None when the scene has none of
    that kind); planes are gathered here by global object id. lost: rays
    whose winner is unknown (their cotangents are dropped), or None. dot:
    the replay's row-wise dot product (component_dot for engine 'xla').

    On a miss the forward's p is the ray origin, so p's cotangent goes to
    the origin. Returns (g_sph (R, 4), g_box (R, 18), g_pln (R, 4),
    pln_slot (R,) int32, g_origins, g_dirs): the per-ray winner cotangents
    [c r], [mins maxs pos rot] and [normal offset], zero on rays whose
    winner is of another kind (None for an absent kind); each ray's winning
    plane, -1 where its winner is no plane (None without planes), for the
    caller's winner_scatter; and the rays' cotangents (None unless
    need_rays)."""
    pln = scene.planes
    n_sph, n_box, n_pln = scene.spheres.count, scene.boxes.count, pln.count
    r_total = origins.shape[0]
    dtype, device = origins.dtype, origins.device
    idx = hit.obj_id
    hm = hit.hit

    if n_sph:
        c = sph_rows[:, 0:3]
        r = torch.where(is_sph, sph_rows[:, 3], 1.0)
    else:
        c = torch.zeros_like(origins)
        r = torch.ones(r_total, dtype=dtype, device=device)
    box_params = None
    if n_box:
        box_params = [box_rows[:, 0:3], box_rows[:, 3:6], box_rows[:, 6:9],
                      box_rows[:, 9:18].reshape(-1, 3, 3)]
    if n_pln:
        pid = torch.clamp(idx - n_sph - n_box, 0, n_pln - 1)
        pn = torch.index_select(pln.normal, 0, pid)
        poff = torch.index_select(pln.offset, 0, pid)
    else:
        pn = torch.zeros_like(origins)
        pn[:, 2] = 1.0
        poff = torch.zeros(r_total, dtype=dtype, device=device)

    # a miss's p is its origin; a lost winner's ray gets nothing
    gp_direct_o = torch.where(hm[:, None], 0.0, gp)
    if lost is not None:
        hm = hm & ~lost
    live = hm[:, None]
    gt = torch.where(hm, gt, 0.0)
    gn = torch.where(live, gn, 0.0)
    gp = torch.where(live, gp, 0.0)

    # replay one candidate per ray and take its VJP
    inputs = [c, r, pn, poff] + (box_params or []) \
        + ([origins, dirs] if need_rays else [])
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in inputs]
        o_, d_ = (leaves[-2:] if need_rays
                  else (origins.detach(), dirs.detach()))
        bp = leaves[4:8] if n_box else None
        t, p, n = _winner_recompute(leaves[0], leaves[1], leaves[2],
                                    leaves[3], o_, d_, is_sph, hit.inside,
                                    hm, box_params=bp, is_box=is_box,
                                    dot=dot)
        grads = torch.autograd.grad((t, p, n), leaves, (gt, gp, gn),
                                    allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    gc, gr, gpn, gpoff = grads[:4]

    g_sph = g_box = None
    if n_sph:
        g_sph = torch.where(is_sph[:, None],
                            torch.cat([gc, gr[:, None]], -1), 0.0)
    if n_box:
        gbm, gbx, gbp, gbrot = grads[4:8]
        g_box = torch.where(is_box[:, None], torch.cat(
            [gbm, gbx, gbp, gbrot.reshape(-1, 9)], dim=-1), 0.0)

    g_pln = pln_slot = None
    if n_pln:
        pln_mask = hm & ~is_sph & ~is_box
        g_pln = torch.where(pln_mask[:, None],
                            torch.cat([gpn, gpoff[:, None]], -1), 0.0)
        pln_slot = torch.where(pln_mask, pid, -1).to(torch.int32)

    go = gd = None
    if need_rays:
        go, gd = grads[-2] + gp_direct_o, grads[-1]
    return g_sph, g_box, g_pln, pln_slot, go, gd


def plane_grads(planes, g_pln):
    """(g_normal (P, 3), g_offset (P,)) from the planes' summed rows
    g_pln (P, 4) [normal offset], or zeros where the scene has no planes
    (g_pln None)."""
    if g_pln is None:
        return torch.zeros_like(planes.normal), torch.zeros_like(planes.offset)
    return g_pln[:, :3], g_pln[:, 3]


# ---------------------------------------------------------------------------
# The transpose of the winner gather: per-ray rows summed into object rows
# ---------------------------------------------------------------------------

# rays of one group that a block of csrc/winner_scatter.cu takes (a longer
# group, a 64x64 tile, is split over blocks to fill the card)
SCATTER_CHUNK = 1024
# the group where no survivor list groups the rays (planes alone): a fixed
# run of consecutive rays
PLANE_GROUP = 1024
SCATTER_WIDTHS = (4, 18, 20)


def winner_scatter_plain(rows, slot, obj, out, plane_rows=None,
                         plane_slot=None, plane_obj=None, plane_out=None):
    """Plain version of winner_scatter: the index_add_ formulation, the
    reference's one-hot contractions by index. Rows go to their group's
    slot rows (T * K, F) and those into out by obj; plane rows to the plane
    rows (NP, F) and those into plane_out by plane_obj (or straight into
    plane_out when plane_obj is None)."""
    take_pln = None
    if plane_slot is not None:
        take_pln = plane_slot >= 0
        g_pln = torch.where(take_pln[:, None], plane_rows, 0.0)
        idx = plane_slot.clamp(min=0)
        if plane_obj is None:
            plane_out.index_add_(0, idx, g_pln)
        else:
            plane_out.index_add_(0, plane_obj, torch.zeros(
                (plane_obj.shape[0], g_pln.shape[-1]), dtype=g_pln.dtype,
                device=g_pln.device).index_add_(0, idx, g_pln))
    if slot is not None:
        t_groups, k = obj.shape
        take = slot.reshape(-1) >= 0
        if take_pln is not None:
            take = take & ~take_pln
        base = torch.arange(t_groups, device=slot.device)[:, None] * k
        idx = (base + slot.clamp(min=0)).reshape(-1)
        g_rows = torch.zeros((t_groups * k, rows.shape[-1]), dtype=rows.dtype,
                             device=rows.device).index_add_(
                                 0, idx, torch.where(take[:, None], rows, 0.0))
        out.index_add_(0, obj.reshape(-1), g_rows)
    return out, plane_out


@kernels.wrapper
def winner_scatter(rows, slot, obj, out, plane_rows=None, plane_slot=None,
                   plane_obj=None, plane_out=None):
    """Add per-ray winner rows into object rows, in place; returns (out,
    plane_out). The transpose of the winner gathers: rays (T * G of them)
    in T groups of G (a tile's rays);

      rows (R, F), slot (T, G) int32: ray i of group t adds rows[i] into
        out[obj[t, slot[t, i]]] (obj (T, K) int32; out (N, F)); slot -1:
        no slot;
      plane_rows (R, F), plane_slot (R,) int32: a ray whose plane_slot p is
        >= 0 adds plane_rows[i] into plane_out[plane_obj[p]] (plane_obj
        (NP,) int32, or None: plane_out[p]) instead; plane_out may be out.

    rows, slot, obj and out may be None together (planes alone, grouped by
    PLANE_GROUP rays); F is 4, 18 or 20. winner_scatter_plain on CPU
    tensors. On CUDA tensors csrc/winner_scatter.cu sums the rows of each
    block of up to SCATTER_CHUNK rays of a group by slot and plane, in one
    fixed order, and one index_add_ adds those block rows into the object
    rows (a second one the plane rows, where plane_out is not out): no
    atomic per ray. Its sums are taken in another order than the plain
    version's, and are the same on every run wherever torch's
    deterministic algorithms are on (index_add_ then sums in a fixed
    order too)."""
    ref = rows if rows is not None else plane_rows
    n_rays, f = ref.shape
    if kernels.on_cpu(ref):
        return winner_scatter_plain(rows, slot, obj, out, plane_rows,
                                    plane_slot, plane_obj, plane_out)
    if f not in SCATTER_WIDTHS:
        raise ValueError(f"winner_scatter: rows of {f} columns; the kernel "
                         f"takes {SCATTER_WIDTHS}")
    dev, f32, i32 = ref.device, torch.float32, torch.int32
    slot, obj, plane_slot, plane_obj = (
        None if x is None else x.to(i32).contiguous()
        for x in (slot, obj, plane_slot, plane_obj))
    k, group, n_planes = 0, PLANE_GROUP, 0
    if slot is not None:
        (t_groups, group), k = slot.shape, obj.shape[1]
        kernels.check("rows", rows, dev, f32, (t_groups * group, f))
        kernels.check("slot", slot, dev, i32, (t_groups, group))
        kernels.check("obj", obj, dev, i32, (t_groups, k))
    if plane_slot is not None:
        n_planes = (plane_obj.shape[0] if plane_obj is not None
                    else plane_out.shape[0])
        kernels.check("plane_rows", plane_rows, dev, f32, (n_rays, f))
        kernels.check("plane_slot", plane_slot, dev, i32, (n_rays,))
        if plane_obj is not None:
            kernels.check("plane_obj", plane_obj, dev, i32, (n_planes,))
    align = 16 if f % 4 == 0 else 8
    for name, x in (("rows", rows), ("plane_rows", plane_rows)):
        if x is not None and x.data_ptr() % align:
            raise ValueError(f"winner_scatter: {name} must be {align}-byte "
                             "aligned (the kernel reads rows as vectors)")
    blocks = -(-n_rays // group) * -(-group // SCATTER_CHUNK)
    n_slot_rows = blocks * k
    part = torch.empty((n_slot_rows + blocks * n_planes, f), dtype=f32,
                       device=dev)
    part_idx = torch.empty((part.shape[0],), dtype=i32, device=dev)
    kernels.launch("oglrt_winner_scatter", dev, rows, slot, obj, k,
                   0 if out is None else out.shape[0], group, SCATTER_CHUNK,
                   n_rays, f, plane_rows, plane_slot, plane_obj, n_planes,
                   part, part_idx)
    kernels.LAUNCHES["winner_scatter"] += 1
    if plane_out is out or not n_planes or not k:
        (out if k else plane_out).index_add_(0, part_idx, part)
    else:   # the slot rows, then the plane rows into their own table
        out.index_add_(0, part_idx[:n_slot_rows], part[:n_slot_rows])
        plane_out.index_add_(0, part_idx[n_slot_rows:], part[n_slot_rows:])
    return out, plane_out


# ---------------------------------------------------------------------------
# The leaves of the engines' differentiable ops
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
