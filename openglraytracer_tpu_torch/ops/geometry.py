"""Winner replay: the (t, p, n) of each ray's winning object, recomputed from
that object's own parameters as a plain differentiable function.

Port of the replay functions of ``openglraytracer_tpu/ops/geometry.py``
(``_sphere_recompute``, ``_box_recompute``, ``_plane_recompute`` and
``_winner_recompute``). The gradient of a hit record with respect to the
scene flows only through each ray's winner: the argmin over candidates is
piecewise constant and occlusion is binary. So the analytic backward of the
culled narrow phase (``ops/accel.py _culled_bwd``) replays one candidate per
ray with the forward's discrete decisions frozen (winner, inside flag, hit
mask) and differentiates the replay with ``torch.autograd``.

The box replay is the slab test of the forward restricted to one box per
ray; its face pick compares the replay's t with the replay's own slab
boundaries, so it is consistent by construction. The dense ``geometry_op``
of that module waits for the dense engines (see ROADMAP.md).
"""

from __future__ import annotations

import torch

from openglraytracer_tpu_torch.ops.intersect import (_rot_apply,
                                                     _rot_apply_t, _safe_div)


def _sphere_recompute(c, r, o, d, inside):
    """Winning-sphere (t, p, n) replay; frozen inside flag selects the root."""
    eps = 1.0e-12
    oc = o - c
    qa = torch.sum(d * d, dim=-1)
    qb = 2.0 * torch.sum(d * oc, dim=-1)
    qc = torch.sum(oc * oc, dim=-1) - r * r
    disc = qb * qb - 4.0 * qa * qc
    disc_safe = torch.where(disc > 0.0, disc, 1.0)
    sq = torch.where(disc > 0.0, torch.sqrt(disc_safe), 0.0)
    inv_2qa = _safe_div(torch.full_like(qa, 0.5), qa)
    t_near = (-qb - sq) * inv_2qa
    t_far = (-qb + sq) * inv_2qa
    t_s = torch.where(inside, t_far, t_near)
    p_s = o + t_s[:, None] * d
    u = p_s - c
    u_len = torch.sqrt(torch.clamp(torch.sum(u * u, dim=-1, keepdim=True),
                                   min=eps))
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


def _plane_recompute(pn, poff, o, d):
    eps = 1.0e-12
    nd = torch.sum(pn * d, dim=-1)
    no = torch.sum(pn * o, dim=-1)
    t_p = _safe_div(poff - no, nd)
    p_p = o + t_p[:, None] * d
    pn_len = torch.sqrt(torch.clamp(torch.sum(pn * pn, dim=-1, keepdim=True),
                                    min=eps))
    n_unit = pn / pn_len
    n_p = torch.where(nd[:, None] > 0.0, -n_unit, n_unit)
    return t_p, p_p, n_p


def _winner_recompute(c, r, pn, poff, o, d, is_sph, inside, hit_mask,
                      box_params=None, is_box=None):
    """Recompute (t, p, n) of the winning candidate from its own parameters,
    with the forward's discrete decisions (winner, inside flag, hit mask)
    frozen.

    c (R, 3), r (R,), pn (R, 3), poff (R,): winner sphere / plane params.
    box_params: optional (mins, maxs, position, rot (R, 3, 3)) of the winner
    box when the scene has boxes; is_box the per-ray box-winner mask.
    Returns t (R,), p (R, 3), n (R, 3): t = 0, p = o and n = 0 on misses."""
    t, p, n = _sphere_recompute(c, r, o, d, inside)
    t_p, p_p, n_p = _plane_recompute(pn, poff, o, d)

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
