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
on the GPU) under the culled engines' never-silent overflow count.

The composite is one autograd op, ``_SoftComposite``. On CUDA tensors its
forward and its analytic backward are the two hand-written kernels of
csrc/soft_composite.cu, which walk only each tile's valid survivor slots
and keep every per-pair term in registers: one forward and one backward
launch a view, with nothing kept between them but each ray's out, t_min
and den. On CPU tensors it runs the plain versions
``soft_composite_plain`` (the composite dense over (B, P, K)) and
``soft_composite_bwd_plain`` (its analytic VJP, the kernel's formulas),
tiles in blocks of ``tile_block`` (by default as many as fit
``block_pairs`` ray-sphere pairs), each under ``torch.utils.checkpoint``
while autograd records, so a step holds one block's (B, P, K) working set.

Traced (utils/profiling.py, while a profiler records): the broad phase's
spans ``broad_phase/soft_tile_cones`` and ``broad_phase/soft_compact``, a
block's forward ``soft_composite/block`` and, on the plain path, its
recompute in the backward ``soft_composite/recompute``; counters
``soft_rays``, ``soft_kept_pairs`` (valid survivor slots times their
tile's rays; every pair on the dense pass) and ``soft_live_pairs``
(ray-sphere pairs whose coverage is non-zero after the cut and the front
gate, counted in the forward only: the kernel's own count on the card).
"""

from __future__ import annotations

import ctypes
import math

import torch

from openglraytracer_tpu_torch import kernels
from openglraytracer_tpu_torch.models.scene import Scene
from openglraytracer_tpu_torch.ops.intersect import (_SQRT_EPS,
                                                     _safe_normalize,
                                                     _safe_sqrt,
                                                     maybe_checkpoint)
from openglraytracer_tpu_torch.ops.shade import (_BLOCK, LIGHT_GRADS,
                                                 _light_table)
from openglraytracer_tpu_torch.ops.shading import (_POW_EPS, _safe_pow,
                                                   material_table)
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
# ray-sphere pairs a culled block of the plain path holds by default
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


def _view(dx, dy, dz):
    """The view direction normalize(-d) of each ray, as components."""
    inv = torch.rsqrt(_max(dx * dx + dy * dy + dz * dz, 1e-20))
    return -dx * inv, -dy * inv, -dz * inv


def _light_terms(lp, px, py, pz, nx, ny, nz, vx, vy, vz):
    """One light's shadowless Phong geometry at points p with normals n:
    (tl, |tl|^2, 1/|tl|, l, cos_t, r, |r|^2, 1/|r|, r.v, cos_p), vectors as
    component triples."""
    tlx, tly, tlz = lp[0] - px, lp[1] - py, lp[2] - pz
    sl = tlx * tlx + tly * tly + tlz * tlz
    linv = torch.rsqrt(_max(sl, 1e-20))
    lx, ly, lz = tlx * linv, tly * linv, tlz * linv
    cos_t = lx * nx + ly * ny + lz * nz
    # light_ref = normalize(reflect(-light_dir, n)) = 2 cos_t n - l
    rx, ry, rz = (2 * cos_t * nx - lx, 2 * cos_t * ny - ly,
                  2 * cos_t * nz - lz)
    sr = rx * rx + ry * ry + rz * rz
    rinv = torch.rsqrt(_max(sr, 1e-20))
    dot_rv = rx * vx + ry * vy + rz * vz
    return ((tlx, tly, tlz), sl, linv, (lx, ly, lz), cos_t, (rx, ry, rz),
            sr, rinv, dot_rv, dot_rv * rinv)


def _phong_acc(m_rows, lights, p, n, v):
    """Shadowless Phong ADS over component tensors of any broadcastable
    shape (...,): m_rows (..., 20) packed material_table rows; lights
    (position, ambient, diffuse, specular); p, n, v component triples.
    Returns (acc (..., 4), each light's _light_terms): the colour is
    acc[..., :3] * acc[..., 3], the reference's rgb * alpha."""
    lpos, lamb, ldiff, lspec = lights
    m_amb = m_rows[..., 0:4]
    m_diff = m_rows[..., 4:8]
    m_spec = m_rows[..., 8:12]
    m_emis = m_rows[..., 12:16]
    m_shin = m_rows[..., 16]
    acc = m_amb.new_zeros(m_amb.shape[:-1] + (4,))
    terms = []
    for j in range(lpos.shape[0]):
        acc = acc + lamb[j] * m_amb
        lt = _light_terms(lpos[j], *p, *n, *v)
        acc = acc + ldiff[j] * m_diff * _max(lt[4], 0.0)[..., None]
        acc = acc + lspec[j] * m_spec * _safe_pow(lt[9], m_shin)[..., None]
        terms.append(lt)
    return acc + m_emis, terms


def _rgb(acc):
    out = acc[..., :3] * acc[..., 3:4]
    return out[..., 0], out[..., 1], out[..., 2]


def _pair_geometry(o, d, rows, valid, bw: float, t_bg: float):
    """The sphere quadratic of every (ray, slot) pair of a block. o, d
    (B, P, 3); rows (B, K, 6); valid (B, K). Returns a dict of (B, P, K)
    tensors (and the (B, 1, K) centres and radii): the coverage alpha0,
    the closest approach t_hit, t_sph clamped to [_T_EPS, t_bg], and
    ``live``: coverage above the cut, in front, on a valid slot."""
    ox, oy, oz = o[..., 0, None], o[..., 1, None], o[..., 2, None]
    dx, dy, dz = d[..., 0, None], d[..., 1, None], d[..., 2, None]
    cx = rows[..., 0][:, None, :]                         # (B, 1, K)
    cy = rows[..., 1][:, None, :]
    cz = rows[..., 2][:, None, :]
    rr = rows[..., 3][:, None, :]
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz             # (B, P, K)
    b = ocx * dx + ocy * dy + ocz * dz
    oc2 = ocx * ocx + ocy * ocy + ocz * ocz
    r2 = _max(rr * rr, 1e-12)
    disc = r2 - (oc2 - b * b)                             # r^2 - d_perp^2
    q = bw * r2
    alpha0 = torch.sigmoid(disc / q)
    # _safe_sqrt keeps the silhouette derivative finite (sqrt(max(disc, 0))
    # gives 0 * inf = NaN in the backward exactly on the silhouette)
    sq = _safe_sqrt(disc)
    t_hit = -b - sq                                       # closest approach
    front = (t_hit > _T_EPS) & valid[:, None, :]          # on miss (disc<0)
    live = front & (alpha0 > _ALPHA_CUT)
    t1 = _max(t_hit, _T_EPS)
    return dict(c=(cx, cy, cz), rr=rr, oc=(ocx, ocy, ocz), b=b, r2=r2,
                disc=disc, q=q, alpha0=alpha0, sq=sq, t_hit=t_hit,
                live=live, t1=t1, t_sph=_min(t1, t_bg))


def _plane_geometry(o, d, n_unit, off, t_bg: float):
    """Hard coverage of one plane (unit normal n_unit (3,), offset off)
    by rays o, d (..., 3). Returns a dict of (...)-shaped tensors."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    nd = n_unit[0] * dx + n_unit[1] * dy + n_unit[2] * dz
    no = n_unit[0] * ox + n_unit[1] * oy + n_unit[2] * oz
    den = torch.where(torch.abs(nd) < 1e-9, torch.where(nd < 0, -1e-9, 1e-9),
                      nd)
    t_raw = (off - no) / den
    hit = (torch.abs(nd) > 1e-9) & (t_raw > _T_EPS)
    t1 = _max(t_raw, _T_EPS)
    t = _min(t1, t_bg)
    sgn = torch.where(nd > 0.0, -1.0, 1.0).to(nd.dtype)
    return dict(den=den, t_raw=t_raw, hit=hit, t1=t1, t=t, sgn=sgn,
                p=(ox + t * dx, oy + t * dy, oz + t * dz),
                n=(sgn * n_unit[0], sgn * n_unit[1], sgn * n_unit[2]))


def soft_composite_plain(o, d, rows, valid, m_rows, lights, pl_n, pl_off,
                         pl_m, bw: float, gamma: float, t_bg: float,
                         count_live: bool = False):
    """Plain version of the soft composite kernel: the composite of a block
    of tiles over every slot, dense over (B, P, K). o, d (B, P, 3); rows
    (B, K, 6) [cx cy cz r mat gid] survivor rows (or (1, N, 6) dense);
    valid (B, K); m_rows (B, K, 20) the slots' material rows; lights
    (position, ambient, diffuse, specular); pl_n (Q, 3) unit plane normals,
    pl_off (Q,) their offsets along them, pl_m (Q, 20) their material rows.
    Returns (out (B, P, 3), t_min (B, P), den (B, P)): the image, the
    per-ray least live t that stabilises the depth softmax, and the
    softmax's denominator. count_live: add the block's live pairs to the
    soft_live_pairs counter while tracing."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]          # (B, P)
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    pg = _pair_geometry(o, d, rows, valid, bw, t_bg)
    cx, cy, cz = pg["c"]
    alpha = torch.where(pg["live"], pg["alpha0"], 0.0)
    if count_live and tracing():
        count("soft_live_pairs", torch.count_nonzero(alpha))
    t_sph = pg["t_sph"]

    # sphere shading at p = o + t d, n = (p - c) / |p - c|
    px = ox[..., None] + t_sph * dx[..., None]
    py = oy[..., None] + t_sph * dy[..., None]
    pz = oz[..., None] + t_sph * dz[..., None]
    nx_, ny_, nz_ = px - cx, py - cy, pz - cz
    ninv = torch.rsqrt(_max(nx_ * nx_ + ny_ * ny_ + nz_ * nz_, 1e-20))
    v = _view(dx, dy, dz)
    acc, _ = _phong_acc(m_rows[:, None], lights, (px, py, pz),
                        (nx_ * ninv, ny_ * ninv, nz_ * ninv),
                        tuple(c[..., None] for c in v))
    sr, sg, sb = _rgb(acc)

    # planes: hard coverage (plane geometry is never a soft-fit trainable)
    t_pl_list, col_pl_list = [], []
    for i in range(pl_off.shape[0]):
        pln = _plane_geometry(o, d, pl_n[i], pl_off[i], t_bg)
        hit = pln["hit"]
        pr, pg_, pb = _rgb(_phong_acc(pl_m[i], lights, pln["p"], pln["n"],
                                      v)[0])
        t_pl_list.append(torch.where(hit, pln["t"], t_bg))
        col_pl_list.append((torch.where(hit, pr, 0.0),
                            torch.where(hit, pg_, 0.0),
                            torch.where(hit, pb, 0.0),
                            hit.to(o.dtype)))

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
    for t_pl, (pr, pg_, pb, a_pl) in zip(t_pl_list, col_pl_list):
        w = a_pl * torch.exp((t_min - t_pl) / gamma)
        den = den + w
        num_r = num_r + w * pr
        num_g = num_g + w * pg_
        num_b = num_b + w * pb
    w_bg = torch.exp((t_min - t_bg) / gamma)              # bg color = black
    den = den + w_bg
    inv = 1.0 / _max(den, 1e-20)
    return (torch.stack([num_r * inv, num_g * inv, num_b * inv], dim=-1),
            t_min, den)


# --- the analytic backward ---------------------------------------------------
#
# out = num / den with num = sum_i w_i rgb_i and den = sum_i w_i + w_bg,
# w_i = alpha_i exp((t_min - t_i) / gamma). Every weight carries the factor
# exp(t_min / gamma) (for a live sphere t_i >= t_min, so the clamp of its
# exponent at 0 never binds), so t_min cancels exactly in num / den: its
# adjoint is zero, and the backward takes each weight's derivative with
# t_min held fixed. Every other select follows the plain forward's:
# torch.maximum and torch.minimum pass a gradient above (below) the
# constant and half of it at a tie, clamp passes it at the bound, sigmoid's
# is y (1 - y), rsqrt's -0.5 y^3, and a dead pair (coverage cut to 0) or a
# missed plane gives nothing.

def _gate_max(x, c: float):
    """d max(x, c) / dx as torch.maximum's backward gives it."""
    return torch.where(x > c, 1.0, torch.where(x == c, 0.5, 0.0)).to(x.dtype)


def _gate_min(x, c: float):
    return torch.where(x < c, 1.0, torch.where(x == c, 0.5, 0.0)).to(x.dtype)


def _phong_bwd(m_rows, lights, acc, terms, n, v, g_rgb, want_lights: bool):
    """Backward of _phong_acc's colour acc[:3] * acc[3] at its cotangent
    g_rgb (three component tensors). Returns (g_m (..., 20), g_p, g_n
    component triples, per light (g_pos (3,), g_amb, g_diff, g_spec (4,))
    summed over every element, or None without want_lights)."""
    lpos, lamb, ldiff, lspec = lights
    m_amb = m_rows[..., 0:4]
    m_diff = m_rows[..., 4:8]
    m_spec = m_rows[..., 8:12]
    m_shin = m_rows[..., 16]
    nx, ny, nz = n
    vx, vy, vz = v
    a3 = acc[..., 3]
    g_acc = torch.stack([g_rgb[0] * a3, g_rgb[1] * a3, g_rgb[2] * a3,
                         g_rgb[0] * acc[..., 0] + g_rgb[1] * acc[..., 1]
                         + g_rgb[2] * acc[..., 2]], dim=-1)
    zero = torch.zeros_like(g_acc[..., 0])
    g_amb = torch.zeros_like(g_acc)
    g_diff = torch.zeros_like(g_acc)
    g_spec = torch.zeros_like(g_acc)
    g_shin = zero
    gpx = gpy = gpz = gnx = gny = gnz = zero
    light_grads = [] if want_lights else None
    for j in range(lpos.shape[0]):
        ((tlx, tly, tlz), sl, linv, (lx, ly, lz), cos_t, (rx, ry, rz), sr,
         rinv, dot_rv, cos_p) = terms[j]
        ct = _max(cos_t, 0.0)
        bb = torch.clamp(cos_p, min=_POW_EPS)
        lg = torch.log(bb)
        val = torch.exp(m_shin * lg)
        pw = torch.where(cos_p > 0.0, val, 0.0)
        g_amb = g_amb + lamb[j] * g_acc
        g_diff = g_diff + ldiff[j] * (g_acc * ct[..., None])
        g_spec = g_spec + lspec[j] * (g_acc * pw[..., None])
        g_ct = torch.sum(g_acc * (ldiff[j] * m_diff), dim=-1)
        g_pw = torch.sum(g_acc * (lspec[j] * m_spec), dim=-1)
        g_cos_t = g_ct * _gate_max(cos_t, 0.0)
        g_val = torch.where(cos_p > 0.0, g_pw, 0.0)
        g_shin = g_shin + g_val * val * lg
        g_cos_p = torch.where(cos_p >= _POW_EPS, g_val * val * m_shin / bb,
                              0.0)
        # cos_p = (r . v) / |r|
        g_dot = g_cos_p * rinv
        g_sr = g_cos_p * dot_rv * (-0.5 * rinv * rinv * rinv) \
            * _gate_max(sr, 1e-20)
        grx = g_dot * vx + 2 * rx * g_sr
        gry = g_dot * vy + 2 * ry * g_sr
        grz = g_dot * vz + 2 * rz * g_sr
        # r = 2 cos_t n - l; cos_t = l . n
        g_cos_t = g_cos_t + 2 * (grx * nx + gry * ny + grz * nz)
        gnx = gnx + 2 * cos_t * grx + g_cos_t * lx
        gny = gny + 2 * cos_t * gry + g_cos_t * ly
        gnz = gnz + 2 * cos_t * grz + g_cos_t * lz
        glx, gly, glz = g_cos_t * nx - grx, g_cos_t * ny - gry, \
            g_cos_t * nz - grz
        # l = tl / |tl|, tl = light - p
        g_sl = (glx * tlx + gly * tly + glz * tlz) \
            * (-0.5 * linv * linv * linv) * _gate_max(sl, 1e-20)
        gtx = glx * linv + 2 * tlx * g_sl
        gty = gly * linv + 2 * tly * g_sl
        gtz = glz * linv + 2 * tlz * g_sl
        gpx, gpy, gpz = gpx - gtx, gpy - gty, gpz - gtz
        if want_lights:
            light_grads.append((
                torch.stack([gtx.sum(), gty.sum(), gtz.sum()]),
                torch.sum((g_acc * m_amb).reshape(-1, 4), dim=0),
                torch.sum((g_acc * ct[..., None] * m_diff).reshape(-1, 4),
                          dim=0),
                torch.sum((g_acc * pw[..., None] * m_spec).reshape(-1, 4),
                          dim=0)))
    g_m = torch.cat([g_amb, g_diff, g_spec, g_acc, g_shin[..., None],
                     torch.zeros_like(g_acc[..., :3])], dim=-1)
    return g_m, (gpx, gpy, gpz), (gnx, gny, gnz), light_grads


def soft_composite_bwd_plain(o, d, rows, valid, m_rows, lights, pl_n, pl_off,
                             pl_m, out, t_min, den, g, bw: float,
                             gamma: float, t_bg: float,
                             geometry: bool = False):
    """Plain version of the soft composite's backward kernel: the analytic
    VJP of soft_composite_plain at its cotangent g (B, P, 3), from the
    forward's out, t_min and den, recomputing every pair's terms. Returns
    (g_rows (B, K, 6) with the centre and radius columns, g_m_rows
    (B, K, 20), g_pl_m (Q, 20), and with geometry the lights' (g_pos
    (L, 3), g_amb, g_diff, g_spec (L, 4)) and the planes' (g_pl_n (Q, 3),
    g_pl_off (Q,)), else None for those six)."""
    dtype = o.dtype
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    v = _view(dx, dy, dz)
    inv = 1.0 / _max(den, 1e-20)
    g_num = g * inv[..., None]                             # (B, P, 3)
    g_den = -torch.sum(g * out, dim=-1) * inv * _gate_max(den, 1e-20)

    # ---- sphere pairs
    pg = _pair_geometry(o, d, rows, valid, bw, t_bg)
    cx, cy, cz = pg["c"]
    live, alpha0, t_sph = pg["live"], pg["alpha0"], pg["t_sph"]
    e = torch.exp(_min((t_min[..., None] - t_sph) / gamma, 0.0))
    w = torch.where(live, alpha0, 0.0) * e
    px = ox[..., None] + t_sph * dx[..., None]
    py = oy[..., None] + t_sph * dy[..., None]
    pz = oz[..., None] + t_sph * dz[..., None]
    nx_, ny_, nz_ = px - cx, py - cy, pz - cz
    sn = nx_ * nx_ + ny_ * ny_ + nz_ * nz_
    ninv = torch.rsqrt(_max(sn, 1e-20))
    n = (nx_ * ninv, ny_ * ninv, nz_ * ninv)
    vk = tuple(c[..., None] for c in v)
    acc, terms = _phong_acc(m_rows[:, None], lights, (px, py, pz), n, vk)
    s = _rgb(acc)
    gn = [g_num[..., c, None] for c in range(3)]
    g_w = gn[0] * s[0] + gn[1] * s[1] + gn[2] * s[2] + g_den[..., None]
    g_m, (gpx, gpy, gpz), (gnx, gny, gnz), lg_sph = _phong_bwd(
        m_rows[:, None], lights, acc, terms, n, vk,
        tuple(gc * w for gc in gn), geometry)
    g_z = torch.where(live, g_w * e, 0.0) * (1.0 - alpha0) * alpha0
    g_t = -(g_w * w) / gamma
    # n = n_ / |n_|, n_ = p - c
    g_sn = (gnx * nx_ + gny * ny_ + gnz * nz_) \
        * (-0.5 * ninv * ninv * ninv) * _gate_max(sn, 1e-20)
    gnx_ = gnx * ninv + 2 * nx_ * g_sn
    gny_ = gny * ninv + 2 * ny_ * g_sn
    gnz_ = gnz * ninv + 2 * nz_ * g_sn
    # p = o + t d
    g_t = g_t + (gpx + gnx_) * dx[..., None] + (gpy + gny_) * dy[..., None] \
        + (gpz + gnz_) * dz[..., None]
    g_thit = g_t * _gate_min(pg["t1"], t_bg) * _gate_max(pg["t_hit"], _T_EPS)
    b, disc, q, r2, rr = pg["b"], pg["disc"], pg["q"], pg["r2"], pg["rr"]
    # t_hit = -b - sqrt(max(disc, eps)); alpha0 = sigmoid(disc / q)
    g_disc = -g_thit / (2 * pg["sq"]) * (disc >= _SQRT_EPS).to(dtype) \
        + g_z / q
    g_r2 = g_disc - g_z * (disc / q) / q * bw
    # disc = r2 - (|oc|^2 - b^2), b = oc . d
    g_b = -g_thit + 2 * b * g_disc
    g_rr = g_r2 * _gate_max(rr * rr, 1e-12) * 2 * rr
    ocx, ocy, ocz = pg["oc"]
    gcx = -gnx_ - (-2 * ocx * g_disc + g_b * dx[..., None])
    gcy = -gny_ - (-2 * ocy * g_disc + g_b * dy[..., None])
    gcz = -gnz_ - (-2 * ocz * g_disc + g_b * dz[..., None])
    lv = live[..., None]
    g_pair = torch.where(lv, torch.stack([gcx, gcy, gcz, g_rr], dim=-1), 0.0)
    g_rows = torch.cat([torch.sum(g_pair, dim=1),
                        torch.zeros_like(rows[..., 4:])], dim=-1)
    g_m_rows = torch.sum(torch.where(lv, g_m, 0.0), dim=1)

    # ---- planes
    n_pl = pl_off.shape[0]
    g_pl_m = torch.zeros_like(pl_m)
    g_pl_n = torch.zeros_like(pl_n)
    g_pl_off = torch.zeros_like(pl_off)
    lg_pl = []
    for i in range(n_pl):
        pln = _plane_geometry(o, d, pl_n[i], pl_off[i], t_bg)
        hit = pln["hit"]
        acc, terms = _phong_acc(pl_m[i], lights, pln["p"], pln["n"], v)
        col = _rgb(acc)
        w = torch.where(hit, torch.exp((t_min - pln["t"]) / gamma), 0.0)
        gw = g_num[..., 0] * col[0] + g_num[..., 1] * col[1] \
            + g_num[..., 2] * col[2] + g_den
        gm, (gpx, gpy, gpz), (gnx, gny, gnz), lgs = _phong_bwd(
            pl_m[i], lights, acc, terms, pln["n"], v,
            tuple(g_num[..., c] * w for c in range(3)), geometry)
        g_pl_m[i] = torch.sum(torch.where(hit[..., None], gm, 0.0)
                              .reshape(-1, gm.shape[-1]), dim=0)
        if geometry:
            lg_pl.append(lgs)
            g_tp = -(gw * w) / gamma + gpx * dx + gpy * dy + gpz * dz
            g_traw = torch.where(hit, g_tp, 0.0) \
                * _gate_min(pln["t1"], t_bg) * _gate_max(pln["t_raw"], _T_EPS)
            # t_raw = (off - n . o) / (n . d)
            g_off = g_traw / pln["den"]
            g_nd = -g_traw * pln["t_raw"] / pln["den"]
            sgn = pln["sgn"]
            g_pl_off[i] = torch.sum(g_off)
            g_pl_n[i] = torch.stack([
                torch.sum(g_nd * dx - g_off * ox + sgn * gnx),
                torch.sum(g_nd * dy - g_off * oy + sgn * gny),
                torch.sum(g_nd * dz - g_off * oz + sgn * gnz)])
    if not geometry:
        return g_rows, g_m_rows, g_pl_m, None, None, None, None, None, None
    per_light = [[sum(parts) for parts in zip(*grads)]
                 for grads in zip(lg_sph, *lg_pl)]
    n_lights = lights[0].shape[0]
    stacked = [torch.stack([pl[q] for pl in per_light]) if n_lights else
               torch.zeros_like(x) for q, x in enumerate(lights)]
    return (g_rows, g_m_rows, g_pl_m, *stacked, g_pl_n, g_pl_off)


# --- the kernels' wrappers and the autograd op ----------------------------

_MAX_GEOMETRY_LIGHTS = 8    # kMaxLights in csrc/soft_composite.cu


def _plane_table(pl_n, pl_off, pl_m):
    """(Q, 24) [n(3) off m(20)], the kernels' layout."""
    return torch.cat([pl_n, pl_off[:, None], pl_m], dim=-1).contiguous()


def _check_block(dev, o, d, rows, valid, m_rows):
    b, p = o.shape[0], o.shape[1]
    k = rows.shape[1]
    f32 = torch.float32
    kernels.check("o", o, dev, f32, (b, p, 3))
    kernels.check("d", d, dev, f32, (b, p, 3))
    kernels.check("rows", rows, dev, f32, (b, k, 6))
    kernels.check("valid", valid, dev, torch.bool, (b, k))
    kernels.check("m_rows", m_rows, dev, f32, (b, k, 20))
    if m_rows.data_ptr() % 16:
        raise ValueError("m_rows: the kernels read rows as float4 and need "
                         "a 16-byte aligned tensor")
    return b, p, k


@kernels.wrapper
def soft_composite(o, d, rows, valid, m_rows, lights, pl_n, pl_off, pl_m,
                   bw: float, gamma: float, t_bg: float, *,
                   save: bool = False, count_live: bool = False):
    """Forward wrapper: arguments and results as soft_composite_plain.
    Kernel csrc/soft_composite.cu on CUDA tensors (t_min and den are
    written only with save, else None; the live pairs are the kernel's own
    count, made only while tracing), soft_composite_plain on CPU tensors."""
    if kernels.on_cpu(o):
        return soft_composite_plain(o, d, rows, valid, m_rows, lights, pl_n,
                                    pl_off, pl_m, bw, gamma, t_bg,
                                    count_live=count_live)
    dev = o.device
    o, d, rows, valid, m_rows = (x.contiguous()
                                 for x in (o, d, rows, valid, m_rows))
    b, p, k = _check_block(dev, o, d, rows, valid, m_rows)
    light_tab = _light_table(*lights).contiguous()
    plane_tab = _plane_table(pl_n, pl_off, pl_m)
    f32 = torch.float32
    out = torch.empty((b, p, 3), dtype=f32, device=dev)
    t_min = den = live = None
    if save:
        t_min = torch.empty((b, p), dtype=f32, device=dev)
        den = torch.empty((b, p), dtype=f32, device=dev)
    if count_live and tracing():
        live = torch.zeros((), dtype=torch.int32, device=dev)
    kernels.launch("oglrt_soft_composite", dev, o, d, rows, valid, m_rows,
                   light_tab, light_tab.shape[0], plane_tab,
                   plane_tab.shape[0], b, p, k, ctypes.c_float(bw),
                   ctypes.c_float(gamma), ctypes.c_float(t_bg), out,
                   t_min, den, live)
    kernels.LAUNCHES["soft_composite"] += 1
    if live is not None:
        count("soft_live_pairs", live)
    return out, t_min, den


@kernels.wrapper
def soft_composite_bwd(o, d, rows, valid, m_rows, lights, pl_n, pl_off,
                       pl_m, out, t_min, den, g, bw: float, gamma: float,
                       t_bg: float, geometry: bool = False):
    """Backward wrapper: arguments and results as soft_composite_bwd_plain.
    Kernel csrc/soft_composite.cu on CUDA tensors (its variant with the
    light and plane-geometry cotangents only with geometry), the plain
    version on CPU tensors. The kernel writes each (tile, chunk of rays,
    slot) row and each block's plane and light rows; where a tile has more
    than one chunk, torch.sum adds its chunks' rows on the device."""
    if kernels.on_cpu(o):
        return soft_composite_bwd_plain(o, d, rows, valid, m_rows, lights,
                                        pl_n, pl_off, pl_m, out, t_min, den,
                                        g, bw, gamma, t_bg, geometry)
    dev = o.device
    o, d, rows, valid, m_rows = (x.contiguous()
                                 for x in (o, d, rows, valid, m_rows))
    b, p, k = _check_block(dev, o, d, rows, valid, m_rows)
    f32 = torch.float32
    for name, x, shape in (("out", out, (b, p, 3)), ("t_min", t_min, (b, p)),
                           ("den", den, (b, p)), ("g", g, (b, p, 3))):
        kernels.check(name, x, dev, f32, shape)
    light_tab = _light_table(*lights).contiguous()
    plane_tab = _plane_table(pl_n, pl_off, pl_m)
    n_lights, n_pl = light_tab.shape[0], plane_tab.shape[0]
    if geometry and n_lights > _MAX_GEOMETRY_LIGHTS:
        raise ValueError(f"light gradients of the soft composite take at "
                         f"most {_MAX_GEOMETRY_LIGHTS} lights, not "
                         f"{n_lights}")
    chunks = -(-p // _BLOCK)
    g_rows = torch.empty((b, chunks, k, 6), dtype=f32, device=dev)
    g_m = torch.empty((b, chunks, k, 20), dtype=f32, device=dev)
    g_pl = torch.empty((b * chunks, n_pl, 24), dtype=f32, device=dev)
    g_li = (torch.empty((b * chunks, n_lights, LIGHT_GRADS), dtype=f32,
                        device=dev) if geometry else None)
    kernels.launch("oglrt_soft_composite_bwd", dev, o, d, rows, valid,
                   m_rows, light_tab, n_lights, plane_tab, n_pl, b, p, k,
                   ctypes.c_float(bw), ctypes.c_float(gamma),
                   ctypes.c_float(t_bg), out, t_min, den, g, int(geometry),
                   g_rows, g_m, g_pl, g_li)
    kernels.LAUNCHES["soft_composite_bwd"] += 1
    if chunks > 1:
        g_rows, g_m = torch.sum(g_rows, dim=1), torch.sum(g_m, dim=1)
    else:
        g_rows, g_m = g_rows[:, 0], g_m[:, 0]
    pl = torch.sum(g_pl, dim=0)
    if not geometry:
        return g_rows, g_m, pl[:, 4:], None, None, None, None, None, None
    li = torch.sum(g_li, dim=0)
    return (g_rows, g_m, pl[:, 4:], li[:, 0:3], li[:, 3:7], li[:, 7:11],
            li[:, 11:15], pl[:, 0:3], pl[:, 3])


class _SoftComposite(torch.autograd.Function):
    """Forward soft_composite, backward soft_composite_bwd; nothing per
    pair is kept between them, only each ray's out, t_min and den."""

    @staticmethod
    def forward(ctx, o, d, rows, valid, m_rows, lpos, lamb, ldiff, lspec,
                pl_n, pl_off, pl_m, bw, gamma, t_bg, save, count_live):
        lights = (lpos, lamb, ldiff, lspec)
        out, t_min, den = soft_composite(o, d, rows, valid, m_rows, lights,
                                         pl_n, pl_off, pl_m, bw, gamma, t_bg,
                                         save=save, count_live=count_live)
        if save:
            ctx.save_for_backward(o, d, rows, valid, m_rows, lpos, lamb,
                                  ldiff, lspec, pl_n, pl_off, pl_m, out,
                                  t_min, den)
            ctx.soft = (bw, gamma, t_bg)
        return out

    @staticmethod
    def backward(ctx, g):
        (o, d, rows, valid, m_rows, lpos, lamb, ldiff, lspec, pl_n, pl_off,
         pl_m, out, t_min, den) = ctx.saved_tensors
        need = ctx.needs_input_grad
        g_rows, g_m, g_pl_m, *geo = soft_composite_bwd(
            o, d, rows, valid, m_rows, (lpos, lamb, ldiff, lspec), pl_n,
            pl_off, pl_m, out, t_min, den, g.contiguous(), *ctx.soft,
            geometry=any(need[5:11]))
        return (None, None, g_rows if need[2] else None, None,
                g_m if need[4] else None,
                *(x if want else None for x, want in zip(geo, need[5:11])),
                g_pl_m if need[11] else None, None, None, None, None, None)


def _composite_block(scene: Scene, mat_tab, o, d, sph_rows, sph_valid,
                     bw: float, gamma: float, t_bg: float,
                     count_live: bool = False):
    """Soft composite of one block. o, d: (B, P, 3); sph_rows (B, K, 6)
    [cx cy cz r mat gid] survivor rows (or (1, N, 6) dense); sph_valid
    (B, K). Returns (B, P, 3). Gathers the slots' and the planes' material
    rows and the planes' unit normals here, where autograd folds their
    cotangents back into the scene, and composites through _SoftComposite.
    count_live: count the block's live pairs while tracing (its forward,
    not a recompute)."""
    if o.requires_grad or d.requires_grad:
        raise ValueError("the soft composite gives no gradient of the rays "
                         "(the camera is not a soft-fit trainable)")
    mat_ids = sph_rows[..., 4].to(torch.int64)            # exact small floats
    m_rows = torch.index_select(mat_tab, 0, mat_ids.reshape(-1)).reshape(
        mat_ids.shape + (mat_tab.shape[-1],))
    pls, lights = scene.planes, scene.lights
    pl_n = _safe_normalize(pls.normal)
    pl_off = pls.offset * torch.rsqrt(
        _max(torch.sum(pls.normal ** 2, dim=-1), 1e-20))
    pl_m = torch.index_select(mat_tab, 0, pls.material_id.long())
    diff = (sph_rows, m_rows, *lights, pl_n, pl_off, pl_m)
    save = torch.is_grad_enabled() and any(x.requires_grad for x in diff)
    return _SoftComposite.apply(o, d, sph_rows, sph_valid, m_rows,
                                *lights, pl_n, pl_off, pl_m, float(bw),
                                float(gamma), float(t_bg), save, count_live)


def soft_render_rays(scene: Scene, origins, dirs, *, bw: float, gamma: float,
                     cull=None, t_bg: float = 200.0, tile_block: int = 0,
                     block_pairs: int = BLOCK_PAIRS,
                     with_cull_stats: bool = False):
    """Soft forward over flat rays. origins/dirs (R, 3), dirs unit.

    cull: None for a dense (R x N) pass, or ((th, tw) | tile_p, k) with
    tile-major rays (accel.tile_image order) sharing one origin for the
    coned broad phase, whose (T, N) mask compacts through compact_mask.
    On CUDA tensors every tile goes through one launch of each kernel. On
    CPU tensors the tiles run in checkpointed blocks of tile_block tiles
    (0: at most block_pairs ray-sphere pairs a block, dividing the tile
    count). Returns (R, 3), and with with_cull_stats also the overflow
    count, a device int32 scalar (tiles whose survivors exceeded k; 0 on
    the dense pass). Never waits for the device."""
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

    if not kernels.on_cpu(origins):
        # the kernels hold no (B, P, K) working set: one launch a view
        with span("soft_composite", "block"):
            out = _composite_block(scene, mat_tab, o_t, d_t, rows, valid, bw,
                                   gamma, t_bg, count_live=True)
        out = out.reshape(r, 3)
        return (out, ovf) if with_cull_stats else out

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
    back, as in the hard culled engines (on CPU tensors in blocks of at
    most block_pairs ray-sphere pairs: soft_render_rays)."""
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
