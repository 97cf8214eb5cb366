"""The benchmark's plain reference: a dense ray tracer in plain PyTorch.

Camera rays, ray-sphere and ray-plane hits (the closest positive root,
the far one from inside a sphere, the first object on a tie, spheres
before planes, a miss at t >= 1e4), hard shadows (a segment from the hit
point plus 0.01 along the normal to each light, blocked by any object met
at 0 < t < 1), Phong shading (per light: ambient, diffuse and specular,
the specular from the reflected light direction; the output is rgb times
the summed alpha, black on a miss), and the gradients of a pixel loss by
autograd through the winning object's hit.

It imports nothing of the program and takes only the plain tensors the
benchmark made (``benchmark/scenes``). To stay short of a dense scan of
every ray against every object, each 16x16 tile of rays first keeps the
spheres that a cone around its rays can meet, a test that only ever keeps
too many (float64 angles, every radius grown by ``MARGIN``); every kept
pair is then tested exactly as a dense tracer would test it. With
``dense=True`` every sphere is kept (the tests compare the two).

All arithmetic of the pair tests and the shade runs in ``dtype`` (float32
as the configurations state; the lower-precision control runs bfloat16);
rays are made in float64 and rounded to ``dtype``. No matrix product of
float32 is taken, so TF32 cannot enter.
"""

from __future__ import annotations

import math

import torch

MISS_T = 1.0e4
SHADOW_EPS = 0.01
TILE = 16
MARGIN = 0.02        # cull slack on radii: a shadow segment ends 0.01 off
#                      its light, so the cone from the light misses it by
#                      at most 0.01
ANGLE_SLACK = 1e-7   # rad: acos of a float64 cosine near 1 is good to 2e-8
PAIR_BLOCK = 1 << 24  # elements of one (tiles, rays, candidates) block
SHADE_BLOCK = 1 << 20  # rays shaded at once


def _rot(axis: int, deg: float) -> torch.Tensor:
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    m = torch.eye(3, dtype=torch.float64)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    m[i, i], m[j, j] = c, c
    if axis == 1:            # y: [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        m[i, j], m[j, i] = s, -s
    else:                    # x, z: [[c, -s], [s, c]] in their plane
        m[i, j], m[j, i] = -s, s
    return m


def camera_rays(camera: dict, height: int, width: int):
    """(origin (3,), dirs (H, W, 3)) in float64 on the camera's device;
    row 0 is the bottom of the image. The camera-to-world rotation is
    Rz(yaw) Rx(pitch) Ry(roll) Rx(90 deg), looking down -z of its frame;
    pixel (row, col) looks through NDC ((col - W//2) / (W//2),
    (row - H//2) / (H//2)) of a perspective of vertical field v_fov."""
    dev = camera["position"].device
    pitch, yaw, roll = (float(a) for a in camera["angles"])
    rot = _rot(2, yaw) @ _rot(0, pitch) @ _rot(1, roll) @ _rot(0, 90.0)
    q = math.tan(math.radians(float(camera["v_fov"])) / 2.0)
    aspect = float(camera["aspect"])
    hw, hh = width // 2, height // 2
    x = (torch.arange(width, dtype=torch.float64, device=dev) - hw) / hw
    y = (torch.arange(height, dtype=torch.float64, device=dev) - hh) / hh
    eye = torch.stack(torch.broadcast_tensors(
        x[None, :] * q * aspect, y[:, None] * q,
        torch.full((height, width), -1.0, dtype=torch.float64, device=dev)),
        -1)
    d = eye @ rot.to(dev).T
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return camera["position"].to(torch.float64), d


def _tiles(x, ts: int):
    """(H, W, ...) -> (T, ts*ts, ...) in tile-major order."""
    h, w = x.shape[:2]
    rest = x.shape[2:]
    return (x.reshape(h // ts, ts, w // ts, ts, *rest).transpose(1, 2)
            .reshape((h // ts) * (w // ts), ts * ts, *rest))


def _untiles(x, h: int, w: int, ts: int):
    rest = x.shape[2:]
    return (x.reshape(h // ts, w // ts, ts, ts, *rest).transpose(1, 2)
            .reshape(h, w, *rest))


def _cone_keep(apex, vec, valid, centers, radii, dense: bool):
    """(T, N) bool: the spheres that any ray apex + s vec[t, p] (s > 0,
    valid[t, p]) of tile t can meet; a superset. float64."""
    t_tiles, n = vec.shape[0], centers.shape[0]
    any_valid = valid.any(1)
    if dense:
        return any_valid[:, None].expand(t_tiles, n)
    u = vec / torch.linalg.vector_norm(vec, dim=-1, keepdim=True).clamp_min(
        1e-300)
    s = torch.where(valid[..., None], u, 0.0).sum(1)
    axis = s / torch.linalg.vector_norm(s, dim=-1, keepdim=True).clamp_min(
        1e-300)
    cos_in = torch.where(valid, (u * axis[:, None, :]).sum(-1), 1.0)
    half = torch.acos(cos_in.amin(1).clamp(-1.0, 1.0))          # (T,)
    w = centers - apex                                          # (N, 3)
    dist = torch.linalg.vector_norm(w, dim=-1)
    rr = radii + MARGIN
    ang = torch.acos(((axis @ w.T) / dist.clamp_min(1e-300)).clamp(-1, 1))
    ang_r = torch.asin((rr / dist.clamp_min(1e-300)).clamp(max=1.0))
    keep = ang <= half[:, None] + ang_r[None, :] + ANGLE_SLACK
    keep = keep | (dist <= rr)[None, :]
    return keep & any_valid[:, None]


def _groups(keep, per_tile: int):
    """Yield (tile ids (G,), candidate ids (G, K), candidate valid (G, K)),
    the tiles ordered by their kept count so a block pads little, each
    list in ascending sphere order (the first sphere wins a tie)."""
    counts = keep.sum(1)
    order = torch.argsort(counts, descending=True)
    counts_sorted = counts[order].tolist()
    n = keep.shape[1]
    iota = torch.arange(n, device=keep.device)
    i = 0
    while i < len(counts_sorted) and counts_sorted[i] > 0:
        k = counts_sorted[i]
        g = max(1, PAIR_BLOCK // (per_tile * k))
        tiles = order[i:i + g]
        key = torch.where(keep[tiles], iota, n + iota)
        ids = torch.sort(key, dim=1).values[:, :k]
        yield tiles, ids % n, ids < n
        i += g


def _sphere_roots(ox, oy, oz, dx, dy, dz, cx, cy, cz, r):
    """qa, the discriminant and the half-sums of the ray-sphere quadratic,
    broadcast over (..., rays, spheres)."""
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    qa = dx * dx + dy * dy + dz * dz
    qb = 2.0 * (dx * ocx + dy * ocy + dz * ocz)
    qc = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = qb * qb - 4.0 * qa * qc
    return qa, qb, disc


def _plane_t(o, d, normal, offset):
    """(R, P) plane distances (inf where parallel or behind)."""
    nd = (d[:, None, 0] * normal[None, :, 0]
          + d[:, None, 1] * normal[None, :, 1]
          + d[:, None, 2] * normal[None, :, 2])
    no = (o[..., None, 0] * normal[None, :, 0]
          + o[..., None, 1] * normal[None, :, 1]
          + o[..., None, 2] * normal[None, :, 2])
    t = (offset[None, :] - no) / torch.where(nd.abs() < 1e-12,
                                             torch.full_like(nd, 1e-12), nd)
    ok = (nd.abs() > 1e-9) & (t > 0.0)
    return torch.where(ok, t, torch.full_like(t, math.inf)), nd


def geometry(scene: dict, origin64, dirs64, dtype=torch.float32,
             dense: bool = False):
    """The no-grad pass over (H, W) rays from one origin: each ray's
    winner (kind 0 miss, 1 sphere, 2 plane; its index), inside flag, hit
    point, normal and (R, L) occlusion, in raster order (R = H*W)."""
    h, w = dirs64.shape[:2]
    dev = dirs64.device
    ts = TILE if h % TILE == 0 and w % TILE == 0 else 1
    d_t = _tiles(dirs64, ts)                           # (T, P, 3) f64
    t_tiles, per = d_t.shape[:2]
    center = scene["center"].to(dtype)
    radius = scene["radius"].to(dtype)
    c64, r64 = center.double(), radius.double()
    n = center.shape[0]
    o = origin64.to(dtype)
    dd = d_t.to(dtype)

    best_t = torch.full((t_tiles, per), math.inf, dtype=dtype, device=dev)
    best_i = torch.zeros((t_tiles, per), dtype=torch.long, device=dev)
    best_in = torch.zeros((t_tiles, per), dtype=torch.bool, device=dev)
    if n:
        keep = _cone_keep(origin64, d_t, torch.ones_like(d_t[..., 0],
                                                          dtype=torch.bool),
                          c64, r64, dense)
        for tiles, ids, ok_c in _groups(keep, per):
            d = dd[tiles]                                 # (G, P, 3)
            c, r = center[ids], radius[ids]               # (G, K, 3)
            qa, qb, disc = _sphere_roots(
                o[0], o[1], o[2], d[..., 0, None], d[..., 1, None],
                d[..., 2, None], c[:, None, :, 0], c[:, None, :, 1],
                c[:, None, :, 2], r[:, None, :])
            ok = (disc >= 0.0) & ok_c[:, None, :] & (qa > 1e-12)
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            t_near = (-qb - sq) / (2.0 * qa)
            t_far = (-qb + sq) / (2.0 * qa)
            inside = t_near < 0.0
            t = torch.where(inside, t_far, t_near)
            ok = ok & (t_far >= 0.0) & (t > 0.0)
            t = torch.where(ok, t, torch.full_like(t, math.inf))
            tmin, j = torch.min(t, dim=-1)                # first minimum
            best_t[tiles] = tmin
            best_i[tiles] = torch.gather(ids, 1, j)
            best_in[tiles] = torch.gather(inside, 2, j[..., None])[..., 0]

    t_s = _untiles(best_t, h, w, ts).reshape(-1)
    i_s = _untiles(best_i, h, w, ts).reshape(-1)
    in_s = _untiles(best_in, h, w, ts).reshape(-1)
    dflat = dirs64.reshape(-1, 3).to(dtype)
    kind = torch.where(t_s < MISS_T, 1, 0)
    t_best = t_s
    idx = i_s
    if scene["plane_offset"].shape[0]:
        tp, _ = _plane_t(o[None, :].expand(dflat.shape[0], 3), dflat,
                         scene["plane_normal"].to(dtype),
                         scene["plane_offset"].to(dtype))
        tpmin, jp = torch.min(tp, dim=-1)
        plane_wins = tpmin < t_s                      # a sphere wins a tie
        t_best = torch.where(plane_wins, tpmin, t_s)
        idx = torch.where(plane_wins, jp, i_s)
        kind = torch.where(t_best < MISS_T,
                           torch.where(plane_wins, 2, 1), 0)
    in_s = in_s & (kind == 1)
    hit = kind > 0

    # hit point and normal (the shade recomputes both with autograd)
    p, nrm = _hit_frame(scene, o, dflat, kind, idx, in_s, t_best, dtype)

    # shadows: one pass per light, the light as the cones' apex
    lpos = scene["light_position"].to(dtype)
    so = p + nrm * SHADOW_EPS
    occ = torch.zeros((dflat.shape[0], lpos.shape[0]), dtype=torch.bool,
                      device=dev)
    lit_any = (scene["light_diffuse"] != 0).any(1) | (
        scene["light_specular"] != 0).any(1)
    for li in range(lpos.shape[0]):
        if not bool(lit_any[li]):
            continue
        seg = lpos[li] - p                             # (R, 3) unnormalized
        blocked = torch.zeros_like(hit)
        if n:
            so_t = _tiles(so.reshape(h, w, 3), ts)
            seg_t = _tiles(seg.reshape(h, w, 3), ts)
            hit_t = _tiles(hit.reshape(h, w), ts)
            lp64 = scene["light_position"][li].double()
            keep = _cone_keep(lp64, so_t.double() - lp64, hit_t, c64, r64,
                              dense)
            blk_t = torch.zeros_like(hit_t)
            for tiles, ids, ok_c in _groups(keep, per):
                s0, sg = so_t[tiles], seg_t[tiles]         # (G, P, 3)
                c, r = center[ids], radius[ids]
                qa, qb, disc = _sphere_roots(
                    s0[..., 0, None], s0[..., 1, None], s0[..., 2, None],
                    sg[..., 0, None], sg[..., 1, None], sg[..., 2, None],
                    c[:, None, :, 0], c[:, None, :, 1], c[:, None, :, 2],
                    r[:, None, :])
                sq = torch.sqrt(torch.clamp(disc, min=0.0))
                t1 = (-qb - sq) / (2.0 * qa)
                t2 = (-qb + sq) / (2.0 * qa)
                meet = ((t1 > 0.0) & (t1 < 1.0)) | ((t2 > 0.0) & (t2 < 1.0))
                meet = meet & (disc >= 0.0) & (qa > 1e-12) & ok_c[:, None, :]
                blk_t[tiles] = meet.any(-1)
            blocked = _untiles(blk_t, h, w, ts).reshape(-1)
        if scene["plane_offset"].shape[0]:
            tp, _ = _plane_t(so, seg, scene["plane_normal"].to(dtype),
                             scene["plane_offset"].to(dtype))
            blocked = blocked | (tp < 1.0).any(-1)
        occ[:, li] = blocked & hit
    return dict(kind=kind, idx=idx, inside=in_s, t=t_best, occ=occ,
                origin=o, dirs=dflat)


def _hit_frame(scene, o, d, kind, idx, inside, t_plane, dtype,
               center=None, radius=None):
    """(p, n) of each ray's winner: for a sphere winner t, p and n are
    recomputed from its center and radius (so autograd reaches them), for
    a plane winner from the plane's distance t_plane."""
    center = scene["center"].to(dtype) if center is None else center
    radius = scene["radius"].to(dtype) if radius is None else radius
    sph = kind == 1
    pln = kind == 2
    n_sph = center.shape[0]
    dev = d.device
    if n_sph:
        i_s = torch.where(sph, idx, 0)
        c = center[i_s]
        r = radius[i_s]
        qa, qb, disc = _sphere_roots(o[0], o[1], o[2], d[:, 0], d[:, 1],
                                     d[:, 2], c[:, 0], c[:, 1], c[:, 2], r)
        sq = torch.sqrt(torch.clamp(disc, min=1e-20))
        t_s = torch.where(inside, (-qb + sq) / (2.0 * qa),
                          (-qb - sq) / (2.0 * qa))
        t_s = torch.where(sph, t_s, torch.zeros_like(t_s))
    else:
        c = torch.zeros_like(d)
        t_s = torch.zeros(d.shape[0], dtype=dtype, device=dev)
    t_p = torch.where(pln, t_plane, torch.zeros_like(t_plane))
    t = torch.where(sph, t_s, t_p)
    p = o + t[:, None] * d
    n_s = _normalize(p - c) * torch.where(inside, -1.0, 1.0).to(dtype)[:, None]
    if scene["plane_offset"].shape[0]:
        pn = _normalize(scene["plane_normal"].to(dtype))[torch.where(
            pln, idx, 0)]
        facing = (d * pn).sum(-1, keepdim=True) > 0.0
        n_p = torch.where(facing, -pn, pn)
    else:
        n_p = torch.zeros_like(d)
    nrm = torch.where(sph[:, None], n_s, torch.where(pln[:, None], n_p, 0.0))
    return p, nrm


def _normalize(v):
    return v * torch.rsqrt(torch.clamp((v * v).sum(-1, keepdim=True),
                                       min=1e-20))


def _safe_pow(base, e):
    val = torch.exp(e * torch.log(torch.clamp(base, min=1e-12)))
    return torch.where(base > 0.0, val, torch.zeros_like(val))


def shade(scene: dict, geo: dict, dtype=torch.float32, leaves=None,
          rows=None):
    """(R, 3) colors of the rays geo[rows] (all by default), Phong with the
    occlusion of the geometry pass; differentiable in ``leaves`` (a dict
    of center, radius or diffuse tensors that replace the scene's)."""
    leaves = leaves or {}
    sl = slice(None) if rows is None else rows
    kind, idx, inside = geo["kind"][sl], geo["idx"][sl], geo["inside"][sl]
    d, occ, o = geo["dirs"][sl], geo["occ"][sl], geo["origin"]
    center = leaves.get("center", scene["center"].to(dtype))
    radius = leaves.get("radius", scene["radius"].to(dtype))
    p, nrm = _hit_frame(scene, o, d, kind, idx, inside, geo["t"][sl], dtype,
                        center, radius)
    mat = torch.where(kind == 1, scene["sphere_material"].long()[
        torch.where(kind == 1, idx, 0)], torch.zeros_like(idx))
    if scene["plane_offset"].shape[0]:
        mat = torch.where(kind == 2, scene["plane_material"].long()[
            torch.where(kind == 2, idx, 0)], mat)
    diffuse = leaves.get("diffuse", scene["diffuse"].to(dtype))
    m_amb = scene["ambient"].to(dtype)[mat]
    m_diff = diffuse[mat]
    m_spec = scene["specular"].to(dtype)[mat]
    m_emis = scene["emissive"].to(dtype)[mat]
    m_shin = scene["shininess"].to(dtype)[mat][:, None]
    lpos = scene["light_position"].to(dtype)
    view = _normalize(-d)
    amb = torch.zeros_like(m_amb)
    dif = torch.zeros_like(m_amb)
    spe = torch.zeros_like(m_amb)
    for j in range(lpos.shape[0]):
        amb = amb + scene["light_ambient"][j].to(dtype) * m_amb
        ldir = _normalize(lpos[j] - p)
        lit = (~occ[:, j])[:, None].to(dtype)
        ref = _normalize(-ldir - 2.0 * (nrm * -ldir).sum(-1, keepdim=True)
                         * nrm)
        cos_t = (ldir * nrm).sum(-1, keepdim=True)
        cos_p = (view * ref).sum(-1, keepdim=True)
        dif = dif + lit * scene["light_diffuse"][j].to(dtype) * m_diff \
            * torch.clamp(cos_t, min=0.0)
        spe = spe + lit * scene["light_specular"][j].to(dtype) * m_spec \
            * _safe_pow(cos_p, m_shin)
    phong = amb + dif + spe + m_emis
    color = phong[:, :3] * phong[:, 3:4]
    return torch.where((kind > 0)[:, None], color, torch.zeros_like(color))


def render(scene: dict, camera: dict, height: int, width: int,
           dtype=torch.float32, dense: bool = False) -> torch.Tensor:
    """The (H, W, 3) image in ``dtype``, row 0 the bottom."""
    with torch.no_grad():
        origin, dirs = camera_rays(camera, height, width)
        geo = geometry(scene, origin, dirs, dtype, dense)
        r = height * width
        out = torch.cat([shade(scene, geo, dtype,
                               rows=slice(i, i + SHADE_BLOCK))
                         for i in range(0, r, SHADE_BLOCK)])
    return out.reshape(height, width, 3)


def to_uint8(image: torch.Tensor) -> torch.Tensor:
    """[0, 1] float (H, W, 3) -> uint8, rows flipped to top-first (row 0 of
    a render is the bottom)."""
    img = torch.clamp(image.float(), 0.0, 1.0)
    return (img * 255.0 + 0.5).to(torch.uint8).flip(0)


def loss_and_grads(scene: dict, camera: dict, height: int, width: int,
                   target, leaves: dict, dtype=torch.float32,
                   dense: bool = False):
    """mean((render - target)^2) over every pixel and channel, and its
    gradient with respect to each tensor of ``leaves`` (center, radius,
    diffuse; the scene's own are replaced by them), by autograd through
    the shade of each ray's winner. The winners and the occlusion are
    discrete and carry no gradient."""
    scene = dict(scene, **{k: v.detach() for k, v in leaves.items()})
    with torch.no_grad():
        origin, dirs = camera_rays(camera, height, width)
        geo = geometry(scene, origin, dirs, dtype, dense)
    tgt = target.reshape(-1, 3).to(dtype)
    r = height * width
    req = {k: v.detach().to(dtype).requires_grad_() for k, v in
           leaves.items()}
    grads = {k: torch.zeros_like(v) for k, v in req.items()}
    total = torch.zeros((), dtype=torch.float64, device=tgt.device)
    for i in range(0, r, SHADE_BLOCK):
        rows = slice(i, i + SHADE_BLOCK)
        col = shade(scene, geo, dtype, leaves=req, rows=rows)
        part = torch.sum(torch.square(col - tgt[rows])) / (r * 3)
        gs = torch.autograd.grad(part, list(req.values()),
                                 allow_unused=True)
        for k, g in zip(req, gs):
            if g is not None:
                grads[k] += g
        total += part.detach().double()
    return total, grads


class Adam:
    """Adam (Kingma and Ba), as the step torch.optim.Adam takes by default:
    betas (0.9, 0.999), eps 1e-8, bias-corrected moments; ``lr`` one rate
    or a rate for each parameter's name."""

    def __init__(self, params: dict, lr, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.params = params
        self.lr = lr if isinstance(lr, dict) else {k: lr for k in params}
        self.b1, self.b2, self.eps = betas[0], betas[1], eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, grads: dict) -> None:
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = math.sqrt(1.0 - self.b2 ** self.t)
        for k, p in self.params.items():
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1.0 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1.0 - self.b2) * g * g
            denom = torch.sqrt(self.v[k]) / bc2 + self.eps
            self.params[k] = p - (self.lr[k] / bc1) * self.m[k] / denom
