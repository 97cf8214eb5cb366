"""The benchmark's plain soft reference: the soft-coverage forward of the
config-5 fit's soft stages in plain PyTorch, from its equations, and the
gradients of its multi-view loss by autograd.

For a ray o + t d (d unit) and a sphere (c, r), with oc = o - c,
b = oc . d and d_perp^2 = |oc|^2 - b^2 (the squared distance from the
centre to the ray's line):

  coverage   alpha = sigmoid((r^2 - d_perp^2) / (bw r^2)), cut to 0 below
             ALPHA_CUT and behind the front gate t > T_EPS;
  depth      t = -b - sqrt(max(r^2 - d_perp^2, 0)): the near root where
             the ray meets the sphere, the point of closest approach where
             it passes by; clamped to [T_EPS, t_bg] for the shade and the
             weights;
  shade      Phong ambient, diffuse and specular of every light at
             p = o + t d with the normal (p - c) / |p - c|, no shadows,
             rgb times the summed alpha channel;
  planes     hard coverage: a plane hit at T_EPS < t (and |n . d| > 1e-9)
             takes part with coverage 1, its normal facing the ray;
  background black, at depth t_bg, coverage 1;
  weights    w = coverage * exp(-(t - t_min) / gamma) over the spheres, the
             planes and the background, t_min the least t among the live
             ones (a shift that cancels in the quotient), and the colour
             sum(w rgb) / sum(w).

The loss is the mean over the views of each view's mean squared error over
its pixels and channels. Gradients come from autograd, in blocks of tiles
so that a block's graph fits on the card.

Departures from the published description (the port's docstring of
``ops/soft.py``, written from the JAX package's): none in the equations.
The square root's argument is held at 1e-20 from below, so its derivative
stays finite on a silhouette (where the ray just touches the sphere the
exact derivative is infinite); the exponent of a dead sphere is taken at
t_bg (its weight is 0 either way, and no overflow reaches the backward).

Culling: each 16x16 tile keeps the spheres that a cone around its rays
can meet with every radius grown by sqrt(1 + 8 bw) (coverage is below
ALPHA_CUT past sqrt(1 + 6.91 bw) r) and the tracer's margin
(``tracer._cone_keep``, float64): a test that only ever keeps too many, so
the culled image equals the dense one. ``dense=True`` keeps every sphere.

Arithmetic runs in ``dtype`` (float32 as the configuration states; the
lower-precision control runs bfloat16); rays are made in float64 and
rounded. TF32 is switched off; no float32 matrix product is taken.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import tracer

ALPHA_CUT = 1.0e-3
T_EPS = 1.0e-3
LOGIT_REACH = 8.0       # sqrt(1 + 8 bw) r: the grown radius of the cull
SQRT_FLOOR = 1.0e-20
BLOCK = 1 << 21         # ray-sphere pairs of one block of tiles


def _exact() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _dot(a, b):
    return (a * b).sum(-1)


def _blocks(keep, per_tile: int):
    """Yield (tile ids (G,), candidate ids (G, K), candidate valid (G, K))
    over every tile (a tile that keeps no sphere gets one invalid slot:
    its planes and background are still drawn), the tiles ordered by
    their kept count so that a block pads little."""
    counts = keep.sum(1)
    order = torch.argsort(counts, descending=True)
    counts_sorted = counts[order].tolist()
    n = keep.shape[1]
    iota = torch.arange(n, device=keep.device)
    i = 0
    while i < len(counts_sorted):
        k = max(counts_sorted[i], 1)
        g = max(1, BLOCK // (per_tile * k))
        tiles = order[i:i + g]
        key = torch.where(keep[tiles], iota, n + iota)
        ids = torch.sort(key, dim=1).values[:, :k]
        yield tiles, ids % n, ids < n
        i += g


def _phong(m, lights, p, nrm, d):
    """Shadowless Phong of points p (..., 3) with unit normals nrm, seen
    along d; m: the material columns (ambient, diffuse, specular,
    emissive (..., 4), shininess (...,)). Returns rgb * alpha (..., 3)."""
    view = tracer._normalize(-d)
    acc = m["emissive"]
    for j in range(lights["position"].shape[0]):
        ldir = tracer._normalize(lights["position"][j] - p)
        cos_t = _dot(ldir, nrm)[..., None]
        ref = tracer._normalize(2.0 * cos_t * nrm - ldir)
        cos_p = _dot(view, ref)
        acc = acc + lights["ambient"][j] * m["ambient"] \
            + lights["diffuse"][j] * m["diffuse"] * torch.clamp(cos_t,
                                                                 min=0.0) \
            + lights["specular"][j] * m["specular"] * tracer._safe_pow(
                cos_p, m["shininess"])[..., None]
    return acc[..., :3] * acc[..., 3:4]


def _materials(scene, ids, diffuse, dtype):
    return {"ambient": scene["ambient"].to(dtype)[ids],
            "diffuse": diffuse[ids],
            "specular": scene["specular"].to(dtype)[ids],
            "emissive": scene["emissive"].to(dtype)[ids],
            "shininess": scene["shininess"].to(dtype)[ids]}


def _composite(scene, o, d, c, r, ok, mat_ids, diffuse, bw, gamma, t_bg,
               dtype):
    """Colours (G, P, 3) of the rays o + t d (d (G, P, 3)) over their
    tiles' candidate spheres c (G, K, 3), r (G, K), ok (G, K), the planes
    and the background."""
    lights = {"position": scene["light_position"].to(dtype),
              "ambient": scene["light_ambient"].to(dtype),
              "diffuse": scene["light_diffuse"].to(dtype),
              "specular": scene["light_specular"].to(dtype)}
    dk = d[:, :, None, :]                                 # (G, P, 1, 3)
    oc = o - c[:, None]                                   # (G, 1, K, 3)
    b = _dot(oc, dk)                                      # (G, P, K)
    d_perp2 = _dot(oc, oc) - b * b
    r2 = (r * r)[:, None, :]
    disc = r2 - d_perp2
    alpha = torch.sigmoid(disc / (bw * r2))
    t = -b - torch.sqrt(torch.clamp(disc, min=SQRT_FLOOR))
    live = (alpha > ALPHA_CUT) & (t > T_EPS) & ok[:, None, :]
    alpha = torch.where(live, alpha, torch.zeros_like(alpha))
    t = torch.clamp(t, T_EPS, t_bg)
    p = o + t[..., None] * dk
    nrm = tracer._normalize(p - c[:, None])
    mat = _materials(scene, mat_ids, diffuse, dtype)
    col_s = _phong({k: v[:, None] for k, v in mat.items()}, lights, p, nrm,
                   dk)                                     # (G, P, K, 3)

    t_bg_t = torch.full_like(b[..., 0], t_bg)
    t_live = torch.where(live, t, t_bg)
    t_min = torch.minimum(t_live.amin(-1), t_bg_t)
    planes = []
    for i in range(scene["plane_offset"].shape[0]):
        normal = scene["plane_normal"][i].to(dtype)
        inv_len = torch.rsqrt(_dot(normal, normal))
        n_hat = normal * inv_len
        nd = _dot(d, n_hat)                               # (G, P)
        facing_ray = nd.abs() > 1e-9
        t_pl = (scene["plane_offset"][i].to(dtype) * inv_len
                - _dot(o, n_hat)) / torch.where(facing_ray, nd,
                                                torch.ones_like(nd))
        hit = facing_ray & (t_pl > T_EPS)
        t_pl = torch.where(hit, torch.clamp(t_pl, T_EPS, t_bg), t_bg_t)
        facing = torch.where(nd > 0.0, -1.0, 1.0).to(dtype)[..., None]
        pid = scene["plane_material"][i].long()
        m_pl = _materials(scene, pid, diffuse, dtype)
        col = _phong(m_pl, lights, o + t_pl[..., None] * d,
                     facing * n_hat, d)
        planes.append((hit, t_pl, col))
        t_min = torch.minimum(t_min, t_pl)
    t_min = t_min.detach()

    w_s = alpha * torch.exp((t_min[..., None] - t_live) / gamma)
    num = (w_s[..., None] * col_s).sum(-2)
    den = w_s.sum(-1)
    for hit, t_pl, col in planes:
        w = torch.where(hit, torch.exp((t_min - t_pl) / gamma),
                        torch.zeros_like(t_min))
        num = num + w[..., None] * col
        den = den + w
    den = den + torch.exp((t_min - t_bg) / gamma)
    return num / den[..., None]


def _view(scene, camera, height, width, leaves, bw, gamma, t_bg, dtype,
          dense):
    """Yield (tile ids, the block's colours (G, P, 3)) over one view,
    differentiable in ``leaves`` (center, radius, diffuse)."""
    origin64, dirs64 = tracer.camera_rays(camera, height, width)
    d_t = tracer._tiles(dirs64, tracer.TILE)              # (T, P, 3) f64
    center = leaves.get("center", scene["center"].to(dtype))
    radius = leaves.get("radius", scene["radius"].to(dtype))
    diffuse = leaves.get("diffuse", scene["diffuse"].to(dtype))
    grown = radius.detach().double() * math.sqrt(1.0 + LOGIT_REACH * bw)
    keep = tracer._cone_keep(origin64, d_t, torch.ones_like(
        d_t[..., 0], dtype=torch.bool), center.detach().double(), grown,
        dense)
    o = origin64.to(dtype)
    dd = d_t.to(dtype)
    sph_mat = scene["sphere_material"].long()
    for tiles, ids, ok in _blocks(keep, d_t.shape[1]):
        yield tiles, _composite(scene, o, dd[tiles], center[ids],
                                radius[ids], ok, sph_mat[ids], diffuse, bw,
                                gamma, t_bg, dtype)


def render(scene: dict, cameras, height: int, width: int, bw: float,
           gamma: float, t_bg: float, dtype=torch.float32,
           dense: bool = False) -> torch.Tensor:
    """The soft images (V, H, W, 3) of the views ``cameras``, in ``dtype``,
    row 0 the bottom."""
    _exact()
    out = []
    with torch.no_grad():
        for cam in cameras:
            img = None
            for tiles, col in _view(scene, cam, height, width, {}, bw, gamma,
                                    t_bg, dtype, dense):
                if img is None:
                    n_tiles = (height // tracer.TILE) * (width // tracer.TILE)
                    img = col.new_zeros((n_tiles,) + col.shape[1:])
                img[tiles] = col
            out.append(tracer._untiles(img, height, width, tracer.TILE))
    return torch.stack(out)


def loss_and_grads(scene: dict, cameras, height: int, width: int, target,
                   leaves: dict, bw: float, gamma: float, t_bg: float,
                   dtype=torch.float32, dense: bool = False):
    """The mean over the views of each view's mean((image - target)^2), as
    a float64 scalar, and its gradient with respect to each tensor of
    ``leaves`` (center, radius, diffuse; the scene's own are replaced by
    them). target (V, H, W, 3)."""
    _exact()
    req = {k: v.detach().to(dtype).requires_grad_() for k, v in
           leaves.items()}
    grads = {k: torch.zeros_like(v) for k, v in req.items()}
    total = torch.zeros((), dtype=torch.float64, device=target.device)
    scale = height * width * 3 * len(cameras)
    for v, cam in enumerate(cameras):
        tgt = tracer._tiles(target[v].to(dtype), tracer.TILE)
        for tiles, col in _view(scene, cam, height, width, req, bw, gamma,
                                t_bg, dtype, dense):
            part = torch.sum(torch.square(col - tgt[tiles])) / scale
            gs = torch.autograd.grad(part, list(req.values()),
                                     allow_unused=True)
            for k, g in zip(req, gs):
                if g is not None:
                    grads[k] += g
            total += part.detach().double()
    return total, grads
