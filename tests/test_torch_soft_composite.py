"""PyTorch port: the soft composite's autograd op (ops/soft.py
_SoftComposite) and its analytic backward, on the CPU; its kernels
(csrc/soft_composite.cu) against their plain versions on the card.

On the CPU the op runs its plain versions: the forward is the composite
dense over (B, P, K), and its backward ``soft_composite_bwd_plain`` must
equal autograd through that forward, for the sphere rows, the material
rows, and the lights and planes where they require grad. The cases cover
the culled and the dense pass, 0 and 1 planes, 1 and 2 lights, and rays
placed on the silhouettes (the discriminant at 0 and just off it), at the
coverage cut (alpha at _ALPHA_CUT and an ulp-scale step either side) and
beyond t_bg (the depth clamped).

Tolerances: the analytic backward takes t_min, the per-ray least live
depth that stabilises the softmax, as a constant, because it cancels
exactly in num / den; autograd routes it through amin and the weights'
clamps, whose parts add to zero only up to rounding, and it sums each
slot over the rays, and the weights over the slots, in another order. In
float64 the two agree to 1e-9 of each leaf's largest gradient (F64_RTOL;
measured below 1e-12). In float32 a leaf's gradient is held to F32_RTOL
(1e-4) of its largest: a silhouette ray's dt/d(disc) = 1/(2 sqrt(disc))
multiplies the rounding of disc, whose terms cancel.

The tests marked ``cuda`` compare the kernels with the plain versions (on
the card's tensors, in blocks of tiles) at the c5_grid4096_soft512 cell's
shapes and at 32x32 tiles, the dense pass and tiles with no survivor,
exactly K and an overflow, and a three-view soft step at the cell's
shapes:

    python -m pytest --noconftest -m cuda tests/test_torch_soft_composite.py -q

The forward's image is held to 2e-6 of a channel (CARD_ATOL: the kernel
adds a ray's weights slot by slot, torch.sum in its own order; each
weight and colour is the same float32 arithmetic), its t_min exactly and
den to 1e-6 relative; the live-pair count exactly; each gradient row of
the spheres' and the slots' material rows to CARD_GRAD_RTOL (1e-4) of its
leaf's largest row, the sums' order again; the planes' and the lights'
rows, each a sum over every ray of the view (262,144 at 512x512) whose
terms cancel, to CARD_SUM_RTOL (1e-3; a plane's offset measured 1.2e-4).
Imports no jax.
"""

import math

import pytest
import torch

from openglraytracer_tpu_torch.models import builders as tb
from openglraytracer_tpu_torch.models.scene import empty_planes
from openglraytracer_tpu_torch.ops import soft as ts
from openglraytracer_tpu_torch.ops.accel import (_gather_tile_rows,
                                                 _sphere_table, compact_mask,
                                                 sphere_vs_cone, tile_cones,
                                                 tile_image)
from openglraytracer_tpu_torch.ops.raygen import generate_rays
from openglraytracer_tpu_torch.ops.shading import material_table

F64_RTOL, F32_RTOL = 1e-9, 1e-4
CARD_ATOL, CARD_GRAD_RTOL, CARD_SUM_RTOL = 2e-6, 1e-4, 1e-3
BW, GAMMA = 0.5, 0.6
H = W = 32
TILE = (16, 16)


def _logit_cut():
    """The logit at which the coverage sigmoid equals _ALPHA_CUT."""
    c = ts._ALPHA_CUT
    return math.log(c / (1.0 - c))


def _aim(o, c, r, h):
    """A unit direction from o that passes centre c at distance h."""
    u = c - o
    dist = torch.linalg.vector_norm(u)
    u = u / dist
    e = torch.linalg.cross(u, torch.tensor([0.0, 0.0, 1.0], dtype=o.dtype))
    e = e / torch.linalg.vector_norm(e)
    s = h / dist
    return torch.sqrt(1.0 - s * s) * u + s * e


def _special_rays(o, c, r, bw):
    """Directions from o at sphere (c, r): on the silhouette (disc 0 and
    just off it) and at the coverage cut (alpha = _ALPHA_CUT and just
    either side of it)."""
    disc_cut = _logit_cut() * bw * r * r
    hs = [r, r * (1 - 1e-4), r * (1 + 1e-4),
          torch.sqrt(r * r - disc_cut),
          torch.sqrt(r * r - disc_cut * (1 - 1e-3)),
          torch.sqrt(r * r - disc_cut * (1 + 1e-3)),
          0.5 * r]
    return torch.stack([_aim(o, c, r, h) for h in hs])


def _block(culled, planes, lights, dtype, t_bg):
    """Inputs of one call of the op: (o, d, rows, valid, m_rows, lights,
    pl_n, pl_off, pl_m, t_bg), the trainable ones leaves that require
    grad, the special rays written over the start of the first tile
    that has survivors (culled) or of the rays (dense)."""
    scene, cam = tb.sphere_grid_scene(3, seed=5, dtype=dtype, device="cpu")
    if planes == 0:
        scene = scene._replace(planes=empty_planes(dtype, device="cpu"))
    lt = scene.lights
    scene = scene._replace(lights=lt._replace(
        **{k: v[:lights] for k, v in lt._asdict().items()}))
    origins, dirs = (x.to(dtype) for x in generate_rays(cam, H, W))
    table = _sphere_table(scene)
    if culled:
        o = tile_image(origins, *TILE).reshape(-1, TILE[0] * TILE[1], 3)
        d = tile_image(dirs, *TILE).reshape(-1, TILE[0] * TILE[1], 3)
        axis, cos_half = tile_cones(d)
        mask = sphere_vs_cone(o[0, 0], axis, cos_half, scene.spheres.center,
                              scene.spheres.radius * ts.expand_factor(BW))
        idx, valid, _ = compact_mask(mask, int(scene.spheres.count))
        rows = _gather_tile_rows(table, idx)
    else:
        o, d = origins.reshape(1, -1, 3), dirs.reshape(1, -1, 3)
        valid = torch.ones((1, table.shape[0]), dtype=torch.bool)
        rows = table[None]
    o, d = o.clone(), d.clone()
    tile = int(torch.nonzero(valid.any(-1))[0])
    slots = torch.nonzero(valid[tile])[:, 0]
    at = 0
    for s in slots[:4]:
        sp = _special_rays(o[tile, 0], rows[tile, s, :3], rows[tile, s, 3],
                           BW)
        d[tile, at:at + sp.shape[0]] = sp
        at += sp.shape[0]
    mat_tab = material_table(scene)
    m_rows = torch.index_select(
        mat_tab, 0, rows[..., 4].long().reshape(-1)).reshape(
            rows.shape[:2] + (20,))
    pls = scene.planes
    pl_n = ts._safe_normalize(pls.normal)
    pl_off = pls.offset * torch.rsqrt(torch.sum(pls.normal ** 2, dim=-1))
    pl_m = torch.index_select(mat_tab, 0, pls.material_id.long())
    leaves = [x.detach().clone().requires_grad_()
              for x in (rows, m_rows, *scene.lights, pl_n, pl_off, pl_m)]
    rows, m_rows, *rest = leaves
    return (o, d, rows, valid, m_rows, tuple(rest[:4]), rest[4], rest[5],
            rest[6], t_bg)


def _leaves(args):
    o, d, rows, valid, m_rows, lights, pl_n, pl_off, pl_m, _ = args
    return [rows, m_rows, *lights, pl_n, pl_off, pl_m]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("lights", [1, 2], ids=["1light", "2lights"])
@pytest.mark.parametrize("planes", [0, 1], ids=["0planes", "1plane"])
@pytest.mark.parametrize("culled", [True, False], ids=["culled", "dense"])
def test_plain_backward_equals_autograd(culled, planes, lights, dtype):
    """soft_composite_bwd_plain at a random cotangent against autograd
    through soft_composite_plain (the forward of the op): every leaf's
    gradient, with every light and plane leaf requiring grad (the
    geometry variant) and with none of them. t_bg 7 sits inside the
    grid's depth range (2-11), so live pairs beyond it clamp."""
    args = _block(culled, planes, lights, dtype, t_bg=7.0)
    o, d, rows, valid, m_rows, lts, pl_n, pl_off, pl_m, t_bg = args
    out, t_min, den = ts.soft_composite_plain(
        o, d, rows, valid, m_rows, lts, pl_n, pl_off, pl_m, BW, GAMMA, t_bg)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(3),
                    dtype=dtype)
    leaves = _leaves(args)
    want = torch.autograd.grad(out, leaves, g, allow_unused=True)
    pg = ts._pair_geometry(o, d, rows, valid, BW, t_bg)
    assert bool((t_min < t_bg).any())
    assert bool((pg["live"] & (pg["t1"] > t_bg)).any()), \
        "no live pair clamps at t_bg"
    tol = F64_RTOL if dtype == torch.float64 else F32_RTOL
    with torch.no_grad():
        for geometry in (True, False):
            got = ts.soft_composite_bwd_plain(
                o, d, rows, valid, m_rows, lts, pl_n, pl_off, pl_m, out,
                t_min, den, g, BW, GAMMA, t_bg, geometry)
            g_rows, g_m, g_pl_m, g_lp, g_la, g_ld, g_ls, g_pn, g_po = got
            pairs = [(g_rows, want[0]), (g_m, want[1]), (g_pl_m, want[8])]
            if geometry:
                pairs += list(zip((g_lp, g_la, g_ld, g_ls, g_pn, g_po),
                                  want[2:8]))
            else:
                assert all(x is None for x in got[3:])
            for i, (a, b) in enumerate(pairs):
                if b is None:
                    b = torch.zeros_like(a)
                scale = float(b.abs().max()) if b.numel() else 0.0
                assert a.shape == b.shape, i
                err = float((a - b).abs().max()) if b.numel() else 0.0
                assert err <= tol * max(scale, 1e-30), (i, err, scale)


def test_the_op_gives_the_plain_forward_and_counts_no_kernel_ray():
    """_composite_block on CPU tensors: the image of soft_composite_plain
    bit for bit, and no launch of the kernel while tracing."""
    from torch.profiler import ProfilerActivity, profile

    from openglraytracer_tpu_torch import kernels
    from openglraytracer_tpu_torch.utils import profiling
    scene, cam = tb.sphere_grid_scene(3, seed=5, device="cpu")
    origins, dirs = generate_rays(cam, H, W)
    before = dict(kernels.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("entry", "step"):
            img = ts.soft_render_rays(scene, origins.reshape(-1, 3),
                                      dirs.reshape(-1, 3), bw=BW,
                                      gamma=GAMMA)
    rec = profiling.record()
    assert kernels.LAUNCHES["soft_composite"] == \
        before.get("soft_composite", 0)
    assert rec.counters["soft_rays"].value == H * W
    assert dict(kernels.LAUNCHES) == before
    table = _sphere_table(scene)
    mat_tab = material_table(scene)
    pls = scene.planes
    want = ts.soft_composite_plain(
        origins.reshape(1, -1, 3), dirs.reshape(1, -1, 3), table[None],
        torch.ones((1, table.shape[0]), dtype=torch.bool),
        torch.index_select(mat_tab, 0, table[:, 4].long())[None],
        tuple(scene.lights), ts._safe_normalize(pls.normal),
        pls.offset * torch.rsqrt(torch.sum(pls.normal ** 2, dim=-1)),
        torch.index_select(mat_tab, 0, pls.material_id.long()), BW, GAMMA,
        200.0)[0][0]
    assert torch.equal(img, want)


def test_rays_that_require_grad_are_refused():
    scene, cam = tb.sphere_grid_scene(2, seed=5, device="cpu")
    origins, dirs = generate_rays(cam, 8, 8)
    with pytest.raises(ValueError, match="no gradient of the rays"):
        ts.soft_render_rays(scene, origins.reshape(-1, 3),
                            dirs.reshape(-1, 3).requires_grad_(), bw=BW,
                            gamma=GAMMA)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _orbit(cam, phi_deg):
    phi = math.radians(phi_deg)
    x, y, z = (float(v) for v in cam.position)
    a = [float(v) for v in cam.angles]
    dev = cam.position.device
    return cam._replace(
        position=torch.tensor((x * math.cos(phi) - y * math.sin(phi),
                               x * math.sin(phi) + y * math.cos(phi), z),
                              device=dev),
        angles=torch.tensor([a[0], a[1] + phi_deg, a[2]], device=dev))


def _card_views(dev, side, res, tile, bw, k=None, views=(0.0, 45.0, -45.0)):
    """The op's inputs of each view of the side x side grid at res x res
    (tile None: the dense pass), as soft_render_rays makes them: (o, d,
    rows, valid, m_rows, lights, pl_n, pl_off, pl_m, found) a view."""
    scene, cam = tb.sphere_grid_scene(side, seed=1, device=dev)
    table = _sphere_table(scene)
    mat_tab = material_table(scene)
    pls = scene.planes
    pl_n = ts._safe_normalize(pls.normal)
    pl_off = pls.offset * torch.rsqrt(torch.sum(pls.normal ** 2, dim=-1))
    pl_m = torch.index_select(mat_tab, 0, pls.material_id.long())
    out = []
    for v in views:
        c = _orbit(cam, v)
        origins, dirs = generate_rays(c, res, res)
        if tile is None:
            o, d = origins.reshape(1, -1, 3), dirs.reshape(1, -1, 3)
            valid = torch.ones((1, table.shape[0]), dtype=torch.bool,
                               device=dev)
            rows, found = table[None], None
        else:
            kk = k if k is not None else ts.suggest_soft_cull(
                scene, c, res, res, (tile, tile), bw, headroom=2.0)[1]
            o = tile_image(origins, tile, tile).reshape(-1, tile * tile, 3)
            d = tile_image(dirs, tile, tile).reshape(-1, tile * tile, 3)
            axis, cos_half = tile_cones(d)
            mask = sphere_vs_cone(o[0, 0], axis, cos_half,
                                  scene.spheres.center,
                                  scene.spheres.radius * ts.expand_factor(bw))
            idx, valid, found = compact_mask(mask, kk)
            rows = _gather_tile_rows(table, idx)
        m_rows = torch.index_select(
            mat_tab, 0, rows[..., 4].long().reshape(-1)).reshape(
                rows.shape[:2] + (20,))
        out.append((o.contiguous(), d.contiguous(), rows, valid, m_rows,
                    tuple(scene.lights), pl_n, pl_off, pl_m, found))
    return out


def _plain_blocks(view, bw, gamma, t_bg, g, geometry, tiles):
    """The plain forward and backward on the card's tensors, tiles at a
    time (the (B, P, K) working set of a whole view does not fit)."""
    o, d, rows, valid, m_rows, lights, pl_n, pl_off, pl_m, _ = view
    outs, grads, live = [], [], 0
    for s in range(0, o.shape[0], tiles):
        sl = slice(s, s + tiles)
        out, t_min, den = ts.soft_composite_plain(
            o[sl], d[sl], rows[sl], valid[sl], m_rows[sl], lights, pl_n,
            pl_off, pl_m, bw, gamma, t_bg)
        pg = ts._pair_geometry(o[sl], d[sl], rows[sl], valid[sl], bw, t_bg)
        live += int(torch.count_nonzero(pg["live"]))
        outs.append((out, t_min, den))
        if g is not None:
            grads.append(ts.soft_composite_bwd_plain(
                o[sl], d[sl], rows[sl], valid[sl], m_rows[sl], lights, pl_n,
                pl_off, pl_m, out, t_min, den, g[sl], bw, gamma, t_bg,
                geometry))
    fwd = [torch.cat(x) for x in zip(*outs)]
    if g is None:
        return fwd, None, live
    bwd = [torch.cat([gr[0] for gr in grads]),
           torch.cat([gr[1] for gr in grads])]
    for q in range(2, 9):
        parts = [gr[q] for gr in grads]
        bwd.append(None if parts[0] is None else sum(parts))
    return fwd, bwd, live


def _close_rows(got, want, what, rtol=CARD_GRAD_RTOL):
    """Each row within rtol of the leaf's largest row norm."""
    got, want = got.reshape(-1, got.shape[-1] if got.dim() > 1 else 1), \
        want.reshape(-1, want.shape[-1] if want.dim() > 1 else 1)
    scale = float(torch.linalg.vector_norm(want, dim=-1).max())
    err = float(torch.linalg.vector_norm(got - want, dim=-1).max())
    assert err <= rtol * max(scale, 1e-30), (what, err, scale)


def _check_view(view, bw, gamma, t_bg, geometry, tiles):
    from openglraytracer_tpu_torch import kernels
    from openglraytracer_tpu_torch.utils import profiling
    from torch.profiler import ProfilerActivity, profile
    o, d, rows, valid, m_rows, lights, pl_n, pl_off, pl_m, _ = view
    g = torch.randn(o.shape, generator=torch.Generator(o.device)
                    .manual_seed(7), device=o.device)
    before = kernels.LAUNCHES["soft_composite"]
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("entry", "step"):
            out, t_min, den = ts.soft_composite(
                o, d, rows, valid, m_rows, lights, pl_n, pl_off, pl_m, bw,
                gamma, t_bg, save=True, count_live=True)
    counters = profiling.record().counters
    assert kernels.LAUNCHES["soft_composite"] == before + 1
    got_b = ts.soft_composite_bwd(o, d, rows, valid, m_rows, lights, pl_n,
                                  pl_off, pl_m, out, t_min, den, g, bw, gamma,
                                  t_bg, geometry)
    (p_out, p_tmin, p_den), p_b, live = _plain_blocks(
        view, bw, gamma, t_bg, g, geometry, tiles)
    assert counters["soft_live_pairs"].value == live
    assert float((out - p_out).abs().max()) <= CARD_ATOL
    assert torch.equal(t_min, p_tmin)
    torch.testing.assert_close(den, p_den, rtol=1e-6, atol=0)
    for q, (a, b) in enumerate(zip(got_b, p_b)):
        if b is None:
            assert a is None, q
        else:
            # 0, 1: the slots' rows; from 2 on the planes' and lights' sums
            _close_rows(a, b, q, CARD_GRAD_RTOL if q < 2 else CARD_SUM_RTOL)
    # no float atomics: the same call gives the same bits
    again = ts.soft_composite_bwd(o, d, rows, valid, m_rows, lights, pl_n,
                                  pl_off, pl_m, out, t_min, den, g, bw,
                                  gamma, t_bg, geometry)
    for a, b in zip(got_b, again):
        assert (a is None and b is None) or torch.equal(a, b)
    return live


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [False, True], ids=["plain", "geometry"])
def test_kernels_at_the_cell_shapes(geometry):
    """c5_grid4096_soft512: 4096 spheres, three 512x512 views, 16x16
    tiles, K as the cell sizes it (320-352), bw 0.5, gamma 0.6."""
    dev = _card()
    for view in _card_views(dev, 64, 512, 16, 0.5):
        assert int(view[-1].max()) <= view[2].shape[1]
        assert _check_view(view, 0.5, 0.6, 200.0, geometry, 64) > 0


@pytest.mark.cuda
def test_kernels_at_32x32_tiles_and_on_the_dense_pass():
    """The 2048x2048 stage's tiles (32x32: four chunks of 256 rays a tile)
    at 512x512, and the dense pass (one tile of every ray, every sphere)
    on a 16x16 grid at 128x128."""
    dev = _card()
    for view in _card_views(dev, 64, 512, 32, 0.09, views=(0.0,)):
        _check_view(view, 0.09, 0.1, 200.0, False, 16)
    for view in _card_views(dev, 16, 128, None, 0.5, views=(0.0,)):
        _check_view(view, 0.5, 0.6, 200.0, True, 1)


@pytest.mark.cuda
def test_kernels_on_empty_full_and_overflowing_tiles():
    """Survivor lists cut to a K that some tile's count equals, at 16x16
    tiles of a 512x512 view: tiles with none, with exactly K and with more
    (overflow: the first K kept)."""
    dev = _card()
    found = _card_views(dev, 64, 512, 16, 0.5, views=(0.0,))[0][-1]
    counts = torch.unique(found[found > 0])
    k = int(counts[len(counts) // 2])
    view = _card_views(dev, 64, 512, 16, 0.5, k=k, views=(0.0,))[0]
    found = view[-1]
    assert bool((found == 0).any()) and bool((found == k).any()) \
        and bool((found > k).any())
    _check_view(view, 0.5, 0.6, 200.0, True, 64)


@pytest.mark.cuda
def test_a_soft_step_launches_each_kernel_once_a_view():
    """A three-view soft fit step at the cell's shapes: one forward and one
    backward launch a view, no recompute span, soft_rays three views of
    rays, and two identical steps give the same gradients bit for bit."""
    from torch.profiler import ProfilerActivity, profile

    from openglraytracer_tpu_torch import kernels
    from openglraytracer_tpu_torch.train import inverse
    from openglraytracer_tpu_torch.utils import profiling
    dev = _card()
    true, cam = tb.sphere_grid_scene(64, seed=1, device=dev)
    cams = tuple(_orbit(cam, v) for v in (0.0, 45.0, -45.0))
    specs = tuple(ts.suggest_soft_cull(true, c, 512, 512, (16, 16), 0.5,
                                       headroom=2.0) for c in cams)
    with torch.no_grad():
        target = torch.stack([ts.soft_render(true, c, 512, 512, bw=0.5,
                                             gamma=0.6, cull=s)
                              for c, s in zip(cams, specs)])
    start = true._replace(spheres=true.spheres._replace(
        center=true.spheres.center + 0.05))
    cfg = inverse.FitConfig(height=512, width=512, soft=(0.5, 0.6),
                            cull=specs)
    init_fn, step_fn = inverse.make_train_step(
        cams, cfg, optimizer=lambda ps: torch.optim.SGD(ps, lr=0.0))
    grads = []
    for traced in (False, True):
        params, opt = init_fn(start)
        before = dict(kernels.LAUNCHES)
        if traced:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                step_fn(params, opt, start, target)
            rec = profiling.record()
            names = {(s.layer, s.name) for s in rec.spans}
            assert ("soft_composite", "recompute") not in names
            assert rec.counters["soft_rays"].value == 3 * 512 * 512
        else:
            step_fn(params, opt, start, target)
        torch.cuda.synchronize()
        for name in ("soft_composite", "soft_composite_bwd"):
            assert kernels.LAUNCHES[name] - before.get(name, 0) == 3, name
        grads.append({k: v.grad.clone() for k, v in params.items()})
    # the step's gradients fold the kernels' rows through index_select's
    # backward (index_add_, whose atomics may add in another order):
    # under deterministic algorithms the whole step is bit-identical
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = []
        for _ in range(2):
            params, opt = init_fn(start)
            step_fn(params, opt, start, target)
            runs.append({k: v.grad.clone() for k, v in params.items()})
    finally:
        torch.use_deterministic_algorithms(False)
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k
        _close_rows(grads[0][k], runs[0][k], k)
