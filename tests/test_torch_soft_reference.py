"""PyTorch port: the soft-coverage forward (ops/soft.py soft_render) and the
multi-view soft fit step (train/inverse.py make_train_step with
FitConfig.soft) held to the benchmark's plain soft reference
(benchmark/reference/soft.py), which is written from the equations in plain
float32 PyTorch and shares no code with the port. A seeded 4x4 sphere grid
at 64x64, three views orbited 0, +45 and -45 degrees about world z, the
config-5 soft stage's (bw, gamma) and 16x16 tiles, on the culled and the
dense soft pass.

Tolerances, with their reasons (measured on the CPU): the port makes its
camera rays through its float32 camera inverse and the reference in
float64, rounded once; the two ray sets lie up to ~5e-6 rad apart, which
moves a pixel by the image's slope times that: up to 5.0e-4 of a channel
where a ray runs along a sphere's edge (IMAGE_ATOL, three times that). The
loss averages those over every pixel: 5e-6 relative (LOSS_RTOL, ten
times). A gradient row of a sphere seen near its silhouette carries
dt/d(disc) = 1/(2 sqrt(disc)), which magnifies rounding: the reference
itself moves its center and radius gradients by 2.3e-3 and 1.8e-3 of their
norm between float32 and float64 on the same rays, and by as much between
the two ray sets (GRAD_RTOL, each leaf's gap over its norm, 1e-2). Given
the port's own rays, the reference follows the port's loss to 1.1e-7 and
its gradients to 1.4e-6 of their norm (SAME_RAYS_RTOL).
"""

import math

import pytest
import torch

from benchmark.reference import soft as ref
from benchmark.reference import tracer
from openglraytracer_tpu_torch.models import builders as tb
from openglraytracer_tpu_torch.ops import soft as ts
from openglraytracer_tpu_torch.ops.raygen import generate_rays
from openglraytracer_tpu_torch.train import inverse as tinv

H = W = 64
TILE = (16, 16)
BW, GAMMA, T_BG = 0.5, 0.6, 200.0
VIEWS = (0.0, 45.0, -45.0)
TRAINABLE = ("spheres.center", "spheres.radius", "materials.diffuse")
PLAIN = {"spheres.center": "center", "spheres.radius": "radius",
         "materials.diffuse": "diffuse"}
IMAGE_ATOL = 1.5e-3
LOSS_RTOL = 5e-5
GRAD_RTOL = 1e-2
# on the port's own rays the reference follows the port to rounding
SAME_RAYS_RTOL = 1e-4
# the port against itself in other blocks: a leaf's gradient rows sum
# over the blocks in another order (1.2e-7 of the norm measured, one tile
# a block)
BLOCK_RTOL = 1e-6


def _orbit(cam, phi_deg):
    phi = math.radians(phi_deg)
    x, y, z = (float(v) for v in cam.position)
    pos = (x * math.cos(phi) - y * math.sin(phi),
           x * math.sin(phi) + y * math.cos(phi), z)
    a = [float(v) for v in cam.angles]
    return cam._replace(position=torch.tensor(pos),
                        angles=torch.tensor([a[0], a[1] + phi_deg, a[2]]))


def _plain_scene(scene):
    """The port's Scene as the reference's plain tensors."""
    m, lt = scene.materials, scene.lights
    return dict(center=scene.spheres.center, radius=scene.spheres.radius,
                sphere_material=scene.spheres.material_id,
                plane_normal=scene.planes.normal,
                plane_offset=scene.planes.offset,
                plane_material=scene.planes.material_id,
                ambient=m.ambient, diffuse=m.diffuse, specular=m.specular,
                emissive=m.emissive, shininess=m.shininess,
                light_position=lt.position, light_ambient=lt.ambient,
                light_diffuse=lt.diffuse, light_specular=lt.specular)


def _plain_camera(cam):
    return dict(position=cam.position, angles=cam.angles, v_fov=cam.v_fov,
                aspect=cam.aspect)


def _world(seed=3):
    scene, cam = tb.sphere_grid_scene(4, seed=seed, device="cpu")
    cams = tuple(_orbit(cam, v) for v in VIEWS)
    return scene, cams


def _culls(scene, cams, culled):
    if not culled:
        return (None,) * len(cams)
    return tuple(ts.suggest_soft_cull(scene, c, H, W, TILE, BW,
                                      headroom=2.0) for c in cams)


@pytest.mark.parametrize("culled", [True, False], ids=["culled", "dense"])
def test_soft_render_matches_reference(culled):
    scene, cams = _world()
    culls = _culls(scene, cams, culled)
    with torch.no_grad():
        got = torch.stack([
            ts.soft_render(scene, c, H, W, bw=BW, gamma=GAMMA, cull=cu,
                           t_bg=T_BG) for c, cu in zip(cams, culls)])
    want = ref.render(_plain_scene(scene), [_plain_camera(c) for c in cams],
                      H, W, BW, GAMMA, T_BG, dense=not culled)
    assert float(want.amax()) > 0.2        # the spheres and the ground lit
    torch.testing.assert_close(got, want, rtol=0.0, atol=IMAGE_ATOL)


def _start(true):
    """The fit script's start: the true scene perturbed by seeded noise."""
    g = torch.Generator().manual_seed(11)
    sph, mats = true.spheres, true.materials
    return true._replace(
        spheres=sph._replace(
            center=sph.center + 0.1 * torch.randn(sph.center.shape,
                                                  generator=g),
            radius=torch.clamp(sph.radius + 0.05 * torch.randn(
                sph.radius.shape, generator=g), min=0.1)),
        materials=mats._replace(diffuse=torch.clamp(
            mats.diffuse + 0.3 * torch.randn(mats.diffuse.shape,
                                              generator=g), 0.0, 1.0)))


def _port_step(true, start, cams, culls):
    """(loss, gradients, the port's target) of the port's first soft step:
    SGD at rate 0 leaves each gradient on its leaf."""
    with torch.no_grad():
        target = torch.stack([
            ts.soft_render(true, c, H, W, bw=BW, gamma=GAMMA, cull=cu)
            for c, cu in zip(cams, culls)])
    cfg = tinv.FitConfig(height=H, width=W, soft=(BW, GAMMA), cull=culls,
                         trainable=TRAINABLE)
    init_fn, step_fn = tinv.make_train_step(
        cams, cfg, optimizer=lambda ps: torch.optim.SGD(ps, lr=0.0))
    params, opt = init_fn(start)
    params, opt, loss, ovf = step_fn(params, opt, start, target)
    assert int(ovf) == 0
    return float(loss), {k: params[k].grad for k in TRAINABLE}, target


def _ref_step(start, cams, target, culled):
    p_start = _plain_scene(start)
    loss, grads = ref.loss_and_grads(
        p_start, [_plain_camera(c) for c in cams], H, W, target,
        {PLAIN[k]: p_start[PLAIN[k]] for k in TRAINABLE}, BW, GAMMA, T_BG,
        dense=not culled)
    assert float(loss) > 1e-3
    return float(loss), {k: grads[PLAIN[k]] for k in TRAINABLE}


def _gaps(got, want):
    return {k: float((got[k] - want[k]).norm() / want[k].norm())
            for k in TRAINABLE}


@pytest.mark.parametrize("culled", [True, False], ids=["culled", "dense"])
def test_soft_fit_step_matches_reference(culled):
    """The first step's loss and its gradients of the centers, radii and
    diffuse colours, from a perturbed start toward the true scene's soft
    render over the three views, each side with its own target."""
    true, cams = _world()
    culls = _culls(true, cams, culled)
    start = _start(true)
    loss, grads, _ = _port_step(true, start, cams, culls)
    want_target = ref.render(_plain_scene(true),
                             [_plain_camera(c) for c in cams], H, W, BW,
                             GAMMA, T_BG, dense=not culled)
    want_loss, want_grads = _ref_step(start, cams, want_target, culled)
    assert abs(loss - want_loss) <= LOSS_RTOL * want_loss
    gaps = _gaps(grads, want_grads)
    assert max(gaps.values()) <= GRAD_RTOL, gaps


@pytest.mark.parametrize("culled", [True, False], ids=["culled", "dense"])
def test_soft_fit_step_on_the_ports_rays_matches_reference(culled,
                                                             monkeypatch):
    """The same step with the reference given the port's camera rays and
    the port's target: what is left is the rounding of two float32
    evaluations of the same equations."""
    true, cams = _world()
    culls = _culls(true, cams, culled)
    start = _start(true)
    loss, grads, target = _port_step(true, start, cams, culls)

    def port_rays(camera, height, width):
        cam = next(c for c in cams if torch.equal(c.angles,
                                                  camera["angles"]))
        origins, dirs = generate_rays(cam, height, width)
        return origins.reshape(-1, 3)[0].double(), dirs.double()

    monkeypatch.setattr(tracer, "camera_rays", port_rays)
    want_loss, want_grads = _ref_step(start, cams, target, culled)
    assert abs(loss - want_loss) <= SAME_RAYS_RTOL * want_loss
    gaps = _gaps(grads, want_grads)
    assert max(gaps.values()) <= SAME_RAYS_RTOL, gaps


@pytest.mark.parametrize("block_pairs", [1, 100_000],
                         ids=["tile_a_block", "several_tiles_a_block"])
def test_block_size_changes_no_number_of_the_step(block_pairs):
    """make_train_step's soft_block_pairs only splits the culled soft
    forward into checkpointed blocks: the image is the same, bit for bit,
    and the gradients differ from the one-block step only by the order in
    which a leaf's rows sum over the blocks (float32 rounding,
    BLOCK_RTOL)."""
    true, cams = _world()
    culls = _culls(true, cams, True)
    start = _start(true)
    with torch.no_grad():
        target = torch.stack([
            ts.soft_render(true, c, H, W, bw=BW, gamma=GAMMA, cull=cu)
            for c, cu in zip(cams, culls)])
        split = torch.stack([
            ts.soft_render(true, c, H, W, bw=BW, gamma=GAMMA, cull=cu,
                           block_pairs=block_pairs)
            for c, cu in zip(cams, culls)])
    assert torch.equal(split, target)

    def step(pairs):
        cfg = tinv.FitConfig(height=H, width=W, soft=(BW, GAMMA),
                             cull=culls, trainable=TRAINABLE)
        init_fn, step_fn = tinv.make_train_step(
            cams, cfg, optimizer=lambda ps: torch.optim.SGD(ps, lr=0.0),
            soft_block_pairs=pairs)
        params, opt = init_fn(start)
        params, opt, loss, ovf = step_fn(params, opt, start, target)
        assert int(ovf) == 0
        return float(loss), {k: params[k].grad for k in TRAINABLE}

    one_loss, one_grads = step(None)
    loss, grads = step(block_pairs)
    assert loss == one_loss
    gaps = _gaps(grads, one_grads)
    assert max(gaps.values()) <= BLOCK_RTOL, gaps
