"""PyTorch port: the soft-coverage forward (ops/soft.py) and the soft fit
against the JAX package's ops/soft.py, on the same seeded inputs, and the
port counterparts of the reference's own tests/test_soft.py.

Tolerances (measured on the CPU): on the same rays the port's
soft_render_rays equals the JAX package's run op by op to 3e-6 (torch's and
XLA's rsqrt, exp and log round an ulp apart on a few per cent of inputs):
atol 1e-5, and its gradients to SOFT_GRAD_TOL of max|g|. Against the
jitted soft_render (the reference's entry point) the images differ by up
to 2.5e-4 and the gradients by up to 1.3e-3 of max|g|: XLA contracts the
multiply-adds of the cancellation-prone r^2 - (|oc|^2 - b^2) into fused
ones under jit, which the port, like the JAX package run op by op, does
not; JIT_ATOL and JIT_GRAD_TOL hold those."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openglraytracer_tpu.models.builders import sphere_grid_scene
from openglraytracer_tpu.ops import accel as ja
from openglraytracer_tpu.ops import soft as js
from openglraytracer_tpu.ops.raygen import generate_rays as j_rays
from openglraytracer_tpu.train import inverse as jinv
from openglraytracer_tpu_torch.models import builders as tb
from openglraytracer_tpu_torch.ops import soft as ts
from openglraytracer_tpu_torch.ops.intersect import closest_hit
from openglraytracer_tpu_torch.ops.raygen import generate_rays
from openglraytracer_tpu_torch.ops.shading import phong_shade_lit
from openglraytracer_tpu_torch.train import inverse as tinv

from _torch_helpers import np_, to_torch, to_torch_camera, to_torch_scene

H = W = 64
TILE = (16, 16)
OP_ATOL, SOFT_GRAD_TOL = 1e-5, 1e-4
JIT_ATOL, JIT_GRAD_TOL = 5e-4, 3e-3
TRAINABLE = ("spheres.center", "spheres.radius", "materials.diffuse")
# (grid side, bw, gamma): a sharp and a broad coverage band
CASES = {"side4_sharp": (4, 0.03, 0.15), "side8_broad": (8, 0.5, 0.6)}


@functools.cache
def _case(name):
    side, bw, gamma = CASES[name]
    scene, cam = sphere_grid_scene(side)
    spec = js.suggest_soft_cull(scene, cam, H, W, TILE, bw)
    return scene, cam, bw, gamma, spec


def _rays(cam, tiled):
    """The JAX package's rays (raster or tile-major) as numpy arrays."""
    o, d = j_rays(cam, H, W)
    if tiled:
        o, d = ja.tile_image(o, *TILE), ja.tile_image(d, *TILE)
    return np.array(o).reshape(-1, 3), np.array(d).reshape(-1, 3)


def _with_params(scene, params, lib):
    """scene with the trainable leaves replaced (JAX or port)."""
    apply = jinv.apply_params if lib == "jax" else tinv.apply_params
    return apply(scene, params)


@pytest.mark.parametrize("culled", [False, True], ids=["dense", "culled"])
@pytest.mark.parametrize("name", list(CASES))
def test_soft_render_rays_matches_jax(name, culled):
    """Image and gradients of soft_render_rays on the same rays against the
    JAX package run op by op: the image to OP_ATOL, each leaf's gradient
    of an MSE to SOFT_GRAD_TOL * max|g|; the overflow count equal (0)."""
    scene, cam, bw, gamma, spec = _case(name)
    cull = spec if culled else None
    o, d = _rays(cam, culled)
    target = np.random.default_rng(5).random(o.shape).astype(np.float32)

    def j_loss(params):
        img, ovf = js.soft_render_rays(
            _with_params(scene, params, "jax"), jnp.asarray(o),
            jnp.asarray(d), bw=bw, gamma=gamma, cull=cull,
            with_cull_stats=True)
        return jnp.mean(jnp.square(img - target)), (img, ovf)

    start = {k: jnp.asarray(v) for k, v in
             jinv.extract_params(scene, TRAINABLE).items()}
    with jax.disable_jit():
        (_, (img_j, ovf_j)), g_j = jax.value_and_grad(
            j_loss, has_aux=True)(start)

    tscene = to_torch_scene(scene)
    params = {k: torch.from_numpy(np.array(v)).requires_grad_()
              for k, v in start.items()}
    img_t, ovf_t = ts.soft_render_rays(
        _with_params(tscene, params, "torch"), *to_torch(o, d), bw=bw,
        gamma=gamma, cull=cull, with_cull_stats=True)
    torch.mean(torch.square(img_t - torch.from_numpy(target))).backward()

    assert ovf_t.dtype == torch.int32 and int(ovf_t) == int(ovf_j) == 0
    np.testing.assert_allclose(np_(img_t), np_(img_j), rtol=0, atol=OP_ATOL)
    for k in TRAINABLE:
        a, b = np_(g_j[k]), np_(params[k].grad)
        scale = float(np.abs(a).max())
        assert scale > 0.0, k
        np.testing.assert_allclose(b, a, rtol=0, atol=SOFT_GRAD_TOL * scale,
                                   err_msg=f"gradient of {k}")


@pytest.mark.parametrize("culled", [False, True], ids=["dense", "culled"])
@pytest.mark.parametrize("name", list(CASES))
def test_soft_render_matches_jitted_jax(name, culled):
    """soft_render from the camera (the port's own rays, bit-equal to the
    reference's) against the reference's jitted soft_render, with the
    overflow count: the image to JIT_ATOL."""
    scene, cam, bw, gamma, spec = _case(name)
    cull = spec if culled else None
    img_j, ovf_j = js.soft_render(scene, cam, H, W, bw=bw, gamma=gamma,
                                  cull=cull, with_cull_stats=True)
    img_t, ovf_t = ts.soft_render(to_torch_scene(scene),
                                  to_torch_camera(cam), H, W, bw=bw,
                                  gamma=gamma, cull=cull,
                                  with_cull_stats=True)
    assert int(ovf_t) == int(ovf_j) == 0
    assert tuple(img_t.shape) == (H, W, 3)
    np.testing.assert_allclose(np_(img_t), np_(img_j), rtol=0,
                               atol=JIT_ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_suggest_soft_cull_matches_jax(name):
    scene, cam, bw, _, spec = _case(name)
    for headroom in (1.5, 2.0):
        assert ts.suggest_soft_cull(
            to_torch_scene(scene), to_torch_camera(cam), H, W, TILE, bw,
            headroom=headroom) == js.suggest_soft_cull(
                scene, cam, H, W, TILE, bw, headroom=headroom)


def test_tile_blocks_equal_one_block():
    """The tile blocks (each under torch.utils.checkpoint when autograd
    records) give the image of a single block bit for bit, and its
    gradients but for the order in which the blocks' shares of the
    materials and lights add up."""
    scene, cam, bw, gamma, spec = _case("side8_broad")
    o, d = to_torch(*_rays(cam, True))
    tscene = to_torch_scene(scene)
    outs = []
    for block in (16, 1, 2, 0):
        params = {k: v.clone().requires_grad_() for k, v in
                  tinv.extract_params(tscene, TRAINABLE).items()}
        img = ts.soft_render_rays(_with_params(tscene, params, "torch"), o,
                                  d, bw=bw, gamma=gamma, cull=spec,
                                  tile_block=block)
        torch.mean(torch.square(img)).backward()
        outs.append((img.detach(), [params[k].grad for k in TRAINABLE]))
    for img, grads in outs[1:]:
        assert torch.equal(img, outs[0][0])
        for a, b in zip(grads, outs[0][1]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-9)


# --- the port counterparts of the reference's tests/test_soft.py ----------

def _hard_shadowless(scene, cam, h, w):
    """Exact nearest hit and Phong with every shadow off: the hard limit of
    the shadowless soft forward."""
    o, d = generate_rays(cam, h, w)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    hit = closest_hit(scene, o, d)
    occ = torch.zeros((o.shape[0], scene.lights.count), dtype=torch.bool)
    col = phong_shade_lit(scene, d, hit, occ)
    return torch.where(hit.hit[:, None], col, 0.0).reshape(h, w, 3)


@torch.no_grad()
def test_hard_limit_matches_shadowless_render():
    scene, cam = tb.single_sphere_scene(device="cpu")
    want = np_(_hard_shadowless(scene, cam, 48, 48))
    got = np_(ts.soft_render(scene, cam, 48, 48, bw=1e-5, gamma=1e-3))
    err = np.abs(got - want).max(-1)
    assert (err < 1e-3).mean() > 0.995, f"max {err.max()}"


@torch.no_grad()
def test_sharp_grid_matches_shadowless_render():
    scene, cam = tb.sphere_grid_scene(4, device="cpu")
    want = np_(_hard_shadowless(scene, cam, 64, 64))
    got = np_(ts.soft_render(scene, cam, 64, 64, bw=1e-5, gamma=1e-3))
    err = np.abs(got - want).max(-1)
    assert (err < 1e-3).mean() > 0.98, f"frac {(err < 1e-3).mean()}"
    assert err.max() < 5e-3, f"max {err.max()}"


def test_soft_loss_matches_finite_differences():
    """d(loss)/d(center) is a true derivative of the soft objective,
    coverage change included: float64 finite differences agree (the
    reference's check_grads, atol and rtol 1e-3)."""
    scene, cam = tb.single_sphere_scene(device="cpu")

    def f64(part):
        return part._replace(**{k: v.double() for k, v in part._asdict()
                                .items() if v.is_floating_point()})
    scene = scene._replace(**{k: f64(getattr(scene, k))
                              for k in scene._fields})
    cam = f64(cam)
    with torch.no_grad():
        target = ts.soft_render(scene, cam, 32, 32, bw=0.05, gamma=0.2)

    def loss(center):
        s = scene._replace(spheres=scene.spheres._replace(center=center))
        img = ts.soft_render(s, cam, 32, 32, bw=0.05, gamma=0.2)
        return torch.mean(torch.square(img - target))

    c64 = (scene.spheres.center + 0.11).requires_grad_()
    assert torch.autograd.gradcheck(loss, (c64,), atol=1e-3, rtol=1e-3)


def test_silhouette_gradient_points_home():
    """A sphere displaced past its own silhouette: the soft loss's gradient
    with respect to the x-center pushes it back."""
    scene, cam = tb.single_sphere_scene(device="cpu")
    with torch.no_grad():
        target = ts.soft_render(scene, cam, 48, 48, bw=0.05, gamma=0.2)
    c = (scene.spheres.center + torch.tensor([0.6, 0.0, 0.0])) \
        .requires_grad_()
    s = scene._replace(spheres=scene.spheres._replace(center=c))
    torch.mean(torch.square(
        ts.soft_render(s, cam, 48, 48, bw=0.05, gamma=0.2) - target)) \
        .backward()
    assert float(c.grad[0, 0]) > 0.0, "the gradient must push it back (-x)"


@torch.no_grad()
@pytest.mark.parametrize("k_full", [True, False])
def test_culled_matches_dense(k_full):
    scene, cam = tb.sphere_grid_scene(4, device="cpu")
    cull = ((TILE, int(scene.spheres.count)) if k_full else
            ts.suggest_soft_cull(scene, cam, H, W, TILE, bw=0.03))
    dense = np_(ts.soft_render(scene, cam, H, W, bw=0.03, gamma=0.15))
    culled, ovf = ts.soft_render(scene, cam, H, W, bw=0.03, gamma=0.15,
                                 cull=cull, with_cull_stats=True)
    assert int(ovf) == 0
    # culling drops only spheres with alpha below the sigmoid reach
    np.testing.assert_allclose(np_(culled), dense, atol=2e-3)


@torch.no_grad()
def test_overflow_counted_never_silent():
    """k = 2 survivors a tile: the count equals the JAX package's."""
    scene, cam = sphere_grid_scene(4)
    _, ovf_j = js.soft_render(scene, cam, H, W, bw=0.03, gamma=0.15,
                              cull=(TILE, 2), with_cull_stats=True)
    _, ovf_t = ts.soft_render(to_torch_scene(scene), to_torch_camera(cam),
                              H, W, bw=0.03, gamma=0.15, cull=(TILE, 2),
                              with_cull_stats=True)
    assert int(ovf_t) == int(ovf_j) > 0


def test_expand_factor_covers_sigmoid_reach():
    bw = 0.04
    f = ts.expand_factor(bw)
    assert abs((1.0 - f * f) / bw + 8.0) < 1e-6
    assert f == js.expand_factor(bw)
    assert (ts._LOGIT_REACH, ts._T_EPS, ts._ALPHA_CUT) == (
        js._LOGIT_REACH, js._T_EPS, js._ALPHA_CUT)


def test_boxes_rejected():
    from openglraytracer_tpu_torch.models.animated import reference_frame
    scene, cam = reference_frame(1.0, device="cpu")
    o, d = generate_rays(cam, 8, 8)
    with pytest.raises(ValueError, match="spheres\\+planes"):
        ts.soft_render_rays(scene, o.reshape(-1, 3), d.reshape(-1, 3),
                            bw=0.05, gamma=0.2)


# --- the soft fit ---------------------------------------------------------

def _orbit(cam, phi_deg, lib):
    """cam orbited phi degrees about the world z axis, as
    scripts/c5_fit_acceptance.py orbits its views."""
    phi = math.radians(phi_deg)
    x, y, z = (float(v) for v in np_(cam.position))
    pos = (x * math.cos(phi) - y * math.sin(phi),
           x * math.sin(phi) + y * math.cos(phi), z)
    a = np_(cam.angles)
    ang = (float(a[0]), float(a[1]) + phi_deg, float(a[2]))
    if lib == "jax":
        return cam._replace(position=jnp.asarray(pos, jnp.float32),
                            angles=jnp.asarray(ang, jnp.float32))
    return cam._replace(position=torch.tensor(pos, dtype=torch.float32),
                        angles=torch.tensor(ang, dtype=torch.float32))


@pytest.mark.parametrize("views", [1, 3])
def test_soft_fit_step_matches_jax(views):
    """One SGD step of make_train_step's soft fit, one view or three
    orbited views (the targets stacked (V, H, W, 3), the loss the mean of
    the per-view MSEs), against the JAX package's jitted step from the same
    start: the loss to 1e-5 relative, the overflow equal, and the step
    p0 - p1, the gradient at lr 1 (a float32 parameter resolves it to 1e-4
    of max|g|), to JIT_GRAD_TOL * max|g| per leaf."""
    scene, cam = sphere_grid_scene(4)
    bw, gamma, lr = 0.1, 0.3, 1.0
    true_j = scene
    init = scene._replace(spheres=scene.spheres._replace(
        center=scene.spheres.center + jnp.asarray(
            np.random.default_rng(2).normal(0, 0.15, (16, 3)), jnp.float32)))
    phis = (0.0, 45.0, -45.0)[:views]
    cams_j = tuple(_orbit(cam, p, "jax") for p in phis)
    cams_t = tuple(_orbit(to_torch_camera(cam), p, "torch") for p in phis)
    culls = tuple(js.suggest_soft_cull(true_j, c, H, W, TILE, bw,
                                       headroom=2.0) for c in cams_j)
    target = jnp.stack([js.soft_render(true_j, c, H, W, bw=bw, gamma=gamma,
                                       cull=cu)
                        for c, cu in zip(cams_j, culls)])
    cam_j = cams_j if views > 1 else cams_j[0]
    cam_t = cams_t if views > 1 else cams_t[0]
    cull = culls if views > 1 else culls[0]
    tgt = target if views > 1 else target[0]

    cfg_j = jinv.FitConfig(height=H, width=W, soft=(bw, gamma), cull=cull,
                           trainable=TRAINABLE)
    init_j, step_j = jinv.make_train_step(cam_j, cfg_j,
                                          optimizer=optax.sgd(lr))
    p0_j, opt_j = init_j(init)
    start = {k: np.array(v) for k, v in p0_j.items()}
    p1_j, _, loss_j, ovf_j = step_j(p0_j, opt_j, init, tgt)

    cfg_t = tinv.FitConfig(height=H, width=W, soft=(bw, gamma), cull=cull,
                           trainable=TRAINABLE)
    init_t, step_t = tinv.make_train_step(
        cam_t, cfg_t, optimizer=lambda ps: torch.optim.SGD(ps, lr=lr))
    p_t, opt_t = init_t(to_torch_scene(init))
    p_t, _, loss_t, ovf_t = step_t(p_t, opt_t, to_torch_scene(init),
                                   torch.from_numpy(np.array(tgt)))

    assert int(ovf_t) == int(ovf_j) == 0
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    for k in TRAINABLE:
        g_j = (start[k] - np_(p1_j[k])) / lr
        g_t = (start[k] - np_(p_t[k])) / lr
        scale = float(np.abs(g_j).max())
        assert scale > 0.0, k
        np.testing.assert_allclose(g_t, g_j, rtol=0,
                                   atol=JIT_GRAD_TOL * scale,
                                   err_msg=f"step of {k}")


def test_soft_fit_recovers_displaced_center():
    """An annealed soft curriculum recovers a displacement that the hard
    engine's straight-through gradient stalls on (the reference's
    integration test, at its sizes)."""
    scene_true, cam = tb.single_sphere_scene(device="cpu")
    h = w = 48
    shift = torch.tensor([[0.45, 0.0, 0.25]])
    scene_fit = scene_true._replace(spheres=scene_true.spheres._replace(
        center=scene_true.spheres.center + shift))
    err0 = float(torch.linalg.norm(shift))
    for bw, gamma, steps, lr in ((0.08, 0.4, 60, 3e-2),
                                 (0.02, 0.1, 60, 1e-2)):
        with torch.no_grad():
            target = ts.soft_render(scene_true, cam, h, w, bw=bw,
                                    gamma=gamma)
        cfg = tinv.FitConfig(height=h, width=w, steps=steps,
                             learning_rate=lr, trainable=("spheres.center",),
                             soft=(bw, gamma), log_every=1000)
        scene_fit, _ = tinv.fit(scene_fit, target, cam, cfg)
    err1 = float(torch.linalg.norm(
        scene_fit.spheres.center - scene_true.spheres.center))
    assert err1 < 0.25 * err0, f"soft fit: {err0:.3f} -> {err1:.3f}"


def test_soft_fit_rejects_mesh_and_hard_multi_view():
    scene, cam = tb.single_sphere_scene(device="cpu")
    with pytest.raises(ValueError, match="unsharded"):
        tinv.make_train_step(cam, tinv.FitConfig(height=16, width=16,
                                                 soft=(0.05, 0.2)),
                             mesh=object())
    with pytest.raises(ValueError, match="multi-view"):
        tinv.make_train_step((cam, cam), tinv.FitConfig(height=16,
                                                        width=16))
