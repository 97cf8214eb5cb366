"""PyTorch port: the inverse-rendering trainer (train/inverse.py) against the
JAX package's: parameter selection, one training step from the same start,
a fit whose loss falls, and the options not ported yet."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openglraytracer_tpu.models.builders import sphere_grid_scene
from openglraytracer_tpu.ops import accel as ja
from openglraytracer_tpu.ops.raygen import generate_rays as j_rays
from openglraytracer_tpu.train import inverse as jinv
from openglraytracer_tpu_torch.models import builders as tb
from openglraytracer_tpu_torch.ops import render as t_render_mod
from openglraytracer_tpu_torch.ops.accel import suggest_cull_config
from openglraytracer_tpu_torch.train import inverse as tinv

from _torch_helpers import np_, to_torch, to_torch_camera, to_torch_scene

H = W = 32
TRAINABLE = ("spheres.center", "spheres.radius", "materials.diffuse",
             "lights.position")
GEOMETRY_TOL = 2e-3


def test_extract_apply_round_trip():
    scene, _ = tb.sphere_grid_scene(2, device="cpu")
    params = tinv.extract_params(scene, tinv.DEFAULT_TRAINABLE)
    assert list(params) == list(tinv.DEFAULT_TRAINABLE)
    assert params["spheres.center"] is scene.spheres.center
    assert tinv.apply_params(scene, params) == scene
    moved = {k: v + 1.0 for k, v in params.items()}
    s2 = tinv.apply_params(scene, moved)
    for k in tinv.DEFAULT_TRAINABLE:
        assert torch.equal(tinv.get_path(s2, k), moved[k])
    assert s2.planes is scene.planes and s2.lights is scene.lights
    assert tinv.extract_params(s2, ("lights",))["lights"] is scene.lights


def test_train_step_matches_jax(monkeypatch):
    """One SGD step of make_train_step from the same start, against the JAX
    package's make_train_step (engine culled_pallas, its kernels in
    interpret mode), with trainable lights (so both cast every shadow). The
    port's render is handed the JAX package's rays: the two raygens differ
    by up to 2e-5 (tests/test_torch_culled.py), which would move the
    geometry gradients by about 1e-3 of their size. On the same rays: the
    loss to 1e-6 relative. Gradients per leaf to 1e-4 * max|g| as in
    tests/test_torch_geometry_vjp.py, except the spheres' (GEOMETRY_TOL):
    the JAX package's jitted step lets XLA contract the winner replay's
    multiply-adds, and its own jitted render and eager trace of the same
    rays differ there by up to 8.6e-4 * max|g| (measured), where the port
    matches the eager trace to 5e-6 * max|g|. The stepped parameters to the
    same bounds times the learning rate."""
    scene, cam = sphere_grid_scene(2, seed=7)
    spec = ja.suggest_cull_config(scene, cam, H, W, (16, 16), headroom=2.0)
    target = np.random.default_rng(3).random((H, W, 3)).astype(np.float32)
    lr = 1e-2

    cfg_j = jinv.FitConfig(height=H, width=W, engine="culled_pallas",
                           cull=spec, trainable=TRAINABLE)
    init_j, step_j = jinv.make_train_step(cam, cfg_j,
                                          optimizer=optax.sgd(lr))
    p0_j, opt_j = init_j(scene)
    start = {k: np.array(v) for k, v in p0_j.items()}
    p1_j, _, loss_j, ovf_j = step_j(p0_j, opt_j, scene, jnp.asarray(target))

    def loss_fn(params):
        from openglraytracer_tpu.ops.render import render
        img = render(jinv.apply_params(scene, params), cam, H, W,
                     engine="culled_pallas", cull=spec)
        return jnp.mean(jnp.square(img - target))
    g_j = jax.grad(loss_fn)({k: jnp.asarray(v) for k, v in start.items()})

    rays = to_torch(*j_rays(cam, H, W))
    monkeypatch.setattr(t_render_mod, "generate_rays", lambda *a: rays)
    ts, tc = to_torch_scene(scene), to_torch_camera(cam)
    cfg_t = tinv.FitConfig(height=H, width=W, engine="culled_pallas",
                           cull=spec, trainable=TRAINABLE)
    init_t, step_t = tinv.make_train_step(
        tc, cfg_t, optimizer=lambda ps: torch.optim.SGD(ps, lr=lr))
    p_t, opt_t = init_t(ts)
    for k in TRAINABLE:
        np.testing.assert_array_equal(np_(p_t[k]), start[k])
    p_t, opt_t, loss_t, ovf_t = step_t(p_t, opt_t, ts, torch.tensor(target))

    assert int(ovf_t) == int(ovf_j) == 0
    assert loss_t.dtype == torch.float32 and not loss_t.requires_grad
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    for k in TRAINABLE:
        a, b = np_(g_j[k]), np_(p_t[k].grad)
        scale = float(np.abs(a).max())
        assert scale > 0.0, k
        tol = (GEOMETRY_TOL if k.startswith("spheres.") else 1e-4) * scale
        np.testing.assert_allclose(b, a, rtol=0, atol=tol,
                                   err_msg=f"gradient of {k}")
        np.testing.assert_allclose(np_(p_t[k]), np_(p1_j[k]), rtol=1e-6,
                                   atol=lr * tol, err_msg=f"stepped {k}")


def test_fit_reduces_loss():
    """fit from perturbed sphere centers (numpy noise) at 48x48 halves the
    loss in 100 Adam steps, as the JAX package's own fit test asks of it
    (tests/test_train.py)."""
    h = w = 48
    scene, cam = tb.sphere_grid_scene(2, seed=7, device="cpu")
    spec = suggest_cull_config(scene, cam, h, w, (16, 16), headroom=2.0)
    with torch.no_grad():
        target = t_render_mod.render(scene, cam, h, w,
                                     engine="culled_pallas", cull=spec)
    noise = np.random.default_rng(3).normal(0, 1, (4, 3)).astype(np.float32)
    init = scene._replace(spheres=scene.spheres._replace(
        center=scene.spheres.center + 0.25 * torch.from_numpy(noise)))
    cfg = tinv.FitConfig(height=h, width=w, steps=100, learning_rate=3e-2,
                         log_every=10, trainable=("spheres.center",),
                         engine="culled_pallas", cull=spec)
    seen = []
    fitted, losses = tinv.fit(init, target, cam, cfg,
                              callback=lambda s, v: seen.append(s))
    assert [s for s, _ in losses] == seen == list(range(0, 100, 10)) + [99]
    assert losses[-1][1] < 0.5 * losses[0][1], losses
    assert not fitted.spheres.center.requires_grad
    delta = (fitted.spheres.center - init.spheres.center).abs().max()
    assert float(delta) > 1e-3
    assert fitted.spheres.radius is init.spheres.radius


def test_trainable_lights_cast_every_shadow(monkeypatch):
    """A light with zero diffuse and specular casts no shadow rays when the
    lights are frozen (static_shadow_mask), and does when a light leaf is
    trainable: training could make it matter."""
    scene, cam = tb.sphere_grid_scene(2, device="cpu")
    lights = scene.lights
    scene = scene._replace(lights=lights._replace(
        diffuse=torch.cat([lights.diffuse[:1], 0 * lights.diffuse[1:]]),
        specular=torch.cat([lights.specular[:1], 0 * lights.specular[1:]])))
    spec = suggest_cull_config(scene, cam, H, W, (16, 16))
    masks = []
    real = t_render_mod.render
    monkeypatch.setattr(tinv, "render", lambda *a, **k: (
        masks.append(k["shadow_lights"]), real(*a, **k))[1])
    target = torch.zeros((H, W, 3))
    for trainable in (("spheres.center",), ("lights.diffuse",)):
        cfg = tinv.FitConfig(height=H, width=W, engine="culled_pallas",
                             cull=spec, trainable=trainable)
        init_fn, step_fn = tinv.make_train_step(cam, cfg)
        step_fn(*init_fn(scene), scene, target)
    assert masks == [(True, False), (True, True)]


@pytest.mark.parametrize("depth", [0, 1])
def test_fit_charges_rays_with_the_static_bounce_mask(monkeypatch, depth):
    """fit logs mrays_per_s from rays_per_frame. At depth > 0 it charges
    the branches that can contribute, static_bounce_mask(scene), as the
    JAX package's fit does: a mirror-only scene casts a reflection child
    and no refraction child. At depth 0 the mask is (True, True)."""
    from openglraytracer_tpu_torch.ops.shading import static_bounce_mask
    from openglraytracer_tpu_torch.utils import metrics
    scene, cam = tb.sphere_grid_scene(2, reflectivity=0.6, device="cpu")
    assert static_bounce_mask(scene) == (True, False)
    masks = []
    real = metrics.rays_per_frame
    monkeypatch.setattr(metrics, "rays_per_frame", lambda *a, **k: (
        masks.append(k["bounce_mask"]), real(*a, **k))[1])
    cfg = tinv.FitConfig(height=8, width=8, depth=depth, steps=1,
                         engine="pallas", trainable=("spheres.center",))
    tinv.fit(scene, torch.zeros((8, 8, 3)), cam, cfg)
    assert masks == [(True, False) if depth else (True, True)]


@pytest.mark.parametrize("change", [
    dict(soft=(0.3, 0.3), mesh=object()), dict(views=2), dict(row_block=8),
    dict(engine="soft"), dict(cull=None), dict(mesh=object())])
def test_make_train_step_rejects_unported(change):
    """What the port rejects: the sharded fit (mesh, slice 8), also with
    soft; a hard fit over several cameras; an unknown engine; a culled
    engine without a spec or with row_block."""
    scene, cam = tb.sphere_grid_scene(2, device="cpu")
    mesh = change.pop("mesh", None)
    if change.pop("views", None):
        cam = (cam, cam)
    kw = dict(height=H, width=W, engine="culled_pallas",
              cull=((16, 16), 8, 8, 0))
    kw.update(change)
    with pytest.raises((NotImplementedError, ValueError),
                       match="ROADMAP|cull|unsharded|multi-view"):
        tinv.make_train_step(cam, tinv.FitConfig(**kw), mesh=mesh)
