"""PyTorch port: depth-1 renders and training-step gradients through the
culled bounce children (kernel 2 and its hot launch, through their plain
versions) against the JAX package's culled_pallas path, whose Pallas kernels
run here in interpret mode. The fixture is tests/test_hot_child.py's:
sphere_grid_scene(4, reflectivity=0.6, seed=3) at 48x64 with 16x16 tiles,
here with two of its materials made glass so that the refraction branch runs
too."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglraytracer_tpu.models.builders import sphere_grid_scene
from openglraytracer_tpu.models.scene import make_camera
from openglraytracer_tpu.ops import accel as ja
from openglraytracer_tpu.ops.render import trace_rays_fast as j_trace
from openglraytracer_tpu.train import inverse as jinv
from openglraytracer_tpu_torch.ops import render as t_render_mod
from openglraytracer_tpu_torch.train import inverse as tinv

from _torch_helpers import (jitted_sphere_rows, np_, to_torch, to_torch_camera,
                            to_torch_scene)


@pytest.fixture(autouse=True)
def _reference_rows_as_jitted(monkeypatch):
    jitted_sphere_rows(monkeypatch)


TILE = (16, 16)
H, W = 48, 64
TRAINABLE = ("spheres.center", "spheres.radius", "materials.diffuse",
             "lights.position")


@functools.cache
def _fixture():
    """(scene, cam, parent spec, 7-element child spec with hot_p > 0)."""
    scene, _ = sphere_grid_scene(4, reflectivity=0.6, seed=3)
    m = scene.materials
    scene = scene._replace(materials=m._replace(
        transparency=m.transparency.at[jnp.array([5, 10])].set(0.5),
        refraction_index=m.refraction_index.at[jnp.array([5, 10])].set(1.5)))
    cam = make_camera((0.0, -10.0, 5.5), (-25.0, 0.0, 0.0), aspect=W / H)
    cull = ja.suggest_cull_config(scene, cam, H, W, TILE, headroom=1.5)
    child = ja.suggest_child_cull_config(scene, cam, H, W, cull,
                                         headroom=1.5)
    assert len(child) == 7
    # 16 spheres are too few for the sizing to pick a hot budget: cap Kp at
    # 8 and let every tile go hot, so that the hot launch decides the
    # over-cap tiles (tests/test_hot_child.py does the same)
    t_tiles = (H // TILE[0]) * (W // TILE[1])
    return scene, cam, cull, child[:1] + (8,) + child[2:6] + (t_tiles,)


def test_depth1_render_matches_jax():
    """Depth 1 with the child spec, reflection and refraction children. On
    identical rays (the port's, traced by the JAX package's
    trace_rays_fast) the colors agree to 1e-5, with no overflow on either
    side."""
    scene, cam, cull, child = _fixture()
    ts, tc = to_torch_scene(scene), to_torch_camera(cam)
    img_t, ovf_t = t_render_mod.render(ts, tc, H, W, depth=1,
                                       engine="culled_pallas", cull=cull,
                                       child_cull=child, with_cull_stats=True)
    origins, dirs = (np_(x) for x in t_render_mod.generate_rays(tc, H, W))
    o, d = (ja.tile_image(jnp.asarray(x), *TILE).reshape(-1, 3)
            for x in (origins, dirs))
    _, kp, ks, hot_m, kb, ksb = ja.parse_cull_spec(cull)
    flat = (TILE[0] * TILE[1],) + tuple(child[1:])
    colors_j, ovf_j = j_trace(scene, o, d, 1, engine="culled_pallas",
                              cull=flat[:1] + (kp, ks, hot_m, kb, ksb),
                              child_cull=flat, with_cull_stats=True)
    img_j = ja.untile_image(colors_j, H, W, *TILE)
    assert int(ovf_t) == int(ovf_j) == 0
    np.testing.assert_allclose(np_(img_t), np_(img_j), rtol=0, atol=1e-5)
    # the bounces changed the image
    img_0 = t_render_mod.render(ts, tc, H, W, engine="culled_pallas",
                                cull=cull)
    assert float((img_t - img_0).abs().max()) > 1e-2


def test_render_checks_the_child_tile():
    scene, cam, cull, child = _fixture()
    ts, tc = to_torch_scene(scene), to_torch_camera(cam)
    bad = ((8, 8),) + tuple(child[1:])
    with pytest.raises(ValueError, match="tile"):
        t_render_mod.render(ts, tc, H, W, depth=1, engine="culled_pallas",
                            cull=cull, child_cull=bad)


def test_depth1_train_step_matches_jax():
    """One SGD step of make_train_step at depth 1 with the child spec,
    against jax.grad of the JAX package's culled_pallas trace of the same
    rays (the port's), run eagerly: the loss to 1e-6 relative, and the
    gradient of each leaf to 2e-3 * max|g| for the sphere leaves and
    1e-4 * max|g| for the others. Not under jax.jit: there XLA contracts
    the winner replay's multiply-adds, and on this fixture the JAX
    package's jitted and eager sphere gradients differ by 2.4e-3 * max|g|
    (measured), where the port is within 5e-5 * max|g| of the eager ones."""
    scene, cam, cull, child = _fixture()
    target = np.random.default_rng(3).random((H, W, 3)).astype(np.float32)
    ts, tc = to_torch_scene(scene), to_torch_camera(cam)
    o, d = (ja.tile_image(jnp.asarray(np_(x)), *TILE).reshape(-1, 3)
            for x in t_render_mod.generate_rays(tc, H, W))
    _, kp, ks, hot_m, kb, ksb = ja.parse_cull_spec(cull)
    flat = (TILE[0] * TILE[1],) + tuple(child[1:])

    def loss_fn(params):
        colors = j_trace(jinv.apply_params(scene, params), o, d, 1,
                         engine="culled_pallas",
                         cull=flat[:1] + (kp, ks, hot_m, kb, ksb),
                         child_cull=flat, bounce_mask=(True, True))
        img = ja.untile_image(colors, H, W, *TILE)
        return jnp.mean(jnp.square(img - target))

    loss_j, g_j = jax.value_and_grad(loss_fn)(
        jinv.extract_params(scene, TRAINABLE))

    lr = 1e-2
    cfg = tinv.FitConfig(height=H, width=W, depth=1, engine="culled_pallas",
                         cull=cull, child_cull=child, trainable=TRAINABLE)
    init_t, step_t = tinv.make_train_step(
        tc, cfg, optimizer=lambda ps: torch.optim.SGD(ps, lr=lr))
    p_t, opt_t = init_t(ts)
    p_t, opt_t, loss_t, ovf_t = step_t(p_t, opt_t, ts, torch.tensor(target))

    assert int(ovf_t) == 0
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    for k in TRAINABLE:
        a, b = np_(g_j[k]), np_(p_t[k].grad)
        scale = float(np.abs(a).max())
        assert scale > 0.0, k
        tol = (2e-3 if k.startswith("spheres.") else 1e-4) * scale
        np.testing.assert_allclose(b, a, rtol=0, atol=tol,
                                   err_msg=f"gradient of {k}")


def test_depth1_needs_a_child_spec():
    """A depth-1 culled_pallas trace needs a child spec only to trace its
    children on the culled path: without one they are traced densely on
    engine 'xla', as the JAX package does (render.py's culled branch), and
    the colors equal its trace_rays_fast without child_cull on the same
    rays (2e-5, as test_render_matches_jax of test_torch_culled.py). The
    training step takes no child spec either."""
    scene, cam, cull, _ = _fixture()
    (th, tw), kp, ks, hot_m, kb, ksb = ja.parse_cull_spec(cull)
    ts, tc = to_torch_scene(scene), to_torch_camera(cam)
    origins, dirs = (np_(x) for x in t_render_mod.generate_rays(tc, H, W))
    o, d = (ja.tile_image(jnp.asarray(x), *TILE).reshape(-1, 3)
            for x in (origins, dirs))
    flat = (th * tw, kp, ks, hot_m, kb, ksb)
    want = j_trace(scene, o, d, 1, engine="culled_pallas", cull=flat)
    with torch.no_grad():
        got, ovf = t_render_mod.trace_rays_fast(
            ts, *to_torch(o, d), 1, engine="culled_pallas", cull=flat,
            with_cull_stats=True)
    assert int(ovf) == 0
    np.testing.assert_allclose(np_(got), np_(want), rtol=0, atol=2e-5)
    init_fn, step_fn = tinv.make_train_step(tc, tinv.FitConfig(
        height=H, width=W, depth=1, engine="culled_pallas", cull=cull))
    _, _, loss, ovf = step_fn(*init_fn(ts), ts, torch.zeros((H, W, 3)))
    assert bool(torch.isfinite(loss)) and int(ovf) == 0
