"""PyTorch port: renders, gradients and a training step of the dense engine
'pallas' (kernel 7 through its plain version, the analytic winner backward
of ops/geometry.py) against the JAX package's engine 'pallas', whose Pallas
kernel runs here in interpret mode. Fixtures: eight_sphere_scene and the
reference's animated OBB world at time 0.8 (glass and mirror boxes, no
plane), at depth 0 and 1, 32x32.

The port is handed the JAX package's rays: the two raygens differ by up to
2e-5 (tests/test_torch_culled.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openglraytracer_tpu.models.animated import reference_frame
from openglraytracer_tpu.models.builders import eight_sphere_scene
from openglraytracer_tpu.ops.raygen import generate_rays as j_rays
from openglraytracer_tpu.ops.render import render as j_render
from openglraytracer_tpu.ops.render import trace_rays_fast as j_trace
from openglraytracer_tpu.train import inverse as jinv
from openglraytracer_tpu_torch.ops import render as t_render_mod
from openglraytracer_tpu_torch.train import inverse as tinv

from _torch_helpers import np_, to_torch, to_torch_camera, to_torch_scene

H = W = 32
FIXTURES = {"eight_spheres": eight_sphere_scene,
            "obb_0.8": lambda: reference_frame(0.8)}
TRAINABLE = {
    "eight_spheres": ("spheres.center", "spheres.radius", "materials.diffuse",
                      "lights.position"),
    "obb_0.8": ("boxes.position", "boxes.angles", "boxes.mins",
                "spheres.center", "materials.diffuse", "lights.position"),
}


def _flat_rays(cam):
    o, d = j_rays(cam, H, W)
    return o.reshape(-1, 3), d.reshape(-1, 3)


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("name", list(FIXTURES))
def test_render_matches_jax(monkeypatch, name, depth):
    """render(engine='pallas') against the JAX package's render on the same
    rays: colors to 1e-5 absolute and relative (the shade's exp, log and
    rsqrt in two libraries; the OBB world's glass highlights reach 4.8),
    and the dense engine reports no overflow."""
    scene, cam = FIXTURES[name]()
    img_j = j_render(scene, cam, H, W, depth=depth, engine="pallas")
    rays = to_torch(*j_rays(cam, H, W))
    monkeypatch.setattr(t_render_mod, "generate_rays", lambda *a: rays)
    img_t, ovf = t_render_mod.render(to_torch_scene(scene),
                                     to_torch_camera(cam), H, W, depth=depth,
                                     engine="pallas", with_cull_stats=True)
    assert int(ovf) == 0 and img_t.shape == (H, W, 3)
    np.testing.assert_allclose(np_(img_t), np_(img_j), rtol=1e-5, atol=1e-5)
    if depth and name.startswith("obb"):     # glass and mirrors
        img_0 = t_render_mod.render(to_torch_scene(scene),
                                    to_torch_camera(cam), H, W,
                                    engine="pallas")
        assert float((img_t - img_0).abs().max()) > 1e-2


@pytest.mark.parametrize("name,depth", [("eight_spheres", 0),
                                        ("obb_0.8", 0), ("obb_0.8", 1)])
def test_gradients_match_jax(name, depth):
    """Gradients of the pixel MSE through trace_rays_fast(engine='pallas')
    against jax.grad of the JAX package's, run eagerly, on the same rays:
    per leaf to 1e-4 * max|g|, as the JAX package holds its engines to each
    other (tests/test_pallas.py). The OBB world's box leaves are non-zero;
    at depth 1 the children's cotangents flow back through their origins
    and directions."""
    scene, cam = FIXTURES[name]()
    trainable = TRAINABLE[name]
    o, d = _flat_rays(cam)
    target = np.random.default_rng(5).random((H * W, 3)).astype(np.float32)

    def loss_j(params):
        colors = j_trace(jinv.apply_params(scene, params), o, d, depth,
                         engine="pallas")
        return jnp.mean(jnp.square(colors - target))
    g_j = jax.grad(loss_j)(jinv.extract_params(scene, trainable))

    ts = to_torch_scene(scene)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in tinv.extract_params(ts, trainable).items()}
    colors = t_render_mod.trace_rays_fast(
        tinv.apply_params(ts, params), *to_torch(o, d), depth,
        engine="pallas")
    torch.mean(torch.square(colors - torch.from_numpy(target))).backward()
    for k in trainable:
        a, b = np_(g_j[k]), np_(params[k].grad)
        scale = float(np.abs(a).max())
        assert scale > 0.0, k
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * scale,
                                   err_msg=f"gradient of {k}")


def test_train_step_matches_jax(monkeypatch):
    """One SGD step of make_train_step(engine='pallas') from the same start
    against the JAX package's (jitted) step on the OBB world at depth 1:
    the loss to 1e-6 relative; gradients, against jax.grad of the JAX
    package's (jitted) render, per leaf to 2e-3 * max|g| for the geometry
    leaves and 1e-4 * max|g| for the others. Under jax.jit XLA
    contracts the winner replay's multiply-adds, and the JAX package's own
    jitted and eager gradients differ by up to 2.4e-3 * max|g| on such
    fixtures (ROADMAP.md section 3); the port matches the eager ones to
    1e-4 (test_gradients_match_jax). The stepped parameters to the same
    bounds times the learning rate."""
    scene, cam = reference_frame(0.8)
    trainable = TRAINABLE["obb_0.8"]
    target = np.random.default_rng(3).random((H, W, 3)).astype(np.float32)
    lr = 1e-2
    cfg_j = jinv.FitConfig(height=H, width=W, depth=1, engine="pallas",
                           trainable=trainable)
    init_j, step_j = jinv.make_train_step(cam, cfg_j, optimizer=optax.sgd(lr))
    p0_j, opt_j = init_j(scene)
    start = {k: np.array(v) for k, v in p0_j.items()}
    p1_j, _, loss_j, _ = step_j(p0_j, opt_j, scene, jnp.asarray(target))

    def loss_fn(params):
        img = j_render(jinv.apply_params(scene, params), cam, H, W, depth=1,
                       engine="pallas")
        return jnp.mean(jnp.square(img - target))
    g_j = jax.grad(loss_fn)({k: jnp.asarray(v) for k, v in start.items()})

    rays = to_torch(*j_rays(cam, H, W))
    monkeypatch.setattr(t_render_mod, "generate_rays", lambda *a: rays)
    cfg_t = tinv.FitConfig(height=H, width=W, depth=1, engine="pallas",
                           trainable=trainable)
    init_t, step_t = tinv.make_train_step(
        to_torch_camera(cam), cfg_t,
        optimizer=lambda ps: torch.optim.SGD(ps, lr=lr))
    p_t, opt_t = init_t(to_torch_scene(scene))
    p_t, opt_t, loss_t, ovf_t = step_t(p_t, opt_t, to_torch_scene(scene),
                                       torch.tensor(target))
    assert int(ovf_t) == 0
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    for k in trainable:
        a, b = np_(g_j[k]), np_(p_t[k].grad)
        scale = float(np.abs(a).max())
        assert scale > 0.0, k
        tol = (2e-3 if k.startswith(("spheres.", "boxes.")) else 1e-4) \
            * scale
        np.testing.assert_allclose(b, a, rtol=0, atol=tol,
                                   err_msg=f"gradient of {k}")
        np.testing.assert_allclose(np_(p_t[k]), np_(p1_j[k]), rtol=1e-6,
                                   atol=lr * tol, err_msg=f"stepped {k}")


def test_dense_engine_needs_no_cull_spec():
    """The dense engines ('pallas', 'xla', 'auto', the default, and
    'autodiff') take no cull spec at any depth; the culled engine still
    needs one (its children do not: without a child spec they are traced
    on 'xla'), and so does the XLA culled engine 'culled'."""
    scene, cam = reference_frame(0.8)
    tc = to_torch_camera(cam)
    for engine in ("pallas", "xla", "auto", "autodiff"):
        tinv.make_train_step(tc, tinv.FitConfig(height=H, width=W, depth=2,
                                                engine=engine))
    tinv.make_train_step(tc, tinv.FitConfig(height=H, width=W, depth=2))
    with pytest.raises(ValueError, match="cull"):
        tinv.make_train_step(tc, tinv.FitConfig(height=H, width=W,
                                                engine="culled_pallas"))
    with pytest.raises(ValueError, match="cull"):
        tinv.make_train_step(tc, tinv.FitConfig(height=H, width=W,
                                                engine="culled"))


def test_pick_tracer():
    """pick_tracer returns the reference's tracers: 'pallas' and 'xla' as
    trace_rays_fast traces them, 'auto' (the default) as 'xla', 'autodiff'
    as trace_rays; the culled engines, 'culled' and culled_pallas, need a
    cull spec."""
    scene, cam = reference_frame(0.8)
    ts = to_torch_scene(scene)
    o, d = to_torch(*_flat_rays(cam))
    with torch.no_grad():
        for engine, want in (
                ("pallas", t_render_mod.trace_rays_fast(ts, o, d, 1,
                                                        engine="pallas")),
                ("xla", t_render_mod.trace_rays_fast(ts, o, d, 1)),
                ("autodiff", t_render_mod.trace_rays(ts, o, d, 1))):
            tracer = t_render_mod.pick_tracer(ts, engine)
            assert torch.equal(tracer(ts, o, d, 1), want), engine
        assert torch.equal(t_render_mod.pick_tracer(ts)(ts, o, d, 1),
                           t_render_mod.trace_rays_fast(ts, o, d, 1))
    with pytest.raises(ValueError, match="cull"):
        t_render_mod.pick_tracer(ts, "culled_pallas")
    with pytest.raises(ValueError, match="cull"):
        t_render_mod.pick_tracer(ts, "culled")
