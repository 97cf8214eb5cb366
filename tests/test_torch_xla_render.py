"""PyTorch port: renders, gradients and a training step of the plain dense
engines 'xla' ('auto', the default) and 'autodiff' against the JAX
package's, on the same seeded inputs at small sizes: c1_sphere_plane,
c2_eight_spheres, c4_mirror at depth 1 (a culled_pallas parent whose
children run densely on 'xla') and the reference's animated OBB world at
depth 0 and 2.

The port is handed the JAX package's rays (the two raygens differ by up to
2e-5, tests/test_torch_culled.py). It follows the JAX package run op by op
(tests/test_torch_xla.py): against its eager trace, images agree to 1e-5
(2e-5 through the culled kernels' plain versions), gradients to the
tolerances of tests/test_geometry_vjp.py (atol 5e-5 and rtol 1e-4 at depth
0, atol 1e-4 through bounces; the OBB world's boxes 2e-4 and 5e-4 there).
Against its jitted render, where XLA contracts multiply-adds into fused
ones that move the mirror scene's reflections by up to 2.4e-4, images agree
to 1e-3."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openglraytracer_tpu.models.animated import reference_frame
from openglraytracer_tpu.models.builders import (eight_sphere_scene,
                                                 mirror_scene,
                                                 single_sphere_scene)
from openglraytracer_tpu.ops import accel as ja
from openglraytracer_tpu.ops.raygen import generate_rays as j_rays
from openglraytracer_tpu.ops.render import render as j_render
from openglraytracer_tpu.ops.render import trace_rays as j_trace_ad
from openglraytracer_tpu.ops.render import trace_rays_fast as j_trace
from openglraytracer_tpu.train import inverse as jinv
from openglraytracer_tpu_torch.ops import render as t_render_mod
from openglraytracer_tpu_torch.train import inverse as tinv

from _torch_helpers import np_, to_torch, to_torch_camera, to_torch_scene

H = W = 32
TILE = (16, 16)
# name -> (builder, depth, engine of the port's render)
CASES = {"c1_sphere_plane": (single_sphere_scene, 0, "auto"),
         "c2_eight_spheres": (eight_sphere_scene, 0, "xla"),
         "c4_mirror": (mirror_scene, 1, "culled_pallas"),
         "obb_depth0": (lambda: reference_frame(1.2), 0, "auto"),
         "obb_depth2": (lambda: reference_frame(0.9), 2, "xla")}


@functools.cache
def _case(name):
    builder, depth, engine = CASES[name]
    scene, cam = builder()
    return scene, cam, depth, engine


def _rays(cam, h=H, w=W):
    o, d = j_rays(cam, h, w)
    return o.reshape(-1, 3), d.reshape(-1, 3)


@pytest.mark.parametrize("name", list(CASES))
def test_render_matches_jax(monkeypatch, name):
    """render on the case's engine against the JAX package's trace of the
    same rays (eager) and its render (jitted); the dense engines report no
    overflow, the culled parent none on this fixture."""
    scene, cam, depth, engine = _case(name)
    ts, tc = to_torch_scene(scene), to_torch_camera(cam)
    rays = to_torch(*j_rays(cam, H, W))
    monkeypatch.setattr(t_render_mod, "generate_rays", lambda *a: rays)
    kw = dict(depth=depth, engine=engine)
    if engine == "culled_pallas":
        kw["cull"] = ja.suggest_cull_config(scene, cam, H, W, TILE)
        (th, tw), *ks = ja.parse_cull_spec(kw["cull"])
        o, d = (ja.tile_image(x, th, tw).reshape(-1, 3)
                for x in j_rays(cam, H, W))
        want = ja.untile_image(j_trace(scene, o, d, depth,
                                       engine="culled_pallas",
                                       cull=(th * tw, *ks)), H, W, th, tw)
        atol = 2e-5
    else:
        want = j_trace(scene, *_rays(cam), depth).reshape(H, W, 3)
        atol = 1e-5
    with torch.no_grad():
        img, ovf = t_render_mod.render(ts, tc, H, W, with_cull_stats=True,
                                       **kw)
    assert int(ovf) == 0 and img.shape == (H, W, 3)
    np.testing.assert_allclose(np_(img), np_(want), rtol=atol, atol=atol)
    np.testing.assert_allclose(np_(img), np_(j_render(scene, cam, H, W,
                                                      **kw)),
                               rtol=0, atol=1e-3)
    if depth:
        with torch.no_grad():
            img_0 = t_render_mod.render(ts, tc, H, W, engine=engine,
                                        cull=kw.get("cull"))
        assert float((img - img_0).abs().max()) > 1e-2


@pytest.mark.parametrize("engine", ["auto", "autodiff", "pallas"])
def test_row_block_invariance(engine):
    """Rows traced in blocks of 8 give the image of one trace, bit for bit
    (each ray's computation does not depend on the others')."""
    scene, cam, depth, _ = _case("obb_depth0")
    ts, tc = to_torch_scene(scene), to_torch_camera(cam)
    with torch.no_grad():
        a = t_render_mod.render(ts, tc, H, W, depth=1, engine=engine)
        b = t_render_mod.render(ts, tc, H, W, depth=1, engine=engine,
                                row_block=8)
    assert torch.equal(a, b)


def _float_leaves(scene):
    return tuple(f"{part}.{field}" for part in scene._fields
                 for field in getattr(scene, part)._fields
                 if jnp.issubdtype(getattr(getattr(scene, part),
                                           field).dtype, jnp.floating))


# name -> (builder, depth, atol, box atol)
GRAD_CASES = {"eight_spheres": (eight_sphere_scene, 0, 5e-5, None),
              "single_sphere": (single_sphere_scene, 0, 5e-5, None),
              "mirror_depth1": (mirror_scene, 1, 1e-4, None),
              "obb_0.7": (lambda: reference_frame(0.7), 0, 5e-5, 2e-4),
              "obb_0.2_depth1": (lambda: reference_frame(0.2), 1, 1e-4,
                                 5e-4)}


@pytest.mark.parametrize("engine", ["xla", "autodiff"])
@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_gradients_match_jax(name, engine):
    """d/d(every float leaf of the scene) of sum(colors * weights) at 24x24
    (tests/test_geometry_vjp.py's loss): 'xla' (the analytic backward)
    against jax.grad of the JAX package's trace_rays_fast, 'autodiff'
    (autograd through the chunked scan) against jax.grad of its
    trace_rays."""
    builder, depth, atol, box_atol = GRAD_CASES[name]
    scene, cam = builder()
    o, d = _rays(cam, 24, 24)
    weights = jnp.linspace(0.2, 1.3, 24 * 24 * 3).reshape(24 * 24, 3)
    leaves = _float_leaves(scene)
    j_fn = j_trace if engine == "xla" else j_trace_ad
    t_fn = (t_render_mod.trace_rays_fast if engine == "xla"
            else t_render_mod.trace_rays)

    def loss_j(params):
        return jnp.sum(j_fn(jinv.apply_params(scene, params), o, d, depth)
                       * weights)
    g_j = jax.grad(loss_j)(jinv.extract_params(scene, leaves))

    ts = to_torch_scene(scene)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in tinv.extract_params(ts, leaves).items()}
    colors = t_fn(tinv.apply_params(ts, params), *to_torch(o, d), depth)
    torch.sum(colors * torch.from_numpy(np.array(weights))).backward()
    nonzero = 0
    for k in leaves:
        a = np_(g_j[k])
        g = params[k].grad           # None: the leaf does not reach the loss
        b = np.zeros_like(a) if g is None else np_(g)
        tol = box_atol if k.startswith("boxes.") and box_atol else atol
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=tol,
                                   err_msg=f"gradient of {k}")
        nonzero += bool(np.any(a != 0))
    assert nonzero >= 4


def test_autodiff_gradients_are_finite():
    """Every float leaf's gradient through 'autodiff' on the OBB world at
    depth 2 (boxes, the glass tree, the camera inside the wall box) is
    finite: the guards of the chunked scan hold under autograd, as the
    JAX package's own test asks of it (tests/test_grads.py)."""
    scene, cam = reference_frame(1.1)
    ts = to_torch_scene(scene)
    leaves = _float_leaves(scene)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in tinv.extract_params(ts, leaves).items()}
    o, d = to_torch(*_rays(cam, 24, 24))
    w = torch.linspace(0.3, 1.7, 24 * 24 * 3).reshape(24 * 24, 3)
    img = t_render_mod.trace_rays(tinv.apply_params(ts, params), o, d, 2)
    torch.sum(img * w).backward()
    grads = {k: v.grad for k, v in params.items() if v.grad is not None}
    assert len(grads) >= 10
    for k, g in grads.items():
        assert bool(torch.isfinite(g).all()), k


def test_train_step_matches_jax(monkeypatch):
    """One SGD step of make_train_step(FitConfig()) with the default engine
    ('auto') from the same start against the JAX package's (jitted) step
    on c2_eight_spheres: the loss to 1e-6 relative; gradients, against
    jax.grad of the JAX package's (jitted) render, per leaf to 2e-3 *
    max|g| for the geometry leaves and 1e-4 * max|g| for the others (the
    jitted reference's own spread, tests/test_torch_dense_render.py); the
    stepped parameters to the same bounds times the learning rate."""
    scene, cam = eight_sphere_scene()
    target = np.random.default_rng(4).random((H, W, 3)).astype(np.float32)
    lr = 1e-2
    cfg_j = jinv.FitConfig(height=H, width=W)
    init_j, step_j = jinv.make_train_step(cam, cfg_j, optimizer=optax.sgd(lr))
    p0_j, opt_j = init_j(scene)
    start = {k: np.array(v) for k, v in p0_j.items()}
    p1_j, _, loss_j, _ = step_j(p0_j, opt_j, scene, jnp.asarray(target))

    def loss_fn(params):
        img = j_render(jinv.apply_params(scene, params), cam, H, W)
        return jnp.mean(jnp.square(img - target))
    g_j = jax.grad(loss_fn)({k: jnp.asarray(v) for k, v in start.items()})

    rays = to_torch(*j_rays(cam, H, W))
    monkeypatch.setattr(t_render_mod, "generate_rays", lambda *a: rays)
    cfg_t = tinv.FitConfig(height=H, width=W)
    assert cfg_t.engine == "auto"
    init_t, step_t = tinv.make_train_step(
        to_torch_camera(cam), cfg_t,
        optimizer=lambda ps: torch.optim.SGD(ps, lr=lr))
    p_t, opt_t = init_t(to_torch_scene(scene))
    p_t, opt_t, loss_t, ovf_t = step_t(p_t, opt_t, to_torch_scene(scene),
                                       torch.tensor(target))
    assert int(ovf_t) == 0
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    for k in cfg_t.trainable:
        a, b = np_(g_j[k]), np_(p_t[k].grad)
        scale = float(np.abs(a).max())
        assert scale > 0.0, k
        tol = (2e-3 if k.startswith("spheres.") else 1e-4) * scale
        np.testing.assert_allclose(b, a, rtol=0, atol=tol,
                                   err_msg=f"gradient of {k}")
        np.testing.assert_allclose(np_(p_t[k]), np_(p1_j[k]), rtol=1e-6,
                                   atol=lr * tol, err_msg=f"stepped {k}")
