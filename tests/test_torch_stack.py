"""PyTorch port: the stack bounce engine (trace_rays_stack, its
single-branch chains and depth-0 route), the mirror chain
(trace_rays_mirror, render(mirror_only=True)), render(bounce='stack') on
the engines 'xla', 'pallas' (kernel 7's plain version) and culled_pallas
(kernels 2 and B through their plain versions), the stack cull spec and the
glass grid, against the JAX package on the same seeded inputs; the JAX
package's culled_pallas runs its Pallas kernels here in interpret mode.

Tolerances. The port is handed the JAX package's rays. Against the JAX
package's trace_rays_stack called as a function: rtol 1e-4, atol 1e-5,
those of tests/test_stack_bounce.py for stack against tree (its lax.scan
body is compiled, which on these fixtures keeps the colours within 4e-6
of the port's, except on the mirror chain, held to the JAX package run
op by op). Against its jitted render, where XLA contracts multiply-adds
into fused ones that move the mirror and glass reflections by up to 8.8e-4
(tests/test_torch_xla_render.py): 1e-3. Gradients per leaf
to 2e-4 * max|g| (tests/test_stack_bounce.py:65-85). Overflow counts are
exactly equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglraytracer_tpu.models.animated import reference_frame
from openglraytracer_tpu.models.builders import (mirror_scene,
                                                 sphere_grid_scene)
from openglraytracer_tpu.ops import accel as ja
from openglraytracer_tpu.ops import render as jr
from openglraytracer_tpu.ops.raygen import generate_rays as j_rays
from openglraytracer_tpu.train import inverse as jinv
from openglraytracer_tpu_torch.models import builders as tb
from openglraytracer_tpu_torch.ops import accel as ta
from openglraytracer_tpu_torch.ops import render as tr
from openglraytracer_tpu_torch.train import inverse as tinv

from _torch_helpers import np_, to_torch, to_torch_camera, to_torch_scene

RTOL, ATOL = 1e-4, 1e-5        # stack against tree, and port against JAX
JIT_ATOL = 1e-3                # against the JAX package's jitted render
GRAD_TOL = 2e-4                # per leaf, times max|g|
TILE = (16, 16)


def _rays(cam, h, w, tile=None):
    """The JAX package's rays (R, 3), raster order or tile-major."""
    o, d = j_rays(cam, h, w)
    if tile is not None:
        o, d = (ja.tile_image(x, *tile) for x in (o, d))
    return o.reshape(-1, 3), d.reshape(-1, 3)


def _full_spec(scene, tile=TILE):
    """A spec no list can overflow (K = N), as tests/test_stack_bounce.py
    sizes it, with the tile flattened."""
    n = max(int(scene.spheres.count), 1)
    return (tile[0] * tile[1], n, n, 0, 0, 0)


def _glass_refraction_only():
    """tests/test_bounce_elision.py's refraction-only mirror grid."""
    scene, cam = mirror_scene()
    m = scene.materials
    return scene._replace(materials=m._replace(
        transparency=m.reflectivity,
        reflectivity=jnp.zeros_like(m.reflectivity),
        refraction_index=jnp.full_like(m.refraction_index, 1.3))), cam


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5])
def test_dfs_schedule_matches_jax(depth):
    assert tr._dfs_schedule(depth) == jr._dfs_schedule(depth)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_stack_matches_jax_and_tree(depth):
    """The reference's OBB and glass world (both branches live, TIR rays
    from depth 2): the port's stack against the JAX package's, and against
    the port's own tree (trace_rays_fast)."""
    scene, cam = reference_frame(0.9)
    o, d = _rays(cam, 24, 32)
    want = jr.trace_rays_stack(scene, o, d, depth)
    ts = to_torch_scene(scene)
    with torch.no_grad():
        got = tr.trace_rays_stack(ts, *to_torch(o, d), depth)
        tree = tr.trace_rays_fast(ts, *to_torch(o, d), depth)
    np.testing.assert_allclose(np_(got), np_(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np_(got), np_(tree), rtol=RTOL, atol=ATOL)
    assert float((got - tr.trace_rays_fast(ts, *to_torch(o, d), 0))
                 .abs().max()) > 1e-2


def test_render_stack_depth4_matches_jax(monkeypatch):
    """render(bounce='stack') at depth 4 (31 casts a pixel) against the
    JAX package's stack on the same rays, and its jitted render."""
    scene, cam = reference_frame(1.1)
    h, w = 24, 32
    monkeypatch.setattr(tr, "generate_rays",
                        lambda *a: to_torch(*j_rays(cam, h, w)))
    with torch.no_grad():
        img = tr.render(to_torch_scene(scene), to_torch_camera(cam), h, w,
                        depth=4, bounce="stack")
    want = jr.trace_rays_stack(scene, *_rays(cam, h, w), 4)
    np.testing.assert_allclose(np_(img), np_(want).reshape(h, w, 3),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np_(img), np_(jr.render(
        scene, cam, h, w, depth=4, bounce="stack")), rtol=0, atol=JIT_ATOL)


def test_depth0_route():
    """Depth 0 is one trace_rays_fast cast, on every engine, and equals the
    JAX package's."""
    scene, cam = reference_frame(0.3)
    o, d = _rays(cam, 8, 8)
    ts = to_torch_scene(scene)
    to, td = to_torch(o, d)
    with torch.no_grad():
        for engine in ("xla", "pallas"):
            got = tr.trace_rays_stack(ts, to, td, 0, engine=engine)
            assert torch.equal(got, tr.trace_rays_fast(ts, to, td, 0,
                                                       engine=engine))
    np.testing.assert_allclose(np_(got), np_(jr.trace_rays_stack(
        scene, o, d, 0)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("builder", [mirror_scene, _glass_refraction_only])
def test_single_branch_chain(builder):
    """A scene with one live branch takes the chain (depth + 1 casts):
    equal to the JAX package's chain run op by op (jax.disable_jit), to
    its compiled scan within JIT_ATOL (XLA contracts the mirror grid's
    reflections there by up to 8.8e-4), and to the port's tree."""
    scene, cam = builder()
    o, d = _rays(cam, 24, 32)
    ts = to_torch_scene(scene)
    calls = []
    real = tr.geometry_op
    for depth in (1, 3):
        with torch.no_grad():
            tr.geometry_op = lambda *a: (calls.append(1), real(*a))[1]
            try:
                got = tr.trace_rays_stack(ts, *to_torch(o, d), depth)
            finally:
                tr.geometry_op = real
            tree = tr.trace_rays_fast(ts, *to_torch(o, d), depth)
        assert len(calls) == depth + 1
        calls.clear()
        with jax.disable_jit():
            want = jr.trace_rays_stack(scene, o, d, depth)
        np.testing.assert_allclose(np_(got), np_(want), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(np_(got), np_(jr.trace_rays_stack(
            scene, o, d, depth)), rtol=0, atol=JIT_ATOL)
        np.testing.assert_allclose(np_(got), np_(tree), rtol=RTOL,
                                   atol=ATOL)


def test_mirror_only_matches_jax(monkeypatch):
    """render(mirror_only=True) at depth 3 on the mirror grid against the
    JAX package's render(mirror_only=True) run op by op (jax.disable_jit,
    the port handed its rays), and against the port's tree to
    tests/test_render_golden.py's 5e-5. The JAX package's compiled scan
    is no reference here: XLA's contractions flip the shadow or winner of
    32 of these 2304 pixels at grazes, by up to 0.023, against its own
    eager run and its tree."""
    scene, cam = mirror_scene()
    h = w = 48
    with jax.disable_jit():
        rays = j_rays(cam, h, w)
        want = jr.render(scene, cam, h, w, depth=3, mirror_only=True)
    monkeypatch.setattr(tr, "generate_rays", lambda *a: to_torch(*rays))
    ts, tc = to_torch_scene(scene), to_torch_camera(cam)
    with torch.no_grad():
        img = tr.render(ts, tc, h, w, depth=3, mirror_only=True)
        tree = tr.render(ts, tc, h, w, depth=3)
        # culled_pallas ignores mirror_only, as the reference does
        spec = ((16, 16), 64, 64)
        assert torch.equal(
            tr.render(ts, tc, h, w, depth=1, engine="culled_pallas",
                      cull=spec, mirror_only=True),
            tr.render(ts, tc, h, w, depth=1, engine="culled_pallas",
                      cull=spec))
    np.testing.assert_allclose(np_(img), np_(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np_(img), np_(tree), rtol=0, atol=5e-5)
    assert float((img - tr.render(ts, tc, h, w)).abs().max()) > 1e-2


def test_pallas_stack_matches_jax():
    """Engine 'pallas' (kernel 7's plain version on the CPU) at depth 2
    against the JAX package's 'pallas' stack (its kernel in interpret
    mode)."""
    scene, cam = reference_frame(0.9)
    o, d = _rays(cam, 16, 24)
    with torch.no_grad():
        got = tr.trace_rays_stack(to_torch_scene(scene), *to_torch(o, d), 2,
                                  engine="pallas")
    want = jr.trace_rays_stack(scene, o, d, 2, engine="pallas")
    np.testing.assert_allclose(np_(got), np_(want), rtol=RTOL, atol=ATOL)


@functools.cache
def _culled_case(name):
    """(scene, cam, h, w, depth) of the culled stack fixtures of
    tests/test_stack_bounce.py:101-146."""
    if name == "glass_world":
        return (*reference_frame(0.9), 32, 64, 3)
    return (*sphere_grid_scene(4, reflectivity=0.6, seed=3), 48, 48, 3)


@pytest.mark.parametrize("name", ["glass_world", "mirror_chain"])
def test_culled_stack_matches_jax(name):
    """culled_pallas stack with a spec no list can overflow: the glass
    world (both branches) and the mirror grid (the chain), against the JAX
    package's culled_pallas stack on the same tile-major rays and against
    the port's 'xla' stack; overflow 0 on both sides."""
    scene, cam, h, w, depth = _culled_case(name)
    o, d = _rays(cam, h, w, TILE)
    spec = _full_spec(scene)
    want, ovf_j = jr.trace_rays_stack(scene, o, d, depth,
                                      engine="culled_pallas", cull=spec,
                                      with_cull_stats=True)
    ts = to_torch_scene(scene)
    with torch.no_grad():
        got, ovf_t = tr.trace_rays_stack(ts, *to_torch(o, d), depth,
                                         engine="culled_pallas", cull=spec,
                                         with_cull_stats=True)
        dense = tr.trace_rays_stack(ts, *to_torch(o, d), depth)
    assert int(ovf_t) == int(ovf_j) == 0
    np.testing.assert_allclose(np_(got), np_(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np_(got), np_(dense), rtol=0, atol=JIT_ATOL)


def test_culled_stack_render_matches_jax():
    """render(engine='culled_pallas', bounce='stack') tiles the rays with
    the spec's tile and untiles the image: equal to the port's trace of the
    tile-major rays, and to the JAX package's jitted render."""
    scene, cam, h, w, depth = _culled_case("glass_world")
    n = int(scene.spheres.count)
    spec = (TILE, n, n, 0, 0, 0, 0)
    ts, tc = to_torch_scene(scene), to_torch_camera(cam)
    with torch.no_grad():
        img, ovf = tr.render(ts, tc, h, w, depth=depth,
                             engine="culled_pallas", bounce="stack",
                             cull=spec, with_cull_stats=True)
        o, d = (ta.tile_image(x, *TILE).reshape(-1, 3)
                for x in tr.generate_rays(tc, h, w))
        flat = tr.trace_rays_stack(ts, o, d, depth, engine="culled_pallas",
                                   cull=_full_spec(scene))
    assert int(ovf) == 0
    assert torch.equal(img, ta.untile_image(flat, h, w, *TILE))
    np.testing.assert_allclose(np_(img), np_(jr.render(
        scene, cam, h, w, depth=depth, engine="culled_pallas",
        bounce="stack", cull=spec)), rtol=0, atol=JIT_ATOL)


def test_culled_stack_overflow_counted():
    """A spec that must overflow (K = 1): the port counts exactly the JAX
    package's overflow events, summed over every step."""
    scene, cam = sphere_grid_scene(4, reflectivity=0.6, seed=3)
    spec = ((16, 16), 1, 1, 0, 0, 0)
    _, ovf_j = jr.render(scene, cam, 48, 48, depth=2,
                         engine="culled_pallas", bounce="stack", cull=spec,
                         with_cull_stats=True)
    with torch.no_grad():
        _, ovf_t = tr.render(to_torch_scene(scene), to_torch_camera(cam),
                             48, 48, depth=2, engine="culled_pallas",
                             bounce="stack", cull=spec, with_cull_stats=True)
    assert int(ovf_t) == int(ovf_j) > 0


def _grads(scene_j, trainable, fn_j, fn_t):
    """jax.grad of mean(fn_j(scene)^2) and the port's autograd gradient of
    mean(fn_t(scene)^2), per leaf."""
    params = jinv.extract_params(scene_j, trainable)
    g_j = jax.grad(lambda p: jnp.mean(jnp.square(
        fn_j(jinv.apply_params(scene_j, p)))))(params)
    ts = to_torch_scene(scene_j)
    p_t = {k: v.detach().clone().requires_grad_()
           for k, v in tinv.extract_params(ts, trainable).items()}
    torch.mean(torch.square(fn_t(tinv.apply_params(ts, p_t)))).backward()
    return g_j, {k: v.grad for k, v in p_t.items()}


def _assert_grads(g_j, g_t):
    for k, a in g_j.items():
        a, b = np_(a), np_(g_t[k])
        scale = float(np.abs(a).max())
        assert scale > 0.0, k
        np.testing.assert_allclose(b, a, rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=f"gradient of {k}")


def test_stack_gradients_match_jax():
    """Gradients of the dense stack at depth 2 on the OBB and glass world
    (tests/test_stack_bounce.py:65-85): every step runs under
    torch.utils.checkpoint and is recomputed in the backward."""
    scene, cam = reference_frame(0.5)
    o, d = _rays(cam, 16, 16)
    to, td = to_torch(o, d)
    g_j, g_t = _grads(
        scene, ("boxes.position", "spheres.center", "materials.diffuse",
                "materials.reflectivity", "materials.transparency"),
        lambda s: jr.trace_rays_stack(s, o, d, 2),
        lambda s: tr.trace_rays_stack(s, to, td, 2))
    _assert_grads(g_j, g_t)


def test_culled_stack_gradients_match_jax():
    """Gradients of the culled_pallas stack at depth 2 on a mirror grid
    (tests/test_stack_bounce.py:158-176) against jax.grad of the JAX
    package's culled_pallas stack on the same tile-major rays."""
    scene, cam = sphere_grid_scene(3, reflectivity=0.5, seed=5)
    o, d = _rays(cam, 32, 32, TILE)
    to, td = to_torch(o, d)
    spec = _full_spec(scene)
    g_j, g_t = _grads(
        scene, ("spheres.center", "materials.diffuse"),
        lambda s: jr.trace_rays_stack(s, o, d, 2, engine="culled_pallas",
                                      cull=spec) - 0.3,
        lambda s: tr.trace_rays_stack(s, to, td, 2, engine="culled_pallas",
                                      cull=spec) - 0.3)
    _assert_grads(g_j, g_t)


def test_suggest_stack_cull_config_matches_jax():
    """The stack spec on a small glass grid equals the JAX package's: the
    elementwise max of the primary and child specs, hot_m 0, hot_p every
    tile, Kp floored at min(N, tile_h tile_w)."""
    scene, cam = sphere_grid_scene(4, reflectivity=0.6, seed=3)
    m = scene.materials
    scene = scene._replace(materials=m._replace(
        transparency=m.transparency.at[jnp.array([5, 10])].set(0.5),
        refraction_index=m.refraction_index.at[jnp.array([5, 10])].set(1.5)))
    want = ja.suggest_stack_cull_config(scene, cam, 48, 64, TILE,
                                        headroom=2.0)
    got = ta.suggest_stack_cull_config(to_torch_scene(scene),
                                       to_torch_camera(cam), 48, 64, TILE,
                                       headroom=2.0)
    assert got == want
    assert got[3] == 0 and len(got) == 7


def test_glass_grid_scene_matches_bench():
    import bench
    scene_j, cam_j = bench.glass_grid_scene(4)
    scene_t, cam_t = tb.glass_grid_scene(4, device="cpu")
    for part in scene_j._fields:
        for f, a in getattr(scene_j, part)._asdict().items():
            np.testing.assert_array_equal(
                np_(getattr(getattr(scene_t, part), f)), np_(a),
                err_msg=f"{part}.{f}")
    for f, a in cam_j._asdict().items():
        np.testing.assert_array_equal(np_(getattr(cam_t, f)), np_(a))


def test_stack_rejects_autodiff_and_mismatched_specs():
    scene, cam = reference_frame(0.5)
    ts, tc = to_torch_scene(scene), to_torch_camera(cam)
    o, d = (x.reshape(-1, 3) for x in tr.generate_rays(tc, 8, 8))
    with pytest.raises(ValueError, match="autodiff"):
        tr.render(ts, tc, 8, 8, depth=2, engine="autodiff", bounce="stack")
    with pytest.raises(ValueError, match="autodiff"):
        tr.trace_rays_stack(ts, o, d, 2, engine="autodiff")
    with pytest.raises(ValueError, match="cull"):
        tr.trace_rays_stack(ts, o, d, 2, engine="culled_pallas")
    with pytest.raises(ValueError, match="cull"):
        tr.trace_rays_stack(ts, o, d, 2, cull=(64, 8, 8))
    with pytest.raises(ValueError, match="bounce"):
        tr.render(ts, tc, 8, 8, depth=2, bounce="scan")
    # mirror_only wins over bounce='stack' on the dense engines
    with torch.no_grad():
        assert torch.equal(
            tr.render(ts, tc, 8, 8, depth=2, engine="autodiff",
                      bounce="stack", mirror_only=True),
            tr.render(ts, tc, 8, 8, depth=2, mirror_only=True))
