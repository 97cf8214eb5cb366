"""PyTorch port: engine 'culled''s gradients — ops/accel.py's
culled_geometry_op and bounce_culled_geometry_op, and the stack on
'culled' — and the host-side sizing it brings, against the JAX package's
XLA culled engine run op by op. The sizing fixture is
tests/test_hot_child.py's mirror grid, sphere_grid_scene(4,
reflectivity=0.6, seed=3) at 48x64 with 16x16 tiles, with two of its
materials made glass so that both bounce branches run.

Tolerances: gradients per leaf to 1e-4 * max|g| (the ops) and 2e-4 *
max|g| (the stack, tests/test_torch_stack.py); stack colors to rtol
1e-4, atol 1e-5 (tests/test_torch_stack.py); overflow counts and the
sizing exactly equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglraytracer_tpu.models.animated import reference_frame
from openglraytracer_tpu.models.builders import sphere_grid_scene
from openglraytracer_tpu.models.scene import make_camera
from openglraytracer_tpu.ops import accel as ja
from openglraytracer_tpu.ops import render as jr
from openglraytracer_tpu.train import inverse as jinv
from openglraytracer_tpu_torch.ops import accel as ta
from openglraytracer_tpu_torch.ops import render as tr
from openglraytracer_tpu_torch.train import inverse as tinv

from _torch_helpers import np_, to_torch, to_torch_camera, to_torch_scene

TILE = (16, 16)
TILE_P = TILE[0] * TILE[1]
H, W = 48, 64


@functools.cache
def _fixture():
    """(scene, cam, parent spec, child spec sized for 'culled')."""
    scene, _ = sphere_grid_scene(4, reflectivity=0.6, seed=3)
    m = scene.materials
    scene = scene._replace(materials=m._replace(
        transparency=m.transparency.at[jnp.array([5, 10])].set(0.5),
        refraction_index=m.refraction_index.at[jnp.array([5, 10])].set(1.5)))
    cam = make_camera((0.0, -10.0, 5.5), (-25.0, 0.0, 0.0), aspect=W / H)
    cull = ja.suggest_cull_config(scene, cam, H, W, TILE, headroom=1.5)
    child = ja.suggest_child_cull_config(scene, cam, H, W, cull,
                                         headroom=1.5, hot_primary=False)
    return scene, cam, cull, child


# ---------------------------------------------------------------------------
# The differentiable ops and the host-side sizing
# ---------------------------------------------------------------------------

@functools.cache
def _op_case(name):
    """(scene, origins, dirs, active or None, (kp, ks, hot_m, kb, ksb)):
    'obb' the OBB world's primary rays (a sphere and rotated boxes),
    'reflect' the mirror grid's reflection children (spheres, a plane)."""
    from openglraytracer_tpu.ops.geometry import geometry_op
    from openglraytracer_tpu.ops.raygen import generate_rays
    from openglraytracer_tpu.ops.render import BOUNCE_EPS
    from openglraytracer_tpu.ops.transforms import reflect
    if name == "obb":
        scene, cam = reference_frame(1.2)
        cam = cam._replace(aspect=jnp.asarray(W / H, jnp.float32))
        spec = ja.parse_cull_spec(ja.suggest_cull_config(scene, cam, H, W,
                                                         TILE))[1:]
    else:
        scene, _ = sphere_grid_scene(4, reflectivity=0.6, seed=3)
        cam = make_camera((0.0, -10.0, 5.5), (-25.0, 0.0, 0.0),
                          aspect=W / H)
        n = int(scene.spheres.count)
        spec = (n, n, 0, 0, 0)
    o, d = (ja.tile_image(x, *TILE).reshape(-1, 3)
            for x in generate_rays(cam, H, W))
    if name == "obb":
        return scene, o, d, None, spec
    hit = geometry_op(scene, o, d, "xla", 512)[0]
    active = hit.hit & (scene.materials.reflectivity[hit.material_id] > 0.0)
    return (scene, hit.p + hit.n * BOUNCE_EPS, reflect(d, hit.n), active,
            spec)


_LEAVES = (("spheres", "center"), ("spheres", "radius"), ("boxes", "mins"),
           ("boxes", "maxs"), ("boxes", "position"), ("boxes", "angles"),
           ("planes", "normal"), ("planes", "offset"))


def _with(scene, vals):
    for (part, field), v in zip(_LEAVES, vals):
        scene = scene._replace(**{part: getattr(scene, part)._replace(
            **{field: v})})
    return scene


def _hit_loss(hit, w):
    """A weighted sum of t, p and n over the rays that hit."""
    hm = hit.hit.astype(jnp.float32) if isinstance(hit.t, jax.Array) \
        else hit.hit.to(torch.float32)
    t = hit.t * hm
    return ((t * w[:, 0]).sum() + (hit.p * w[:, 1:4] * hm[:, None]).sum()
            + (hit.n * w[:, 4:7] * hm[:, None]).sum())


@pytest.mark.parametrize("name", ["obb", "reflect"])
def test_culled_geometry_op_gradients_match_jax(name):
    """culled_geometry_op (the OBB world: a sphere and rotated boxes) and
    bounce_culled_geometry_op (the mirror grid's children: spheres and a
    plane) against jax.grad of the JAX package's ops run op by op: every
    leaf that gets a gradient, and the rays, to 1e-4 * max|g|."""
    scene, o, d, active, spec = _op_case(name)
    w = np.random.default_rng(1).normal(0, 1, (o.shape[0], 7)).astype(
        np.float32)

    def loss_j(vals, o_, d_):
        s = _with(scene, vals)
        if active is None:
            hit = ja.culled_geometry_op(s, o_, d_, TILE_P, spec[0], spec[1],
                                        None, *spec[2:])[0]
        else:
            hit = ja.bounce_culled_geometry_op(s, o_, d_, active, TILE_P,
                                               spec[0], spec[1], None,
                                               *spec[2:])[0]
        return _hit_loss(hit._replace(t=jnp.where(hit.hit, hit.t, 0.0)),
                         jnp.asarray(w))

    vals = [getattr(getattr(scene, p), f) for p, f in _LEAVES]
    g_j = jax.grad(loss_j, (0, 1, 2))(vals, o, d)
    want = dict(zip(_LEAVES, g_j[0]), origins=g_j[1], dirs=g_j[2])

    ts = to_torch_scene(scene)
    vt = [getattr(getattr(ts, p), f).clone().requires_grad_()
          for p, f in _LEAVES]
    ot, dt = (x.requires_grad_() for x in to_torch(o, d))
    s = _with(ts, vt)
    if active is None:
        hit = ta.culled_geometry_op(s, ot, dt, TILE_P, spec[0], spec[1],
                                    None, *spec[2:])[0]
    else:
        hit = ta.bounce_culled_geometry_op(s, ot, dt, to_torch(active),
                                           TILE_P, spec[0], spec[1], None,
                                           *spec[2:])[0]
    _hit_loss(hit._replace(t=torch.where(hit.hit, hit.t, 0.0)),
              torch.from_numpy(w)).backward()
    got = dict(zip(_LEAVES, (v.grad for v in vt)), origins=ot.grad,
               dirs=dt.grad)
    n_checked = 0
    for k, a in want.items():
        a = np_(a)
        b = np.zeros_like(a) if got[k] is None else np_(got[k])
        scale = float(np.abs(a).max()) if a.size else 0.0
        if scale == 0.0:
            assert not np.any(b), k
            continue
        n_checked += 1
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * scale,
                                   err_msg=f"gradient of {k}")
    assert n_checked >= (7 if name == "obb" else 5)


def test_host_sizing_matches_jax():
    """suggest_cull_sizes, and suggest_child_cull_config with
    hot_primary=False (the sizing of the 'culled' children: the maximum
    counts, no hot budget), return the JAX package's values, and
    cull_counts, measured with the 'culled' narrow phase, its counts."""
    scene, cam, cull, child = _fixture()
    ts, tc = to_torch_scene(scene), to_torch_camera(cam)
    assert ta.suggest_cull_sizes(ts, tc, H, W, TILE) == \
        ja.suggest_cull_sizes(scene, cam, H, W, TILE)
    got = ta.suggest_child_cull_config(ts, tc, H, W, cull, hot_primary=False)
    assert got == child and len(got) == 4
    for a, b in zip(ja.cull_counts(scene, cam, H, W, TILE),
                    ta.cull_counts(ts, tc, H, W, TILE)):
        np.testing.assert_array_equal(np_(b), np_(a))


# ---------------------------------------------------------------------------
# The stack on 'culled'
# ---------------------------------------------------------------------------

def test_stack_matches_jax():
    """trace_rays_stack on 'culled' at depth 3 on the glass world (both
    branches) with a spec no list can overflow, against the JAX package's
    'culled' stack on the same tile-major rays (tolerances of
    tests/test_torch_stack.py: rtol 1e-4, atol 1e-5), and with K = 1,
    where both count the same overflow events summed over every step."""
    scene, cam = reference_frame(0.9)
    h, w = 32, 64
    o, d = (ja.tile_image(x, *TILE).reshape(-1, 3)
            for x in jr.generate_rays(cam, h, w))
    ts = to_torch_scene(scene)
    n = int(scene.spheres.count)
    for spec in ((TILE_P, n, n, 0, 0, 0), (TILE_P, 1, 1, 0, 1, 1)):
        want, ovf_j = jr.trace_rays_stack(scene, o, d, 3, engine="culled",
                                          cull=spec, with_cull_stats=True)
        with torch.no_grad():
            got, ovf_t = tr.trace_rays_stack(ts, *to_torch(o, d), 3,
                                             engine="culled", cull=spec,
                                             with_cull_stats=True)
        assert int(ovf_t) == int(ovf_j)
        np.testing.assert_allclose(np_(got), np_(want), rtol=1e-4,
                                   atol=1e-5)
    assert int(ovf_t) > 0


def test_stack_render_and_gradients_match_jax():
    """render(engine='culled', bounce='stack') on a mirror grid at depth 2
    equals the port's trace of the tile-major rays, and its gradients (each
    step checkpointed and recomputed in the backward) match jax.grad of
    the JAX package's 'culled' stack run op by op to 2e-4 * max|g|
    (tests/test_torch_stack.py). Not with the scan's body compiled: XLA
    then contracts the winner replay's multiply-adds, which moves this
    fixture's center gradient by up to 8 % of an element (measured)."""
    scene, cam = sphere_grid_scene(3, reflectivity=0.5, seed=5)
    n = int(scene.spheres.count)
    ts, tc = to_torch_scene(scene), to_torch_camera(cam)
    with torch.no_grad():
        img, ovf = tr.render(ts, tc, 32, 32, depth=2, engine="culled",
                             bounce="stack", cull=(TILE, n, n, 0, 0, 0, 0),
                             with_cull_stats=True)
        o, d = (ta.tile_image(x, *TILE).reshape(-1, 3)
                for x in tr.generate_rays(tc, 32, 32))
        flat = tr.trace_rays_stack(ts, o, d, 2, engine="culled",
                                   cull=(TILE_P, n, n, 0, 0, 0))
    assert int(ovf) == 0
    assert torch.equal(img, ta.untile_image(flat, 32, 32, *TILE))

    spec = (TILE_P, n, n, 0, 0, 0)
    oj, dj = (jnp.asarray(np_(x)) for x in (o, d))
    trainable = ("spheres.center", "materials.diffuse")
    with jax.disable_jit():     # the scan's body op by op, not compiled
        g_j = jax.grad(lambda p: jnp.mean(jnp.square(jr.trace_rays_stack(
            jinv.apply_params(scene, p), oj, dj, 2, engine="culled",
            cull=spec) - 0.3)))(jinv.extract_params(scene, trainable))
    p_t = {k: v.detach().clone().requires_grad_()
           for k, v in tinv.extract_params(ts, trainable).items()}
    torch.mean(torch.square(tr.trace_rays_stack(
        tinv.apply_params(ts, p_t), o, d, 2, engine="culled",
        cull=spec) - 0.3)).backward()
    for k, a in g_j.items():
        a, b = np_(a), np_(p_t[k].grad)
        scale = float(np.abs(a).max())
        assert scale > 0.0, k
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-4 * scale,
                                   err_msg=f"gradient of {k}")


