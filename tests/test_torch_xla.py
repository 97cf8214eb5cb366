"""PyTorch port: the plain dense engine's intersection layer
(ops/intersect.py) against the JAX package's ops/intersect.py, run op by op
as the JAX package's own tests run it (tests/test_intersect.py), on the same
seeded numpy inputs: mixed sphere/box/plane scenes, with a third of the rays
aimed at sphere silhouettes and a third at box corners, each within a
relative 1e-6 of the graze.

Discrete outputs (hit flags, winner ids, materials, inside flags, occlusion
bits) must be equal; t and p to rtol 1e-6 (atol 1e-5 for p near the
origin), n to atol 1e-6 (the two libraries' rsqrt round differently).
Under jit the JAX package's XLA contracts some multiply-adds into fused
ones, and which ones depends on the shapes, so the port follows the op by
op rounding (tests/test_torch_xla_render.py holds renders to both)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglraytracer_tpu.models.animated import reference_frame
from openglraytracer_tpu.models.animated import reference_scene as j_ref
from openglraytracer_tpu.models.builders import (eight_sphere_scene,
                                                 mirror_scene)
from openglraytracer_tpu.models.scene import (Boxes, Planes, Spheres,
                                              make_lights, make_materials,
                                              make_scene)
from openglraytracer_tpu.ops import intersect as ji
from openglraytracer_tpu.ops.transforms import euler_rotation_3x3b as j_rot
from openglraytracer_tpu_torch.models.animated import reference_scene
from openglraytracer_tpu_torch.ops import intersect as ti
from openglraytracer_tpu_torch.ops.transforms import euler_rotation_3x3b

from _torch_helpers import np_, to_torch, to_torch_scene

T_RTOL, P_ATOL, N_ATOL = 1e-6, 1e-5, 1e-6
GRAZE = 1e-6


@functools.cache
def _mixed():
    """9 spheres, 4 rotated boxes, 2 planes, 3 materials, 3 lights (one of
    them ambient only). The box angles are reference_frame(0.8)'s, whose
    rotation tables round alike in both packages (their sin and cos do not
    everywhere), so closest_hit sees the same boxes."""
    rng = np.random.default_rng(11)
    ns, nb = 9, 4
    f = np.float32
    angles = np.asarray(reference_frame(0.8)[0].boxes.angles)
    spheres = Spheres(jnp.asarray(rng.uniform(-3, 3, (ns, 3)), f),
                      jnp.asarray(rng.uniform(0.4, 1.0, ns), f),
                      jnp.asarray(rng.integers(0, 3, ns), jnp.int32))
    boxes = Boxes(jnp.asarray(-rng.uniform(0.3, 0.9, (nb, 3)), f),
                  jnp.asarray(rng.uniform(0.3, 0.9, (nb, 3)), f),
                  jnp.asarray(rng.uniform(-3, 3, (nb, 3)), f),
                  jnp.asarray(angles, f),
                  jnp.asarray(rng.integers(0, 3, nb), jnp.int32))
    planes = Planes(jnp.asarray([[0.1, -0.2, 1.0], [0.0, 0.0, -2.0]], f),
                    jnp.asarray([-3.5, -9.0], f),
                    jnp.asarray([1, 2], jnp.int32))
    mats = make_materials([dict(diffuse=(0.8, 0.3, 0.2, 1.0)),
                           dict(diffuse=(0.2, 0.7, 0.3, 1.0)),
                           dict(diffuse=0.5)])
    lights = make_lights([
        dict(position=(5.0, 5.0, 8.0), ambient=0.1, diffuse=1.0,
             specular=1.0),
        dict(position=(0.1, 0.1, 0.1), ambient=0.2),
        dict(position=(-6.0, 2.0, 6.0), diffuse=0.5, specular=0.5)])
    scene = make_scene(spheres=spheres, boxes=boxes, planes=planes,
                       materials=mats, lights=lights)
    np.testing.assert_array_equal(
        np_(euler_rotation_3x3b(torch.from_numpy(np.array(angles)))),
        np_(j_rot(boxes.angles)))
    return scene


SCENES = {"mixed": _mixed,
          "obb_0.8": lambda: reference_frame(0.8)[0],
          "eight_spheres": lambda: eight_sphere_scene()[0],
          "mirror": lambda: mirror_scene()[0]}


def _graze_rays(scene, n=3000, seed=0):
    """(o, d) float32 numpy: origins in a box around the scene; a third of
    the rays aimed at a sphere's silhouette, a third at a box corner, each
    scaled by 1 +- GRAZE, and the rest in random directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-9.0, 9.0, (n, 3))
    d = rng.normal(0.0, 1.0, (n, 3))
    sph = scene.spheres
    if sph.count:
        c, r = np.asarray(sph.center, np.float64), np.asarray(sph.radius)
        k = rng.integers(0, sph.count, n)
        v = c[k] - o
        u = rng.normal(0.0, 1.0, (n, 3))
        u -= (u * v).sum(-1, keepdims=True) / (v * v).sum(-1, keepdims=True) \
            * v
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        scale = 1.0 + rng.choice([-GRAZE, 0.0, GRAZE], n)
        d[0::3] = (c[k] + u * (r[k] * scale)[:, None] - o)[0::3]
    box = scene.boxes
    if box.count:
        k = rng.integers(0, box.count, n)
        corner = np.where(rng.random((n, 3)) < 0.5, np.asarray(box.mins)[k],
                          np.asarray(box.maxs)[k])
        corner = corner * (1.0 + rng.choice([-GRAZE, 0.0, GRAZE], (n, 3)))
        rot = np.asarray(j_rot(box.angles), np.float64)[k]
        tgt = np.asarray(box.position)[k] + np.einsum("rij,rj->ri", rot,
                                                      corner)
        d[1::3] = (tgt - o)[1::3]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _check_hit(ht, hj, n_ref=None):
    """Discrete fields equal, t and p to rtol T_RTOL, n to atol N_ATOL of
    hj.n, or of n_ref where given."""
    for f in ("hit", "obj_id", "material_id", "inside"):
        np.testing.assert_array_equal(np_(getattr(ht, f)),
                                      np_(getattr(hj, f)), err_msg=f)
    np.testing.assert_allclose(np_(ht.t), np_(hj.t), rtol=T_RTOL, atol=0)
    np.testing.assert_allclose(np_(ht.p), np_(hj.p), rtol=T_RTOL,
                               atol=P_ATOL)
    np.testing.assert_allclose(np_(ht.n), np_(hj.n if n_ref is None
                                              else n_ref),
                               rtol=0, atol=N_ATOL)


def _tables(scene, kind):
    """The candidate test's object arguments, JAX and torch, with the last
    object marked invalid."""
    part = {"sphere": scene.spheres, "box": scene.boxes,
            "plane": scene.planes}[kind]
    valid = np.arange(part.count) < part.count - 1
    if kind == "sphere":
        cols = (part.center, part.radius)
    elif kind == "box":
        cols = (part.mins, part.maxs, part.position, j_rot(part.angles))
    else:
        cols = (part.normal, part.offset)
    cols = tuple(np.asarray(x) for x in cols) + (valid,)
    return tuple(jnp.asarray(x) for x in cols), to_torch(*cols)


@pytest.mark.parametrize("kind", ["sphere", "box", "plane"])
def test_candidates_match_jax(kind):
    """sphere_candidates, box_candidates (on the JAX package's rotation
    table) and plane_candidates, with and without normals: the (R, C)
    hits, t and inside flags, and the normals."""
    scene = _mixed()
    o, d = _graze_rays(scene)
    fn_j = getattr(ji, f"{kind}_candidates")
    fn_t = getattr(ti, f"{kind}_candidates")
    args_j, args_t = _tables(scene, kind)
    tj, nj, inj = fn_j(jnp.asarray(o), jnp.asarray(d), *args_j)
    tt, nt, int_ = fn_t(*to_torch(o, d), *args_t)
    hit = np_(tj) < ji.INF_T
    assert 0 < hit.sum() < hit.size
    np.testing.assert_array_equal(np_(tt) < ti.INF_T, hit)
    np.testing.assert_array_equal(np_(int_), np_(inj))
    np.testing.assert_allclose(np_(tt), np_(tj), rtol=T_RTOL, atol=0)
    np.testing.assert_allclose(np_(nt), np_(nj), rtol=0, atol=N_ATOL)
    t0, n0, in0 = fn_t(*to_torch(o, d), *args_t, with_normals=False)
    assert n0 is None and torch.equal(t0, tt) and torch.equal(in0, int_)


@pytest.mark.parametrize("max_t", [1.0, 0.5])
def test_sphere_blocked_matches_jax(max_t):
    """The sqrt-free occlusion predicate on unnormalized segments from the
    grazing rays' origins: every (ray, sphere) bit equal."""
    scene = _mixed()
    o, d = _graze_rays(scene, seed=1)
    seg = d * np.float32(12.0)
    args_j, args_t = _tables(scene, "sphere")
    want = np_(ji.sphere_blocked(jnp.asarray(o), jnp.asarray(seg), *args_j,
                                 max_t=max_t))
    assert 0 < want.sum()
    got = ti.sphere_blocked(*to_torch(o, seg), *args_t, max_t=max_t)
    np.testing.assert_array_equal(np_(got), want)


@pytest.mark.parametrize("name", ["mixed", "obb_0.8", "eight_spheres"])
def test_closest_hit_matches_jax(name):
    scene = SCENES[name]()
    o, d = _graze_rays(scene, seed=2)
    hj = ji.closest_hit(scene, jnp.asarray(o), jnp.asarray(d))
    ht = ti.closest_hit(to_torch_scene(scene), *to_torch(o, d))
    # the OBB world's wall box encloses every origin: every ray hits it
    assert 0 < int(ht.hit.sum()) and bool(ht.inside.any())
    _check_hit(ht, hj)


@pytest.mark.parametrize("name", ["eight_spheres", "mirror"])
def test_closest_hit_sp_matches_jax(name):
    """The normal-free sphere scan of sphere/plane scenes (the c2 and
    c4_mirror scenes), and its refusal of boxes. It rebuilds the winner's
    normal rounded as closest_hit computes it (o - c + t d; the JAX
    package's closest_hit_sp rounds o + t d - c, up to 2.4e-5 apart from
    distant origins), so that the bounce children of 'xla' and 'autodiff'
    start alike: its normals equal the port's closest_hit's and are held
    to the JAX package's closest_hit."""
    scene = SCENES[name]()
    o, d = _graze_rays(scene, seed=3)
    hj = ji.closest_hit_sp(scene, jnp.asarray(o), jnp.asarray(d))
    ts = to_torch_scene(scene)
    ht = ti.closest_hit_sp(ts, *to_torch(o, d))
    assert bool(ht.inside.any()) or name == "mirror"
    assert torch.equal(ht.n, ti.closest_hit(ts, *to_torch(o, d)).n)
    _check_hit(ht, hj, n_ref=ji.closest_hit(scene, jnp.asarray(o),
                                            jnp.asarray(d)).n)
    with pytest.raises(ValueError, match="sphere/plane"):
        ti.closest_hit_sp(to_torch_scene(_mixed()), *to_torch(o, d))


def _shadow_inputs(scene, seed):
    """Shadow origins p + 0.01 n and the segments to every light, from the
    JAX package's closest hit of grazing rays (numpy)."""
    o, d = _graze_rays(scene, seed=seed)
    hj = ji.closest_hit(scene, jnp.asarray(o), jnp.asarray(d))
    org = np.asarray(hj.p + hj.n * 0.01)
    seg = np.asarray(scene.lights.position[None] - hj.p[:, None])
    return org, seg


@pytest.mark.parametrize("mask", [None, (True, False, True)])
def test_shadow_occlusion_sp_matches_jax(mask):
    """Every light's occlusion in one scan, with and without the static
    light mask (a masked light casts nothing: unoccluded)."""
    scene = _mixed()
    org, seg = _shadow_inputs(scene, 4)
    want = np_(ji.shadow_occlusion_sp(scene, jnp.asarray(org),
                                      jnp.asarray(seg), lights_mask=mask))
    assert 0 < want.sum()
    got = ti.shadow_occlusion_sp(to_torch_scene(scene), *to_torch(org, seg),
                                 lights_mask=mask)
    np.testing.assert_array_equal(np_(got), want)
    if mask is not None:
        assert not np_(got)[:, 1].any()


def test_any_hit_matches_jax():
    """any_hit along each light's segment: equal to the JAX package's and
    to the matching column of shadow_occlusion_sp."""
    scene = _mixed()
    org, seg = _shadow_inputs(scene, 5)
    ts = to_torch_scene(scene)
    occ = ti.shadow_occlusion_sp(ts, *to_torch(org, seg))
    for j in range(seg.shape[1]):
        want = np_(ji.any_hit(scene, jnp.asarray(org),
                              jnp.asarray(seg[:, j])))
        got = ti.any_hit(ts, *to_torch(org, seg[:, j]))
        np.testing.assert_array_equal(np_(got), want)
        np.testing.assert_array_equal(np_(got), np_(occ[:, j]))


@pytest.mark.parametrize("chunk", [3, 7, 512])
def test_chunk_size_invariance(chunk):
    """The chunked running minimum gives the same record at every chunk
    size, bit for bit, as the JAX package's does; so does the shadow
    scan."""
    scene = _mixed()
    ts = to_torch_scene(scene)
    o, d = _graze_rays(scene, seed=6)
    ref = ti.closest_hit(ts, *to_torch(o, d), chunk_size=512)
    got = ti.closest_hit(ts, *to_torch(o, d), chunk_size=chunk)
    for f, a, b in zip(ti.Hit._fields, got, ref):
        assert torch.equal(a, b), f
    _check_hit(got, ji.closest_hit(scene, jnp.asarray(o), jnp.asarray(d),
                                   chunk_size=chunk))
    sp = SCENES["mirror"]()
    tsp = to_torch_scene(sp)
    a = ti.closest_hit_sp(tsp, *to_torch(o, d), chunk_size=chunk)
    b = ti.closest_hit_sp(tsp, *to_torch(o, d), chunk_size=512)
    for f, x, y in zip(ti.Hit._fields, a, b):
        assert torch.equal(x, y), f
    org, seg = _shadow_inputs(scene, 6)
    assert torch.equal(
        ti.shadow_occlusion_sp(ts, *to_torch(org, seg), chunk_size=chunk),
        ti.shadow_occlusion_sp(ts, *to_torch(org, seg)))


def test_first_minimum_ties():
    """Ties at equal t: of identical spheres the first wins, within a chunk
    and across chunks (strict <); a sphere beats a plane it touches (both
    hit at t = 5 exactly), in closest_hit and closest_hit_sp, as in the
    JAX package."""
    f = np.float32
    c = np.array([[0, 0, 1], [3, 0, 1], [0, 0, 1], [0, 0, 1]], f)
    scene = make_scene(
        spheres=Spheres(jnp.asarray(c), jnp.ones(4, f),
                        jnp.asarray([0, 1, 2, 3], jnp.int32)),
        planes=Planes(jnp.asarray([[0, 0, 1]], f), jnp.zeros(1, f),
                      jnp.asarray([1], jnp.int32)),
        materials=make_materials([dict(diffuse=0.5)] * 4),
        lights=make_lights([dict(position=(0.0, 0.0, 9.0), diffuse=1.0)]))
    # up the z axis from below: the plane z = 0 and the spheres' bottom
    # at t = 5; down onto the spheres' top at t = 3
    o = np.array([[0, 0, -5], [0, 0, 5], [3, 0, -5]], f)
    d = np.array([[0, 0, 1], [0, 0, -1], [0, 0, 1]], f)
    ts = to_torch_scene(scene)
    for chunk in (1, 2, 512):
        for fj, ft in ((ji.closest_hit, ti.closest_hit),
                       (ji.closest_hit_sp, ti.closest_hit_sp)):
            ht = ft(ts, *to_torch(o, d), chunk_size=chunk)
            hj = fj(scene, jnp.asarray(o), jnp.asarray(d), chunk_size=chunk)
            np.testing.assert_array_equal(np_(ht.t), [5.0, 3.0, 5.0])
            np.testing.assert_array_equal(np_(ht.obj_id), [0, 0, 1])
            _check_hit(ht, hj)


def test_degenerate_rays_no_nan():
    """A zero direction misses everything and an axis-parallel one hits,
    with finite outputs and a finite autograd gradient through the chunked
    scan (the guards take the place of the GLSL's IEEE infinities), as the
    JAX package's own test asks of it."""
    scene = to_torch_scene(j_ref(0.5))
    assert np.array_equal(np_(scene.spheres.center),
                          np_(reference_scene(0.5, device="cpu")
                              .spheres.center))
    o = torch.tensor([[0.0, -20.0, 0.0], [0.0, -20.0, 0.0]])
    d = torch.tensor([[0.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    hit = ti.closest_hit(scene, o, d)
    assert bool(torch.isfinite(hit.t).all()) and not bool(hit.hit[0])
    assert bool(hit.hit[1])
    centers = scene.spheres.center.clone().requires_grad_()
    s = scene._replace(spheres=scene.spheres._replace(center=centers))
    for dd in (d, torch.tensor([[0.0, 0.0, 0.0], [0.3, 1.0, 0.0]])):
        h = ti.closest_hit(s, o, dd)
        (g,) = torch.autograd.grad(torch.sum(torch.where(h.hit, h.t, 0.0)),
                                   centers)
        assert bool(torch.isfinite(g).all())
    g_j = jax.grad(lambda c: jnp.sum(jnp.where(
        (h := ji.closest_hit(j_ref(0.5)._replace(
            spheres=j_ref(0.5).spheres._replace(center=c)),
            jnp.asarray(np_(o)), jnp.asarray(np_(dd)))).hit, h.t, 0.0)))(
        j_ref(0.5).spheres.center)
    np.testing.assert_allclose(np_(g), np_(g_j), rtol=1e-5, atol=1e-6)
