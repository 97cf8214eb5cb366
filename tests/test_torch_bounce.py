"""PyTorch port: the pieces of the 4096-object culled paths — the compaction
kernel (its plain version), the secondary-ray culled geometry with kernel 2
in per-ray mode and its hot launch (their plain versions), the child cull
spec and the winner-overflow backward — against the JAX package, whose
Pallas kernels run here in interpret mode. The fixture is the JAX package's
own (tests/test_hot_child.py): sphere_grid_scene(4, reflectivity=0.6,
seed=3) at 48x64 with 16x16 tiles, and the reflection children of its
primary hits."""

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
from openglraytracer_tpu.ops.geometry import geometry_op
from openglraytracer_tpu.ops.pallas_compact import compact_mask_pallas
from openglraytracer_tpu.ops.pallas_culled import \
    bounce_culled_pallas_geometry_op
from openglraytracer_tpu.ops.raygen import generate_rays
from openglraytracer_tpu.ops.render import BOUNCE_EPS
from openglraytracer_tpu.ops.transforms import reflect as j_reflect
from openglraytracer_tpu.ops.transforms import refract as j_refract
from openglraytracer_tpu_torch.ops import accel as ta
from openglraytracer_tpu_torch.ops.culled import (bounce_culled_geometry_op,
                                                  culled_geometry)
from openglraytracer_tpu_torch.ops.transforms import reflect, refract

from _torch_helpers import (assert_same_aux, np_, to_torch, to_torch_camera,
                            to_torch_scene)

TILE = (16, 16)
TILE_P = TILE[0] * TILE[1]
H, W = 48, 64


def _mirror_scene():
    scene, _ = sphere_grid_scene(4, reflectivity=0.6, seed=3)
    cam = make_camera((0.0, -10.0, 5.5), (-25.0, 0.0, 0.0), aspect=W / H)
    return scene, cam


@functools.cache
def _primary(boxes: bool):
    """(scene, tile-major directions, primary Hit) as JAX arrays: the
    mirror grid, or the reference's OBB world."""
    if boxes:
        scene, cam = reference_frame(1.2)
        cam = cam._replace(aspect=jnp.asarray(W / H, jnp.float32))
    else:
        scene, cam = _mirror_scene()
    origins, dirs = generate_rays(cam, H, W)
    o = ja.tile_image(origins, *TILE).reshape(-1, 3)
    d = ja.tile_image(dirs, *TILE).reshape(-1, 3)
    return scene, d, geometry_op(scene, o, d, "xla", 512)[0]


@functools.cache
def _children(kind: str):
    """(scene, (co, cd, active)) as JAX arrays: the children of the primary
    hits. 'reflect': the mirror grid's reflections. 'boxes': reflections
    off the reference's OBB world (every hit spawns). 'refract': the mirror
    grid's hits refracted with eta 1.5, as on leaving glass, so grazing rays
    totally internally reflect and get the zero direction."""
    scene, d, hit = _primary(kind == "boxes")
    if kind == "refract":
        co = hit.p - hit.n * BOUNCE_EPS
        cd = j_refract(d, hit.n, jnp.full((d.shape[0], 1), 1.5))
        return scene, (co, cd, hit.hit)
    active = hit.hit
    if kind == "reflect":
        active = active & (scene.materials.reflectivity[hit.material_id]
                           > 0.0)
    return scene, (hit.p + hit.n * BOUNCE_EPS, j_reflect(d, hit.n), active)


def _compare(hit_j, occ_j, aux_j, hit_t, occ_t, aux_t, active):
    """Discrete records and CullAux exactly; t to rtol 1e-5 and n to rtol
    1e-4 / atol 1e-5 on active rays; occlusion exactly where they hit."""
    act = np_(active)
    for f in ("obj_id", "hit", "material_id", "inside"):
        np.testing.assert_array_equal(np_(getattr(hit_t, f))[act],
                                      np_(getattr(hit_j, f))[act], err_msg=f)
    live = act & np_(hit_j.hit)
    np.testing.assert_allclose(np_(hit_t.t)[live], np_(hit_j.t)[live],
                               rtol=1e-5)
    np.testing.assert_allclose(np_(hit_t.n)[act], np_(hit_j.n)[act],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np_(occ_t)[live], np_(occ_j)[live])
    assert_same_aux(aux_j, aux_t)


def _both(kind, kp, ks, hot_p=0, kb=0, ksb=0):
    scene, (co, cd, active) = _children(kind)
    out_j = bounce_culled_pallas_geometry_op(scene, co, cd, active, TILE_P,
                                             kp, ks, None, 0, kb, ksb, hot_p)
    out_t = culled_geometry(to_torch_scene(scene), *to_torch(co, cd), TILE_P,
                            kp, ks, None, 0, kb, ksb,
                            active=to_torch(active), hot_p=hot_p)
    return out_j, out_t, active


# ---------------------------------------------------------------------------
# Kernel 6: compaction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1024, 1100])
def test_compact_mask_matches_pallas(n):
    """compact_mask_plain (what compact_mask runs on the CPU, and the
    compaction kernel's plain version) against the JAX package's Pallas
    compaction on masks wide enough for the kernel, with empty, full and
    overflowing tiles: idx where valid, valid and count exactly."""
    rng = np.random.default_rng(n)
    mask = rng.random((12, n)) < rng.choice([0.001, 0.01, 0.05], (12, 1))
    mask[0] = False                     # empty tile
    mask[1] = True                      # full tile: count n >> k
    mask[2, [0, n // 2, n - 1]] = True  # first and last ids
    k = 40
    ij, vj, cj = compact_mask_pallas(jnp.asarray(mask), k)
    it, vt, ct = ta.compact_mask(torch.from_numpy(mask), k)
    assert it.shape == (12, k) and it.dtype == torch.int32
    np.testing.assert_array_equal(np_(vt), np_(vj))
    np.testing.assert_array_equal(np_(ct), np_(cj))
    np.testing.assert_array_equal(np_(it) * np_(vt), np_(ij) * np_(vj))
    assert int(ct.max()) > k and int(ct.min()) == 0


# ---------------------------------------------------------------------------
# Secondary mode (kernel 2, per-ray) and the hot pass
# ---------------------------------------------------------------------------

def test_reflect_refract_match_jax():
    """reflect and refract, total internal reflection (the zero vector)
    included."""
    _, (co, cd, active) = _children("refract")
    rng = np.random.default_rng(5)
    d = rng.normal(0, 1, (256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    n = rng.normal(0, 1, (256, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    eta = rng.uniform(0.6, 1.6, (256, 1)).astype(np.float32)
    a = j_refract(jnp.asarray(d), jnp.asarray(n), jnp.asarray(eta))
    b = refract(*to_torch(d, n, eta))
    tir = ~np.any(np_(a) != 0.0, axis=-1)
    assert tir.any() and not tir.all()
    np.testing.assert_array_equal(np_(b)[tir], 0.0)
    np.testing.assert_allclose(np_(b), np_(a), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        np_(reflect(*to_torch(d, n))), np_(j_reflect(jnp.asarray(d),
                                                     jnp.asarray(n))),
        rtol=1e-5, atol=1e-6)
    # the refract fixture's children hold TIR rays that are active
    zero = ~np.any(np_(cd) != 0.0, axis=-1) & np_(active)
    assert zero.any()


@pytest.mark.parametrize("kind", ["reflect", "boxes", "refract"])
def test_secondary_geometry_matches_jax(kind):
    """hot_p = 0, exact lists (Kp = N): the port's culled geometry in
    secondary mode (kernel 2's plain version) against the JAX package's
    bounce_culled_pallas_geometry_op."""
    scene, _ = _children(kind)
    n_sph, n_box = int(scene.spheres.count), int(scene.boxes.count)
    (hit_j, occ_j, aux_j), (hit_t, occ_t, aux_t), active = _both(
        kind, max(n_sph, 1), max(n_sph, 1), kb=n_box, ksb=n_box)
    _compare(hit_j, occ_j, aux_j, hit_t, occ_t, aux_t, active)
    assert int(np_(hit_j.hit).sum()) > 0
    if kind == "boxes":
        gid = np_(hit_j.obj_id)[np_(hit_j.hit)]
        assert ((gid >= n_sph) & (gid < n_sph + n_box)).any()


def test_hot_pass_matches_jax():
    """Kp = 8 with hot_p = T: the hot launch over the global table, the
    merge and the rebuilt winner lists against the JAX package. The fixture
    overflows Kp = 8 without the hot pass, so the hot pass decides the
    result."""
    scene, (co, cd, active) = _children("reflect")
    n = int(scene.spheres.count)
    t_tiles = co.shape[0] // TILE_P
    _, _, aux_cold = culled_geometry(to_torch_scene(scene), *to_torch(co, cd),
                                     TILE_P, 8, n, None,
                                     active=to_torch(active))
    assert int(ta.cull_overflow_count(aux_cold)) > 0
    (hit_j, occ_j, aux_j), (hit_t, occ_t, aux_t), active = _both(
        "reflect", 8, n, hot_p=t_tiles)
    _compare(hit_j, occ_j, aux_j, hit_t, occ_t, aux_t, active)
    assert int(ta.cull_overflow_count(aux_t)) == 0


def test_child_spec_matches_jax():
    """suggest_child_cull_config returns the JAX package's 7-element spec
    (its hot_primary=True sizing, the one for culled_pallas children)."""
    scene, cam = _mirror_scene()
    ts, tc = to_torch_scene(scene), to_torch_camera(cam)
    cull = ja.suggest_cull_config(scene, cam, H, W, TILE, headroom=1.5)
    cj = ja.suggest_child_cull_config(scene, cam, H, W, cull)
    ct = ta.suggest_child_cull_config(ts, tc, H, W, cull)
    assert ct == cj and len(ct) == 7


# ---------------------------------------------------------------------------
# The winner-overflow repair of the backward
# ---------------------------------------------------------------------------

def test_winner_overflow_zeroes_cotangents():
    """Kp = 2 with the hot pass: some hot tiles have more distinct winners
    than Kp, so some rays keep their winner (obj_id) but lose its slot
    (j_local = -1). Those rays get finite, zero cotangents — for the sphere
    parameters and for their rays — where the JAX package replays a sphere
    of radius 0; cull_overflow_count reports their tiles. Every other ray's
    cotangents, and the sphere gradients, match the JAX package's."""
    scene, (co, cd, active) = _children("reflect")
    n = int(scene.spheres.count)
    t_tiles = co.shape[0] // TILE_P
    spec = (TILE_P, 2, n, None, 0, 0, 0, t_tiles)

    def loss_j(center, radius, o, d):
        s = scene._replace(spheres=scene.spheres._replace(center=center,
                                                          radius=radius))
        hit, _, _ = bounce_culled_pallas_geometry_op(s, o, d, active, *spec)
        w = active & hit.hit
        return (jnp.sum(jnp.where(w, hit.t, 0.0))
                + jnp.sum(jnp.where(w[:, None], hit.p + hit.n, 0.0)))

    g_j = jax.grad(loss_j, (0, 1, 2, 3))(scene.spheres.center,
                                         scene.spheres.radius, co, cd)

    ts = to_torch_scene(scene)
    act = to_torch(active)

    def grads_t(weight):
        c = ts.spheres.center.clone().requires_grad_()
        r = ts.spheres.radius.clone().requires_grad_()
        o, d = (x.requires_grad_() for x in to_torch(co, cd))
        s = ts._replace(spheres=ts.spheres._replace(center=c, radius=r))
        hit, _, aux = bounce_culled_geometry_op(s, o, d, act, *spec)
        w = (act & hit.hit & weight).to(torch.float32)
        loss = torch.sum(w * hit.t) + torch.sum(w[:, None] * (hit.p + hit.n))
        loss.backward()
        return (c.grad, r.grad, o.grad, d.grad), hit, aux

    g_t, hit, aux = grads_t(torch.ones_like(act))
    is_sph = np_(hit.hit) & (np_(hit.obj_id) >= 0) & (np_(hit.obj_id) < n)
    lost = is_sph & (np_(aux.j_local).reshape(-1) < 0) & np_(active)
    assert lost.any(), "the fixture must overflow a winner list"
    lost_tiles = np.unique(np.nonzero(lost)[0] // TILE_P)
    assert np.all(np_(aux.p_count)[lost_tiles] > 2)
    assert int(ta.cull_overflow_count(aux)) >= len(lost_tiles)

    # the lost rays alone: every cotangent finite and zero
    g_lost, _, _ = grads_t(torch.from_numpy(lost))
    for g in g_lost:
        assert bool(torch.isfinite(g).all()) and not bool(g.any())
    # everything else as the JAX package
    keep = ~lost
    for name, a, b in (("center", g_j[0], g_t[0]), ("radius", g_j[1], g_t[1]),
                       ("origins", np_(g_j[2])[keep], np_(g_t[2])[keep]),
                       ("dirs", np_(g_j[3])[keep], np_(g_t[3])[keep])):
        a, b = np_(a), np_(b)
        scale = float(np.abs(a).max())
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
    np.testing.assert_array_equal(np_(g_t[2])[lost], 0.0)
