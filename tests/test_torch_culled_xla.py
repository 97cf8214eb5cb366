"""PyTorch port: the XLA culled engine 'culled' — ops/accel.py
culled_geometry (the sphere quadratic and the box slab test over (tiles,
survivors, pixels), the dense hot-tile shadow pass), its differentiable
ops, its tile blocks and the host-side sizing it brings — against the JAX
package's ``accel.culled_geometry``.

Tolerances. Against the JAX package run op by op (``jax.disable_jit()``),
which rounds every op once as the port does: winner ids, hit and inside
flags, materials, occlusion where the ray hit, survivor lists, counts and
overflows exactly equal; t and p to rtol 1e-5 (boxes are rotated by each
package's own sin and cos, an ulp apart, which moves a box's t by an ulp);
normals to 1e-5. Against the jitted package, where XLA contracts
multiply-adds into fused ones: at most 1e-3 of rays may flip their winner
or an occlusion bit, t as above, normals to 1e-3 (the contracted normal of
a sphere moves by up to 2.2e-4 on the grid, measured). Gradients of
culled_geometry_op (tests/test_torch_culled_xla_grad.py)."""

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
from openglraytracer_tpu.ops.raygen import generate_rays
from openglraytracer_tpu.ops.render import BOUNCE_EPS
from openglraytracer_tpu.ops.transforms import reflect as j_reflect
from openglraytracer_tpu.ops.transforms import refract as j_refract
from openglraytracer_tpu_torch.ops import accel as ta

from _torch_helpers import assert_same_aux, np_, to_torch, to_torch_scene

TILE = (16, 16)
TILE_P = TILE[0] * TILE[1]
H, W = 48, 64
FLIP_SHARE = 1e-3          # winners the jitted package may flip at grazes


def _tiled(cam, h=H, w=W):
    o, d = generate_rays(cam, h, w)
    return (ja.tile_image(o, *TILE).reshape(-1, 3),
            ja.tile_image(d, *TILE).reshape(-1, 3))


@functools.cache
def _case(name):
    """(scene, origins, dirs, active or None, (kp, ks, hot_m, kb, ksb)) as
    JAX arrays.

    'grid': sphere_grid_scene(8), 64 spheres and a plane, with Kp and Ks
    half the measured maxima and hot_m 2, so that primary and cold shadow
    lists overflow and the dense hot pass decides two tiles a light.
    'obb': the reference's OBB world (a sphere, 4 rotated boxes, 3 lights).
    'reflect': the reflection children of a mirror grid (16 spheres and a
    plane), Kp = Ks = N. 'refract': the same hits refracted with eta 1.5,
    so that grazing rays totally internally reflect into the zero
    direction, with the OBB world's boxes as occluders and targets.
    'wide': 1024 spheres (sphere_grid_scene(32)) at 32x32, Kp = Ks = N:
    every mask is 1024 wide, so the JAX package compacts it with its
    Pallas kernel (interpret mode) and the port with the compaction
    kernel's plain version."""
    if name == "wide":
        scene, cam = sphere_grid_scene(32)
        return (scene, *_tiled(cam, 32, 32), None, (1024, 1024, 0, 0, 0))
    if name == "grid":
        scene, cam = sphere_grid_scene(8)
        cam = cam._replace(aspect=jnp.asarray(W / H, jnp.float32))
        kp, ks = ja.suggest_cull_sizes(scene, cam, H, W, TILE, headroom=1.0)
        return (scene, *_tiled(cam), None, (kp // 2, ks // 2, 2, 0, 0))
    if name == "obb":
        scene, cam = reference_frame(1.2)
        cam = cam._replace(aspect=jnp.asarray(W / H, jnp.float32))
        _, kp, ks, hot_m, kb, ksb = ja.parse_cull_spec(
            ja.suggest_cull_config(scene, cam, H, W, TILE))
        return (scene, *_tiled(cam), None, (kp, ks, hot_m, kb, ksb))
    if name == "reflect":
        scene, _ = sphere_grid_scene(4, reflectivity=0.6, seed=3)
    else:
        scene, _ = reference_frame(1.2)
    cam = make_camera((0.0, -10.0, 5.5), (-25.0, 0.0, 0.0), aspect=W / H)
    o, d = _tiled(cam)
    hit = geometry_op(scene, o, d, "xla", 512)[0]
    n = max(int(scene.spheres.count), 1)
    m = int(scene.boxes.count)
    if name == "reflect":
        active = hit.hit & (scene.materials.reflectivity[hit.material_id]
                            > 0.0)
        co, cd = hit.p + hit.n * BOUNCE_EPS, j_reflect(d, hit.n)
    else:
        active = hit.hit
        co = hit.p - hit.n * BOUNCE_EPS
        cd = j_refract(d, hit.n, jnp.full((d.shape[0], 1), 1.5))
    return scene, co, cd, active, (n, n, 0, m, m)


def _port(name, **kw):
    scene, o, d, active, spec = _case(name)
    act = None if active is None else to_torch(active)
    return ta.culled_geometry(to_torch_scene(scene), *to_torch(o, d), TILE_P,
                              *spec[:2], None, *spec[2:], active=act, **kw)


@functools.cache
def _jax(name, jit: bool):
    scene, o, d, active, (kp, ks, hot_m, kb, ksb) = _case(name)
    fn = functools.partial(ja.culled_geometry, tile_p=TILE_P, kp=kp, ks=ks,
                           shadow_lights=None, hot_m=hot_m, kb=kb, ksb=ksb)
    if jit:
        return jax.jit(fn)(scene, o, d, active=active)
    with jax.disable_jit():
        return fn(scene, o, d, active=active)


def _live(hit_j, active):
    live = np_(hit_j.hit)
    return live if active is None else live & np_(active)


@pytest.mark.parametrize("name", ["grid", "obb", "reflect", "refract",
                                  "wide"])
def test_culled_geometry_matches_jax_op_by_op(name):
    """Every discrete output equal to the JAX package's culled_geometry run
    op by op, hot tiles and overflowing lists included; t, p and n as
    stated above."""
    hit_j, occ_j, aux_j = _jax(name, jit=False)
    hit_t, occ_t, aux_t = _port(name)
    active = _case(name)[3]
    for f in ("hit", "obj_id", "material_id", "inside"):
        np.testing.assert_array_equal(np_(getattr(hit_t, f)),
                                      np_(getattr(hit_j, f)), err_msg=f)
    live = _live(hit_j, active)
    np.testing.assert_array_equal(np_(occ_t)[live], np_(occ_j)[live])
    np.testing.assert_allclose(np_(hit_t.t)[live], np_(hit_j.t)[live],
                               rtol=1e-5)
    np.testing.assert_allclose(np_(hit_t.p)[live], np_(hit_j.p)[live],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np_(hit_t.n)[live], np_(hit_j.n)[live],
                               rtol=0, atol=1e-5)
    assert_same_aux(aux_j, aux_t)
    assert int(ta.cull_overflow_count(aux_t)) == int(
        ja.cull_overflow_count(aux_j))
    assert live.sum() > 0
    if name == "grid":       # the fixture overflows, and the hot pass ran
        assert int(ta.cull_overflow_count(aux_t)) > 0
        assert int(np_(aux_t.s_overflow).sum()) > 0
    if name in ("obb", "refract"):
        gid = np_(hit_t.obj_id)[live]
        n_sph = int(_case(name)[0].spheres.count)
        assert (gid >= n_sph).any() and (gid < n_sph).any()
    if name == "wide":       # the masks took the compaction kernel's path
        assert aux_t.p_idx.shape[-1] == ta.MIN_N_FOR_KERNEL
        assert int(aux_t.p_count.max()) > 0
    if name == "refract":    # zero-direction children are misses
        zero = ~np.any(np_(_case(name)[2]) != 0.0, axis=-1) & np_(active)
        assert zero.any() and not np_(hit_t.hit)[zero].any()


@pytest.mark.parametrize("name", ["grid", "obb", "reflect"])
def test_culled_geometry_matches_jitted_jax(name):
    """Against the jitted package: the share of rays whose winner, hit or
    inside flag differs stays under FLIP_SHARE; the agreeing rays' t,
    normals and occlusion as op by op."""
    hit_j, occ_j, aux_j = _jax(name, jit=True)
    hit_t, occ_t, _ = _port(name)
    active = _case(name)[3]
    agree = np.ones(hit_t.t.shape[0], bool)
    for f in ("hit", "obj_id", "inside"):
        agree &= np_(getattr(hit_t, f)) == np_(getattr(hit_j, f))
    flipped = 1.0 - agree.mean()
    assert flipped <= FLIP_SHARE, f"{flipped:.2e} of rays flipped"
    live = _live(hit_j, active) & agree
    np.testing.assert_allclose(np_(hit_t.t)[live], np_(hit_j.t)[live],
                               rtol=1e-5)
    np.testing.assert_allclose(np_(hit_t.n)[live], np_(hit_j.n)[live],
                               rtol=0, atol=1e-3)
    share = (np_(occ_t)[live] != np_(occ_j)[live]).mean()
    assert share <= FLIP_SHARE


@pytest.mark.parametrize("name", ["grid", "obb", "reflect"])
def test_tile_blocks_equal_the_unblocked_call(name, monkeypatch):
    """The narrow phase and the shadow passes in blocks of one to three
    tiles (TILE_BLOCK_ELEMS cut to three tiles' pixels: one tile a block
    wherever a list holds three objects or more) give the unblocked call's
    outputs bit for bit."""
    whole = _port(name)
    monkeypatch.setattr(ta, "TILE_BLOCK_ELEMS", 3 * TILE_P)
    assert ta._tile_blocks(8, TILE_P) == [(0, 3), (3, 6), (6, 8)]
    blocked = _port(name)
    for a, b in zip((*whole[0], whole[1], *whole[2]),
                    (*blocked[0], blocked[1], *blocked[2])):
        assert torch.equal(a, b)
