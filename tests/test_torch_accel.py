"""PyTorch port: the broad phase, survivor records and cull sizing of
ops/accel.py against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglraytracer_tpu.models.animated import reference_frame
from openglraytracer_tpu.models.builders import (eight_sphere_scene,
                                                 sphere_grid_scene)
from openglraytracer_tpu.ops import accel as ja
from openglraytracer_tpu.ops.pallas_culled import culled_geometry_pallas
from openglraytracer_tpu.ops.raygen import generate_rays
from openglraytracer_tpu_torch.ops import accel as ta
from openglraytracer_tpu_torch.ops.culled import culled_geometry

from _torch_helpers import (assert_same_aux, np_, to_torch, to_torch_camera,
                            to_torch_scene)

TILE = (16, 16)
TILE_P = TILE[0] * TILE[1]
H = W = 64


@pytest.fixture(scope="module")
def grid():
    scene, cam = sphere_grid_scene(8)
    origins, dirs = generate_rays(cam, H, W)
    o = ja.tile_image(origins, *TILE).reshape(-1, 3)
    d = ja.tile_image(dirs, *TILE).reshape(-1, 3)
    return scene, cam, o, d


@pytest.fixture(scope="module")
def grid_hit(grid):
    """Shadows-off primary hit of the grid (the JAX kernel in interpret
    mode, computed once)."""
    scene, _, o, d = grid
    hit, _, _ = culled_geometry_pallas(scene, o, d, TILE_P, 48, 8,
                                       (False, False))
    return hit


def test_tile_image_roundtrip_and_layout(grid):
    x = np.random.default_rng(1).random((H, W, 3)).astype(np.float32)
    tiled = ta.tile_image(torch.from_numpy(x), *TILE)
    np.testing.assert_array_equal(np_(tiled), np_(ja.tile_image(x, *TILE)))
    back = ta.untile_image(tiled.reshape(-1, 3), H, W, *TILE)
    np.testing.assert_array_equal(np_(back), x)
    with pytest.raises(ValueError, match="divide"):
        ta.tile_image(torch.from_numpy(x), 24, 24)


def test_primary_cones_and_compaction(grid):
    """tile_cones to fp rounding (its sums run in another order); on the
    same cones sphere_vs_cone and compact_mask are exact: idx where valid,
    valid and count."""
    scene, _, o, d = grid
    t_tiles = o.shape[0] // TILE_P
    axis_j, cos_j = ja.tile_cones(d.reshape(t_tiles, TILE_P, 3))
    axis_t, cos_t = ta.tile_cones(to_torch(d).reshape(t_tiles, TILE_P, 3))
    np.testing.assert_allclose(np_(axis_t), np_(axis_j), atol=2e-6)
    np.testing.assert_allclose(np_(cos_t), np_(cos_j), atol=2e-6)

    ts = to_torch_scene(scene)
    apex, axis, cos = to_torch(o[0], axis_j, cos_j)
    mask_j = ja.sphere_vs_cone(o[0], axis_j, cos_j, scene.spheres.center,
                               scene.spheres.radius)
    mask_t = ta.sphere_vs_cone(apex, axis, cos, ts.spheres.center,
                               ts.spheres.radius)
    np.testing.assert_array_equal(np_(mask_t), np_(mask_j))
    for k in (4, 16, 64):
        idx_j, val_j, cnt_j = ja.compact_mask(mask_j, k)
        idx_t, val_t, cnt_t = ta.compact_mask(mask_t, k)
        np.testing.assert_array_equal(np_(val_t), np_(val_j))
        np.testing.assert_array_equal(np_(cnt_t), np_(cnt_j))
        np.testing.assert_array_equal(np_(idx_t) * np_(val_t),
                                      np_(idx_j) * np_(val_j))
        assert idx_t.dtype == torch.int32 and cnt_t.dtype == torch.int32


def test_shadow_cones_and_range_prune(grid, grid_hit):
    """shadow_tile_cones to fp rounding; the range-pruned sphere test on
    the same cone exactly."""
    scene, hit = grid[0], grid_hit
    so = hit.p + hit.n * 0.01
    lpos = scene.lights.position[0]
    cj = ja.shadow_tile_cones(so, hit.hit, TILE_P, lpos)
    ct = ta.shadow_tile_cones(*to_torch(so, hit.hit), TILE_P,
                              to_torch(lpos))
    for a, b in zip(cj[:3], ct[:3]):
        np.testing.assert_allclose(np_(b), np_(a), rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(np_(ct[3]), np_(cj[3]))
    ts = to_torch_scene(scene)
    mj = ja.sphere_vs_cone(lpos, cj[0], cj[1], scene.spheres.center,
                           scene.spheres.radius, max_dist=cj[2])
    mt = ta.sphere_vs_cone(to_torch(lpos), *to_torch(cj[0], cj[1]),
                           ts.spheres.center, ts.spheres.radius,
                           max_dist=to_torch(cj[2]))
    np.testing.assert_array_equal(np_(mt), np_(mj))


def test_box_tables_match_jax():
    """OBB bounding spheres and the (M, 20) box table: rotations come from
    sin/cos of two libraries, an ulp apart."""
    scene, _ = reference_frame(1.2)
    ts = to_torch_scene(scene)
    for a, b in zip(ja.box_bounding_spheres(scene),
                    ta.box_bounding_spheres(ts)):
        np.testing.assert_allclose(np_(b), np_(a), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np_(ta._box_table(ts)),
                               np_(ja._box_table(scene)), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(np_(ta._sphere_table(ts)),
                                  np_(ja._sphere_table(scene)))


def test_segment_occluded_matches_jax(grid, grid_hit):
    """The dense hot-tile shadow pass: exact on the same inputs."""
    scene, hit = grid[0], grid_hit
    so = (hit.p + hit.n * 0.01).reshape(-1, TILE_P, 3)[:4]
    p = hit.p.reshape(-1, TILE_P, 3)[:4]
    c, r = scene.spheres.center, scene.spheres.radius
    ones = jnp.ones((1, c.shape[0]), bool)
    for li in range(scene.lights.count):
        lpos = scene.lights.position[li]
        a = ja._segment_occluded(so, p, lpos, c[None, :, 0], c[None, :, 1],
                                 c[None, :, 2], r[None, :], ones)
        tc, tr_ = to_torch(c, r)
        b = ta._segment_occluded(*to_torch(so, p, lpos), tc[None, :, 0],
                                 tc[None, :, 1], tc[None, :, 2], tr_[None, :],
                                 torch.ones((1, c.shape[0]), dtype=torch.bool))
        np.testing.assert_array_equal(np_(b), np_(a))


_SPEC_SCENES = {
    "c3_side8": lambda: sphere_grid_scene(8),
    "c2": eight_sphere_scene,
    "obb": lambda: reference_frame(1.2),
}


@pytest.mark.parametrize("name", list(_SPEC_SCENES))
def test_cull_spec_matches_jax(name):
    """cull_counts exact and the suggested spec tuple equal: the port's
    counts come from its own narrow phase where the JAX package runs its
    XLA culled engine."""
    scene, cam = _SPEC_SCENES[name]()
    ts, tc = to_torch_scene(scene), to_torch_camera(cam)
    from openglraytracer_tpu.ops.shading import static_shadow_mask
    lights = static_shadow_mask(scene)
    cj = ja.cull_counts(scene, cam, H, W, TILE, lights)
    ct = ta.cull_counts(ts, tc, H, W, TILE, lights)
    for a, b in zip(cj, ct):
        np.testing.assert_array_equal(np_(b), np_(a))
    spec_j = ja.suggest_cull_config(scene, cam, H, W, TILE)
    spec_t = ta.suggest_cull_config(ts, tc, H, W, TILE)
    assert spec_t == spec_j
    assert ta.suggest_cull_config(ts, tc, H, W, TILE, hot=False) == \
        ja.suggest_cull_config(scene, cam, H, W, TILE, hot=False)


def test_parse_cull_spec():
    assert ta.parse_cull_spec(((8, 8), 16, 24)) == ((8, 8), 16, 24, 0, 0, 0)
    assert ta.parse_cull_spec((64, 16, 24, 2, 3, 4)) == (64, 16, 24, 2, 3, 4)


def test_material_rows_and_overflow_count_match_jax(grid):
    """culled_material_rows by index gathers equals the JAX one-hot
    contraction exactly, and cull_overflow_count agrees on an undersized
    spec (kp = ks = 2 overflows)."""
    scene, _, o, d = grid
    ts = to_torch_scene(scene)
    for kp, ks in ((48, 64), (2, 2)):
        hit_j, _, aux_j = culled_geometry_pallas(scene, o, d, TILE_P, kp, ks)
        hit_t, _, aux_t = culled_geometry(ts, *to_torch(o, d), TILE_P, kp,
                                          ks)
        assert_same_aux(aux_j, aux_t)
        rows_j = ja.culled_material_rows(scene, hit_j, aux_j, TILE_P)
        rows_t = ta.culled_material_rows(ts, hit_t, aux_t, TILE_P)
        np.testing.assert_array_equal(np_(rows_t), np_(rows_j))
        ovf_j = int(ja.cull_overflow_count(aux_j))
        assert int(ta.cull_overflow_count(aux_t)) == ovf_j
        assert (ovf_j > 0) == (kp == 2)
