"""PyTorch port: kernel 3's plain version (the per-light shadow occlusion of
the culled engine) with its hot (tile, light) pairs, which test every
sphere of the scene, against the JAX package: the occlusion of
culled_geometry_pallas with hot_m > 0, whose Pallas shadow kernel runs here
in interpret mode and whose hot tiles take accel._segment_occluded, and
accel._segment_occluded itself on the hand-built graze inputs the GPU
checks hold the kernel to (kernel_cases.shadow_graze_inputs)."""

import jax.numpy as jnp
import numpy as np
import pytest

from openglraytracer_tpu.models.animated import reference_frame
from openglraytracer_tpu.models.builders import sphere_grid_scene
from openglraytracer_tpu.ops import accel as ja
from openglraytracer_tpu.ops.pallas_culled import culled_geometry_pallas
from openglraytracer_tpu.ops.raygen import generate_rays
from openglraytracer_tpu_torch import kernel_cases
from openglraytracer_tpu_torch.ops.culled import (_top_tiles,
                                                  culled_geometry,
                                                  shadow_occlusion)

from _torch_helpers import assert_same_aux, np_, to_torch, to_torch_scene

TILE = (16, 16)
TILE_P = TILE[0] * TILE[1]
H = W = 48


def _grid():
    scene, cam = sphere_grid_scene(8)
    kp, ks = ja.suggest_cull_sizes(scene, cam, H, W, TILE)
    return scene, cam, (kp, ks, 2, 0, 0)


def _boxes():
    scene, cam = reference_frame(1.2)
    _, kp, ks, _, kb, ksb = ja.parse_cull_spec(
        ja.suggest_cull_config(scene, cam, H, W, TILE))
    return scene, cam, (kp, ks, 2, kb, ksb)


@pytest.mark.parametrize("case", ["grid", "boxes"])
def test_hot_pairs_match_jax(case):
    """The (R, L) occlusion with hot shadow tiles equals the JAX package's
    on every ray, hit or not, bit for bit, and CullAux exactly. "grid":
    64 spheres, 2 lights, hot_m 2, with a tile hot for one light only;
    "boxes": the reference's OBB world (4 boxes, 1 sphere, 3 lights), hot
    sphere pairs beside the cold pairs' boxes."""
    scene, cam, (kp, ks, hot_m, kb, ksb) = {"grid": _grid,
                                            "boxes": _boxes}[case]()
    origins, dirs = generate_rays(cam, H, W)
    o = ja.tile_image(origins, *TILE).reshape(-1, 3)
    d = ja.tile_image(dirs, *TILE).reshape(-1, 3)
    _, occ_j, aux_j = culled_geometry_pallas(scene, o, d, TILE_P, kp, ks,
                                             None, hot_m, kb, ksb)
    _, occ_t, aux_t = culled_geometry(to_torch_scene(scene), *to_torch(o, d),
                                      TILE_P, kp, ks, None, hot_m, kb, ksb)
    np.testing.assert_array_equal(np_(occ_t), np_(occ_j))
    assert_same_aux(aux_j, aux_t)
    hot = [set(_top_tiles(c, hot_m).tolist()) for c in aux_t.s_count]
    if case == "grid":
        assert hot[0] != hot[1]         # a tile hot for one light only
        assert int(np_(aux_j.s_count).max()) > 0
    else:
        assert int(np_(aux_j.sb_count).max()) > 0     # boxes in the lists


@pytest.mark.parametrize("n_sph", [1100, 2048])
def test_plain_on_graze_inputs_matches_jax(n_sph):
    """Kernel 3's plain version on the hand-built graze inputs (tangent
    segments with the discriminant at 0 and an ulp either side, cast
    origins inside a sphere, qa at _DIV_EPS, tiles hot for one light only)
    against the JAX package's _segment_occluded: over every sphere on a hot
    pair, over the pair's valid survivor rows on a cold one. Bit for bit;
    the plane blocks nothing."""
    args, kw = kernel_cases.shadow_graze_inputs("cpu", n_sph)
    so, hp, lights, _, ssph, _, _, cnt, tile_p = args
    got = np_(shadow_occlusion(*args, **kw))
    n_tiles = cnt.shape[0]
    so_t = jnp.asarray(np_(so).reshape(n_tiles, tile_p, 3))
    hp_t = jnp.asarray(np_(hp).reshape(n_tiles, tile_p, 3))
    sph = jnp.asarray(np_(kw["spheres"]))
    want = np.zeros((n_tiles, tile_p, 2), bool)
    for li in range(2):
        lpos = jnp.asarray(np_(lights[li]))
        hot = np_(kw["hot_ids"][li])
        want[hot, :, li] = np_(ja._segment_occluded(
            so_t[hot], hp_t[hot], lpos, sph[None, :, 0], sph[None, :, 1],
            sph[None, :, 2], sph[None, :, 3], jnp.ones((1, n_sph), bool)))
        cold = np.setdiff1d(np.arange(n_tiles), hot)
        rows = np_(ssph[cold, li])                        # (C, Ks, 4)
        k = np.arange(rows.shape[1])
        valid = ~np.isnan(rows[..., 3]) & (k < np_(cnt[cold, li, 0:1]))
        want[cold, :, li] = np_(ja._segment_occluded(
            so_t[cold], hp_t[cold], lpos, *(jnp.asarray(rows[..., c])
                                            for c in range(3)),
            jnp.asarray(np.nan_to_num(rows[..., 3])), jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want.reshape(-1, 2))
    # the hand-built cases reach both sides of every branch they aim at
    blocked = want.reshape(-1, 2)[:, 0]
    kind = np.arange(blocked.size) % 8
    hot0 = np.isin(np.arange(blocked.size) // tile_p, np_(kw["hot_ids"][0]))
    for k in (0, 7):
        sel = blocked[hot0 & (kind == k)]
        assert sel.any() and not sel.all()
    assert not blocked[kind == 5].any() and blocked[hot0 & (kind == 6)].all()
