"""PyTorch port: the culled narrow phase (kernels A and B through their plain
versions), the fused shade and the culled_pallas render against the JAX
package, whose Pallas kernels run here in interpret mode (each JAX output is
computed once per module)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglraytracer_tpu.models.animated import reference_frame
from openglraytracer_tpu.models.builders import sphere_grid_scene
from openglraytracer_tpu.models.scene import Spheres
from openglraytracer_tpu.ops import accel as ja
from openglraytracer_tpu.ops.pallas_culled import culled_geometry_pallas
from openglraytracer_tpu.ops.pallas_shade import _shade_pallas
from openglraytracer_tpu.ops.raygen import generate_rays
from openglraytracer_tpu.ops.render import render as j_render
from openglraytracer_tpu.ops.render import trace_rays_fast as j_trace
from openglraytracer_tpu_torch.models.builders import \
    sphere_grid_scene as t_grid
from openglraytracer_tpu_torch.models.scene import Boxes
from openglraytracer_tpu_torch.ops import accel as ta
from openglraytracer_tpu_torch.ops.culled import culled_geometry
from openglraytracer_tpu_torch.ops.raygen import generate_rays as t_rays
from openglraytracer_tpu_torch.ops.render import render as t_render
from openglraytracer_tpu_torch.ops.shade import phong_fused

from _torch_helpers import (assert_same_aux, jitted_sphere_rows, np_, to_torch,
                            to_torch_camera, to_torch_scene)


@pytest.fixture(autouse=True)
def _reference_rows_as_jitted(monkeypatch):
    jitted_sphere_rows(monkeypatch)


TILE = (16, 16)
TILE_P = TILE[0] * TILE[1]
H = W = 64


def _tiled_rays(cam):
    origins, dirs = generate_rays(cam, H, W)
    return (ja.tile_image(origins, *TILE).reshape(-1, 3),
            ja.tile_image(dirs, *TILE).reshape(-1, 3))


def _grid_spec(ks_div=1, hot_m=0):
    scene, cam = sphere_grid_scene(8)
    kp, ks = ja.suggest_cull_sizes(scene, cam, H, W, TILE)
    return scene, cam, (kp, max(2, ks // ks_div), hot_m, 0, 0)


def _obb_spec():
    scene, cam = reference_frame(1.2)
    _, kp, ks, hot_m, kb, ksb = ja.parse_cull_spec(
        ja.suggest_cull_config(scene, cam, H, W, TILE))
    return scene, cam, (kp, ks, hot_m, kb, ksb)


_CASES = {
    "spheres": _grid_spec,
    # ks halved so that cold tiles overflow and the hot pass (top 4 tiles
    # per light) must compose with the kernel's cold-tile scan
    "hot_tiles": lambda: _grid_spec(ks_div=2, hot_m=4),
    # the reference's 4 OBBs + 1 sphere: box slab test, face pick, merge
    "obb": _obb_spec,
}


@pytest.mark.parametrize("case", list(_CASES))
def test_culled_geometry_matches_jax(case):
    """Shared-pinhole culled geometry on identical rays. Discrete records,
    occlusion (where the primary ray hit) and CullAux exactly; t, n and p at
    the tolerances the JAX package holds its own kernels to
    (tests/test_pallas_culled.py). Normals and points are compared on hits
    only: both sides leave dead values on misses."""
    scene, cam, (kp, ks, hot_m, kb, ksb) = _CASES[case]()
    o, d = _tiled_rays(cam)
    hit_j, occ_j, aux_j = culled_geometry_pallas(scene, o, d, TILE_P, kp, ks,
                                                 None, hot_m, kb, ksb)
    hit_t, occ_t, aux_t = culled_geometry(to_torch_scene(scene),
                                          *to_torch(o, d), TILE_P, kp, ks,
                                          None, hot_m, kb, ksb)
    for f in ("hit", "obj_id", "material_id", "inside"):
        np.testing.assert_array_equal(np_(getattr(hit_t, f)),
                                      np_(getattr(hit_j, f)), err_msg=f)
    hm = np_(hit_j.hit)[:, None]
    np.testing.assert_array_equal(np_(occ_t) & hm, np_(occ_j) & hm)
    np.testing.assert_allclose(np_(hit_t.t), np_(hit_j.t), rtol=5e-5,
                               atol=1e-4)
    np.testing.assert_allclose(np_(hit_t.n) * hm, np_(hit_j.n) * hm,
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np_(hit_t.p) * hm, np_(hit_j.p) * hm,
                               rtol=5e-4, atol=5e-4)
    assert_same_aux(aux_j, aux_t)
    if case == "hot_tiles":
        assert int(np_(aux_j.s_count).max()) > ks   # the hot pass mattered


def test_culled_geometry_rejects_bounce_mode():
    """The hot-primary pass belongs to secondary mode (bounce bundles, with
    an active mask); asking for it on primary rays raises."""
    scene, cam = sphere_grid_scene(2)
    ts, tc = to_torch_scene(scene), to_torch_camera(cam)
    o, d = (x.reshape(-1, 3) for x in t_rays(tc, 16, 16))
    with pytest.raises(ValueError, match="secondary"):
        culled_geometry(ts, o, d, 256, 4, 4, hot_p=1)
    hit, _, _ = culled_geometry(ts, o, d, 256, 4, 4,
                                active=torch.zeros(256, dtype=torch.bool))
    assert not bool(hit.hit.any())     # inactive rays are misses


def _grid_with_boxes():
    """The port's sphere_grid_scene(4) (16 spheres, a ground plane, two
    lights) with three rotated boxes among its spheres."""
    scene, cam = t_grid(4, device="cpu")
    boxes = Boxes(mins=torch.full((3, 3), -0.4),
                  maxs=torch.full((3, 3), 0.4),
                  position=torch.tensor([[-1.25, -1.25, 0.5],
                                         [1.25, 0.0, 0.6],
                                         [0.0, 2.5, 0.4]]),
                  angles=torch.tensor([[0.0, 30.0, 0.0], [15.0, 0.0, 45.0],
                                       [0.0, 0.0, 20.0]]),
                  material_id=torch.tensor([0, 1, 2], dtype=torch.int32))
    return scene._replace(boxes=boxes), cam


@pytest.mark.parametrize("mode", ["shared", "secondary"])
def test_both_engines_and_the_sizing_keep_the_same_survivors(mode):
    """Engine 'culled' (ops/accel.py) and culled_pallas (ops/culled.py)
    on one scene of spheres, boxes and a plane, the second light not
    casting, hot shadow tiles on: equal survivor lists and counts, primary
    and shadow, and equal shadow overflows. Secondary mode: the
    reflections of the primary hits with every third ray inactive, no
    hot-primary pass. Shared mode: cull_counts' primary sphere and box
    counts are the engines' counts."""
    from openglraytracer_tpu_torch.ops.transforms import reflect
    scene, cam = _grid_with_boxes()
    _, kp, ks, _, kb, ksb = ta.parse_cull_spec(
        ta.suggest_cull_config(scene, cam, H, W, TILE))
    o, d = (ta.tile_image(x, *TILE).reshape(-1, 3) for x in t_rays(cam, H, W))
    lights, hot_m, active = (True, False), 2, None
    if mode == "secondary":
        hit, _, _ = ta.culled_geometry(scene, o, d, TILE_P, kp, ks, lights)
        o, d = hit.p + hit.n * 1e-3, reflect(d, hit.n)
        active = hit.hit & (torch.arange(o.shape[0]) % 3 != 0)
    args = (scene, o, d, TILE_P, kp, max(1, ks // 2), lights, hot_m, kb,
            ksb)
    _, _, aux_x = ta.culled_geometry(*args, active=active)
    _, _, aux_c = culled_geometry(*args, active=active)
    for f in ("p_idx", "p_valid", "p_count", "b_idx", "b_valid", "b_count",
              "s_count", "s_overflow", "sb_count", "sb_overflow"):
        assert torch.equal(getattr(aux_x, f), getattr(aux_c, f)), f
    assert int(aux_c.b_count.sum()) > 0 and int(aux_c.s_count[0].sum()) > 0
    assert not bool(aux_c.s_count[1].any())
    if mode == "shared":
        p_count, _, pb_count, _ = ta.cull_counts(scene, cam, H, W, TILE,
                                                 lights)
        assert torch.equal(p_count, aux_c.p_count)
        assert torch.equal(pb_count, aux_c.b_count)


def test_shade_matches_jax_kernel():
    """The fused shade (its plain version on the CPU) against the JAX
    package's shade kernel on the same generic data: atol 2e-5 — the same
    chain in the same order, but XLA contracts a*b+c into FMAs where the
    port rounds every op, and the specular power amplifies that up to
    shininess-fold."""
    rng = np.random.default_rng(3)
    r_tot, n_l, tile_p = 512, 3, 256
    mat = rng.random((r_tot, 20)).astype(np.float32)
    mat[:, 16] = 1.0 + 63.0 * rng.random(r_tot)     # shininess 1..64
    lpos = rng.normal(0, 5, (n_l, 3)).astype(np.float32)
    lamb, ldiff, lspec = (rng.random((n_l, 4)).astype(np.float32)
                          for _ in range(3))
    dirs = rng.normal(0, 1, (r_tot, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    p = rng.normal(0, 3, (r_tot, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (r_tot, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    occ = rng.random((r_tot, n_l)) < 0.3
    args = (mat, lpos, lamb, ldiff, lspec, dirs, p, nrm)
    a = _shade_pallas(*(jnp.asarray(x) for x in args),
                      jnp.asarray(occ, jnp.float32), tile_p)
    b = phong_fused(*to_torch(*args), torch.from_numpy(occ))
    assert b.shape == (r_tot, 3) and b.dtype == torch.float32
    np.testing.assert_allclose(np_(b), np_(a), rtol=0, atol=2e-5)


# (builder, image tolerance on identical rays). 1e-5 is the JAX package's
# own bound between its engines (tests/test_pallas_culled.py) and holds on
# the sphere grid. The OBB scene's colors reach 3.7, and there the shade
# alone differs by up to 1.3e-5 on identical inputs (measured): XLA
# contracts the shade's a*b+c chains into FMAs where the port rounds each
# op, as its CUDA kernel does with --fmad=false. Its images are held to the
# shade's own bound, 2e-5 (test_shade_matches_jax_kernel).
_RENDER_SCENES = {
    "spheres": (lambda: sphere_grid_scene(8), 1e-5),
    "obb": (lambda: reference_frame(1.2), 2e-5),
}


@pytest.mark.parametrize("name", list(_RENDER_SCENES))
def test_render_matches_jax(name):
    """render(..., engine='culled_pallas'). On identical rays (the port's,
    traced by the JAX package's trace_rays_fast) the images agree to the
    tolerance above. Against the JAX package's render end to end they agree
    to one 8-bit level (1/255): the two generate rays that differ by up to
    2e-5 (see test_generate_rays_matches_jax), which the specular power
    amplifies to ~2e-3 in color."""
    builder, atol = _RENDER_SCENES[name]
    scene, cam = builder()
    spec = ja.suggest_cull_config(scene, cam, H, W, TILE)
    ts, tc = to_torch_scene(scene), to_torch_camera(cam)
    img_t, ovf = t_render(ts, tc, H, W, engine="culled_pallas", cull=spec,
                          with_cull_stats=True)
    assert img_t.shape == (H, W, 3) and int(ovf) == 0
    origins, dirs = (np_(x) for x in t_rays(tc, H, W))
    o = ja.tile_image(jnp.asarray(origins), *TILE).reshape(-1, 3)
    d = ja.tile_image(jnp.asarray(dirs), *TILE).reshape(-1, 3)
    _, kp, ks, hot_m, kb, ksb = ja.parse_cull_spec(spec)
    colors = j_trace(scene, o, d, engine="culled_pallas",
                     cull=(TILE_P, kp, ks, hot_m, kb, ksb))
    img_j = ja.untile_image(colors, H, W, *TILE)
    np.testing.assert_allclose(np_(img_t), np_(img_j), rtol=0, atol=atol)
    img_e2e = j_render(scene, cam, H, W, engine="culled_pallas", cull=spec)
    np.testing.assert_allclose(np_(img_t), np_(img_e2e), rtol=0,
                               atol=1.0 / 255.0)


def test_box_only_scene_render_matches_jax():
    """No spheres at all: empty sphere lists, boxes only. Tolerance as for
    the OBB scene in test_render_matches_jax."""
    scene, cam = reference_frame(1.2)
    scene = scene._replace(spheres=Spheres(
        center=jnp.zeros((0, 3), jnp.float32),
        radius=jnp.zeros((0,), jnp.float32),
        material_id=jnp.zeros((0,), jnp.int32)))
    spec = ja.suggest_cull_config(scene, cam, H, W, TILE)
    ts, tc = to_torch_scene(scene), to_torch_camera(cam)
    assert ta.suggest_cull_config(ts, tc, H, W, TILE) == spec
    o, d = _tiled_rays(cam)
    _, kp, ks, hot_m, kb, ksb = ja.parse_cull_spec(spec)
    cull = (TILE_P, kp, ks, hot_m, kb, ksb)
    a = j_trace(scene, o, d, engine="culled_pallas", cull=cull)
    from openglraytracer_tpu_torch.ops.render import trace_rays_fast
    b = trace_rays_fast(ts, *to_torch(o, d), engine="culled_pallas",
                        cull=cull)
    np.testing.assert_allclose(np_(b), np_(a), rtol=0, atol=2e-5)
