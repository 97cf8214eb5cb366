"""PyTorch port: the dense engine's forward (ops/dense.py, the plain version
of kernel 7) against the JAX package's pallas_geometry, whose Pallas kernel
runs here in interpret mode, on the same scenes and rays.

Both round each operation alike: the port writes out as fused
multiply-adds exactly the multiply-adds that XLA's CPU compiler contracts
in the reference kernel, so t is equal bit for bit when the two packages'
box rotation tables agree. They differ where XLA's sin or cos of a box
angle rounds an ulp apart from PyTorch's (reference_frame(1.2): one entry
of one box), which moves t by up to 2e-7 relative; and where XLA's rsqrt,
which is not correctly rounded, normalizes the normal (the port divides by
a correctly rounded sqrt): up to a few ulp of n. p = o + t d is rounded as
two operations in the port and fused by XLA: about one ulp of the scene's
scale. Discrete outputs are compared exactly: the hit mask, the winner,
its material and inside flag, and the occlusion bits where the ray hit
(on a miss the kernel's occlusion is computed but unspecified).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglraytracer_tpu.models.animated import reference_frame
from openglraytracer_tpu.models.builders import (eight_sphere_scene,
                                                 single_sphere_scene,
                                                 sphere_grid_scene)
from openglraytracer_tpu.ops.pallas_render import pallas_geometry
from openglraytracer_tpu.ops.raygen import generate_rays
from openglraytracer_tpu.ops.transforms import refract
from openglraytracer_tpu_torch import kernels
from openglraytracer_tpu_torch.ops import dense

from _torch_helpers import np_, to_torch, to_torch_scene

H = W = 32
T_RTOL = 1e-6
N_ATOL = 3e-6
P_RTOL, P_ATOL = 1e-6, 1e-5

FIXTURES = {
    "single_sphere": single_sphere_scene,
    "eight_spheres": eight_sphere_scene,
    "grid3": lambda: sphere_grid_scene(3),
    "obb_0.3": lambda: reference_frame(0.3),
    "obb_1.2": lambda: reference_frame(1.2),
}


def _rays(cam, h=H, w=W):
    o, d = generate_rays(cam, h, w)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def _compare(scene, o, d):
    """dense_geometry on the CPU against pallas_geometry on the same rays;
    returns the port's Hit."""
    geo = pallas_geometry(scene, o, d)
    hit, occ = dense.dense_geometry(to_torch_scene(scene), *to_torch(o, d))
    jh = geo.hit
    for f in ("hit", "obj_id", "material_id", "inside"):
        np.testing.assert_array_equal(np_(getattr(hit, f)),
                                      np_(getattr(jh, f)), err_msg=f)
    hm = np_(jh.hit)[:, None]
    assert occ.shape == geo.occluded.shape and occ.dtype == torch.bool
    np.testing.assert_array_equal(np_(occ) & hm, np_(geo.occluded) & hm)
    np.testing.assert_allclose(np_(hit.t), np_(jh.t), rtol=T_RTOL, atol=0)
    np.testing.assert_allclose(np_(hit.n), np_(jh.n), rtol=0, atol=N_ATOL)
    np.testing.assert_allclose(np_(hit.p), np_(jh.p), rtol=P_RTOL,
                               atol=P_ATOL)
    return hit


@pytest.mark.parametrize("name", list(FIXTURES))
def test_dense_geometry_matches_jax(name):
    scene, cam = FIXTURES[name]()
    hit = _compare(scene, *_rays(cam))
    assert 0 < int(hit.hit.sum())
    if name.startswith("obb"):
        # every pixel hits (the camera orbits inside the wall box), and
        # some winners are the boxes seen from inside
        assert bool(hit.hit.all()) and bool(hit.inside.any())


def test_dense_geometry_exact_t_without_trig():
    """Where the rotation tables agree (no box, or box angles whose sin and
    cos round alike in both packages), t is equal bit for bit."""
    for builder in (eight_sphere_scene, lambda: reference_frame(0.3)):
        scene, cam = builder()
        o, d = _rays(cam)
        geo = pallas_geometry(scene, o, d)
        hit, _ = dense.dense_geometry(to_torch_scene(scene), *to_torch(o, d))
        np.testing.assert_array_equal(np_(hit.t), np_(geo.hit.t))


def test_dense_geometry_ray_count_not_a_tile_multiple():
    """400 rays: the reference kernel pads to its tiles of 4096 with
    zero-direction rays; the port takes any count."""
    scene, cam = single_sphere_scene()
    _compare(scene, *_rays(cam, 20, 20))


def test_dense_geometry_zero_direction_rays_inside_boxes():
    """Rays with d = 0, as total internal reflection hands the refraction
    children, from points inside the OBB world's boxes: every box's slab t
    comes out of the clamped reciprocal (1e12), and whether such a ray hits
    is decided by INF_T and MISS_T. Plus refraction children of the
    world's primary hits spawned with glass's ratio (1.5 from inside every
    box, the wall cube's included), so that the grazing ones are total
    internal reflections, at a time whose rotation tables agree in both
    packages: there t is exact too."""
    scene, cam = reference_frame(0.8)
    inside = jnp.asarray([[0.0, 0.0, 0.0], [5.0, -5.0, -3.0], [3.0, 4.0, 1.0],
                          [10.99, 0.0, 0.0], [0.0, 0.0, -3.999],
                          [-3.0, 4.0, 1.0]], jnp.float32)
    _compare(scene, inside, jnp.zeros_like(inside))
    o, d = _rays(cam)
    geo = pallas_geometry(scene, o, d)
    # refraction children with glass's ratio: 1/1.5 from outside, 1.5 from
    # inside
    n = geo.hit.n
    ratio = jnp.where(geo.hit.inside, 1.5, 1.0 / 1.5)[:, None]
    child_d = refract(d, n, ratio)
    child_o = geo.hit.p - n * 1.0e-3
    tir = np.asarray(jnp.all(child_d == 0.0, axis=-1))
    assert tir.any()
    hit = _compare(scene, child_o, child_d)
    np.testing.assert_array_equal(
        np_(hit.t), np_(pallas_geometry(scene, child_o, child_d).hit.t))


def test_dense_hit_counts_no_launch_on_the_cpu():
    scene, cam = eight_sphere_scene()
    kernels.LAUNCHES.clear()
    dense.dense_geometry(to_torch_scene(scene), *to_torch(*_rays(cam)))
    assert sum(kernels.LAUNCHES.values()) == 0


def test_scene_tables_match_jax():
    """_scene_tables: planes pre-normalized (offset over the normal's
    length), empty types as tables of 0 rows."""
    from openglraytracer_tpu.ops.pallas_render import _scene_tables
    for builder in (lambda: sphere_grid_scene(3), lambda: reference_frame(0.8)):
        scene, _ = builder()
        sph, box, pln, lg = dense._scene_tables(to_torch_scene(scene))
        jsph, jbox, jpln, jlg = (np_(x) for x in _scene_tables(scene))
        assert sph.shape == (scene.spheres.count, dense.SPH_COLS)
        assert box.shape == (scene.boxes.count, dense.BOX_COLS)
        assert pln.shape == (scene.planes.count, dense.PLN_COLS)
        assert lg.shape == (scene.lights.count, dense.LIGHT_COLS)
        np.testing.assert_array_equal(np_(sph), jsph[:sph.shape[0], :4])
        np.testing.assert_allclose(np_(box), jbox[:box.shape[0]], rtol=0,
                                   atol=1e-7)
        np.testing.assert_allclose(np_(pln), jpln[:pln.shape[0], :4],
                                   rtol=1e-7, atol=0)
        np.testing.assert_array_equal(np_(lg), jlg[:, :3])
