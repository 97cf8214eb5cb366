"""PyTorch port: scene containers, builders, transforms and ray generation
against the JAX package."""

import json

import jax
import numpy as np
import pytest
import torch

from openglraytracer_tpu.models import builders as jb
from openglraytracer_tpu.models.scene import scene_to_dict as j_scene_to_dict
from openglraytracer_tpu.ops import raygen as jr
from openglraytracer_tpu.ops import transforms as jt
from openglraytracer_tpu_torch.models import builders as tb
from openglraytracer_tpu_torch.models import scene as ts
from openglraytracer_tpu_torch.ops import raygen as tr
from openglraytracer_tpu_torch.ops import transforms as tt

from _torch_helpers import np_, to_torch_camera, to_torch_scene


def _leaves(scene, cam):
    return [x for part in (*scene, cam) for x in part]


@pytest.mark.parametrize("name", list(jb.BENCH_CONFIGS))
def test_builders_bit_equal(name):
    """Same seeded numpy draws, same float64 -> float32 rounding: every
    builder's arrays equal the JAX builder's bit for bit, dtypes included."""
    jscene, jcam = jb.BENCH_CONFIGS[name][0]()
    tscene, tcam = tb.BENCH_CONFIGS[name][0](device="cpu")
    assert jb.BENCH_CONFIGS[name][1:] == tb.BENCH_CONFIGS[name][1:]
    jl = jax.tree_util.tree_leaves((jscene, jcam))
    tl = _leaves(tscene, tcam)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert np_(a).dtype == np_(b).dtype
        np.testing.assert_array_equal(np_(b), np_(a))


def test_builders_and_loaders_default_to_cuda():
    """Every public function of the port that builds or loads a scene, a
    camera, part of a scene or a camera's pixel grid (ops/raygen.py) puts
    it on the GPU unless asked otherwise,
    as the JAX package's builders put theirs on its default device. Found
    by inspecting each signature. Without a card a default call raises:
    it never falls back to the CPU."""
    import inspect

    from openglraytracer_tpu_torch.models import animated as ta
    found = {}
    for mod in (tb, ts, ta, tr):
        for name, fn in vars(mod).items():
            if (name.startswith("_") or not inspect.isfunction(fn)
                    or fn.__module__ != mod.__name__):
                continue
            params = inspect.signature(fn).parameters
            if "device" in params:
                found[f"{mod.__name__}.{name}"] = params["device"].default
    for name, (builder, *_) in tb.BENCH_CONFIGS.items():
        found[f"BENCH_CONFIGS[{name!r}]"] = inspect.signature(
            builder).parameters["device"].default
    short = {k.rsplit(".", 1)[-1] for k in found}
    assert {"single_sphere_scene", "eight_sphere_scene", "sphere_grid_scene",
            "mirror_scene", "mirror_grid4096_scene", "reference_materials",
            "reference_scene", "reference_camera", "reference_frame",
            "scene_from_numpy", "camera_from_numpy", "scene_from_dict",
            "camera_from_dict", "load_scene_camera", "make_camera",
            "make_materials", "make_lights", "pixel_ndc"} <= short, \
        sorted(short)
    assert {k: v for k, v in found.items() if v != "cuda"} == {}
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tb.sphere_grid_scene(2)
        with pytest.raises((AssertionError, RuntimeError)):
            tr.pixel_ndc(4, 4)


def test_scene_from_numpy_is_exact():
    jscene, jcam = jb.eight_sphere_scene()
    tscene, tcam = to_torch_scene(jscene), to_torch_camera(jcam)
    for a, b in zip(jax.tree_util.tree_leaves((jscene, jcam)),
                    _leaves(tscene, tcam)):
        assert np_(a).dtype == np_(b).dtype and b.device.type == "cpu"
        np.testing.assert_array_equal(np_(b), np_(a))
    assert tscene.spheres.count == 8 and tscene.object_count == 9


def test_scene_json_interchange(tmp_path):
    """A scene JSON written by the JAX package loads into the port with the
    same values, and the port's own save/load round-trips."""
    jscene, jcam = jb.single_sphere_scene()
    d = j_scene_to_dict(jscene)
    d["camera"] = {k: np_(v).tolist() for k, v in jcam._asdict().items()}
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(d))
    tscene, tcam = ts.load_scene_camera(str(path), device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves((jscene, jcam)),
                    _leaves(tscene, tcam)):
        np.testing.assert_array_equal(np_(b), np_(a))
    path2 = tmp_path / "again.json"
    ts.save_scene(tscene, str(path2), camera=tcam)
    s2, c2 = ts.load_scene_camera(str(path2), device="cpu")
    for a, b in zip(_leaves(tscene, tcam), _leaves(s2, c2)):
        assert torch.equal(a, b)


def test_scene_from_dict_rejects_bad_schema():
    with pytest.raises(ValueError, match="missing columns"):
        ts.scene_from_dict({"spheres": {"center": [[0.0, 0.0, 0.0]]}},
                           device="cpu")
    with pytest.raises(ValueError, match="dict of column arrays"):
        ts.scene_from_dict({"spheres": [[0.0, 0.0, 0.0]]}, device="cpu")


def test_make_scene_fills_empty_sets():
    mats = ts.make_materials([dict(diffuse=0.5)], device="cpu")
    lights = ts.make_lights([dict(position=(0.0, 0.0, 5.0), diffuse=1.0)],
                            device="cpu")
    scene = ts.make_scene(materials=mats, lights=lights)
    assert scene.spheres.count == scene.boxes.count == scene.planes.count == 0
    assert scene.spheres.material_id.dtype == torch.int32
    with pytest.raises(ValueError, match="required"):
        ts.make_scene(materials=mats)


def test_camera_matrices():
    """proj and view equal the JAX package's exactly, and so does the
    inverse view-projection: the port runs the reference's float32 LU
    (transforms.inv4) op for op, which keeps the reference's own error
    against the float64 inverse."""
    _, jcam = jb.sphere_grid_scene(8)
    tcam = to_torch_camera(jcam)
    jp, jv, ji = (np_(x) for x in jt.camera_matrices(jcam))
    tp, tv, ti = (np_(x) for x in tt.camera_matrices(tcam))
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tv, jv)
    exact = np.linalg.inv(jp.astype(np.float64) @ jv.astype(np.float64))
    assert np.abs(ti - exact).max() <= np.abs(ji - exact).max()


def _camera(name):
    if name == "obb":
        from openglraytracer_tpu.models.animated import reference_frame
        return reference_frame(1.2)[1]
    return jb.BENCH_CONFIGS[name][0]()[1]


@pytest.mark.parametrize("name", ["c3_grid64", "c5_grid4096",
                                  "c4_mirror4096", "obb"])
def test_camera_inverse_equals_jax_lu(name):
    """The inverse of proj @ view equals the reference's float32
    jnp.linalg.inv bit for bit at the far c5 camera (0, -160, 88) too,
    where a closed form is 6.8e-3 away from it (the reference's own error
    against float64 there is 6.7e-3)."""
    jcam = _camera(name)
    _, _, ji = jt.camera_matrices(jcam)
    _, _, ti = tt.camera_matrices(to_torch_camera(jcam))
    np.testing.assert_array_equal(np_(ti), np_(ji))


def test_euler_rotation_3x3b():
    angles = np.random.default_rng(0).uniform(-180, 180, (16, 3)) \
        .astype(np.float32)
    a = np_(jt.euler_rotation_3x3b(angles))
    b = np_(tt.euler_rotation_3x3b(torch.from_numpy(angles)))
    # same formula, elementwise; sin/cos of two libraries differ by an ulp
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


@pytest.mark.parametrize("hw", [(64, 64), (37, 51)])
def test_pixel_ndc_integer_division(hw):
    """NDC from integer half sizes, odd sizes included: exact."""
    h, w = hw
    jx, jy = jr.pixel_ndc(h, w)
    tx, ty = tr.pixel_ndc(h, w, device="cpu")
    np.testing.assert_array_equal(np_(tx), np_(jx))
    np.testing.assert_array_equal(np_(ty), np_(jy))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 100.0])
def test_inv4_equals_jax_on_random_matrices(scale):
    """transforms.inv4 is the reference's float32 LU and solve as such,
    not only on camera matrices: 200 seeded random 4x4s at each scale
    invert to jnp.linalg.inv's result bit for bit."""
    rng = np.random.default_rng(int(scale * 1000))
    mats = (rng.normal(size=(200, 4, 4)) * scale).astype(np.float32)
    for m in mats:
        np.testing.assert_array_equal(
            np_(tt.inv4(torch.from_numpy(m))),
            np_(jax.numpy.linalg.inv(jax.numpy.asarray(m))))


@pytest.mark.parametrize("builder", ["sphere_grid_scene",
                                     "eight_sphere_scene"])
def test_generate_rays_matches_jax(builder):
    """Origins and directions equal the JAX package's bit for bit: the
    camera inverse, the unprojection's pairwise sums and the fused |d|^2
    round as the reference's on the CPU."""
    _, jcam = getattr(jb, builder)()
    tcam = to_torch_camera(jcam)
    jo, jd = jr.generate_rays(jcam, 64, 64)
    to, td = tr.generate_rays(tcam, 64, 64)
    np.testing.assert_array_equal(np_(to), np_(jo))
    np.testing.assert_array_equal(np_(td), np_(jd))
    np.testing.assert_allclose(np.linalg.norm(np_(td), axis=-1), 1.0,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["c5_grid4096", "obb"])
def test_generate_rays_bit_equal_far_camera(name):
    """c5's far camera at 256x256, jitted on the JAX side as render runs
    it: every ray direction equal (before the LU port they were 7.2e-5
    apart, which moved 4.1 % of c5's pixels)."""
    jcam = _camera(name)
    jd = jax.jit(lambda c: jr.generate_rays(c, 256, 256)[1])(jcam)
    _, td = tr.generate_rays(to_torch_camera(jcam), 256, 256)
    np.testing.assert_array_equal(np_(td), np_(jd))


@pytest.mark.parametrize("time", [0.0, 0.3, 0.8, 1.2, 3.7, 11.0])
def test_reference_frame_matches_jax(time):
    """The animated OBB world and its orbiting camera: the same leaves,
    shapes and dtypes as the JAX package's, values equal but for float32
    sin and cos, which the two libraries may round an ulp apart (one entry
    at time 1.2): to 3e-7 relative and 1e-6 absolute."""
    from openglraytracer_tpu.models.animated import reference_frame as jf
    from openglraytracer_tpu_torch.models.animated import (
        reference_frame as tf)
    jscene, jcam = jf(time)
    tscene, tcam = tf(time, device="cpu")
    assert tscene.spheres.count == 1 and tscene.boxes.count == 4
    assert tscene.planes.count == 0 and tscene.lights.count == 3
    jl = jax.tree_util.tree_leaves((jscene, jcam))
    tl = _leaves(tscene, tcam)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert np_(a).dtype == np_(b).dtype and np_(a).shape == np_(b).shape
        np.testing.assert_allclose(np_(b), np_(a), rtol=3e-7, atol=1e-6)


def test_reference_constants_match_jax():
    from openglraytracer_tpu.models import scene as js
    assert ts.REF_MATERIALS == js.REF_MATERIALS
    assert ts.REF_LIGHTS == js.REF_LIGHTS
    assert ts.TIME_SCALE == js.TIME_SCALE
