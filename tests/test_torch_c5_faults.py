"""PyTorch port: parity at the 4096-sphere scene, on a c5-scene fixture:
sphere_grid_scene(64), c5's camera (0, -160, 88), 256x256 rays in 32x32
tiles, the cull spec suggest_cull_config sizes for that image, cropped to
the tiles FAULT_TILES where the faults show (5 of 64 tiles, 5,120 rays).
The rays are the JAX package's own, which the port's equal bit for bit
(tests/test_torch_scene.py).

  * culled_pallas (its plain versions on the CPU) against the JAX
    package's jitted culled_geometry_pallas: every winner, t and occlusion
    bit equal. Before the survivor rows summed |oc|^2 with fused
    multiply-adds, as the jitted reference does, one winner and six rays'
    occlusion bits of the 65,536 differed, all in these tiles.
  * The plain engine 'xla' follows the JAX package run op by op, every op
    rounded once (a kept divergence, ROADMAP.md): against the jitted
    reference, whose XLA contracts multiply-adds by the shapes of its
    fusions, some rays of the crop take another winner or shade apart
    beyond 1/255; against the reference run op by op, none."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglraytracer_tpu.models.builders import sphere_grid_scene
from openglraytracer_tpu.ops import accel as ja
from openglraytracer_tpu.ops.pallas_culled import culled_geometry_pallas
from openglraytracer_tpu.ops.raygen import generate_rays as j_rays
from openglraytracer_tpu.ops.render import trace_rays_fast as j_trace
from openglraytracer_tpu.ops.shading import static_shadow_mask
from openglraytracer_tpu_torch.ops import culled as tcul
from openglraytracer_tpu_torch.ops.render import trace_rays_fast as t_trace

from _torch_helpers import np_, to_torch, to_torch_scene

HW, TILE = 256, 32
FAULT_TILES = (21, 26, 28, 29, 37)


@functools.cache
def _fixture():
    scene, cam = sphere_grid_scene(64)
    lights = static_shadow_mask(scene)
    spec = ja.suggest_cull_config(scene, cam, HW, HW, (TILE, TILE),
                                  shadow_lights=lights)
    o, d = j_rays(cam, HW, HW)
    ids = jnp.asarray(FAULT_TILES)
    o = ja.tile_image(o, TILE, TILE)[ids].reshape(-1, 3)
    d = ja.tile_image(d, TILE, TILE)[ids].reshape(-1, 3)
    return scene, lights, spec, np.array(o), np.array(d)


def test_culled_pallas_equals_jitted_reference_at_4096_spheres():
    scene, lights, spec, o, d = _fixture()
    (th, tw), kp, ks, _, kb, ksb = ja.parse_cull_spec(spec)
    # hot_m 0: the crop's few tiles would all be hot
    hit_j, occ_j, aux_j = jax.jit(
        lambda s, o, d: culled_geometry_pallas(s, o, d, th * tw, kp, ks,
                                               lights, 0, kb, ksb))(
        scene, jnp.asarray(o), jnp.asarray(d))
    hit_t, occ_t, aux_t = tcul.culled_geometry(
        to_torch_scene(scene), *to_torch(o, d), th * tw, kp, ks, lights, 0,
        kb, ksb)
    assert int(np_(aux_t.p_count).max()) <= kp
    np.testing.assert_array_equal(np_(hit_t.obj_id), np_(hit_j.obj_id))
    np.testing.assert_array_equal(np_(hit_t.t), np_(hit_j.t))
    np.testing.assert_array_equal(np_(hit_t.inside), np_(hit_j.inside))
    np.testing.assert_array_equal(np_(occ_t), np_(occ_j))


def _xla_colors(jitted: bool):
    scene, lights, _, o, d = _fixture()
    fn = functools.partial(j_trace, engine="xla", shadow_lights=lights)
    if jitted:
        return np_(jax.jit(fn)(scene, jnp.asarray(o), jnp.asarray(d)))
    with jax.disable_jit():
        return np_(fn(scene, jnp.asarray(o), jnp.asarray(d)))


@pytest.mark.parametrize("jitted", [False, True], ids=["op_by_op", "jit"])
def test_xla_keeps_the_op_by_op_rounding(jitted):
    """The kept divergence of the plain engine: equal (to the libraries'
    rsqrt and pow) to the reference run op by op; against its jitted
    render 2.4 % of this crop's rays shade apart beyond 1/255 (0.47 % of
    the whole 256x256 image)."""
    scene, lights, _, o, d = _fixture()
    with torch.no_grad():
        got = np_(t_trace(to_torch_scene(scene), *to_torch(o, d),
                          engine="xla", shadow_lights=lights))
    diff = np.abs(got - _xla_colors(jitted)).max(-1)
    apart = float((diff > 1.0 / 255.0).mean())
    if jitted:
        assert 0.0 < apart < 0.05, apart
    else:
        assert apart == 0.0 and diff.max() < 1e-4, (apart, diff.max())
