"""PyTorch port: the winner replay (ops/geometry.py), the culled op's analytic
backward (ops/accel.py _culled_bwd, ops/culled.py culled_geometry_op) and the
gradients of the culled_pallas render against jax.grad of the JAX package's
culled_pallas path, whose Pallas kernels (the shade backward included) run
here in interpret mode. Both sides trace the same tile-major rays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglraytracer_tpu.models.animated import reference_frame
from openglraytracer_tpu.models.builders import sphere_grid_scene
from openglraytracer_tpu.ops import accel as ja
from openglraytracer_tpu.ops import geometry as jg
from openglraytracer_tpu.ops.raygen import generate_rays
from openglraytracer_tpu.ops.render import trace_rays_fast as j_trace
from openglraytracer_tpu.ops.transforms import euler_rotation_3x3b
from openglraytracer_tpu.train import inverse as jinv
from openglraytracer_tpu_torch.ops import geometry as tg
from openglraytracer_tpu_torch.ops.culled import (culled_geometry,
                                                  culled_geometry_op)
from openglraytracer_tpu_torch.ops.geometry import _box_recompute
from openglraytracer_tpu_torch.ops.render import trace_rays_fast as t_trace
from openglraytracer_tpu_torch.ops.transforms import \
    euler_rotation_3x3b as t_euler
from openglraytracer_tpu_torch.train import inverse as tinv

from _torch_helpers import jitted_sphere_rows, np_, to_torch, to_torch_scene


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


def _replay_inputs(seed, r_tot=96):
    """Random winners of every kind (sphere, box, plane, miss), inside
    flags and generic rays, as numpy arrays."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    kind = rng.integers(0, 4, r_tot)          # 0 sphere 1 box 2 plane 3 miss
    o = rng.normal(0, 3, (r_tot, 3)).astype(f32)
    d = rng.normal(0, 1, (r_tot, 3)).astype(f32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    c = (o + 4.0 * d + rng.normal(0, 0.3, (r_tot, 3))).astype(f32)
    r = (0.5 + rng.random(r_tot)).astype(f32)
    pn = rng.normal(0, 1, (r_tot, 3)).astype(f32)
    poff = rng.normal(0, 1, r_tot).astype(f32)
    bm = (-0.3 - rng.random((r_tot, 3))).astype(f32)
    bx = (0.3 + rng.random((r_tot, 3))).astype(f32)
    bp = (o + 5.0 * d).astype(f32)
    ang = rng.uniform(-80, 80, (r_tot, 3)).astype(f32)
    inside = rng.random(r_tot) < 0.2
    return dict(c=c, r=r, pn=pn, poff=poff, bm=bm, bx=bx, bp=bp, ang=ang,
                o=o, d=d, is_sph=kind == 0, is_box=kind == 1,
                inside=inside, hm=kind != 3,
                g=[rng.normal(0, 1, s).astype(f32)
                   for s in ((r_tot,), (r_tot, 3), (r_tot, 3))])


def test_winner_replay_and_its_vjp_match_jax():
    """_winner_recompute with boxes: values and the VJP with respect to
    every winner parameter and the rays, against jax.vjp of the JAX
    replay. rtol 1e-5/atol 1e-5: the same float32 chain, summed in the
    same order (the 3-sums of torch.sum and jnp.sum may round apart)."""
    x = _replay_inputs(5)
    rot_j = euler_rotation_3x3b(jnp.asarray(x["ang"]))
    diff_j = [jnp.asarray(x[k]) for k in ("c", "r", "pn", "poff", "bm", "bx",
                                          "bp")] + [rot_j] \
        + [jnp.asarray(x["o"]), jnp.asarray(x["d"])]
    flags = [jnp.asarray(x[k]) for k in ("is_sph", "inside", "hm", "is_box")]

    def f_j(c, r, pn, poff, bm, bx, bp, rot, o, d):
        return jg._winner_recompute(c, r, pn, poff, o, d, flags[0], flags[1],
                                    flags[2], box_params=(bm, bx, bp, rot),
                                    is_box=flags[3])

    out_j, vjp = jax.vjp(f_j, *diff_j)
    g_j = vjp(tuple(jnp.asarray(g) for g in x["g"]))

    leaves = [torch.tensor(np_(a)).requires_grad_() for a in diff_j]
    tflags = [torch.from_numpy(x[k]) for k in ("is_sph", "inside", "hm",
                                               "is_box")]
    c, r, pn, poff, bm, bx, bp, rot, o, d = leaves
    out_t = tg._winner_recompute(c, r, pn, poff, o, d, tflags[0], tflags[1],
                                 tflags[2], box_params=(bm, bx, bp, rot),
                                 is_box=tflags[3])
    g_t = torch.autograd.grad(out_t, leaves,
                              [torch.from_numpy(g) for g in x["g"]])
    for name, a, b in zip("tpn", out_j, out_t):
        np.testing.assert_allclose(np_(b), np_(a), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    names = ("c", "r", "pn", "poff", "bm", "bx", "bp", "rot", "o", "d")
    for name, a, b in zip(names, g_j, g_t):
        np.testing.assert_allclose(np_(b), np_(a), rtol=1e-5, atol=1e-5,
                                   err_msg=f"vjp {name}")


def test_box_replay_reproduces_the_forward():
    """On the animated OBB frame, every box winner's replayed t and normal
    equal the forward's (kernel A's plain version): the replay takes the
    local-space origin from the gathered rotation per ray, the forward from
    its precomputed row, so t agrees to rounding; the face pick agrees
    exactly, so the normals differ only by the forward's renormalization
    (an ulp, where another face would differ by order 1)."""
    scene, cam = reference_frame(1.2)
    spec = ja.suggest_cull_config(scene, cam, H, W, TILE)
    _, kp, ks, hot_m, kb, ksb = ja.parse_cull_spec(spec)
    ts = to_torch_scene(scene)
    o, d = to_torch(*_tiled_rays(cam))
    hit, _, aux = culled_geometry(ts, o, d, TILE_P, kp, ks, None, hot_m, kb,
                                  ksb)
    n_sph = ts.spheres.count
    is_box = hit.hit & (hit.obj_id >= n_sph) \
        & (hit.obj_id < n_sph + ts.boxes.count)
    assert int(is_box.sum()) > 100
    bid = (hit.obj_id - n_sph).clamp(0, ts.boxes.count - 1).long()
    b = ts.boxes
    rot = t_euler(b.angles)[bid]
    t_r, _, n_r = _box_recompute(b.mins[bid], b.maxs[bid], b.position[bid],
                                 rot, o, d, hit.inside)
    np.testing.assert_allclose(np_(t_r[is_box]), np_(hit.t[is_box]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np_(n_r[is_box]), np_(hit.n[is_box]),
                               rtol=0, atol=1e-6)


def _scene_c3_like():
    scene, cam = sphere_grid_scene(8)
    kp, ks = ja.suggest_cull_sizes(scene, cam, H, W, TILE)
    return scene, cam, (TILE_P, kp, ks, 0, 0, 0)


def _scene_obb():
    scene, cam = reference_frame(1.2)
    _, kp, ks, hot_m, kb, ksb = ja.parse_cull_spec(
        ja.suggest_cull_config(scene, cam, H, W, TILE))
    return scene, cam, (TILE_P, kp, ks, hot_m, kb, ksb)


_GRAD_CASES = {
    "sphere_grid": (_scene_c3_like,
                    ("spheres.center", "spheres.radius", "materials.diffuse",
                     "lights.position", "lights.diffuse")),
    "obb_frame": (_scene_obb,
                  ("boxes.position", "boxes.angles", "spheres.center",
                   "materials.diffuse")),
}


@pytest.mark.parametrize("case", list(_GRAD_CASES))
def test_render_gradients_match_jax(case):
    """Gradients of a pixel MSE (random target from a numpy seed) through
    trace_rays_fast, engine culled_pallas, on the same rays: per leaf,
    atol 1e-4 * max|g| (as the JAX package holds its own culled engines to
    each other, tests/test_pallas_culled.py): the port sums the survivor
    scatters with index_add_ and the light cotangents over all rays at once,
    where the JAX package contracts one-hot matrices and sums per tile. The
    loss to 1e-6 relative; the differentiable op's records equal the plain
    culled_geometry's exactly."""
    builder, trainable = _GRAD_CASES[case]
    scene, cam, cull = builder()
    o, d = _tiled_rays(cam)
    target = np.random.default_rng(11).random((H * W, 3)).astype(np.float32)

    def loss_j(params):
        img = j_trace(jinv.apply_params(scene, params), o, d, 0,
                      engine="culled_pallas", cull=cull)
        return jnp.mean(jnp.square(img - target))

    lj, gj = jax.value_and_grad(loss_j)(jinv.extract_params(scene,
                                                            trainable))

    ts = to_torch_scene(scene)
    to, td = to_torch(o, d)
    params = {k: v.clone().requires_grad_()
              for k, v in tinv.extract_params(ts, trainable).items()}
    img = t_trace(tinv.apply_params(ts, params), to, td,
                  engine="culled_pallas", cull=cull)
    lt = torch.mean(torch.square(img - torch.from_numpy(target)))
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-6)
    for k in trainable:
        a, b = np_(gj[k]), np_(params[k].grad)
        scale = float(np.abs(a).max())
        assert scale > 0.0, k
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * scale,
                                   err_msg=f"gradient of {k}")

    # the op's forward is culled_geometry, whose records equal the JAX
    # package's exactly (tests/test_torch_culled.py): it changes none
    hit_a, occ_a, aux_a = culled_geometry(ts, to, td, *cull[:3], None,
                                          *cull[3:])
    hit_b, occ_b, aux_b = culled_geometry_op(ts, to, td, *cull[:3], None,
                                             *cull[3:])
    for a, b in zip((*hit_a, occ_a, *aux_a), (*hit_b, occ_b, *aux_b)):
        assert torch.equal(a, b)


def test_culled_op_returns_only_what_is_asked():
    """Leaves that do not require grad get none; origins and dirs get theirs
    only when asked, with the miss rule: a ray that hit nothing passes p's
    cotangent straight to its origin."""
    scene, cam, cull = _scene_c3_like()
    ts = to_torch_scene(scene)
    o, d = (x.clone().requires_grad_() for x in to_torch(*_tiled_rays(cam)))
    center = ts.spheres.center.clone().requires_grad_()
    ts = ts._replace(spheres=ts.spheres._replace(center=center))
    hit, occ, aux = culled_geometry_op(ts, o, d, *cull[:3], None, *cull[3:])
    for x in (hit.inside, hit.obj_id, hit.hit, occ, *aux):
        assert not x.requires_grad
    torch.sum(hit.p).backward()
    assert ts.spheres.radius.grad is None and center.grad is not None
    miss = ~hit.hit
    assert int(miss.sum()) > 0
    np.testing.assert_array_equal(np_(o.grad[miss]), 1.0)
    np.testing.assert_array_equal(np_(d.grad[miss]), 0.0)
