"""PyTorch port: engine 'culled' end to end — render, a make_train_step
step, and cli render/fit/animate --engine culled — against the JAX
package's XLA culled engine. The fixture is tests/test_hot_child.py's
mirror grid, sphere_grid_scene(4, reflectivity=0.6, seed=3) at 48x64 with
16x16 tiles, with two of its materials made glass so that both bounce
branches run.

Tolerances. Images on identical rays (the port's, traced by the JAX
package run op by op): 1e-5, the JAX package's own bound between its
engines (tests/test_pallas_culled.py), and no overflow on either side.
Gradients against jax.grad run op by op: 1e-4 * max|g| per leaf, and
2e-3 * max|g| for the sphere leaves, as
tests/test_torch_bounce_render.py holds the kernel engine (the shade's
and the replay's sums run in another order). Against the JAX package's
jitted CLI, where XLA contracts multiply-adds into fused ones: one 8-bit
level."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglraytracer_tpu import cli as j_cli
from openglraytracer_tpu.models.animated import reference_frame
from openglraytracer_tpu.models.builders import sphere_grid_scene
from openglraytracer_tpu.models.scene import make_camera
from openglraytracer_tpu.ops import accel as ja
from openglraytracer_tpu.ops import render as jr
from openglraytracer_tpu.train import inverse as jinv
from openglraytracer_tpu_torch import cli
from openglraytracer_tpu_torch import kernels
from openglraytracer_tpu_torch.ops import accel as ta
from openglraytracer_tpu_torch.ops import render as tr
from openglraytracer_tpu_torch.train import inverse as tinv

from _torch_helpers import (jitted_sphere_rows, np_, to_torch_camera,
                            to_torch_scene)


@pytest.fixture(autouse=True)
def _reference_rows_as_jitted(monkeypatch):
    jitted_sphere_rows(monkeypatch)


TILE = (16, 16)
H, W = 48, 64
TRAINABLE = ("spheres.center", "spheres.radius", "materials.diffuse",
             "lights.position")


@functools.cache
def _fixture():
    """(scene, cam, parent spec, child spec sized for 'culled')."""
    scene, _ = sphere_grid_scene(4, reflectivity=0.6, seed=3)
    m = scene.materials
    scene = scene._replace(materials=m._replace(
        transparency=m.transparency.at[jnp.array([5, 10])].set(0.5),
        refraction_index=m.refraction_index.at[jnp.array([5, 10])].set(1.5)))
    cam = make_camera((0.0, -10.0, 5.5), (-25.0, 0.0, 0.0), aspect=W / H)
    cull = ja.suggest_cull_config(scene, cam, H, W, TILE, headroom=1.5)
    child = ja.suggest_child_cull_config(scene, cam, H, W, cull,
                                         headroom=1.5, hot_primary=False)
    return scene, cam, cull, child


def _flat(spec):
    tile, kp, ks, hot_m, kb, ksb = ja.parse_cull_spec(spec)
    return (tile[0] * tile[1], kp, ks, hot_m, kb, ksb)


def _port_rays(tc):
    """The port's rays in tile-major order, as JAX arrays."""
    return tuple(ja.tile_image(jnp.asarray(np_(x)), *TILE).reshape(-1, 3)
                 for x in tr.generate_rays(tc, H, W))


# ---------------------------------------------------------------------------
# render and the training step
# ---------------------------------------------------------------------------

_DEPTHS = {"depth0": (0, False), "depth1_child": (1, True),
           "depth1_dense": (1, False)}


@pytest.mark.parametrize("case", list(_DEPTHS))
def test_render_matches_jax(case):
    """render(engine='culled') at depth 0, and at depth 1 with the child
    spec (children on the culled path) and without (children on 'xla'),
    against the JAX package's trace_rays_fast on the port's rays, run op by
    op: 1e-5, no overflow; no kernel is launched."""
    depth, with_child = _DEPTHS[case]
    scene, cam, cull, child = _fixture()
    ts, tc = to_torch_scene(scene), to_torch_camera(cam)
    kernels.LAUNCHES.clear()
    with torch.no_grad():
        img_t, ovf_t = tr.render(ts, tc, H, W, depth=depth, engine="culled",
                                 cull=cull,
                                 child_cull=child if with_child else None,
                                 with_cull_stats=True)
    assert not kernels.LAUNCHES
    o, d = _port_rays(tc)
    with jax.disable_jit():
        colors_j, ovf_j = jr.trace_rays_fast(
            scene, o, d, depth, engine="culled", cull=_flat(cull),
            child_cull=_flat(child) if with_child else None,
            with_cull_stats=True)
    img_j = ja.untile_image(colors_j, H, W, *TILE)
    assert int(ovf_t) == int(ovf_j) == 0
    np.testing.assert_allclose(np_(img_t), np_(img_j), rtol=0, atol=1e-5)
    if depth:                       # the bounces changed the image
        with torch.no_grad():
            img_0 = tr.render(ts, tc, H, W, engine="culled", cull=cull)
        assert float((img_t - img_0).abs().max()) > 1e-2


def test_obb_render_matches_jax():
    """render(engine='culled') on the OBB world at depth 0 (the box broad
    and narrow phases, box shadows), against the JAX package on the port's
    rays run op by op: 2e-5, the shade's own bound on this scene, whose
    colors reach 3.7 (tests/test_torch_culled.py)."""
    scene, cam = reference_frame(1.2)
    cam = cam._replace(aspect=jnp.asarray(W / H, jnp.float32))
    spec = ja.suggest_cull_config(scene, cam, H, W, TILE)
    ts, tc = to_torch_scene(scene), to_torch_camera(cam)
    assert ta.suggest_cull_config(ts, tc, H, W, TILE) == spec
    with torch.no_grad():
        img_t = tr.render(ts, tc, H, W, engine="culled", cull=spec)
    o, d = _port_rays(tc)
    with jax.disable_jit():
        colors = jr.trace_rays_fast(scene, o, d, engine="culled",
                                    cull=_flat(spec))
    np.testing.assert_allclose(np_(img_t),
                               np_(ja.untile_image(colors, H, W, *TILE)),
                               rtol=0, atol=2e-5)


@pytest.mark.parametrize("case", list(_DEPTHS))
def test_train_step_matches_jax(case):
    """One SGD step of make_train_step on 'culled' (depth 0; depth 1 with
    and without the child spec) against jax.grad of the JAX package's
    'culled' trace of the same rays, run op by op: the loss to 1e-6
    relative, each leaf's gradient as stated above, and the stepped
    parameters."""
    depth, with_child = _DEPTHS[case]
    scene, cam, cull, child = _fixture()
    target = np.random.default_rng(3).random((H, W, 3)).astype(np.float32)
    ts, tc = to_torch_scene(scene), to_torch_camera(cam)
    o, d = _port_rays(tc)
    cc = _flat(child) if with_child else None

    def loss_fn(params):
        colors = jr.trace_rays_fast(jinv.apply_params(scene, params), o, d,
                                    depth, engine="culled", cull=_flat(cull),
                                    child_cull=cc, bounce_mask=(True, True),
                                    shadow_lights=(True,) * 2)
        img = ja.untile_image(colors, H, W, *TILE)
        return jnp.mean(jnp.square(img - target))

    loss_j, g_j = jax.value_and_grad(loss_fn)(
        jinv.extract_params(scene, TRAINABLE))

    lr = 1e-2
    cfg = tinv.FitConfig(height=H, width=W, depth=depth, engine="culled",
                         cull=cull, child_cull=child if with_child else None,
                         trainable=TRAINABLE)
    init_t, step_t = tinv.make_train_step(
        tc, cfg, optimizer=lambda ps: torch.optim.SGD(ps, lr=lr))
    p_t, opt_t = init_t(ts)
    before = {k: v.detach().clone() for k, v in p_t.items()}
    p_t, opt_t, loss_t, ovf_t = step_t(p_t, opt_t, ts, torch.tensor(target))

    assert int(ovf_t) == 0
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    for k in TRAINABLE:
        a, b = np_(g_j[k]), np_(p_t[k].grad)
        scale = float(np.abs(a).max())
        assert scale > 0.0, k
        tol = (2e-3 if k.startswith("spheres.") else 1e-4) * scale
        np.testing.assert_allclose(b, a, rtol=0, atol=tol,
                                   err_msg=f"gradient of {k}")
        np.testing.assert_allclose(np_(p_t[k]), np_(before[k]) - lr * b,
                                   rtol=0, atol=1e-7)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def _png(path):
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"), np.int16)


@pytest.mark.parametrize("flags", [
    ["--scene", "c3_grid64", "--width", "64", "--height", "64"],
    ["--scene", "c4_mirror", "--width", "64", "--height", "64",
     "--child-cull"],
    ["--scene", "c2_eight_spheres", "--width", "32", "--height", "32",
     "--depth", "2", "--bounce", "stack"]])
def test_cli_render_culled_cpu(flags, tmp_path, capsys):
    """render --engine culled: prints the cull spec (with --child-cull the
    child spec, sized as the reference sizes the 'culled' children: no
    hot budget; with --bounce stack the stack spec), and its PNG is within
    one 8-bit level of the JAX package's CLI run with the same flags."""
    out, ref = tmp_path / "t.png", tmp_path / "j.png"
    base = ["render", "--engine", "culled", "--cull-tile", "16"] + flags
    cli.main(base + ["--device", "cpu", "--out", str(out)])
    printed = capsys.readouterr().out
    assert ("stack cull: tile=16" if "stack" in flags
            else "cull: tile=16") in printed
    if "--child-cull" in flags:
        line = next(x for x in printed.splitlines()
                    if x.startswith("child cull:"))
        assert "hot_p" not in line
    if "stack" not in flags:       # the reference's CLI sizes no stack spec
        j_cli.main(base + ["--out", str(ref)])
        a, b = _png(out), _png(ref)
        assert a.shape == b.shape and int(np.abs(a - b).max()) <= 1
    else:
        assert _png(out).shape == (32, 32, 3)


def test_cli_fit_and_animate_culled_cpu(tmp_path, capsys):
    """fit --engine culled prints its cull spec and its loss falls;
    animate --engine culled writes its frames with one spec."""
    cli.main(["fit", "--engine", "culled", "--device", "cpu", "--grid-side",
              "2", "--width", "32", "--height", "32", "--cull-tile", "16",
              "--steps", "5"])
    printed = capsys.readouterr().out
    assert "cull: ((16, 16)" in printed
    line = next(x for x in printed.splitlines() if x.startswith("fit:"))
    first, final = (float(line.split(w)[1].split(",")[0])
                    for w in (" first ", " final "))
    assert final < first
    pattern = str(tmp_path / "c{}.png")
    cli.main(["animate", "--frames", "2", "--width", "32", "--height", "16",
              "--engine", "culled", "--device", "cpu", "--out-pattern",
              pattern])
    assert "cull: tile=8" in capsys.readouterr().out
    assert _png(tmp_path / "c1.png").shape == (16, 32, 3)
