"""PyTorch port: ``remat`` at the reference's positions, and the positional
order of render and trace_rays.

remat runs each object chunk (closest_hit, any_hit, and so shadow_masks,
phong_shade, trace_rays and the 'autodiff' engine; each mirror step of
trace_rays_mirror) under torch.utils.checkpoint while autograd records:
the backward recomputes the chunk instead of holding its (R, C)
intermediates. It changes no value: on the CPU the images and gradients
with remat equal those without bit for bit (the recompute is the same ops
in the same order). The analytic-backward engines ignore it, as in the
reference. The reference's signatures are held parameter for parameter:
remat is render's 7th positional parameter and trace_rays' 6th; the port's
own device keyword comes last."""

import functools
import inspect

import numpy as np
import pytest
import torch

from openglraytracer_tpu.models.animated import reference_frame
from openglraytracer_tpu.models.builders import mirror_scene
from openglraytracer_tpu.ops import intersect as ji
from openglraytracer_tpu.ops import render as jr
from openglraytracer_tpu.ops import shading as jsh
from openglraytracer_tpu.ops.raygen import generate_rays as j_rays
from openglraytracer_tpu_torch.ops import intersect as ti
from openglraytracer_tpu_torch.ops import render as tr
from openglraytracer_tpu_torch.ops import shading as tsh
from openglraytracer_tpu_torch.train import inverse as tinv

from _torch_helpers import np_, to_torch, to_torch_camera, to_torch_scene

H = W = 24
LEAVES = ("spheres.center", "spheres.radius", "boxes.position",
          "materials.diffuse")


@pytest.mark.parametrize("name", ["render", "trace_rays", "pick_tracer",
                                  "trace_rays_mirror", "closest_hit",
                                  "any_hit", "shadow_masks", "phong_shade"])
def test_signature_follows_the_reference(name):
    """Every parameter of the reference's function, in its order, with its
    default; render's own device keyword last, and no fused_shade switch
    (the port's culled_pallas always shades with the fused kernel)."""
    mods = {"render": (jr, tr), "trace_rays": (jr, tr),
            "pick_tracer": (jr, tr), "trace_rays_mirror": (jr, tr),
            "closest_hit": (ji, ti), "any_hit": (ji, ti),
            "shadow_masks": (jsh, tsh), "phong_shade": (jsh, tsh)}
    jm, tm = mods[name]
    jp = dict(inspect.signature(getattr(jm, name)).parameters)
    tp = dict(inspect.signature(getattr(tm, name)).parameters)
    if name == "render":
        assert list(tp)[-1] == "device"
        del tp["device"]
        assert "fused_shade" in jp and "fused_shade" not in tp
        del jp["fused_shade"]
    assert list(tp) == list(jp)
    for k, p in jp.items():
        assert tp[k].default == p.default, k
    if name in ("render", "trace_rays"):
        assert list(tp).index("remat") == (6 if name == "render" else 5)


@functools.cache
def _obb():
    """The reference's animated OBB world (spheres, rotated boxes, three
    lights), in both packages, with its rays."""
    scene, cam = reference_frame(0.9)
    o, d = j_rays(cam, H, W)
    return (scene, cam, to_torch_scene(scene), to_torch_camera(cam),
            *to_torch(np.array(o).reshape(-1, 3), np.array(d).reshape(-1, 3)))


def _grads(scene, fn, leaves=LEAVES):
    """fn(scene with fresh leaves) -> (output, {leaf: gradient of
    mean(out^2)})."""
    params = {k: v.detach().clone().requires_grad_() for k, v in
              tinv.extract_params(scene, leaves).items()}
    out = fn(tinv.apply_params(scene, params))
    torch.mean(torch.square(out)).backward()
    return out.detach(), {k: v.grad for k, v in params.items()}


def _assert_same(a, b):
    out_a, g_a = a
    out_b, g_b = b
    assert torch.equal(out_a, out_b)
    for k in g_a:
        assert g_a[k] is not None and torch.equal(g_a[k], g_b[k]), k


@pytest.mark.parametrize("chunk", [2, 512])
def test_trace_rays_remat_equal(chunk):
    """Engine 'autodiff' (trace_rays, depth 1): remat on and off, in chunks
    of 2 objects (many checkpointed chunks) and of 512 (one)."""
    *_, ts, _, o, d = _obb()
    runs = [_grads(ts, lambda s, r=r: tr.trace_rays(s, o, d, 1, chunk, r))
            for r in (False, True)]
    _assert_same(*runs)


def test_closest_hit_and_shading_remat_equal():
    """closest_hit's hit record and phong_shade's colour (through
    shadow_masks and any_hit) with remat, against without."""
    *_, ts, _, o, d = _obb()

    def shade(s, remat):
        hit = ti.closest_hit(s, o, d, chunk_size=2, remat=remat)
        col = tsh.phong_shade(s, d, hit, chunk_size=2, remat=remat)
        return torch.cat([col, hit.p, hit.n, hit.t[:, None]], dim=-1)

    _assert_same(*(_grads(ts, lambda s, r=r: shade(s, r))
                   for r in (False, True)))
    hit = ti.closest_hit(ts, o, d, chunk_size=2, remat=True)
    assert hit.t.grad_fn is None        # no grad recorded, no checkpoint
    occ = ti.any_hit(ts, hit.p + 0.01 * hit.n, d, chunk_size=2, remat=True)
    assert torch.equal(occ, ti.any_hit(ts, hit.p + 0.01 * hit.n, d,
                                       chunk_size=2))


@pytest.mark.parametrize("engine,depth,mirror", [
    ("autodiff", 1, False), ("xla", 1, False), ("auto", 0, False),
    ("xla", 2, True)])
def test_render_remat_equal(engine, depth, mirror):
    """render with remat on and off: 'autodiff' checkpoints its chunks,
    the mirror chain its steps, 'xla' ignores it; images and gradients
    equal."""
    *_, ts, tc, _, _ = _obb()
    runs = [_grads(ts, lambda s, r=r: tr.render(
        s, tc, H, W, depth, 3, r, engine=engine, mirror_only=mirror))
        for r in (False, True)]
    _assert_same(*runs)


def test_render_remat_matches_jax():
    """'autodiff' with remat at depth 1 against the JAX package's render
    with remat on the same camera (the rays equal bit for bit): images to
    the plain engine's 1e-3 against the jitted reference."""
    js, jc, ts, tc, _, _ = _obb()
    img_j = jr.render(js, jc, H, W, depth=1, remat=True, engine="autodiff")
    with torch.no_grad():
        img_t = tr.render(ts, tc, H, W, 1, 512, True, engine="autodiff")
    np.testing.assert_allclose(np_(img_t), np_(img_j), rtol=0, atol=1e-3)


def test_render_positional_remat():
    """The reference's positional call render(scene, cam, h, w, depth,
    chunk_size, remat) reaches trace_rays with remat set."""
    *_, ts, tc, _, _ = _obb()
    seen = []
    real = tr.trace_rays

    def spy(*a, **kw):
        seen.append(a[5] if len(a) > 5 else kw.get("remat"))
        return real(*a, **kw)

    tr.trace_rays = spy
    try:
        with torch.no_grad():
            tr.render(ts, tc, 8, 8, 0, 512, True, None, False, "autodiff")
    finally:
        tr.trace_rays = real
    assert seen == [True]


@pytest.mark.parametrize("remat", [False, True])
def test_fit_config_remat_reaches_render(monkeypatch, remat):
    scene, cam = mirror_scene()
    seen = []
    real = tinv.render

    def spy(*a, **kw):
        seen.append(kw["remat"])
        return real(*a, **kw)

    monkeypatch.setattr(tinv, "render", spy)
    ts, tc = to_torch_scene(scene), to_torch_camera(cam)
    init_fn, step_fn = tinv.make_train_step(tc, tinv.FitConfig(
        height=8, width=8, engine="autodiff", remat=remat))
    params, opt = init_fn(ts)
    step_fn(params, opt, ts, torch.zeros((8, 8, 3)))
    assert seen == [remat]
