"""PyTorch port on a CUDA device: each hand-written kernel against its plain
version on the same inputs, the launch counts, a sync-free frame and a
sync-free training step.

Needs a GPU and nvcc; skipped elsewhere. Imports no jax, so it runs on a
machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from openglraytracer_tpu_torch import kernels
from openglraytracer_tpu_torch.models.builders import sphere_grid_scene
from openglraytracer_tpu_torch.models.scene import (Boxes, Planes, Spheres,
                                                    make_camera, make_lights,
                                                    make_materials,
                                                    make_scene)
from openglraytracer_tpu_torch.ops import culled, shade, shading
from openglraytracer_tpu_torch.ops.accel import suggest_cull_config
from openglraytracer_tpu_torch.ops.render import render
from openglraytracer_tpu_torch.train import inverse

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _box_scene(device):
    rng = np.random.default_rng(11)

    def t(x, dtype=torch.float32):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    n = 6
    boxes = Boxes(mins=t(-0.2 - 0.5 * rng.random((n, 3))),
                  maxs=t(0.2 + 0.5 * rng.random((n, 3))),
                  position=t(rng.normal(0.0, 1.5, (n, 3))),
                  angles=t(rng.uniform(-90.0, 90.0, (n, 3))),
                  material_id=t(rng.integers(0, 2, n), torch.int32))
    spheres = Spheres(center=t([[0.5, -1.0, 0.5]]), radius=t([0.5]),
                      material_id=t([1], torch.int32))
    planes = Planes(normal=t([[0.0, 0.0, 1.0]]), offset=t([-2.0]),
                    material_id=t([0], torch.int32))
    mats = make_materials([dict(diffuse=(0.8, 0.3, 0.2, 1.0),
                                shininess=20.0), dict(diffuse=0.6)],
                          device=device)
    lights = make_lights([dict(position=(4.0, -5.0, 6.0), ambient=0.1,
                               diffuse=1.0, specular=1.0),
                          dict(position=(0.1, 0.1, 0.1), ambient=0.3)],
                         device=device)
    cam = make_camera((0.0, -7.0, 2.0), angles=(-12.0, 0.0, 0.0),
                      aspect=1.0, device=device)
    return make_scene(spheres=spheres, boxes=boxes, planes=planes,
                      materials=mats, lights=lights), cam


def _kernel_inputs(monkeypatch, scene, cam, hw, tile):
    """Arguments each kernel wrapper receives on the render path."""
    seen = {}
    for mod, name in ((culled, "primary_hit"), (culled, "shadow_occlusion"),
                      (shade, "phong_fused")):
        fn = getattr(mod, name)

        def spy(*a, _fn=fn, _name=name):
            seen[_name] = a
            return _fn(*a)
        monkeypatch.setattr(mod, name, spy)
    spec = suggest_cull_config(scene, cam, hw, hw, (tile, tile))
    render(scene, cam, hw, hw, cull=spec)
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("which", ["grid", "boxes"])
def test_kernels_match_plain_versions(dev, monkeypatch, which):
    """Kernel vs plain version, same inputs, on the card: both round every
    op as IEEE float32 (--fmad=false; the sphere quadratic's fmaf is
    emulated exactly in the plain version), so discrete outputs are equal
    and floats equal to a few ulp (rsqrtf); the shade to 2e-5 (expf/logf
    against PyTorch's own, amplified by shininess)."""
    scene, cam = (sphere_grid_scene(8, device=dev) if which == "grid"
                  else _box_scene(dev))
    args = _kernel_inputs(monkeypatch, scene, cam, 128, 16)
    a = args["primary_hit"]
    if which == "boxes":
        assert a[2].shape[1] > 0
    k, p = culled.primary_hit(*a), culled.primary_hit_plain(*a)
    for x, y in zip(k[2:], p[2:]):
        assert torch.equal(x, y)
    torch.testing.assert_close(k[0], p[0], rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(k[1], p[1], rtol=0, atol=1e-5)
    b = args["shadow_occlusion"]
    for x, y in zip(culled.shadow_occlusion(*b),
                    culled.shadow_occlusion_plain(*b)):
        assert torch.equal(x, y)
    s = args["phong_fused"]
    torch.testing.assert_close(shade.phong_fused(*s), shading.phong_core(*s),
                               rtol=0, atol=2e-5)


def test_launch_counts_and_cpu_agreement(dev):
    """One launch of each kernel per frame, none on the CPU path; the card's
    image equals the CPU's (plain versions) to 1e-4 (rsqrt/exp/log of two
    libraries, amplified by the specular power)."""
    scene, cam = sphere_grid_scene(8, device=dev)
    spec = suggest_cull_config(scene, cam, 64, 64, (16, 16))
    kernels.LAUNCHES.clear()
    img, ovf = render(scene, cam, 64, 64, cull=spec, with_cull_stats=True)
    assert dict(kernels.LAUNCHES) == {"primary_hit": 1,
                                      "shadow_occlusion": 1,
                                      "phong_fused": 1}
    assert int(ovf) == 0
    cpu_scene, cpu_cam = sphere_grid_scene(8)
    kernels.LAUNCHES.clear()
    ref = render(cpu_scene, cpu_cam, 64, 64, cull=spec)
    assert sum(kernels.LAUNCHES.values()) == 0
    torch.testing.assert_close(img.cpu(), ref, rtol=0, atol=1e-4)


def test_frame_is_sync_free(dev):
    scene, cam = sphere_grid_scene(8, device=dev)
    lights = shading.static_shadow_mask(scene)
    spec = suggest_cull_config(scene, cam, 128, 128, (32, 32),
                               shadow_lights=lights)
    render(scene, cam, 128, 128, cull=spec, shadow_lights=lights)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        img = render(scene, cam, 128, 128, cull=spec, shadow_lights=lights)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(img).all())


TRAINABLE = ("spheres.center", "spheres.radius", "materials.diffuse",
             "lights.position", "lights.diffuse")


def _grad_step(scene, cam, hw, spec, trainable, shadow_lights=None):
    """Leaf copies of the trainable columns and the loss mean(img^2) of a
    render, backpropagated; returns the leaves (their .grad filled)."""
    params = {k: v.detach().clone().requires_grad_()
              for k, v in inverse.extract_params(scene, trainable).items()}
    img = render(inverse.apply_params(scene, params), cam, hw, hw, cull=spec,
                 shadow_lights=shadow_lights)
    torch.mean(torch.square(img)).backward()
    return params


@pytest.mark.parametrize("which", ["grid", "boxes"])
def test_shade_backward_kernel_matches_plain(dev, monkeypatch, which):
    """Kernel 5 against phong_shade_bwd_plain on the arguments a training
    step hands it: per-ray cotangents to 1e-4 of each output's largest
    magnitude, light cotangents (sums over rays in another order) to 1e-3
    (the bounds chip_smoke.py states)."""
    scene, cam = (sphere_grid_scene(8, device=dev) if which == "grid"
                  else _box_scene(dev))
    trainable = TRAINABLE if which == "grid" else (
        "boxes.position", "boxes.angles", "materials.diffuse")
    seen = {}
    fn = shade.phong_shade_bwd

    def spy(*a):
        seen["args"] = tuple(x.detach() for x in a)
        return fn(*a)
    monkeypatch.setattr(shade, "phong_shade_bwd", spy)
    spec = suggest_cull_config(scene, cam, 128, 128, (16, 16))
    _grad_step(scene, cam, 128, spec, trainable)
    monkeypatch.undo()
    args = seen["args"]
    kernels.LAUNCHES.clear()
    got = shade.phong_shade_bwd(*args)
    assert kernels.LAUNCHES["phong_shade_bwd"] == 1
    want = shade.phong_shade_bwd_plain(*args)
    for i, (a, b) in enumerate(zip(got, want)):
        tol = (1e-3 if 1 <= i <= 4 else 1e-4) * float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=0, atol=tol)


def test_train_step_launches_and_is_sync_free(dev):
    """One training step launches each of the four kernels once, never
    waits for the host (set_sync_debug_mode('error')), and reports no
    overflow; its gradients are finite and non-zero."""
    scene, cam = sphere_grid_scene(8, device=dev)
    spec = suggest_cull_config(scene, cam, 128, 128, (32, 32))
    cfg = inverse.FitConfig(height=128, width=128, cull=spec,
                            trainable=inverse.DEFAULT_TRAINABLE)
    init_fn, step_fn = inverse.make_train_step(
        cam, cfg, optimizer=lambda ps: torch.optim.SGD(ps, lr=1e-7))
    params, opt = init_fn(scene)
    target = torch.zeros((128, 128, 3), device=dev)
    step_fn(params, opt, scene, target)
    torch.cuda.synchronize()
    kernels.LAUNCHES.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, loss, ovf = step_fn(params, opt, scene, target)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert dict(kernels.LAUNCHES) == {"primary_hit": 1,
                                      "shadow_occlusion": 1,
                                      "phong_fused": 1, "phong_shade_bwd": 1}
    assert int(ovf) == 0 and bool(torch.isfinite(loss))
    for k, v in params.items():
        assert bool(torch.isfinite(v.grad).all()) and bool(v.grad.any()), k


def test_gradients_match_cpu(dev):
    """The card's gradients (kernels) against the CPU's (plain versions) on
    the same rays at 64x64: per leaf 5e-3 of max|g|. The two devices'
    rsqrt/exp/log round apart, which the specular power (shininess up to
    64) lifts to about 1e-4 of a pixel's colour (the images differ by up
    to 5.8e-5), and a leaf's gradient sums hundreds of such pixel terms
    that largely cancel: measured up to 1.04e-3 of max|g| (one sphere
    center component of 192). Against the plain versions on the card
    (chip_smoke.py), the agreement is 1e-6 of max|g|."""
    from openglraytracer_tpu_torch.ops.accel import (parse_cull_spec,
                                                     tile_image)
    from openglraytracer_tpu_torch.ops.raygen import generate_rays
    from openglraytracer_tpu_torch.ops.render import trace_rays_fast
    scene, cam = sphere_grid_scene(8)
    (th, tw), kp, ks, hot_m, kb, ksb = parse_cull_spec(suggest_cull_config(
        scene, cam, 64, 64, (16, 16)))
    o, d = (tile_image(x, th, tw).reshape(-1, 3)
            for x in generate_rays(cam, 64, 64))
    grads = []
    for device in (dev, torch.device("cpu")):
        s = type(scene)(*(type(part)(*(x.to(device) for x in part))
                          for part in scene))
        params = {k: v.detach().clone().requires_grad_() for k, v in
                  inverse.extract_params(s, TRAINABLE).items()}
        img = trace_rays_fast(inverse.apply_params(s, params), o.to(device),
                              d.to(device),
                              cull=(th * tw, kp, ks, hot_m, kb, ksb))
        torch.mean(torch.square(img)).backward()
        grads.append(params)
    for k in TRAINABLE:
        a, b = grads[0][k].grad.cpu(), grads[1][k].grad
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=5e-3 * float(b.abs().max()))


def test_wrappers_reject_bad_inputs(dev):
    with pytest.raises(TypeError, match="dtype"):
        shade.phong_fused(torch.zeros((4, 20), device=dev, dtype=torch.float64),
                          *(torch.zeros((1, k), device=dev)
                            for k in (3, 4, 4, 4)),
                          *(torch.zeros((4, 3), device=dev) for _ in range(3)),
                          torch.zeros((4, 1), device=dev, dtype=torch.bool))
    # the backward kernel reads material rows as float4
    mat = torch.zeros(4 * 20 + 1, device=dev)[1:].reshape(4, 20)
    with pytest.raises(ValueError, match="aligned"):
        shade.phong_shade_bwd(mat, *(torch.zeros((1, k), device=dev)
                                     for k in (3, 4, 4, 4)),
                              *(torch.zeros((4, 3), device=dev)
                                for _ in range(3)),
                              torch.zeros((4, 1), device=dev,
                                          dtype=torch.bool),
                              torch.zeros((4, 3), device=dev))
