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

from openglraytracer_tpu_torch import kernel_cases, kernels
from openglraytracer_tpu_torch.models.builders import (mirror_grid4096_scene,
                                                       sphere_grid_scene)
from openglraytracer_tpu_torch.models.scene import (Boxes, Planes, Spheres,
                                                    make_camera, make_lights,
                                                    make_materials,
                                                    make_scene)
from openglraytracer_tpu_torch.ops import accel, culled, shade, shading
from openglraytracer_tpu_torch.ops.accel import (suggest_child_cull_config,
                                                 suggest_cull_config)
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
    render(scene, cam, hw, hw, engine="culled_pallas", cull=spec)
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
    assert torch.equal(culled.shadow_occlusion(*b),
                       culled.shadow_occlusion_plain(*b))
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
    img, ovf = render(scene, cam, 64, 64, engine="culled_pallas", cull=spec,
                      with_cull_stats=True)
    assert dict(kernels.LAUNCHES) == {"primary_hit": 1,
                                      "shadow_occlusion": 1,
                                      "phong_fused": 1}
    assert int(ovf) == 0
    cpu_scene, cpu_cam = sphere_grid_scene(8, device="cpu")
    kernels.LAUNCHES.clear()
    ref = render(cpu_scene, cpu_cam, 64, 64, engine="culled_pallas",
                 cull=spec)
    assert sum(kernels.LAUNCHES.values()) == 0
    torch.testing.assert_close(img.cpu(), ref, rtol=0, atol=1e-4)


def test_frame_is_sync_free(dev):
    scene, cam = sphere_grid_scene(8, device=dev)
    lights = shading.static_shadow_mask(scene)
    spec = suggest_cull_config(scene, cam, 128, 128, (32, 32),
                               shadow_lights=lights)
    render(scene, cam, 128, 128, engine="culled_pallas", cull=spec,
           shadow_lights=lights)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        img = render(scene, cam, 128, 128, engine="culled_pallas", cull=spec,
                     shadow_lights=lights)
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
    img = render(inverse.apply_params(scene, params), cam, hw, hw,
                 engine="culled_pallas", cull=spec,
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
    """One training step launches each of the four kernels once and the
    backward's winner scatter twice (the winners' geometry rows with the
    plane's, and the material rows), never waits for the host
    (set_sync_debug_mode('error')), and reports no overflow; its gradients
    are finite and non-zero."""
    scene, cam = sphere_grid_scene(8, device=dev)
    spec = suggest_cull_config(scene, cam, 128, 128, (32, 32))
    cfg = inverse.FitConfig(height=128, width=128, engine="culled_pallas",
                            cull=spec, trainable=inverse.DEFAULT_TRAINABLE)
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
                                      "phong_fused": 1, "phong_shade_bwd": 1,
                                      "winner_scatter": 2}
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
    scene, cam = sphere_grid_scene(8, device="cpu")
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
                              d.to(device), engine="culled_pallas",
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


def test_compact_kernel_matches_plain(dev):
    """Kernel 6 at (4096, 4096), the c5 mask size: empty, sparse, dense and
    full rows; idx where valid, valid and count exactly, idx 0 elsewhere."""
    gen = torch.Generator(device=dev).manual_seed(6)
    p = torch.tensor([0.0, 0.001, 0.02, 0.3, 1.0],
                     device=dev).repeat_interleave(820)[:4096, None]
    mask = torch.rand((4096, 4096), generator=gen, device=dev) < p
    kernels.LAUNCHES.clear()
    idx, valid, count = accel.compact_mask(mask, 232)
    assert kernels.LAUNCHES["compact_mask"] == 1
    pi, pv, pc = accel.compact_mask_plain(mask, 232)
    assert torch.equal(valid, pv) and torch.equal(count, pc)
    assert torch.equal(idx * valid, pi * pv)
    assert not bool(idx[~valid].any())
    # narrow masks keep torch.topk: no launch
    kernels.LAUNCHES.clear()
    accel.compact_mask(mask[:, :1000], 8)
    assert kernels.LAUNCHES["compact_mask"] == 0


def test_compact_kernel_on_ragged_masks(dev):
    """Kernel 6 on masks whose rows start off a 16-byte boundary (widths
    1025, 4095, 4097) with rows of 0, K - 1, K, K + 1 and N survivors
    (kernel_cases.ragged_masks): idx where valid, valid and count exactly,
    idx 0 elsewhere."""
    for mask, k in kernel_cases.ragged_masks(dev):
        kernels.LAUNCHES.clear()
        idx, valid, count = accel.compact_mask(mask, k)
        assert kernels.LAUNCHES["compact_mask"] == 1
        pi, pv, pc = accel.compact_mask_plain(mask, k)
        assert torch.equal(valid, pv) and torch.equal(count, pc)
        assert torch.equal(idx * valid, pi * pv)
        assert not bool(idx[~valid].any())


@pytest.mark.parametrize("n_sph", [1000, 5000])
def test_shadow_kernel_on_graze_inputs(dev, n_sph):
    """Kernel 3 against its plain version, bit for bit, on segments that
    split warps (kernel_cases.shadow_graze_inputs): tangents with the
    discriminant at 0 and an ulp either side, cast origins inside a sphere,
    qa at _DIV_EPS, tiles hot for one light only, against a table of one
    staged chunk and of five (the last partial)."""
    a, kw = kernel_cases.shadow_graze_inputs(dev, n_sph)
    kernels.LAUNCHES.clear()
    got = culled.shadow_occlusion(*a, **kw)
    assert kernels.LAUNCHES["shadow_occlusion"] == 1
    assert kernels.LAUNCHES["shadow_occlusion_hot"] == 1
    want = culled.shadow_occlusion_plain(*a, **kw)
    assert torch.equal(got, want)
    blocked = want[:, 0].reshape(-1, 32)
    assert bool((blocked.any(dim=1) & ~blocked.all(dim=1)).any())


def test_shadow_kernel_hot_pairs_match_plain(dev, monkeypatch):
    """Kernel 3 with hot (tile, light) pairs against its plain version (the
    dense _segment_occluded on the hot tiles), bit for bit, on the inputs
    both levels of a c4_mirror4096 frame (128x128; its specs with hot_m 4,
    as the full-size frame's have hot_m 32 and 128) hand it."""
    scene, cam = mirror_grid4096_scene(device=dev)
    spec = suggest_cull_config(scene, cam, 128, 128, (32, 32))
    child = suggest_child_cull_config(scene, cam, 128, 128, spec)
    spec, child = spec[:3] + (4,), child[:3] + (4,) + child[4:]
    seen = []
    fn = culled.shadow_occlusion

    def spy(*a, **k):
        seen.append(a)
        return fn(*a, **k)
    monkeypatch.setattr(culled, "shadow_occlusion", spy)
    with torch.no_grad():
        render(scene, cam, 128, 128, depth=1, engine="culled_pallas",
               cull=spec, child_cull=child)
    monkeypatch.undo()
    assert len(seen) == 2 and all(a[9] is not None for a in seen)
    for a in seen:
        assert torch.equal(culled.shadow_occlusion(*a),
                           culled.shadow_occlusion_plain(*a))


def _mirror_inputs(monkeypatch, dev, hw):
    """The arguments of kernel 2's cold and hot launches in a depth-1
    render of c4_mirror4096 at hw x hw (32x32 tiles, its child spec)."""
    scene, cam = mirror_grid4096_scene(device=dev)
    spec = suggest_cull_config(scene, cam, hw, hw, (32, 32))
    child = suggest_child_cull_config(scene, cam, hw, hw, spec)
    assert accel.cull_hot_p(child) > 0, child
    seen = []
    fn = culled.primary_hit_ray

    def spy(*a, **k):
        seen.append((a, k))
        return fn(*a, **k)
    monkeypatch.setattr(culled, "primary_hit_ray", spy)
    with torch.no_grad():
        _, ovf = render(scene, cam, hw, hw, depth=1, engine="culled_pallas",
                        cull=spec, child_cull=child,
                        with_cull_stats=True)
    monkeypatch.undo()
    assert int(ovf) == 0
    return seen


def test_kernel2_matches_plain(dev, monkeypatch):
    """Kernel 2, cold per-ray launch and hot launch, against its plain
    version on the inputs a c4_mirror4096 frame (128x128) hands it: the
    discrete outputs equal, t and n to a few ulp."""
    seen = _mirror_inputs(monkeypatch, dev, 128)
    hot = [x for x in seen if x[1].get("tile_ids") is not None]
    assert len(seen) == 2 and len(hot) == 1
    assert int(hot[0][0][5][:, 0].max()) == 4096     # a truly hot tile
    for a, k in seen:
        got = culled.primary_hit_ray(*a, **k)
        want = culled.primary_hit_plain(*a[:1], *a[2:], origins=a[1], **k)
        for x, y in zip(got[2:], want[2:]):
            assert torch.equal(x, y)
        torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-5)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_sph", [1000, 4200])
def test_kernel2_hot_on_grazing_rays(dev, n_sph):
    """Kernel 2's hot launch against its plain version on rays that split
    warps (kernel_cases.graze_hot_inputs): tangent grazes with qd at 0 and
    an ulp either side, spheres behind the origin, invalid rows that must
    never win and a slack block row, against a table of one staged chunk
    (1000 rows) and one of five (4200 rows, with winners past row 4096).
    Discrete outputs equal, t and n as in test_kernel2_matches_plain."""
    a, kw = kernel_cases.graze_hot_inputs(dev, n_sph, 2)
    kernels.LAUNCHES.clear()
    got = culled.primary_hit_ray(*a, **kw)
    assert kernels.LAUNCHES["primary_hit_hot"] == 1
    want = culled.primary_hit_plain(a[0], *a[2:], origins=a[1], **kw)
    n_rays = a[0].shape[0]
    target, ahead = kernel_cases.graze_target(dev, n_sph, n_rays)
    own = want[4][:n_rays] == target
    assert 0 < int(own.sum()) < n_rays and not bool(own[~ahead].any())
    if n_sph > 4096:     # winners from the second chunk
        assert int(target[own].max()) >= 4096
    for x, y in zip(got[2:], want[2:]):
        assert torch.equal(x, y)
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)


def test_depth1_frame_launches_and_is_sync_free(dev, monkeypatch):
    """A depth-1 c4_mirror4096 frame at 128x128 launches kernel A, kernel 2
    (cold and hot), kernel B, the shade and the compaction, never waits for
    the host, and matches the plain versions' image on the card on >= 99.9 %
    of pixels within 1/255 (a discrete winner may flip at a tangent graze).
    The CPU's image is no reference here: the two devices' rsqrt and sqrt
    round apart, and the mirrors turn that into other winners for 0.4 % of
    the children (measured)."""
    scene, cam = mirror_grid4096_scene(device=dev)
    lights = shading.static_shadow_mask(scene)
    bmask = shading.static_bounce_mask(scene)
    spec = suggest_cull_config(scene, cam, 128, 128, (32, 32),
                               shadow_lights=lights)
    child = suggest_child_cull_config(scene, cam, 128, 128, spec,
                                      shadow_lights=lights)
    kw = dict(depth=1, engine="culled_pallas", cull=spec, child_cull=child,
              shadow_lights=lights, bounce_mask=bmask, with_cull_stats=True)
    with torch.no_grad():
        render(scene, cam, 128, 128, **kw)
        torch.cuda.synchronize()
        kernels.LAUNCHES.clear()
        torch.cuda.set_sync_debug_mode("error")
        try:
            img, ovf = render(scene, cam, 128, 128, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        launched = dict(kernels.LAUNCHES)
        plain2 = culled.primary_hit_plain
        for mod, name, fn in (
                (culled, "primary_hit", plain2),
                (culled, "primary_hit_ray",
                 lambda d, o, *a, tile_ids=None: plain2(
                     d, *a, origins=o, tile_ids=tile_ids)),
                (culled, "shadow_occlusion", culled.shadow_occlusion_plain),
                (shade, "phong_shade", shading.phong_core),
                (accel, "compact_mask", accel.compact_mask_plain),
                (culled, "compact_mask", accel.compact_mask_plain)):
            monkeypatch.setattr(mod, name, fn)
        kernels.LAUNCHES.clear()
        ref = render(scene, cam, 128, 128, **kw)[0]
        assert sum(kernels.LAUNCHES.values()) == 0
    for k in ("primary_hit", "primary_hit_ray", "primary_hit_hot",
              "shadow_occlusion", "phong_fused", "compact_mask"):
        assert launched.get(k, 0) >= 1, (k, launched)
    assert int(ovf) == 0
    close = (img - ref).abs().amax(dim=-1) <= 1.0 / 255.0
    assert float(close.float().mean()) >= 0.999


def _dense_inputs(monkeypatch, scene, cam, h, w, depth):
    """The arguments of every dense_hit call of a render (the primary rays,
    then the bounce children at depth 1), and its image."""
    from openglraytracer_tpu_torch.ops import dense
    seen = []
    fn = dense.dense_hit

    def spy(*a):
        seen.append(a)
        return fn(*a)
    monkeypatch.setattr(dense, "dense_hit", spy)
    with torch.no_grad():
        img = render(scene, cam, h, w, depth=depth, engine="pallas")
    monkeypatch.undo()
    return seen, img


@pytest.mark.parametrize("which", ["c3", "obb"])
def test_dense_kernel_matches_plain(dev, monkeypatch, which):
    """Kernel 7 against dense_hit_plain on the rays a render hands it (c3
    at 256x256; the OBB world at 320x180, depth 1: the primary rays and
    both sets of children, zero-direction TIR children included). Both
    round every op alike (--fmad=false, the same fmaf written out and
    emulated): t, n, inside and obj_id equal, and occlusion equal where the
    ray hit."""
    from openglraytracer_tpu_torch.models.animated import reference_frame
    from openglraytracer_tpu_torch.ops import dense
    if which == "c3":
        scene, cam = sphere_grid_scene(8, device=dev)
        seen, _ = _dense_inputs(monkeypatch, scene, cam, 256, 256, 0)
    else:
        scene, cam = reference_frame(1.2, device=dev)
        seen, _ = _dense_inputs(monkeypatch, scene, cam, 180, 320, 1)
    assert len(seen) == (1 if which == "c3" else 3)
    for a in seen:
        kernels.LAUNCHES.clear()
        got = dense.dense_hit(*a)
        assert kernels.LAUNCHES["dense_hit"] == 1
        want = dense.dense_hit_plain(*a)
        hit = want[0] < 1e4
        for x, y in zip(got[:4], want[:4]):
            assert torch.equal(x, y)
        assert torch.equal(got[4] & hit, want[4] & hit)


@pytest.mark.parametrize("which", ["graze", "partially_blocked"])
def test_dense_kernel_on_split_warps(dev, which):
    """Kernel 7 against dense_hit_plain on rays that split warps
    (kernel_cases): tangent grazes with disc at 0 and an ulp either side
    against a table of 300 spheres, two staging chunks; and warps in which
    the first sphere blocks a light's segment on some lanes only, so that
    those lanes stop testing early.
    Equal bit for bit, occlusion where the ray hit."""
    from openglraytracer_tpu_torch.ops import dense
    a = (kernel_cases.graze_dense_inputs(dev, 300, 4096) if which == "graze"
         else kernel_cases.partial_block_inputs(dev, 4096))
    got = dense.dense_hit(*a)
    want = dense.dense_hit_plain(*a)
    hit = want[0] < 1e4
    if which == "graze":
        target, ahead = kernel_cases.graze_target(dev, 300, 4096)
        own = want[3] == target
        assert 0 < int(own.sum()) < 4096 and not bool(own[~ahead].any())
    else:
        assert kernel_cases.mixed_warps(want[4], hit) > 0.0
    for x, y in zip(got[:4], want[:4]):
        assert torch.equal(x, y)
    assert torch.equal(got[4] & hit, want[4] & hit)


def test_dense_frame_and_step_launch_and_are_sync_free(dev):
    """Engine pallas: one dense_hit launch per depth-0 frame of c3, three
    per depth-1 frame of the OBB world (primary, reflection and refraction
    children) and as many per training step, whose backward adds the
    planes' rows with one winner scatter a cast where the scene has planes
    (c3's ground; the OBB world has none); neither waits for the host; the
    step's gradients are finite and non-zero, box leaves included."""
    from openglraytracer_tpu_torch.models.animated import reference_frame
    for builder, h, w, depth, trainable, n in (
            (lambda: sphere_grid_scene(8, device=dev), 128, 128, 0,
             inverse.DEFAULT_TRAINABLE, 1),
            (lambda: reference_frame(0.8, device=dev), 72, 128, 1,
             inverse.DEFAULT_TRAINABLE + ("boxes.position", "boxes.angles"),
             3)):
        scene, cam = builder()
        bmask = shading.static_bounce_mask(scene) if depth else (True, True)
        kw = dict(depth=depth, engine="pallas", bounce_mask=bmask)
        with torch.no_grad():
            render(scene, cam, h, w, **kw)
            torch.cuda.synchronize()
            kernels.LAUNCHES.clear()
            torch.cuda.set_sync_debug_mode("error")
            try:
                img = render(scene, cam, h, w, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        assert dict(kernels.LAUNCHES) == {"dense_hit": n}
        assert bool(torch.isfinite(img).all())
        cfg = inverse.FitConfig(height=h, width=w, depth=depth,
                                engine="pallas", trainable=trainable)
        init_fn, step_fn = inverse.make_train_step(
            cam, cfg, optimizer=lambda ps: torch.optim.SGD(ps, lr=1e-7))
        params, opt = init_fn(scene)
        target = torch.zeros((h, w, 3), device=dev)
        step_fn(params, opt, scene, target)
        torch.cuda.synchronize()
        kernels.LAUNCHES.clear()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, _, loss, ovf = step_fn(params, opt, scene, target)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want = {"dense_hit": n}
        if scene.planes.count:
            want["winner_scatter"] = n
        assert dict(kernels.LAUNCHES) == want
        assert int(ovf) == 0 and bool(torch.isfinite(loss))
        for k, v in params.items():
            assert bool(torch.isfinite(v.grad).all()) and bool(v.grad.any()), k


def test_dense_wrapper_rejects_bad_inputs(dev):
    from openglraytracer_tpu_torch.ops import dense
    rays = torch.zeros((8, 3), device=dev)
    sph = torch.zeros((2, 4), device=dev)
    box = torch.zeros((0, 18), device=dev)
    pln = torch.zeros((1, 4), device=dev)
    lg = torch.zeros((2, 3), device=dev)
    with pytest.raises(ValueError, match="shape"):
        dense.dense_hit(rays, rays, torch.zeros((2, 8), device=dev), box,
                        pln, lg)
    with pytest.raises(TypeError, match="dtype"):
        dense.dense_hit(rays, rays.double(), sph, box, pln, lg)
    with pytest.raises(ValueError, match="contiguous"):
        dense.dense_hit(rays, torch.zeros((3, 8), device=dev).T, sph, box,
                        pln, lg)
    with pytest.raises(ValueError, match="on cpu"):
        dense.dense_hit(rays.cpu(), rays, sph, box, pln, lg)


def test_xla_engine_on_the_card(dev):
    """Engine 'xla' (plain PyTorch) runs on the card without a kernel and
    without a host sync, and renders the CPU's image (1e-4: the two
    devices' rsqrt, exp and log round differently); c4_mirror's culled
    parent launches kernels A, B and the shade once and traces its children
    on 'xla'."""
    from openglraytracer_tpu_torch.models.builders import (
        eight_sphere_scene, mirror_scene)
    scene, cam = eight_sphere_scene(device=dev)
    cpu_scene, cpu_cam = eight_sphere_scene(device="cpu")
    lights = shading.static_shadow_mask(scene)
    with torch.no_grad():
        render(scene, cam, 64, 64, shadow_lights=lights)
        torch.cuda.synchronize()
        kernels.LAUNCHES.clear()
        torch.cuda.set_sync_debug_mode("error")
        try:
            img = render(scene, cam, 64, 64, shadow_lights=lights)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert sum(kernels.LAUNCHES.values()) == 0
        ref = render(cpu_scene, cpu_cam, 64, 64)
    torch.testing.assert_close(img.cpu(), ref, rtol=0, atol=1e-4)
    scene, cam = mirror_scene(device=dev)
    spec = suggest_cull_config(scene, cam, 128, 128, (64, 64))
    kernels.LAUNCHES.clear()
    with torch.no_grad():
        img, ovf = render(scene, cam, 128, 128, depth=1,
                          engine="culled_pallas", cull=spec,
                          with_cull_stats=True)
    assert int(ovf) == 0 and bool(torch.isfinite(img).all())
    assert {k: kernels.LAUNCHES[k] for k in ("primary_hit",
                                             "shadow_occlusion",
                                             "phong_fused")} == {
        "primary_hit": 1, "shadow_occlusion": 1, "phong_fused": 1}


def _zero_dir(d):
    return (d == 0.0).all(dim=-1)


def test_dense_kernel_on_deep_glass_steps(dev, monkeypatch):
    """Kernel 7 on every step of a depth-4 'pallas' stack frame of the OBB
    and glass world (160x96): 31 launches, and on the steps that carry
    zero-direction total-internal-reflection rays (from depth 2 on) the
    kernel equals dense_hit_plain bit for bit, those rays missing."""
    from openglraytracer_tpu_torch.models.animated import reference_frame
    from openglraytracer_tpu_torch.ops import dense
    scene, cam = reference_frame(1.2, device=dev)
    seen = []
    fn = dense.dense_hit

    def spy(*a):
        seen.append(a)
        return fn(*a)
    monkeypatch.setattr(dense, "dense_hit", spy)
    kernels.LAUNCHES.clear()
    with torch.no_grad():
        render(scene, cam, 96, 160, depth=4, engine="pallas",
               bounce="stack")
    monkeypatch.undo()
    assert kernels.LAUNCHES["dense_hit"] == 31 == len(seen)
    tir = [a for a in seen if bool(_zero_dir(a[1]).any())]
    assert tir, "no step carried a zero-direction ray"
    for a in tir:
        got = dense.dense_hit(*a)
        want = dense.dense_hit_plain(*a)
        hit = want[0] < 1e4
        for x, y in zip(got[:4], want[:4]):
            assert torch.equal(x, y)
        assert torch.equal(got[4] & hit, want[4] & hit)
        assert not bool(hit[_zero_dir(a[1])].any())


def test_kernel2_on_deep_glass_steps(dev, monkeypatch):
    """Kernel 2, cold and hot, on the steps of a depth-3 culled stack frame
    of a 4096-sphere glass grid (128x128, 32x32 tiles, Kp 64 so that tiles
    go hot, hot_p every tile) that carry zero-direction TIR rays: against
    its plain version, the discrete outputs equal, t and n to a few ulp,
    and the zero-direction rays miss in both launches."""
    from openglraytracer_tpu_torch.models.builders import glass_grid_scene
    scene, cam = glass_grid_scene(device=dev)
    n = int(scene.spheres.count)
    spec = ((32, 32), 64, n, 0, 0, 0, 16)
    seen = []
    fn = culled.primary_hit_ray

    def spy(*a, **k):
        seen.append((a, k))
        return fn(*a, **k)
    monkeypatch.setattr(culled, "primary_hit_ray", spy)
    with torch.no_grad():
        render(scene, cam, 128, 128, depth=3, engine="culled_pallas",
               bounce="stack", cull=spec)
    monkeypatch.undo()
    assert len(seen) == 2 * 15
    deep = [(a, k) for a, k in seen if bool(_zero_dir(a[0]).any())]
    assert any(k.get("tile_ids") is None for _, k in deep)
    assert any(int(a[5][:, 0].max()) == n for a, k in deep
               if k.get("tile_ids") is not None), "no truly hot tile"
    for a, k in deep:
        got = culled.primary_hit_ray(*a, **k)
        want = culled.primary_hit_plain(*a[:1], *a[2:], origins=a[1], **k)
        for x, y in zip(got[2:], want[2:]):
            assert torch.equal(x, y)
        torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-5)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)
        zero = _zero_dir(a[0])
        if k.get("tile_ids") is not None:
            tp = a[6]
            zero = zero.reshape(-1, tp)[k["tile_ids"].long()].reshape(-1)
        assert not bool((got[0][zero] < 1e4).any())


def test_culled_xla_launches_only_the_compaction_kernel(dev, monkeypatch):
    """Engine 'culled' on 4096 spheres (c5_grid4096's grid at 256x256,
    32x32 tiles, depth 0): its (64, 4096) masks go to kernel 6, once for
    the primary lists and once per lit light a frame, and no other kernel
    runs; kernel 6 equals its plain version on each of those masks; the
    frame is sync-free."""
    scene, cam = sphere_grid_scene(64, device=dev)
    lights = shading.static_shadow_mask(scene)
    spec = suggest_cull_config(scene, cam, 256, 256, (32, 32),
                               shadow_lights=lights)
    masks = []
    fn = accel.compact_mask

    def spy(mask, k):
        masks.append((mask, k))
        return fn(mask, k)

    def frame():
        with torch.no_grad():
            return render(scene, cam, 256, 256, engine="culled", cull=spec,
                          shadow_lights=lights, with_cull_stats=True)
    monkeypatch.setattr(accel, "compact_mask", spy)
    img, ovf = frame()
    monkeypatch.undo()
    torch.cuda.synchronize()
    want = {"compact_mask": 1 + sum(map(bool, lights))}
    assert len(masks) == want["compact_mask"] and int(ovf) == 0
    assert bool(torch.isfinite(img).all())
    for mask, k in masks:
        assert mask.shape == (64, 4096)
        ki, kv, kc = accel.compact_mask(mask, k)
        pi, pv, pc = accel.compact_mask_plain(mask, k)
        assert torch.equal(kv, pv) and torch.equal(kc, pc)
        assert torch.equal(ki * kv, pi * pv)
    kernels.LAUNCHES.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        frame()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == want


@pytest.mark.parametrize("which", ["grid", "boxes"])
def test_culled_xla_agrees_with_culled_pallas(dev, which):
    """On the card, engine 'culled' (plain PyTorch) renders culled_pallas's
    image (the kernels) to 1/255 on >= 99.9 % of pixels, on the 64-sphere
    grid at depth 0 and on the box scene at depth 1 with culled children.
    Its training gradients are held to the dense engine 'xla', which rounds
    the sphere quadratic and the normal as 'culled' does, within 1e-3 *
    max|g| (culled_pallas rounds them as its kernels do, with fused
    multiply-adds, and at grazing rays the centers' gradient is singular),
    and below 1024 objects it launches no kernel but the backward's winner
    scatter, which the culled engines share."""
    if which == "grid":
        scene, cam = sphere_grid_scene(8, device=dev)
        hw, depth = 256, 0
    else:
        scene, cam = _box_scene(dev)
        hw, depth = 128, 1
    spec = suggest_cull_config(scene, cam, hw, hw, (16, 16))
    child = {e: (suggest_child_cull_config(scene, cam, hw, hw, spec,
                                           hot_primary=e == "culled_pallas")
                 if depth else None) for e in ("culled", "culled_pallas")}
    child["xla"] = None
    imgs, grads = {}, {}
    for engine in ("culled", "culled_pallas", "xla"):
        kernels.LAUNCHES.clear()
        cfg = inverse.FitConfig(height=hw, width=hw, depth=depth,
                                engine=engine, child_cull=child[engine],
                                cull=spec if engine != "xla" else None)
        init_fn, step_fn = inverse.make_train_step(
            cam, cfg, optimizer=lambda ps: torch.optim.SGD(ps, lr=0.0))
        params, opt = init_fn(scene)
        _, _, _, ovf = step_fn(params, opt, scene,
                               torch.zeros((hw, hw, 3), device=dev))
        assert int(ovf) == 0
        grads[engine] = {k: v.grad for k, v in params.items()}
        if engine == "culled":
            # fewer than 1024 objects: no compaction kernel
            assert set(kernels.LAUNCHES) == {"winner_scatter"}
        with torch.no_grad():
            imgs[engine] = render(scene, cam, hw, hw, depth=depth,
                                  engine=engine, child_cull=child[engine],
                                  cull=spec if engine != "xla" else None)
    for other in ("culled_pallas", "xla"):
        diff = (imgs["culled"] - imgs[other]).abs().amax(dim=-1)
        assert float((diff <= 1.0 / 255.0).float().mean()) >= 0.999, other
    for k, g in grads["xla"].items():
        scale = float(g.abs().max())
        assert scale > 0.0
        assert float((grads["culled"][k] - g).abs().max()) <= 1e-3 * scale


def test_raygen_on_the_card_equals_the_cpu(dev, monkeypatch):
    """On the CPU's camera matrices of c5's camera, the card's camera
    inverse (its pivots on the device, sync-free) and its rays equal the
    CPU's bit for bit. (End to end the card's float32 trig may round the
    view an ulp apart, which the far camera magnifies: 4e-5 on the H100.)
    The rays are the eager ops' (the arithmetic held here; the graph
    replays them, tests/test_torch_raygen_graph.py), and every host copy
    is made before the sync-debug window, which holds the program's alone."""
    from openglraytracer_tpu_torch.ops import raygen
    from openglraytracer_tpu_torch.ops.transforms import inv4
    _, cam = sphere_grid_scene(64, device="cpu")
    mats = raygen.camera_matrices(cam)
    proj, view = mats[0], mats[1]
    pv = proj[:, 0:1] * view[0:1, :]
    for k in range(1, 4):
        pv = pv + proj[:, k:k + 1] * view[k:k + 1, :]
    cam_d = cam._replace(**{k: v.to(dev) for k, v in cam._asdict().items()})
    want = raygen._rays_eager(cam, 256, 256)[1]
    pv_dev = pv.to(dev)
    mats_dev = tuple(m.to(dev) for m in mats)
    monkeypatch.setattr(raygen, "camera_matrices", lambda c: mats_dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        inv_dev = inv4(pv_dev)
        d_dev = raygen._rays_eager(cam_d, 256, 256)[1]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(inv_dev.cpu(), mats[2])
    assert torch.equal(d_dev.cpu(), want)


def test_soft_step_launches_the_compaction_kernel(dev):
    """A soft render of a 1024-sphere grid at 128x128 with 16x16 tiles
    launches kernel 6 and the soft composite once each and equals its
    render through the plain compaction; a two-view soft fit step launches
    kernel 6, the soft composite and its backward twice each, sync-free,
    with no overflow."""
    from openglraytracer_tpu_torch.ops.soft import (soft_render,
                                                    suggest_soft_cull)
    scene, cam = sphere_grid_scene(32, device=dev)
    spec = suggest_soft_cull(scene, cam, 128, 128, (16, 16), 0.3)
    kernels.LAUNCHES.clear()
    with torch.no_grad():
        img = soft_render(scene, cam, 128, 128, bw=0.3, gamma=0.3,
                          cull=spec)
    assert dict(kernels.LAUNCHES) == {"compact_mask": 1,
                                      "soft_composite": 1}
    real = accel.compact_mask
    accel.compact_mask = accel.compact_mask_plain
    try:
        with torch.no_grad():
            img_p = soft_render(scene, cam, 128, 128, bw=0.3, gamma=0.3,
                                cull=spec)
    finally:
        accel.compact_mask = real
    assert torch.equal(img, img_p)
    cfg = inverse.FitConfig(height=128, width=128, soft=(0.3, 0.3),
                            cull=(spec, spec))
    init_fn, step_fn = inverse.make_train_step((cam, cam), cfg)
    params, opt = init_fn(scene)
    target = torch.stack([img, img])
    step_fn(params, opt, scene, target)
    torch.cuda.synchronize()
    kernels.LAUNCHES.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, loss, ovf = step_fn(params, opt, scene, target)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert dict(kernels.LAUNCHES) == {"compact_mask": 2,
                                      "soft_composite": 2,
                                      "soft_composite_bwd": 2}
    assert int(ovf) == 0 and bool(torch.isfinite(loss))
