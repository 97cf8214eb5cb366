"""The plain reference agrees with the program's plain CPU path on a tiny
grid scene, and its cone cull keeps every sphere a dense scan needs."""

import torch

from benchmark import harness, port
from benchmark.loops import train
from benchmark.reference import tracer


def _scene(cell, seed):
    recipe = harness.load_module(harness.BENCH_DIR / "scenes"
                                 / "sphere_grid.py")
    scene, cam = recipe.make(cell.config["scene"], seed, "cpu")
    cam["aspect"] = torch.tensor(1.0)
    return scene, cam


def test_cone_cull_equals_dense_scan(tiny_cell):
    cell = tiny_cell("c3_grid64.render", side=5, size=48)
    scene, cam = _scene(cell, 11)
    culled = tracer.render(scene, cam, 48, 48)
    dense = tracer.render(scene, cam, 48, 48, dense=True)
    assert torch.equal(culled, dense)


def test_image_agrees_with_the_program(tiny_cell):
    cell = tiny_cell("c3_grid64.render", side=4, size=64)
    scene, cam = _scene(cell, 5)
    system = port.Port(cell.config, "cpu")
    ps, pc = system.scene(scene), system.camera(cam)
    lights = system.shadow_lights(ps)
    img, ovf = system.render(ps, pc, system.cull_spec(ps, pc, lights),
                             lights)
    assert int(ovf) == 0
    got = system.to_uint8(img).int()
    ref = tracer.to_uint8(tracer.render(scene, cam, 64, 64)).int()
    off = (got - ref).abs().amax(-1) > 1
    # a pixel or two where a ray grazes a silhouette or a shadow's edge
    assert float(off.float().mean()) < 1e-3


def test_loss_and_gradient_agree_with_the_program(tiny_cell):
    cell = tiny_cell("c3_grid64.train", side=4, size=64)
    scene, cam = _scene(cell, 5)
    start = train.perturb(cell, scene, 5)
    system = port.Port(cell.config, "cpu")
    pc = system.camera(cam)
    gt = system.scene(scene)
    lights = system.shadow_lights(gt)
    target, _ = system.render(gt, pc, system.cull_spec(gt, pc, lights),
                              lights)
    ps = system.scene(start)
    init_fn, step_fn = system.train_step(
        pc, system.cull_spec(ps, pc, lights), cell.traffic)
    params, opt = init_fn(ps)
    params, opt, loss, _ = step_fn(params, opt, ps, target)
    grads = system.first_grad(opt, params)
    ref_target = tracer.render(scene, cam, 64, 64)
    ref_loss, ref_grads = tracer.loss_and_grads(
        start, cam, 64, 64, ref_target,
        {k: start[k] for k in ("center", "radius", "diffuse")})
    assert abs(float(loss) - float(ref_loss)) <= 1e-3 * float(ref_loss)
    for k, g in ref_grads.items():
        gap = float((grads[k] - g).norm() / g.norm())
        # the silhouette rays' gradients grow as 1/sqrt(discriminant), and
        # the program's camera rays lie up to 5e-6 rad from exact ones
        assert gap < 2e-2, (k, gap)


def test_adam_follows_torch_optim():
    torch.manual_seed(0)
    p0 = torch.randn(5, 3)
    mine = tracer.Adam({"x": p0.clone()}, 0.01)
    ref = p0.clone().requires_grad_()
    opt = torch.optim.Adam([ref], lr=0.01)
    for _ in range(3):
        g = torch.randn(5, 3)
        mine.step({"x": g})
        ref.grad = g
        opt.step()
    assert torch.allclose(mine.params["x"], ref.detach(), rtol=1e-6,
                          atol=1e-7)
