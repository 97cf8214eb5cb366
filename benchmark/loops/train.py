"""Loop 'train': a fitter running the hard fit.

Set-up renders the target, the image of the seeded ground-truth scene,
through the program's entry point, perturbs the trainable leaves by
seeded Gaussian offsets, sizes the cull spec on that starting scene and
builds the program's fit step (Adam). It then drives that same step
through its first ``checked_steps`` steps (which are also its warm-up),
keeping each step's loss, the first gradient as Adam received it and the
parameters after them. The window calls the step back to back with no
host wait and ends with one synchronise. A step whose cull overflowed, or
whose loss is not finite, counts as failed.

The check has the reference follow the first steps from the same start:
its own target, its own losses, gradients (autograd) and Adam. Compared:
the gap between each step's losses (relative, the worst step); between
the first gradients, the worst leaf of the median over its rows of the
gap between the rows' norms (``_row_gaps``); and between the norms of the
parameters' change over the steps, the worst leaf, each gap divided by
the larger of that leaf's reference norm and the median leaf's.
"""

from __future__ import annotations

import contextlib
import math
import statistics
import time

import torch

from benchmark.port import PLAIN
from benchmark.reference import tracer


def _span(spans, name):
    return spans.span(name) if spans is not None else contextlib.nullcontext()


def perturb(cell, scene: dict, seed: int) -> dict:
    """The fit's start: each perturbed tensor plus sigma * N(0, 1) drawn
    from the seed (radius and colors clamped to stay valid)."""
    g = torch.Generator(device=scene["center"].device)
    g.manual_seed((int(seed) * 3 + 2) % (1 << 63))
    out = dict(scene)
    for key, sigma in cell.traffic["perturb"].items():
        x = scene[key]
        noise = torch.randn(x.shape, generator=g, device=x.device,
                            dtype=x.dtype)
        y = x + float(sigma) * noise
        if key == "radius":
            y = torch.clamp(y, min=0.05)
        if key == "diffuse":
            y = torch.clamp(y, 0.0, 1.0)
        out[key] = y
    return out


def setup(cell, seed, seconds, scene, camera, system):
    traffic = cell.traffic
    cuda = scene["center"].device.type == "cuda"
    p_cam = system.camera(camera)
    gt = system.scene(scene)
    lights = system.shadow_lights(gt)
    target, ovf = system.render(gt, p_cam, system.cull_spec(gt, p_cam, lights),
                                lights)
    start = perturb(cell, scene, seed)
    p_start = system.scene(start)
    cell.extra["marks"].append(("target", time.monotonic()))
    spec = system.cull_spec(p_start, p_cam, lights)
    cell.extra["marks"].append(("cull spec", time.monotonic()))
    init_fn, step_fn = system.train_step(p_cam, spec, traffic)
    params, opt = init_fn(p_start)
    losses, ovfs, grad1 = [], [ovf], None
    for s in range(int(traffic["checked_steps"])):
        params, opt, loss, o = step_fn(params, opt, p_start, target)
        losses.append(loss)
        ovfs.append(o)
        if s == 0:
            grad1 = {k: v.clone() for k, v in
                     system.first_grad(opt, params).items()}
    after = {k: v.detach().clone()
             for k, v in system.params_plain(params).items()}
    return dict(params=params, opt=opt, step_fn=step_fn, scene=p_start,
                target=target, start=start, losses=losses, grad1=grad1,
                after=after, setup_ovf=ovfs, cuda=cuda)


def window(cell, state, seconds, spans):
    """Steps back to back for ``seconds`` of enqueue, then one sync."""
    step_fn = state["step_fn"]
    params, opt = state["params"], state["opt"]
    scene, target = state["scene"], state["target"]
    losses, ovfs = [], []
    with _span(spans, "bench/window"):
        t_start = time.perf_counter()
        deadline = t_start + seconds
        n = 0
        while time.perf_counter() < deadline:
            with _span(spans, "bench/unit"):
                params, opt, loss, ovf = step_fn(params, opt, scene, target)
            losses.append(loss)
            ovfs.append(ovf)
            n += 1
        if state["cuda"]:
            torch.cuda.synchronize()
        t_end = time.perf_counter()
    bad = (torch.stack(ovfs) > 0) | ~torch.isfinite(torch.stack(losses))
    # a set-up step (or the target's render) that overflowed fails too
    setup_bad = sum(int(o) > 0 for o in state["setup_ovf"])
    return dict(units=n, attempted=n, failed=int(bad.sum()) + setup_bad,
                seconds=t_end - t_start, start=t_start)


def release(cell, state, window):
    return dict(losses=[float(x) for x in state["losses"]],
                grad1={k: v.float() for k, v in state["grad1"].items()},
                after=state["after"], start=state["start"])


def _leaf_gaps(got: dict, want: dict, keys) -> dict:
    """Per leaf |norm(got) - norm(want)| / max(norm(want), the median
    leaf's norm of want)."""
    norms = {k: float(torch.linalg.vector_norm(want[k].double()))
             for k in keys}
    med = statistics.median(norms.values())
    return {k: abs(float(torch.linalg.vector_norm(got[k].double())) - norms[k])
            / max(norms[k], med, 1e-300) for k in keys}


def _row_gaps(got: dict, want: dict, keys) -> dict:
    """Per leaf, the median over its rows (a sphere's center or radius, a
    material's diffuse color) of |norm(got row) - norm(want row)| / max(
    norm(want row), the leaf's median row norm of want). A median over
    rows is not moved by the few rows that a ray grazing a silhouette
    gives an ill-conditioned gradient (dt/dr grows as 1/sqrt of the
    discriminant), which swing a whole leaf's norm from seed to seed."""
    out = {}
    for k in keys:
        g = got[k].double().reshape(got[k].shape[0], -1)
        w = want[k].double().reshape(want[k].shape[0], -1)
        gn = torch.linalg.vector_norm(g, dim=1)
        wn = torch.linalg.vector_norm(w, dim=1)
        scale = torch.clamp(torch.maximum(wn, wn.median()), min=1e-300)
        out[k] = float(((gn - wn).abs() / scale).median())
    return out


def check(cell, scene, camera, data):
    h, w = cell.config["height"], cell.config["width"]
    dtype = getattr(torch, cell.config["dtype"])
    steps = len(data["losses"])
    target = tracer.render(scene, camera, h, w, dtype)
    start = data["start"]
    keys = list(data["after"])
    rates = {PLAIN[k]: float(v)
             for k, v in cell.traffic["learning_rates"].items()}
    adam = tracer.Adam({k: start[k].to(dtype) for k in keys}, rates)
    losses, grad1 = [], None
    for s in range(steps):
        loss, grads = tracer.loss_and_grads(start, camera, h, w, target,
                                            adam.params, dtype)
        losses.append(float(loss))
        if s == 0:
            grad1 = grads
        adam.step(grads)
    loss_gap = max(abs(a - b) / max(abs(b), 1e-300)
                   for a, b in zip(data["losses"], losses))
    grad_leaf_gaps = _leaf_gaps(data["grad1"], grad1, keys)
    grad_gaps = _row_gaps(data["grad1"], grad1, keys)
    # leaves whose reference gradient is nought to rounding (under a
    # thousandth of the median leaf's) move under Adam by round-off alone
    g_norms = {k: float(torch.linalg.vector_norm(grad1[k].double()))
               for k in keys}
    med = statistics.median(g_norms.values())
    moved = [k for k in keys if g_norms[k] >= 1e-3 * med]
    got_change = {k: data["after"][k].double() - start[k].double()
                  for k in moved}
    want_change = {k: adam.params[k].double() - start[k].double()
                   for k in moved}
    change_gaps = _leaf_gaps(got_change, want_change, moved)
    cell.extra["detail"] = {
        "losses": data["losses"], "reference_losses": losses,
        "grad_gap": grad_gaps, "grad_leaf_gap": grad_leaf_gaps,
        "change_gap": change_gaps,
        "grad_norms": g_norms}
    out = {"loss_gap": loss_gap, "grad_gap": max(grad_gaps.values()),
           "change_gap": max(change_gaps.values())}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}
