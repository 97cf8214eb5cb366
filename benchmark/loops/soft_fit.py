"""Loop 'soft_fit': a fitter running the config-5 fit's soft-coverage stage.

Set-up makes the configuration's views (its camera orbited ``views``
degrees about world z), sizes each view's soft broad phase on the seeded
true scene (the program's ``suggest_soft_cull`` with the configuration's
headroom, as the fit script sizes it once a stage), renders the soft
target of the true scene over the views through the program's soft
forward at the configuration's (bw, gamma), perturbs the trainable leaves
as the fit script's start does, and builds the program's multi-view soft
fit step with Adam at the traffic's rates. It then drives that step
through its first ``checked_steps`` steps (which are also its warm-up).
The window calls the step back to back with no host wait and ends with one
synchronise (``loops/train.py``'s window). A step whose summed soft cull
overflowed, or whose loss is not finite, counts as failed, as does a
target view that overflowed.

The check has the plain soft reference (``reference/soft.py``) follow the
first steps from the same start, with its own target, losses, gradients
(autograd) and Adam, and compares as ``loops/train.py`` does: the gap
between each step's losses (relative, the worst step), between the first
gradients (the worst leaf's median row gap) and between the norms of the
parameters' change over the steps (the worst leaf).
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from benchmark import port, port_soft
from benchmark.loops import train
from benchmark.port import PLAIN
from benchmark.reference import soft, tracer

window = train.window
release = train.release


def orbit(camera: dict, phi_deg: float) -> dict:
    """The plain camera orbited phi degrees about the world z axis through
    the origin: its position rotated, phi added to its yaw (as the fit
    script's orbit_camera)."""
    phi = math.radians(phi_deg)
    pos = camera["position"].double()
    c, s = math.cos(phi), math.sin(phi)
    position = torch.stack([pos[0] * c - pos[1] * s, pos[0] * s + pos[1] * c,
                            pos[2]]).to(camera["position"].dtype)
    angles = camera["angles"].clone()
    angles[1] = angles[1] + phi_deg
    return dict(camera, position=position, angles=angles)


def views(cell, camera: dict) -> list:
    return [orbit(camera, float(v)) for v in cell.config["views"]]


def perturb(cell, scene: dict, seed: int) -> dict:
    """The fit's start, as the fit script's: each perturbed tensor plus
    sigma * N(0, 1) drawn from the seed, the radii held at or above
    ``radius_floor`` and the colours in [0, 1]."""
    g = torch.Generator(device=scene["center"].device)
    g.manual_seed((int(seed) * 3 + 2) % (1 << 63))
    out = dict(scene)
    for key, sigma in cell.traffic["perturb"].items():
        x = scene[key]
        y = x + float(sigma) * torch.randn(x.shape, generator=g,
                                           device=x.device, dtype=x.dtype)
        if key == "radius":
            y = torch.clamp(y, min=float(cell.traffic["radius_floor"]))
        if key == "diffuse":
            y = torch.clamp(y, 0.0, 1.0)
        out[key] = y
    return out


def setup(cell, seed, seconds, scene, camera, system):
    if type(system) is port.Port:
        system = port_soft.SoftPort(cell.config, system.device)
    traffic = cell.traffic
    cuda = scene["center"].device.type == "cuda"
    cams = [system.camera(c) for c in views(cell, camera)]
    gt = system.scene(scene)
    specs = [system.soft_cull(gt, c) for c in cams]
    cell.extra["marks"].append(("cull specs", time.monotonic()))
    target, ovf = system.soft_render(gt, cams, specs)
    start = perturb(cell, scene, seed)
    p_start = system.scene(start)
    cell.extra["marks"].append(("target", time.monotonic()))
    init_fn, step_fn = system.soft_train_step(cams, specs, traffic)
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
    cell.extra["soft_specs"] = specs
    return dict(params=params, opt=opt, step_fn=step_fn, scene=p_start,
                target=target, start=start, losses=losses, grad1=grad1,
                after=after, setup_ovf=ovfs, cuda=cuda)


def check(cell, scene, camera, data):
    h, w = cell.config["height"], cell.config["width"]
    dtype = getattr(torch, cell.config["dtype"])
    s = cell.config["soft"]
    bw, gamma, t_bg = float(s["bw"]), float(s["gamma"]), float(s["t_bg"])
    cams = views(cell, camera)
    steps = len(data["losses"])
    target = soft.render(scene, cams, h, w, bw, gamma, t_bg, dtype)
    start = data["start"]
    keys = list(data["after"])
    rates = {PLAIN[k]: float(v)
             for k, v in cell.traffic["learning_rates"].items()}
    adam = tracer.Adam({k: start[k].to(dtype) for k in keys}, rates)
    losses, grad1 = [], None
    for i in range(steps):
        loss, grads = soft.loss_and_grads(start, cams, h, w, target,
                                          adam.params, bw, gamma, t_bg,
                                          dtype)
        losses.append(float(loss))
        if i == 0:
            grad1 = grads
        adam.step(grads)
    loss_gap = max(abs(a - b) / max(abs(b), 1e-300)
                   for a, b in zip(data["losses"], losses))
    grad_gaps = train._row_gaps(data["grad1"], grad1, keys)
    g_norms = {k: float(torch.linalg.vector_norm(grad1[k].double()))
               for k in keys}
    med = statistics.median(g_norms.values())
    moved = [k for k in keys if g_norms[k] >= 1e-3 * med]
    got_change = {k: data["after"][k].double() - start[k].double()
                  for k in moved}
    want_change = {k: adam.params[k].double() - start[k].double()
                   for k in moved}
    change_gaps = train._leaf_gaps(got_change, want_change, moved)
    cell.extra["detail"] = {
        "losses": data["losses"], "reference_losses": losses,
        "grad_gap": grad_gaps,
        "grad_leaf_gap": train._leaf_gaps(data["grad1"], grad1, keys),
        "change_gap": change_gaps, "grad_norms": g_norms}
    out = {"loss_gap": loss_gap, "grad_gap": max(grad_gaps.values()),
           "change_gap": max(change_gaps.values())}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}
