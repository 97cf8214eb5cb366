"""Config-5 fit on one GPU (PyTorch port of scripts/c5_fit_acceptance.py):
the 4096-sphere procedural scene, fitted at up to 2048x2048 by a
soft-coverage curriculum and a final hard stage.

  * Soft stages (ops/soft.py) fit the soft forward against soft renders of
    the true scene at the same (bw, gamma) over three cameras orbited about
    the scene (SOFT_VIEWS), bw annealed as the resolution rises.
  * The final stage fits the hard engine 'culled' against the real
    (shadowed) target at 2048x2048 with checkpoints, then a fresh fit from
    the same directory must restore the last step and run RESUME_EXTRA
    more. It runs on one device (the tile-sharded fit is not ported).

The `pass` field of summary.json is the reference's predicate: zero
overflow events in every stage's log, the resume restored at or past the
final step, the mean center error halved, and the hard loss at the final
resolution improved at least tenfold end to end.

    python scripts/c5_fit_torch.py --out DIR [--smoke] [--device cuda]

--smoke runs the reference's smoke sizes (grid side 8, 64^2 to 256^2, a
few dozen steps a stage), every code path at a small scale. Writes
fit_log.jsonl, target.png, init.png, fitted.png and summary.json into DIR.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from openglraytracer_tpu_torch.models.builders import sphere_grid_scene  # noqa: E402
from openglraytracer_tpu_torch.ops.accel import suggest_cull_config  # noqa: E402
from openglraytracer_tpu_torch.ops.render import render  # noqa: E402
from openglraytracer_tpu_torch.ops.soft import (soft_render,  # noqa: E402
                                                suggest_soft_cull)
from openglraytracer_tpu_torch.train.inverse import FitConfig, fit  # noqa: E402
from openglraytracer_tpu_torch.utils.image import save_png  # noqa: E402

TRAINABLE = ("spheres.center", "spheres.radius", "materials.diffuse")

# soft curriculum: (res, steps, bw, gamma, geo_lr, photo_lr); bw sets the
# coverage band (~4 bw r in world units), annealed with the resolution so
# the band stays >= ~1.5 px
SOFT_STAGES = [(512, 300, 0.50, 0.60, 1.2e-2, 3.0e-2),
               (1024, 250, 0.18, 0.25, 5.0e-3, 1.2e-2),
               (2048, 200, 0.09, 0.10, 2.0e-3, 6.0e-3)]
SOFT_VIEWS = [0.0, 45.0, -45.0]     # orbit degrees about world z
# final hard stage: (res, steps, geo_lr, photo_lr), checkpointed
HARD_STAGE = (2048, 200, 6.0e-4, 5.0e-3)
RESUME_EXTRA = 20
GRID_SIDE = 64

# the reference's smoke sizes (its C5_SMOKE=1)
SMOKE_SOFT_STAGES = [(64, 40, 0.50, 0.60, 1.5e-2, 3.0e-2),
                     (128, 30, 0.18, 0.25, 8.0e-3, 1.5e-2),
                     (256, 25, 0.09, 0.10, 3.0e-3, 8.0e-3)]
SMOKE_HARD_STAGE = (256, 30, 1.0e-3, 5.0e-3)
SMOKE_RESUME_EXTRA = 5
SMOKE_GRID_SIDE = 8


def orbit_camera(cam, phi_deg: float):
    """The camera orbited phi degrees about the world z axis through the
    origin (z-up world, yaw about z)."""
    phi = math.radians(phi_deg)
    x, y, z = (float(v) for v in cam.position)
    pos = (x * math.cos(phi) - y * math.sin(phi),
           x * math.sin(phi) + y * math.cos(phi), z)
    ang = (float(cam.angles[0]), float(cam.angles[1]) + phi_deg,
           float(cam.angles[2]))
    return cam._replace(
        position=torch.tensor(pos, dtype=cam.position.dtype,
                              device=cam.position.device),
        angles=torch.tensor(ang, dtype=cam.angles.dtype,
                            device=cam.angles.device))


class CosineAdam(torch.optim.Adam):
    """Adam whose every parameter group decays its learning rate from
    base_lr over decay_steps on a cosine (optax.cosine_decay_schedule); the
    schedule reads the step count from the optimizer's own state, so a
    restored checkpoint resumes it."""

    def __init__(self, groups):
        super().__init__([dict(g, lr=g["base_lr"]) for g in groups])

    @torch.no_grad()
    def step(self, closure=None):
        for g in self.param_groups:
            st = self.state.get(g["params"][0], {})
            count = float(st["step"]) if "step" in st else 0.0
            frac = min(count, g["decay_steps"]) / g["decay_steps"]
            g["lr"] = g["base_lr"] * 0.5 * (1.0 + math.cos(math.pi * frac))
        return super().step(closure)


def make_optimizer(steps, geo_lr, photo_lr):
    """The reference's optimizer: cosine-decayed Adam at geo_lr for the
    centers and radii, at photo_lr for the diffuse colors. A factory of
    the parameter list in TRAINABLE order, as fit() takes it."""
    def build(params):
        center, radius, diffuse = params
        return CosineAdam([
            dict(params=[center, radius], base_lr=geo_lr,
                 decay_steps=steps),
            dict(params=[diffuse], base_lr=photo_lr, decay_steps=steps)])
    return build


def center_err(a, b):
    return float(torch.mean(torch.linalg.norm(
        a.spheres.center - b.spheres.center, dim=-1)))


def hard_mse(scene, target, cam, res, cull):
    with torch.no_grad():
        img = render(scene, cam, res, res, engine="culled", cull=cull)
        return float(torch.mean(torch.square(img - target)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True,
                    help="directory for the log, images and summary")
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's smoke sizes (grid side 8)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    soft_stages = SMOKE_SOFT_STAGES if args.smoke else SOFT_STAGES
    res, steps, geo_lr, photo_lr = (SMOKE_HARD_STAGE if args.smoke
                                    else HARD_STAGE)
    resume_extra = SMOKE_RESUME_EXTRA if args.smoke else RESUME_EXTRA
    side = SMOKE_GRID_SIDE if args.smoke else GRID_SIDE
    dev = torch.device(args.device)

    os.makedirs(args.out, exist_ok=True)
    ckpt_dir = os.path.join(args.out, "ckpt")
    log_path = os.path.join(args.out, "fit_log.jsonl")
    if os.path.exists(log_path):
        os.remove(log_path)
    # an earlier run's checkpoints would turn the hard stage into a resume
    if os.path.isdir(ckpt_dir):
        shutil.rmtree(ckpt_dir)

    scene_true, cam = sphere_grid_scene(side, seed=1, device=dev)
    gen = torch.Generator().manual_seed(0)
    sph, mats = scene_true.spheres, scene_true.materials

    def noise(x):
        return torch.randn(x.shape, generator=gen).to(dev)
    scene_init = scene_true._replace(
        spheres=sph._replace(
            center=sph.center + 0.1 * noise(sph.center),
            radius=torch.clamp(sph.radius + 0.05 * noise(sph.radius),
                               min=0.1)),
        materials=mats._replace(diffuse=torch.clamp(
            mats.diffuse + 0.3 * noise(mats.diffuse), 0.0, 1.0)))
    scene_fit = scene_init
    err0 = center_err(scene_init, scene_true)
    stage_rows = []
    t_total0 = time.time()

    # soft curriculum stages (multi-view, one device)
    cams = tuple(orbit_camera(cam, v) for v in SOFT_VIEWS)
    for s_res, s_steps, bw, gamma, s_geo, s_photo in soft_stages:
        t0 = time.time()
        tile = 32 if s_res >= 1024 else 16
        # headroom 2: the centers move during a stage and the spec is
        # sized once against the true scene
        culls = tuple(suggest_soft_cull(scene_true, c, s_res, s_res,
                                        (tile, tile), bw, headroom=2.0)
                      for c in cams)
        with torch.no_grad():
            target = torch.stack([
                soft_render(scene_true, c, s_res, s_res, bw=bw, gamma=gamma,
                            cull=cu) for c, cu in zip(cams, culls)])
        cfg = FitConfig(height=s_res, width=s_res, steps=s_steps,
                        trainable=TRAINABLE, soft=(bw, gamma), cull=culls,
                        log_every=10, log_path=log_path)
        scene_fit, losses = fit(scene_fit, target, cams, cfg,
                                optimizer=make_optimizer(s_steps, s_geo,
                                                         s_photo))
        row = {"res": s_res, "steps": s_steps, "soft": [bw, gamma],
               "views": SOFT_VIEWS, "k": [c[1] for c in culls],
               "loss_first": losses[0][1], "loss_last": losses[-1][1],
               "center_err": round(center_err(scene_fit, scene_true), 4),
               "sharded": False, "seconds": round(time.time() - t0, 1)}
        stage_rows.append(row)
        print(json.dumps(row), flush=True)

    # final hard stage: culled, checkpointed
    tile = 32 if res >= 1024 else 16
    t0 = time.time()
    cull = suggest_cull_config(scene_true, cam, res, res, (tile, tile),
                               headroom=2.0, hot=False)
    with torch.no_grad():
        target = render(scene_true, cam, res, res, engine="culled",
                        cull=cull)
        save_png(target, os.path.join(args.out, "target.png"))
        save_png(render(scene_init, cam, res, res, engine="culled",
                        cull=cull), os.path.join(args.out, "init.png"))
    loss_init_hard = hard_mse(scene_init, target, cam, res, cull)
    ckpt_every = min(100, steps)
    cfg = FitConfig(height=res, width=res, steps=steps, trainable=TRAINABLE,
                    engine="culled", cull=cull, checkpoint_dir=ckpt_dir,
                    checkpoint_every=ckpt_every, log_every=10,
                    log_path=log_path)
    scene_fit, losses = fit(scene_fit, target, cam, cfg,
                            optimizer=make_optimizer(steps, geo_lr,
                                                     photo_lr))
    row = {"res": res, "steps": steps, "soft": None,
           "loss_first": losses[0][1], "loss_last": losses[-1][1],
           "center_err": round(center_err(scene_fit, scene_true), 4),
           "sharded": False, "seconds": round(time.time() - t0, 1)}
    stage_rows.append(row)
    print(json.dumps(row), flush=True)
    err1 = center_err(scene_fit, scene_true)
    loss_fit_hard = hard_mse(scene_fit, target, cam, res, cull)
    with torch.no_grad():
        save_png(render(scene_fit, cam, res, res, engine="culled",
                        cull=cull), os.path.join(args.out, "fitted.png"))

    # checkpoint resume: a fresh fit from the same directory restores step
    # `steps` and runs only resume_extra more
    cfg2 = FitConfig(height=res, width=res, steps=steps + resume_extra,
                     trainable=TRAINABLE, engine="culled", cull=cull,
                     checkpoint_dir=ckpt_dir, checkpoint_every=ckpt_every,
                     log_every=10, log_path=log_path)
    t0 = time.time()
    _, losses2 = fit(scene_init, target, cam, cfg2,
                     optimizer=make_optimizer(steps + resume_extra, geo_lr,
                                              photo_lr))
    resume_s = time.time() - t0
    resumed_from = losses2[0][0]

    ovf_events = 0
    with open(log_path) as f:
        for line in f:
            ovf_events += json.loads(line).get("cull_overflow_events", 0)
    radius_err = float(torch.mean(torch.abs(
        scene_fit.spheres.radius - scene_true.spheres.radius)))
    hard_drop = loss_init_hard / max(loss_fit_hard, 1e-30)
    summary = {
        "config": ("c5_SMOKE_fit_soft_curriculum" if args.smoke
                   else "c5_grid4096_fit_soft_curriculum"),
        "n_spheres": side * side, "engine": "soft->culled",
        "stages": stage_rows,
        "total_fit_seconds": round(time.time() - t_total0, 1),
        "center_err_init": round(err0, 4),
        "center_err_fitted": round(err1, 4),
        "center_err_reduction": round(1.0 - err1 / err0, 3),
        "center_err_target": 0.05,
        "center_err_target_met": err1 <= 0.05,
        "radius_err_fitted": round(radius_err, 4),
        "overflow_events": ovf_events,
        "resume": {"restored_first_logged_step": resumed_from,
                   "extra_steps": resume_extra,
                   "final_loss": losses2[-1][1],
                   "seconds": round(resume_s, 1),
                   "ok": resumed_from >= steps},
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "hard_loss_init": loss_init_hard,
        "hard_loss_fitted": loss_fit_hard,
        "hard_loss_drop_x": round(hard_drop, 1),
        "pass": (ovf_events == 0 and resumed_from >= steps
                 and err1 < err0 * 0.5 and hard_drop >= 10.0),
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
