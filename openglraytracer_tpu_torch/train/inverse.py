"""Inverse rendering: fit scene parameters to a target image by gradient
descent.

Port of ``openglraytracer_tpu/train/inverse.py`` for the single-device fit
on the hard engine ``culled_pallas`` at depth 0. Trainable leaves are chosen
by dotted path ("spheres.center", "materials.diffuse", ...) into a dict of
parameters; the rest of the scene stays frozen. The loss is the pixel MSE of
a render, and its gradient runs through the shade backward kernel and the
culled op's analytic winner backward. ``torch.optim`` takes the place of
optax: parameters are leaf tensors updated in place by the optimizer.

Not ported yet (see ROADMAP.md), and rejected with a message: the
tile-sharded fit (``mesh``, slice 8), and the soft-coverage forward
(``soft``), checkpoints (``checkpoint_dir``), ``row_block`` and ``remat``
(slice 7).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch

from openglraytracer_tpu_torch.models.scene import Camera, Scene
from openglraytracer_tpu_torch.ops.render import ENGINE, render

DEFAULT_TRAINABLE = ("spheres.center", "spheres.radius", "materials.diffuse")


def get_path(scene: Scene, path: str):
    obj: Any = scene
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def _set_path(scene: Scene, path: str, value):
    parts = path.split(".")
    if len(parts) == 1:
        return scene._replace(**{parts[0]: value})
    sub = getattr(scene, parts[0])
    return scene._replace(
        **{parts[0]: sub._replace(**{parts[1]: value})})


def extract_params(scene: Scene, trainable: Sequence[str]) -> dict:
    return {p: get_path(scene, p) for p in trainable}


def apply_params(scene: Scene, params: dict) -> Scene:
    for path, value in params.items():
        scene = _set_path(scene, path, value)
    return scene


@dataclass
class FitConfig:
    height: int = 256
    width: int = 256
    depth: int = 0
    steps: int = 200
    learning_rate: float = 1.0e-2
    trainable: tuple = DEFAULT_TRAINABLE
    log_every: int = 10
    engine: str = ENGINE
    cull: tuple | None = None       # ((th, tw), kp, ks[, hot_m[, kb, ksb]])
    log_path: str | None = None     # JSONL sink for fit()'s MetricsLogger
    # not ported yet: setting any of these raises (see ROADMAP.md)
    checkpoint_dir: str | None = None
    row_block: int | None = None
    remat: bool = False
    soft: tuple | None = None


def _reject_unported(cfg: FitConfig, camera, mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh: the tile-sharded fit is not yet ported (slice 8 of "
            "ROADMAP.md); fit on one device with mesh=None")
    for name in ("soft", "checkpoint_dir", "row_block", "remat"):
        if getattr(cfg, name):
            raise NotImplementedError(
                f"FitConfig.{name} is not yet ported (slice 7 of "
                "ROADMAP.md)")
    if isinstance(camera, (list, tuple)) and not isinstance(camera, Camera):
        raise ValueError("multi-view fitting is a soft-stage feature "
                         "(hard cull specs are single-camera)")
    if cfg.cull is None:
        raise ValueError(f"engine '{cfg.engine}' needs FitConfig.cull; size "
                         "it with ops/accel.suggest_cull_config")


def make_train_step(camera: Camera, cfg: FitConfig, mesh=None,
                    optimizer: Callable[[list], torch.optim.Optimizer]
                    | None = None):
    """Returns (init_fn, step_fn).

    init_fn(scene) -> (params, opt): params maps each trainable path to a
    fresh leaf tensor (a copy of the scene's) that requires grad; opt is
    ``torch.optim.Adam(lr=cfg.learning_rate)`` over them, or
    ``optimizer(list_of_params)`` when an optimizer factory is given. It
    also reads the light table on the host, once, for the static shadow
    mask (all lights cast when a light leaf is trainable, since a trainable
    light could leave zero).

    step_fn(params, opt, scene, target) -> (params, opt, loss,
    cull_overflow): one forward, backward and optimizer step on the
    device, updating params in place. loss is a detached device scalar and
    cull_overflow a device int32 scalar counting dropped-object events of
    this step's culled broad phase; step_fn never waits for the device."""
    _reject_unported(cfg, camera, mesh)
    lights_trainable = any(p.startswith("lights.") for p in cfg.trainable)
    make_opt = optimizer or (
        lambda ps: torch.optim.Adam(ps, lr=cfg.learning_rate))
    state = {}

    def init_fn(scene: Scene):
        from openglraytracer_tpu_torch.ops.shading import static_shadow_mask
        state["shadow_lights"] = (
            (True,) * scene.lights.count if lights_trainable
            else static_shadow_mask(scene))
        params = {p: x.detach().clone().requires_grad_()
                  for p, x in extract_params(scene, cfg.trainable).items()}
        return params, make_opt(list(params.values()))

    def step_fn(params, opt, scene: Scene, target):
        opt.zero_grad(set_to_none=True)
        img, ovf = render(apply_params(scene, params), camera, cfg.height,
                          cfg.width, depth=cfg.depth, engine=cfg.engine,
                          cull=cfg.cull,
                          shadow_lights=state["shadow_lights"],
                          with_cull_stats=True)
        loss = torch.mean(torch.square(img - target))
        loss.backward()
        opt.step()
        return params, opt, loss.detach(), ovf

    return init_fn, step_fn


def fit(scene_init: Scene, target, camera: Camera, cfg: FitConfig,
        mesh=None, callback: Callable[[int, float], None] | None = None,
        optimizer: Callable[[list], torch.optim.Optimizer] | None = None):
    """Run the optimization loop. Returns (fitted_scene, losses), losses a
    list of (step, loss) at the log points.

    The host waits for the device only at log points (every
    cfg.log_every steps and the last). A device-side running maximum of
    the per-step overflow counter covers every step between them; when it
    fired, the loop recounts the survivors for the current parameters and
    logs the resize suggestion."""
    from openglraytracer_tpu_torch.ops.accel import check_cull_overflow
    from openglraytracer_tpu_torch.utils.metrics import (MetricsLogger,
                                                         rays_per_frame)

    init_fn, step_fn = make_train_step(camera, cfg, mesh=mesh,
                                       optimizer=optimizer)
    params, opt = init_fn(scene_init)
    device = scene_init.spheres.center.device
    target = torch.as_tensor(target, device=device)

    logger = MetricsLogger("fit", path=cfg.log_path)
    losses = []
    rays = rays_per_frame(cfg.height, cfg.width, scene_init.lights.count,
                          cfg.depth, bounce_mask=(True, True))
    t_last, rays_logged = time.perf_counter(), 0
    ovf_running = torch.zeros((), dtype=torch.int32, device=device)
    for step in range(cfg.steps):
        params, opt, loss, ovf = step_fn(params, opt, scene_init, target)
        ovf_running = torch.maximum(ovf_running, ovf)
        rays_logged += rays
        if step % cfg.log_every == 0 or step == cfg.steps - 1:
            lv = float(loss)          # waits: the window below is synced
            now = time.perf_counter()
            mrays = rays_logged / max(now - t_last, 1e-9) / 1e6
            t_last, rays_logged = now, 0
            losses.append((step, lv))
            logger.log(step=step, loss=lv, mrays_per_s=round(mrays, 2))
            if callback is not None:
                callback(step, lv)
            n_ovf = int(ovf_running)
            if n_ovf > 0:
                with torch.no_grad():
                    detail = check_cull_overflow(
                        apply_params(scene_init, params), camera,
                        cfg.height, cfg.width, cfg.cull)
                logger.log(step=step, cull_overflow_events=n_ovf,
                           cull_overflow=detail)
                logging.getLogger(__name__).warning(
                    "culled fit: %d survivor-list overflows since last log "
                    "(objects were dropped); at step %d the suggestion is "
                    "%s", n_ovf, step, detail)
                ovf_running = torch.zeros_like(ovf_running)
    fitted = apply_params(scene_init,
                          {k: v.detach() for k, v in params.items()})
    return fitted, losses
