"""Inverse rendering: fit scene parameters to a target image by gradient
descent.

Port of ``openglraytracer_tpu/train/inverse.py``. The fit runs on the
hard engines: the dense engines ``'auto'`` (= ``'xla'``, the
default), ``'xla'``, ``'autodiff'`` and ``'pallas'`` at any depth, with no
cull spec; and the culled engines ``'culled'`` and ``culled_pallas`` with a
cull spec, their bounce children on the culled path with a child spec
(``FitConfig.child_cull``) and densely on ``'xla'`` without one. With
``FitConfig.soft`` = (bw, gamma) the fit runs the soft-coverage forward
(ops/soft.py) instead, over one camera or a tuple of cameras (multi-view,
the targets stacked (V, H, W, 3), the loss the mean of the per-view MSEs).
``fit`` saves a checkpoint every ``checkpoint_every`` steps into
``checkpoint_dir`` and resumes from the newest one there
(utils/checkpoint.py). With a ``mesh`` (parallel/mesh.py) the fit is
tile-sharded, one process per device: each rank renders its pixel tile
(parallel/sharded.py), its loss is the tile's sum of squared errors over the
whole image's H·W·3, and after the backward every trainable gradient is
``all_reduce``d (summed) over the mesh before the optimizer step, the
reference's psum of the parameter gradients; the reported loss and
overflow are summed too. Trainable leaves are chosen by
dotted path ("spheres.center", "materials.diffuse", ...) into a dict of
parameters; the rest of the scene stays frozen. The loss is the pixel MSE of
a render, and its gradient runs through the shade's backward and the
engine's analytic winner backward (ops/geometry.py). ``torch.optim`` takes
the place of optax: parameters are leaf tensors updated in place by the
optimizer.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from openglraytracer_tpu_torch.models.scene import Camera, Scene
from openglraytracer_tpu_torch.ops.render import CULLED, ENGINES, render
from openglraytracer_tpu_torch.utils.profiling import span

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
    chunk_size: int = 512
    remat: bool = False     # render's remat ('autodiff': chunk checkpoints)
    steps: int = 200
    learning_rate: float = 1.0e-2
    trainable: tuple = DEFAULT_TRAINABLE
    log_every: int = 10
    checkpoint_dir: str | None = None
    checkpoint_every: int = 100
    engine: str = "auto"    # 'auto' | 'xla' | 'autodiff' | 'pallas' |
    # 'culled' | 'culled_pallas'
    # the culled engines only: ((th, tw), kp, ks[, hot_m[, kb, ksb]]), and
    # the bounce-child spec (children traced densely on 'xla' without it;
    # size it with suggest_child_cull_config(hot_primary=False) for
    # 'culled'). With soft, cull is the soft spec ((th, tw), k) of
    # soft.suggest_soft_cull (None: the dense soft pass), a tuple of them
    # for a multi-view fit
    cull: tuple | None = None
    child_cull: tuple | None = None
    row_block: int | None = None    # dense engines: bound a trace's memory
    log_path: str | None = None     # JSONL sink for fit()'s MetricsLogger
    # (bw, gamma): the soft-coverage forward (ops/soft.py) instead of the
    # hard engines; engine, depth and child_cull are then not used
    soft: tuple | None = None


def _multi_view(camera) -> bool:
    """A tuple or list of cameras. Camera is itself a NamedTuple, so a bare
    isinstance(tuple) check would take every single camera for several."""
    return isinstance(camera, (list, tuple)) and not isinstance(camera,
                                                                Camera)


def _check_config(cfg: FitConfig, camera, mesh) -> None:
    if cfg.soft is not None and mesh is not None:
        raise ValueError("soft fit stages run unsharded (they are the "
                         "coarse curriculum stages); pass mesh=None")
    if mesh is not None and cfg.row_block is not None:
        raise ValueError("row_block is not used by the tile-sharded fit "
                         "(each rank renders its own tile); drop it")
    if _multi_view(camera) and cfg.soft is None:
        raise ValueError("multi-view fitting is a soft-stage feature "
                         "(hard cull specs are single-camera)")
    if cfg.soft is not None:
        return
    if cfg.engine not in ENGINES:
        raise NotImplementedError(
            f"engine '{cfg.engine}' is not yet ported; fit with one of "
            f"{ENGINES} (see ROADMAP.md)")
    if cfg.engine in CULLED and cfg.cull is None:
        raise ValueError(f"engine '{cfg.engine}' needs FitConfig.cull; size "
                         "it with ops/accel.suggest_cull_config")
    if cfg.engine in CULLED and cfg.row_block is not None:
        raise ValueError(f"row_block is not supported with engine "
                         f"'{cfg.engine}' (the culled path is already "
                         "tile-blocked)")


def make_train_step(camera: Camera, cfg: FitConfig, mesh=None,
                    optimizer: Callable[[list], torch.optim.Optimizer]
                    | None = None, *, soft_block_pairs: int | None = None):
    """Returns (init_fn, step_fn).

    init_fn(scene) -> (params, opt): params maps each trainable path to a
    fresh leaf tensor (a copy of the scene's) that requires grad; opt is
    ``torch.optim.Adam(lr=cfg.learning_rate)`` over them, or
    ``optimizer(list_of_params)`` when an optimizer factory is given. It
    also reads the light and material tables on the host, once, for the
    static shadow and bounce masks (all lights cast when a light leaf is
    trainable, and both bounce branches run when a reflectivity or
    transparency is, since training could make them matter).

    step_fn(params, opt, scene, target) -> (params, opt, loss,
    cull_overflow): one forward, backward and optimizer step on the
    device, updating params in place. loss is a detached device scalar and
    cull_overflow a device int32 scalar counting dropped-object events of
    this step's culled broad phase (the soft one's, summed over the
    views); step_fn never waits for the device. With cfg.soft, camera may
    be a tuple of cameras, cfg.cull then the matching tuple of soft specs
    and target (V, H, W, 3); soft_block_pairs (the port's own keyword) is
    the ray-sphere pairs a checkpointed block of the culled soft forward's
    plain path holds on CPU tensors (None: ops/soft.py BLOCK_PAIRS); on
    the card the soft kernels take every tile of a view at once. With a
    mesh (parallel/mesh.make_mesh), target
    is the whole (H, W, 3) image of which each rank reads its tile, and
    loss, gradients and cull_overflow are summed over the mesh's ranks
    (all_reduce; over NCCL the step still does not wait for the device)."""
    _check_config(cfg, camera, mesh)
    multi_view = _multi_view(camera)
    lights_trainable = any(p.startswith("lights.") for p in cfg.trainable)
    bounce_trainable = any(p in ("materials.reflectivity",
                                 "materials.transparency", "materials")
                           for p in cfg.trainable)
    make_opt = optimizer or (
        lambda ps: torch.optim.Adam(ps, lr=cfg.learning_rate))
    state = {}

    def init_fn(scene: Scene):
        from openglraytracer_tpu_torch.ops.shading import (
            static_bounce_mask, static_shadow_mask)
        state["shadow_lights"] = (
            (True,) * scene.lights.count if lights_trainable
            else static_shadow_mask(scene))
        state["bounce_mask"] = (
            (True, True) if bounce_trainable or cfg.depth == 0
            else static_bounce_mask(scene))
        params = {p: x.detach().clone().requires_grad_()
                  for p, x in extract_params(scene, cfg.trainable).items()}
        return params, make_opt(list(params.values()))

    def soft_loss(scene: Scene, target):
        from openglraytracer_tpu_torch.ops.soft import (BLOCK_PAIRS,
                                                        soft_render)
        bw, gamma = cfg.soft
        block_pairs = soft_block_pairs or BLOCK_PAIRS
        cams = tuple(camera) if multi_view else (camera,)
        culls = tuple(cfg.cull) if multi_view else (cfg.cull,)
        tgts = target if multi_view else target[None]
        loss, ovf = 0.0, None
        for v in range(len(cams)):
            with span("soft_composite", "view"):
                img, o = soft_render(scene, cams[v], cfg.height, cfg.width,
                                     bw=bw, gamma=gamma, cull=culls[v],
                                     block_pairs=block_pairs,
                                     with_cull_stats=True)
                loss = loss + torch.mean(torch.square(img - tgts[v]))
            ovf = o if ovf is None else ovf + o
        return loss / len(cams), ovf

    def hard_loss(scene: Scene, target):
        kw = dict(depth=cfg.depth, chunk_size=cfg.chunk_size,
                  remat=cfg.remat, engine=cfg.engine, cull=cfg.cull,
                  child_cull=cfg.child_cull,
                  shadow_lights=state["shadow_lights"],
                  bounce_mask=state["bounce_mask"], with_cull_stats=True)
        if mesh is None:
            img, ovf = render(scene, camera, cfg.height, cfg.width,
                              row_block=cfg.row_block, **kw)
            return torch.mean(torch.square(img - target)), ovf
        from openglraytracer_tpu_torch.parallel.mesh import tile_slice
        from openglraytracer_tpu_torch.parallel.sharded import render_sharded
        img, ovf = render_sharded(scene, camera, cfg.height, cfg.width,
                                  mesh=mesh, **kw)
        rows, cols = tile_slice(mesh, cfg.height, cfg.width, mesh.coord)
        # this tile's share of the whole image's mean
        return torch.sum(torch.square(img - target[rows, cols])) \
            / (cfg.height * cfg.width * 3), ovf

    def step_fn(params, opt, scene: Scene, target):
        with span("entry", "step"):
            return _step(params, opt, scene, target)

    def _step(params, opt, scene: Scene, target):
        with span("optimizer", "zero_grad"):
            opt.zero_grad(set_to_none=True)
        scene = apply_params(scene, params)
        loss, ovf = (soft_loss if cfg.soft is not None else hard_loss)(
            scene, target)
        with span("backward", "autograd"):
            loss.backward()
        loss = loss.detach()
        if mesh is not None and mesh.group is not None:
            # one collective a step: the gradients and the loss summed over
            # the mesh in one buffer (each call costs the host more than
            # its bytes do)
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in params.values()]
            flat = torch.cat([g.reshape(-1) for g in grads]
                             + [loss.reshape(1)])
            dist.all_reduce(flat, group=mesh.group)
            parts = flat[:-1].split([g.numel() for g in grads])
            for p, g in zip(params.values(), parts):
                p.grad = g.view_as(p)
            loss = flat[-1]
        with span("optimizer", "step"):
            opt.step()
        return params, opt, loss, ovf

    return init_fn, step_fn


def fit(scene_init: Scene, target, camera: Camera, cfg: FitConfig,
        mesh=None, callback: Callable[[int, float], None] | None = None,
        optimizer: Callable[[list], torch.optim.Optimizer] | None = None):
    """Run the optimization loop. Returns (fitted_scene, losses), losses a
    list of (step, loss) at the log points.

    The host waits for the device only at log points (every
    cfg.log_every steps and the last) and at checkpoints. A device-side
    running maximum of the per-step overflow counter covers every step
    between them; when it fired, the loop recounts the survivors for the
    current parameters and logs the resize suggestion (hard engines).

    With cfg.checkpoint_dir, fit first restores the newest checkpoint there
    (parameters, optimizer state, step) and runs only the steps after it,
    then saves {params, optimizer, step} after every cfg.checkpoint_every
    steps (utils/checkpoint.py keeps the newest three); on a mesh the rank
    at coordinate (0, 0) saves, as the parameters are equal on every
    rank."""
    from openglraytracer_tpu_torch.ops.accel import check_cull_overflow
    from openglraytracer_tpu_torch.ops.shading import static_bounce_mask
    from openglraytracer_tpu_torch.utils import checkpoint as ckpt_util
    from openglraytracer_tpu_torch.utils.metrics import (MetricsLogger,
                                                         rays_per_frame)

    init_fn, step_fn = make_train_step(camera, cfg, mesh=mesh,
                                       optimizer=optimizer)
    params, opt = init_fn(scene_init)
    device = scene_init.spheres.center.device
    target = torch.as_tensor(target, device=device)

    start = 0
    if cfg.checkpoint_dir:
        restored = ckpt_util.restore_latest(cfg.checkpoint_dir, device)
        if restored is not None:
            with torch.no_grad():
                for k, v in params.items():
                    v.copy_(restored["params"][k])
            opt.load_state_dict(restored["optimizer"])
            start = int(restored["step"])

    logger = MetricsLogger("fit", path=cfg.log_path)
    losses = []
    rays = rays_per_frame(cfg.height, cfg.width, scene_init.lights.count,
                          cfg.depth,
                          bounce_mask=(static_bounce_mask(scene_init)
                                       if cfg.depth > 0 else (True, True)))
    t_last, rays_logged = time.perf_counter(), 0
    ovf_running = torch.zeros((), dtype=torch.int32, device=device)
    for step in range(start, cfg.steps):
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
                detail = None
                if cfg.cull is not None and cfg.soft is None:
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
        if cfg.checkpoint_dir and cfg.checkpoint_every and \
                (step + 1) % cfg.checkpoint_every == 0 and \
                (mesh is None or mesh.coord == (0, 0)):
            ckpt_util.save(cfg.checkpoint_dir,
                           {"params": {k: v.detach()
                                       for k, v in params.items()},
                            "optimizer": opt.state_dict(),
                            "step": step + 1}, step + 1)
    fitted = apply_params(scene_init,
                          {k: v.detach() for k, v in params.items()})
    return fitted, losses
