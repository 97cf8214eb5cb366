"""Scaling-efficiency harness: Mrays/s against the number of devices.

Port of ``openglraytracer_tpu/parallel/scaling.py``. For each device count
n it forms the ('dx', 'dy') mesh of the first n ranks (a process group
``dist.new_group(range(n))``; the other ranks wait at a barrier), times the
tile-sharded render or the sharded training step, and reports Mrays/s and
the efficiency relative to perfect linear scaling from the first row:

    efficiency(n) = (mrays(n) / n) / mrays(first) * devices(first)

One process runs per device (parallel/distributed.init_distributed). A
count's time is the slowest rank's: each rank times its own calls (CUDA
events on a card, the host clock on the CPU) and the maximum is
all-reduced, so every rank returns the same rows. Without a process group
the world is the one process and the only count is 1. CPU numbers check
the harness's mechanics, not a device's efficiency.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from openglraytracer_tpu_torch.models.scene import Camera, Scene
from openglraytracer_tpu_torch.parallel.mesh import _factor2, make_mesh
from openglraytracer_tpu_torch.utils.metrics import rays_per_frame


def default_device_counts(n_devices: int) -> list[int]:
    """1, 2, 4, ... up to and always including n_devices."""
    counts = []
    c = 1
    while c < n_devices:
        counts.append(c)
        c *= 2
    counts.append(n_devices)
    return counts


def _best_seconds(run, device, warmup: int, iters: int) -> float:
    """Best of 3 windows of iters calls of run (each chained to the last by
    run itself), after warmup calls: seconds a call, on CUDA events for a
    CUDA device, else the host clock around a finished window."""
    for _ in range(warmup + 1):
        run()
    cuda = device.type == "cuda"
    best = float("inf")
    for _ in range(3):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        if cuda:
            end.record()
            end.synchronize()
            sec = start.elapsed_time(end) / 1e3
        else:
            sec = time.perf_counter() - t0
        best = min(best, sec / iters)
    return best


def _render_fn(scene, cam, height, width, depth, mesh, engine, cull,
               shadow_lights):
    from openglraytracer_tpu_torch.parallel.sharded import render_sharded

    def run():
        with torch.no_grad():
            return render_sharded(scene, cam, height, width, mesh=mesh,
                                  depth=depth, engine=engine, cull=cull,
                                  shadow_lights=shadow_lights)
    return run


def _step_fn(scene, cam, height, width, depth, mesh, engine, cull):
    from openglraytracer_tpu_torch.train.inverse import (FitConfig,
                                                         make_train_step)
    cfg = FitConfig(height=height, width=width, depth=depth, engine=engine,
                    cull=cull)
    init_fn, step_fn = make_train_step(cam, cfg, mesh=mesh)
    params, opt = init_fn(scene)
    target = torch.zeros((height, width, 3), dtype=torch.float32,
                         device=scene.spheres.center.device)

    def run():      # chained: step k updates the params step k+1 reads
        return step_fn(params, opt, scene, target)
    return run


def measure_scaling(scene: Scene, cam: Camera, height: int, width: int,
                    depth: int = 0, mode: str = "render",
                    engine: str = "auto",
                    device_counts: list[int] | None = None,
                    warmup: int = 2, iters: int = 5,
                    cull: tuple | None = None) -> list[dict]:
    """Rows of {devices, mesh, sec, mrays_per_s, efficiency,
    efficiency_baseline_devices} per device count, on every rank.

    mode: 'render' (forward only) or 'step' (forward, backward with the
    gradients' all_reduce, Adam). Device counts must divide the image when
    factorized into the 2-D mesh (use power-of-two resolutions); cull is
    the culled engines' spec, with its tile dividing each rank's tile."""
    from openglraytracer_tpu_torch.ops.shading import static_shadow_mask

    if mode not in ("render", "step"):
        raise ValueError(f"mode must be 'render' or 'step', got {mode!r}")
    world = dist.is_initialized()
    n_world = dist.get_world_size() if world else 1
    rank = dist.get_rank() if world else 0
    counts = device_counts or default_device_counts(n_world)
    shadow_lights = static_shadow_mask(scene)
    rays = rays_per_frame(height, width, scene.lights.count, depth,
                          shadow_lights=shadow_lights)
    device = scene.spheres.center.device

    rows = []
    for n in counts:
        if n > n_world:
            raise ValueError(f"{n} devices requested, have {n_world}")
        group = dist.new_group(list(range(n))) if world else None
        dt = 0.0
        if rank < n:
            mesh = make_mesh(n, group=group)
            dx, dy = mesh.shape
            if height % dx or width % dy:
                raise ValueError(f"mesh {dx}x{dy} must divide the image "
                                 f"{height}x{width}")
            run = (_render_fn(scene, cam, height, width, depth, mesh, engine,
                              cull, shadow_lights) if mode == "render"
                   else _step_fn(scene, cam, height, width, depth, mesh,
                                 engine, cull))
            dt = _best_seconds(run, device, warmup, iters)
        if world:
            # the slowest rank's time, on every rank (the others add 0)
            t = torch.tensor([dt], dtype=torch.float64,
                             device=device if dist.get_backend() == "nccl"
                             else "cpu")
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            dt = float(t)
            dist.barrier()
        dx, dy = _factor2(n)
        rows.append({"devices": n, "mesh": f"{dx}x{dy}", "sec": dt,
                     "mrays_per_s": rays / dt / 1e6})

    per_dev_1 = rows[0]["mrays_per_s"] / rows[0]["devices"]
    for r in rows:
        r["efficiency"] = (r["mrays_per_s"] / r["devices"]) / per_dev_1
        # relative to the smallest measured count: label the baseline so
        # that a [4, 8] sweep is not read as scaling from one device
        r["efficiency_baseline_devices"] = rows[0]["devices"]
    return rows


def format_table(rows: list[dict]) -> str:
    lines = [f"{'devices':>8} {'mesh':>8} {'ms':>10} {'Mrays/s':>10} "
             f"{'efficiency':>11}"]
    for r in rows:
        lines.append(f"{r['devices']:>8} {r['mesh']:>8} "
                     f"{r['sec'] * 1e3:>10.2f} {r['mrays_per_s']:>10.1f} "
                     f"{r['efficiency']:>10.1%}")
    return "\n".join(lines)
