"""Where a frame or training step of the PyTorch/CUDA port spends its
device time.

    python scripts/profile_torch_c3.py [--scene c1_sphere_plane|
        c2_eight_spheres|c3_grid64|c4_mirror|c5_grid4096|c4_mirror4096|
        animated_obb|glass_obb|glass4096|glass1024] [--engine
        culled_pallas|culled|pallas|xla] [--child-cull] [--depth D]
        [--bounce tree|stack] [--frames 5] [--train] [--ops]
        [--out-dir DIR]

Renders the scene (c1_sphere_plane: 256x256, depth 0; c2_eight_spheres:
512x512, depth 0; c3_grid64: 1024x1024, depth 0, 64x64 tiles; c4_mirror:
1024x1024, depth 1, 64x64 tiles, its bounce children densely on 'xla';
c5_grid4096: 2048x2048, depth 0, 32x32 tiles; c4_mirror4096: 1024x1024,
depth 1 with culled bounce children, 32x32 tiles; animated_obb: the
reference's animated OBB world at time 1.2, 1280x720, depth 0;
glass_obb: the same world at 1024x1024, depth 4, the reference's
glass_stack_depth4 row; glass4096: glass_grid_scene(), 4096 glass spheres,
1024x1024, depth 4, 32x32 tiles, the reference's glass4096_stack_culled
row, whose stack spec is suggest_stack_cull_config with headroom 2 and
Ks = N; glass1024: glass_grid_scene(32), 1024 glass spheres, 256x256,
depth 4, 32x32 tiles, the same spec, chip_smoke.py's stack cell on
'culled'; --depth overrides the depth; --bounce stack runs the stack bounce
engine, frames only) with a culled engine (culled_pallas, the kernels, or
culled, the narrow phase in plain PyTorch; the bounce children culled with
--child-cull, sized with suggest_child_cull_config(hot_primary=False) on
culled, and on culled_pallas always on c4_mirror4096, the reference's row;
else traced densely on 'xla') or a dense engine (pallas, kernel 7, or xla,
plain PyTorch; no cull spec, children through the same engine) on the GPU
under torch.profiler — or, with --train, runs its
training step (forward, backward and an SGD step of mean(img^2) with
respect to spheres.center, spheres.radius and materials.diffuse, and for
animated_obb also boxes.position and boxes.angles) — and prints the device
time by kernel name, the wall time per frame or step between CUDA events,
and the device's busy share of it (the rest is the device waiting on the
host's launches), then, with the profiler off, the device time of one
frame or step (enqueued behind a spin kernel, as chip_smoke.py measures
it; median of 5) and its peak device memory
(torch.cuda.max_memory_allocated). With --out-dir it also writes the
Chrome trace there.
c1_sphere_plane, c2_eight_spheres, animated_obb and glass_obb take only
the dense engines, c5_grid4096, c4_mirror4096, glass4096 and glass1024
only the culled ones.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


# the cull tile side of each scene, as the reference's benchmark sizes it
# (None: dense engines only)
TILES = {"c1_sphere_plane": None, "c2_eight_spheres": None, "c3_grid64": 64,
         "c4_mirror": 64, "c5_grid4096": 32, "c4_mirror4096": 32,
         "animated_obb": None, "glass_obb": None, "glass4096": 32,
         "glass1024": 32}
# the scenes whose culled_pallas benchmark row culls the bounce children
CHILD_CULL = ("c4_mirror4096",)
CULLED = ("culled_pallas", "culled")
OBB_TIME = 1.2
OBB_TRAINABLE = ("spheres.center", "spheres.radius", "materials.diffuse",
                 "boxes.position", "boxes.angles")


def main(argv=None):
    from torch.profiler import ProfilerActivity, profile

    from openglraytracer_tpu_torch.models.animated import reference_frame
    from openglraytracer_tpu_torch.models.builders import (BENCH_CONFIGS,
                                                           glass_grid_scene)
    from openglraytracer_tpu_torch.ops.accel import (
        suggest_child_cull_config, suggest_cull_config,
        suggest_stack_cull_config)
    from openglraytracer_tpu_torch.ops.render import render
    from openglraytracer_tpu_torch.ops.shading import (static_bounce_mask,
                                                       static_shadow_mask)

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scene", default="c3_grid64", choices=list(TILES))
    p.add_argument("--engine", default="culled_pallas",
                   choices=["culled_pallas", "culled", "pallas", "xla"])
    p.add_argument("--child-cull", action="store_true",
                   help="cull the bounce children (a culled engine)")
    p.add_argument("--depth", type=int, default=None,
                   help="overrides the scene's depth")
    p.add_argument("--bounce", default="tree", choices=["tree", "stack"])
    p.add_argument("--frames", type=int, default=5)
    p.add_argument("--train", action="store_true",
                   help="profile the training step instead of the frame")
    p.add_argument("--ops", action="store_true",
                   help="also list the PyTorch ops with the most device "
                        "time, by input shape")
    p.add_argument("--out-dir", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")

    dev = torch.device("cuda", 0)
    dense = args.engine not in CULLED
    if args.child_cull and dense:
        raise SystemExit("--child-cull needs a culled engine")
    if args.train and args.bounce == "stack":
        raise SystemExit("--bounce stack profiles frames only")
    if args.scene == "animated_obb":
        scene, cam = reference_frame(OBB_TIME, device=dev)
        h, w, depth = 720, 1280, 0
        trainable = OBB_TRAINABLE
    elif args.scene == "glass_obb":
        scene, cam = reference_frame(OBB_TIME, device=dev)
        h, w, depth = 1024, 1024, 4
        trainable = OBB_TRAINABLE
    elif args.scene in ("glass4096", "glass1024"):
        big = args.scene == "glass4096"
        scene, cam = glass_grid_scene(64 if big else 32, device=dev)
        h = w = 1024 if big else 256
        depth = 4
        trainable = OBB_TRAINABLE[:3]
    else:
        builder, h, w, depth = BENCH_CONFIGS[args.scene]
        scene, cam = builder(device=dev)
        trainable = OBB_TRAINABLE[:3]
    if args.depth is not None:
        depth = args.depth
    if dense and args.scene in ("c5_grid4096", "c4_mirror4096",
                                "glass4096", "glass1024"):
        raise SystemExit(f"{args.scene} takes only a culled engine")
    tile = TILES[args.scene]
    if not dense and tile is None:
        raise SystemExit(f"{args.scene} takes only the dense engines")
    lights = static_shadow_mask(scene)
    spec = child = None
    if not dense and args.bounce == "stack":
        spec = suggest_stack_cull_config(scene, cam, h, w, (tile, tile),
                                         headroom=2.0, shadow_lights=lights)
        if args.scene.startswith("glass"):  # dense shadow lists, Ks = N
            spec = spec[:2] + (int(scene.spheres.count), 0) + spec[4:]
    elif not dense:
        spec = suggest_cull_config(scene, cam, h, w, (tile, tile),
                                   shadow_lights=lights)
        if depth and (args.child_cull or (args.engine == "culled_pallas"
                                          and args.scene in CHILD_CULL)):
            child = suggest_child_cull_config(
                scene, cam, h, w, spec, shadow_lights=lights,
                hot_primary=args.engine == "culled_pallas")
    bmask = static_bounce_mask(scene) if depth else (True, True)

    if args.train:
        from openglraytracer_tpu_torch.train.inverse import (FitConfig,
                                                             make_train_step)
        init_fn, step_fn = make_train_step(
            cam, FitConfig(height=h, width=w, depth=depth,
                           engine=args.engine, cull=spec, child_cull=child,
                           trainable=trainable),
            optimizer=lambda ps: torch.optim.SGD(ps, lr=1e-7))
        params, opt = init_fn(scene)
        target = torch.zeros((h, w, 3), device=dev)

        def run():
            return step_fn(params, opt, scene, target)
    else:
        def run():
            with torch.no_grad():
                return render(scene, cam, h, w, depth=depth,
                              engine=args.engine, cull=spec,
                              child_cull=child, shadow_lights=lights,
                              bounce_mask=bmask, bounce=args.bounce)
    what = "step" if args.train else "frame"

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=args.ops) as prof:
        start.record()
        for _ in range(args.frames):
            run()
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end) / args.frames

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted(((e.device_time_total / 1e3 / args.frames, e.count
                    // args.frames, e.key) for e in events), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"{torch.cuda.get_device_name(0)}; {args.scene} {w}x{h} depth "
          f"{depth}; engine {args.engine}; bounce {args.bounce}; spec "
          f"{spec}"
          + (f"; child spec {child}" if child else ""))
    print(f"{what} wall {wall_ms:.4f} ms (CUDA events, profiler on); device "
          f"busy {busy:.4f} ms = {100 * busy / wall_ms:.1f}%; "
          f"{sum(r[1] for r in rows)} kernel launches per {what}")
    print(f"{'ms/' + what:>10} {'calls':>6}  kernel")
    for ms, n, key in rows[:30]:
        print(f"{ms:10.4f} {n:6d}  {key[:100]}")
    if args.ops:
        ops = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                      if e.device_type == torch.autograd.DeviceType.CPU
                      and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
        print(f"{'ms/' + what:>10} {'calls':>6}  op [input shapes]")
        for e in ops[:15]:
            print(f"{e.self_device_time_total / 1e3 / args.frames:10.4f} "
                  f"{e.count // args.frames:6d}  {e.key} {e.input_shapes}")
    import statistics

    import chip_smoke

    dev_ms = statistics.median(chip_smoke.device_ms(torch, run, (), reps=1)
                               for _ in range(5))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{what} device time {dev_ms:.4f} ms (one {what} behind a spin "
          f"kernel, median of 5); peak device memory {peak:.3f} GiB")
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        path = os.path.join(
            args.out_dir,
            f"{args.scene}_{args.engine}_d{depth}_{args.bounce}_{what}"
            "_trace.json")
        prof.export_chrome_trace(path)
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
