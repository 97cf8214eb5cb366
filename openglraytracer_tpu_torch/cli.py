"""Command-line interface of the PyTorch/CUDA port.

Port of the ``configs``, ``render`` and ``fit`` commands of
``openglraytracer_tpu/cli.py``:

  python -m openglraytracer_tpu_torch.cli configs
  python -m openglraytracer_tpu_torch.cli render --scene c3_grid64 \\
      --cull-tile 64 --out c3.png --time
  python -m openglraytracer_tpu_torch.cli fit --grid-side 4 --width 256 \\
      --height 256 --steps 60 --lr 0.02

``render`` and ``fit`` take the reference's flags where they apply, plus
``--device`` (default ``cuda``; there is no silent fall back to the CPU).
Flags for what this package does not do yet (other engines, bounces, child
culling, the stack bounce engine; PNG targets, soft, sharded and
checkpointed fits) are rejected with a message.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import torch

ENGINES = ["auto", "xla", "pallas", "culled", "culled_pallas"]


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available "
                         "(pass --device cpu to run the plain versions of "
                         "the kernels)")
    return device


def _builtin(name: str, device):
    from openglraytracer_tpu_torch.models.builders import BENCH_CONFIGS
    if name not in BENCH_CONFIGS:
        raise SystemExit(
            f"unknown config '{name}'; available: {list(BENCH_CONFIGS)}")
    builder, h, w, depth = BENCH_CONFIGS[name]
    scene, cam = builder(device=device)
    return scene, cam, h, w, depth


def cmd_configs(args):
    from openglraytracer_tpu_torch.models.builders import BENCH_CONFIGS
    for name, (_, h, w, depth) in BENCH_CONFIGS.items():
        print(f"{name:20s} {w}x{h} depth={depth}")


def _profiled(profile_dir, device):
    """Context manager: a torch.profiler trace when --profile-dir is set,
    written as a Chrome trace into that directory."""
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    print(f"profiling to {profile_dir} (Chrome trace)")
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(profile_dir))


def _resolve_scene(args, device):
    """(scene, cam, h, w, depth) from a builtin name or scene JSON; JSON
    scenes carry their own camera unless --camera-pos/--camera-angles
    override it."""
    from openglraytracer_tpu_torch.models.scene import (load_scene_camera,
                                                        make_camera)
    if args.scene.endswith(".json"):
        scene, cam = load_scene_camera(args.scene, device=device)
        h = args.height or 720
        w = args.width or 1280
        depth = args.depth if args.depth is not None else 0
        if cam is None or args.camera_pos or args.camera_angles:
            cam = make_camera(tuple(args.camera_pos or (0.0, -10.0, 4.0)),
                              tuple(args.camera_angles or (-15.0, 0.0, 0.0)),
                              aspect=w / h, device=device)
    else:
        scene, cam, h, w, depth = _builtin(args.scene, device)
        h, w = args.height or h, args.width or w
        depth = args.depth if args.depth is not None else depth
    return scene, cam, h, w, depth


def _reject_unported(args, depth: int):
    if args.engine != "culled_pallas":
        raise SystemExit(f"--engine {args.engine} is not yet ported to "
                         "PyTorch/CUDA; this package renders with "
                         "--engine culled_pallas (see ROADMAP.md)")
    if args.child_cull:
        raise SystemExit("--child-cull is not yet ported (bounce children "
                         "come with the bounce slice; see ROADMAP.md)")
    if args.bounce != "tree":
        raise SystemExit(f"--bounce {args.bounce} is not yet ported "
                         "(see ROADMAP.md)")
    if depth > 0:
        raise SystemExit(f"depth {depth}: reflection/refraction bounces are "
                         "not yet ported; render with --depth 0 "
                         "(see ROADMAP.md)")


def cmd_render(args):
    from openglraytracer_tpu_torch.models.scene import save_scene
    from openglraytracer_tpu_torch.ops.accel import suggest_cull_config
    from openglraytracer_tpu_torch.ops.render import render
    from openglraytracer_tpu_torch.ops.shading import static_shadow_mask
    from openglraytracer_tpu_torch.utils.image import save_png
    from openglraytracer_tpu_torch.utils.metrics import (MetricsLogger,
                                                         rays_per_frame,
                                                         time_fn)

    device = _device(args.device)
    if args.time and device.type != "cuda":
        raise SystemExit("--time measures with CUDA events: it needs "
                         "--device cuda")
    scene, cam, h, w, depth = _resolve_scene(args, device)
    _reject_unported(args, depth)
    t = args.cull_tile
    if h % t or w % t:
        raise SystemExit(
            f"--cull-tile {t} must divide the image: {w}x{h} "
            f"(--width/--height); pick a dividing tile or resolution "
            f"(e.g. --height {h - h % t or t})")
    shadow_lights = static_shadow_mask(scene)
    spec = suggest_cull_config(scene, cam, h, w, (t, t),
                               shadow_lights=shadow_lights)
    print(f"cull: tile={t} "
          + " ".join(f"{k}={v}" for k, v in
                     zip(("kp", "ks", "hot_m", "kb", "ksb"), spec[1:])))
    kwargs = dict(depth=depth, engine="culled_pallas", cull=spec,
                  shadow_lights=shadow_lights)
    with _profiled(args.profile_dir, device), torch.no_grad():
        img = render(scene, cam, h, w, **kwargs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    if args.time:
        with torch.no_grad():
            dt = time_fn(lambda: render(scene, cam, h, w, **kwargs))
        n_rays = rays_per_frame(h, w, scene.lights.count, depth,
                                shadow_lights=shadow_lights)
        MetricsLogger("render").log(
            h=h, w=w, depth=depth, sec=dt,
            mrays_per_s=round(n_rays / dt / 1e6, 2),
            device=torch.cuda.get_device_name(device))
    if args.save_scene:
        save_scene(scene, args.save_scene, camera=cam)
        print(f"wrote scene+camera JSON {args.save_scene}")
    save_png(img, args.out)
    print(f"wrote {args.out} ({w}x{h}, depth={depth})")


def _reject_unported_fit(args):
    if args.target or args.scene:
        raise SystemExit("--target/--scene fits to a PNG are not yet ported "
                         "(they need utils/image.load_png, slice 9 of "
                         "ROADMAP.md); the default synthetic fit needs "
                         "neither")
    for flag, value, what in (
            ("--soft", args.soft, "the soft-coverage forward (slice 7)"),
            ("--sharded", args.sharded, "the tile-sharded fit (slice 8)"),
            ("--checkpoint-dir", args.checkpoint_dir,
             "checkpoints (slice 7)"),
            ("--row-block", args.row_block, "row blocks (slice 7)")):
        if value:
            raise SystemExit(f"{flag}: {what} is not yet ported (see "
                             "ROADMAP.md)")
    if args.engine != "culled_pallas":
        raise SystemExit(f"--engine {args.engine} is not yet ported to "
                         "PyTorch/CUDA; this package fits with --engine "
                         "culled_pallas (see ROADMAP.md)")
    if args.depth > 0:
        raise SystemExit(f"depth {args.depth}: reflection/refraction bounces "
                         "are not yet ported; fit with --depth 0 "
                         "(see ROADMAP.md)")


def cmd_fit(args):
    """The synthetic fit: render sphere_grid_scene(--grid-side, seed=1) as
    the target, perturb the spheres' centers and radii with noise from a
    torch.Generator seeded with 0, and fit back."""
    from openglraytracer_tpu_torch.models.builders import sphere_grid_scene
    from openglraytracer_tpu_torch.models.scene import save_scene
    from openglraytracer_tpu_torch.ops.accel import suggest_cull_config
    from openglraytracer_tpu_torch.ops.render import render
    from openglraytracer_tpu_torch.train.inverse import FitConfig, fit
    from openglraytracer_tpu_torch.utils.image import save_png

    _reject_unported_fit(args)
    device = _device(args.device)
    h, w, t = args.height or 128, args.width or 128, args.cull_tile
    if h % t or w % t:
        raise SystemExit(f"--cull-tile {t} must divide the fit resolution "
                         f"{w}x{h}")
    scene_true, cam = sphere_grid_scene(args.grid_side, seed=1,
                                        device=device)
    # generous headroom: the scene moves during the fit
    cull = suggest_cull_config(scene_true, cam, h, w, (t, t), headroom=2.0)
    print(f"cull: {cull}")
    with torch.no_grad():
        target = render(scene_true, cam, h, w, cull=cull)
    gen = torch.Generator().manual_seed(0)
    sph = scene_true.spheres
    noise_c = torch.randn(sph.center.shape, generator=gen).to(device)
    noise_r = torch.randn(sph.radius.shape, generator=gen).to(device)
    scene_init = scene_true._replace(spheres=sph._replace(
        center=sph.center + 0.3 * noise_c,
        radius=torch.clamp(sph.radius + 0.1 * noise_r, min=0.1)))

    cfg = FitConfig(height=h, width=w, depth=args.depth, steps=args.steps,
                    learning_rate=args.lr,
                    trainable=tuple(args.trainable.split(",")), cull=cull)
    t0 = time.time()
    with _profiled(args.profile_dir, device):
        fitted, losses = fit(scene_init, target, cam, cfg)
    print(f"fit: {len(losses)} logged losses, first {losses[0][1]:.3e}, "
          f"final {losses[-1][1]:.3e}, {time.time() - t0:.1f}s")
    if args.save_scene:
        save_scene(fitted, args.save_scene, camera=cam)
        print(f"wrote fitted scene JSON {args.save_scene}")
    if args.out:
        with torch.no_grad():
            save_png(render(fitted, cam, h, w, cull=cull), args.out)
        print(f"wrote {args.out}")


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="oglrt-torch",
        description="differentiable raytracer, PyTorch/CUDA port")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene to PNG")
    r.add_argument("--scene", default="c2_eight_spheres",
                   help="builtin config name or scene .json path")
    r.add_argument("--out", default="render.png")
    r.add_argument("--width", type=int, default=None)
    r.add_argument("--height", type=int, default=None)
    r.add_argument("--depth", type=int, default=None)
    r.add_argument("--engine", default="culled_pallas", choices=ENGINES,
                   help="only culled_pallas is ported")
    r.add_argument("--cull-tile", type=int, default=32,
                   help="pixel tile side of the culled engine")
    r.add_argument("--child-cull", action="store_true",
                   help="not yet ported (rejected)")
    r.add_argument("--bounce", default="tree", choices=["tree", "stack"],
                   help="'stack' is not yet ported (rejected)")
    r.add_argument("--camera-pos", type=float, nargs=3, default=None,
                   help="overrides the scene JSON's camera when given")
    r.add_argument("--camera-angles", type=float, nargs=3, default=None)
    r.add_argument("--time", action="store_true",
                   help="print timing metrics (CUDA events; needs a GPU)")
    r.add_argument("--save-scene", default=None,
                   help="also write the scene+camera as JSON (round-trip)")
    r.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of the render here")
    r.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda)")
    r.set_defaults(fn=cmd_render)

    f = sub.add_parser("fit", help="inverse-rendering fit")
    f.add_argument("--grid-side", type=int, default=4)
    f.add_argument("--target", default=None,
                   help="not yet ported (rejected): fit to a PNG")
    f.add_argument("--scene", default=None,
                   help="not yet ported (rejected): initial scene JSON for "
                        "--target fits")
    f.add_argument("--width", type=int, default=None)
    f.add_argument("--height", type=int, default=None)
    f.add_argument("--depth", type=int, default=0)
    f.add_argument("--steps", type=int, default=100)
    f.add_argument("--lr", type=float, default=1e-2)
    f.add_argument("--trainable",
                   default="spheres.center,spheres.radius,materials.diffuse")
    f.add_argument("--sharded", action="store_true",
                   help="not yet ported (rejected)")
    f.add_argument("--engine", default="culled_pallas", choices=ENGINES,
                   help="only culled_pallas is ported")
    f.add_argument("--soft", default=None, metavar="BW,GAMMA",
                   help="not yet ported (rejected)")
    f.add_argument("--cull-tile", type=int, default=32)
    f.add_argument("--row-block", type=int, default=None,
                   help="not yet ported (rejected)")
    f.add_argument("--checkpoint-dir", default=None,
                   help="not yet ported (rejected)")
    f.add_argument("--out", default=None,
                   help="write the fitted scene's render here (PNG)")
    f.add_argument("--save-scene", default=None,
                   help="write the fitted scene+camera as JSON")
    f.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of the fit here")
    f.add_argument("--device", default="cuda",
                   help="torch device to fit on (default cuda)")
    f.set_defaults(fn=cmd_fit)

    c = sub.add_parser("configs", help="list builtin configs")
    c.set_defaults(fn=cmd_configs)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
