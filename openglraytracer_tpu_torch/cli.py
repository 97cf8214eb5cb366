"""Command-line interface of the PyTorch/CUDA port.

Port of the ``configs`` and ``render`` commands of
``openglraytracer_tpu/cli.py``:

  python -m openglraytracer_tpu_torch.cli configs
  python -m openglraytracer_tpu_torch.cli render --scene c3_grid64 \\
      --cull-tile 64 --out c3.png --time

``render`` takes the reference's flags where they apply, plus ``--device``
(default ``cuda``; there is no silent fall back to the CPU). Flags for what
this package does not do yet (other engines, bounces, child culling, the
stack bounce engine) are rejected with a message.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

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
    with _profiled(args.profile_dir, device):
        img = render(scene, cam, h, w, **kwargs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    if args.time:
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

    c = sub.add_parser("configs", help="list builtin configs")
    c.set_defaults(fn=cmd_configs)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
