"""Command-line interface of the PyTorch/CUDA port.

Port of ``openglraytracer_tpu/cli.py``'s ``configs``, ``render``,
``animate``, ``view``, ``fit`` and ``scale`` commands (``bench`` waits for
the port of bench.py):

  python -m openglraytracer_tpu_torch.cli configs
  python -m openglraytracer_tpu_torch.cli render --scene c4_mirror \\
      --out c4.png --time               # engine 'auto' = 'xla'
  python -m openglraytracer_tpu_torch.cli render --scene c3_grid64 \\
      --engine culled_pallas --cull-tile 64 --out c3.png
  python -m openglraytracer_tpu_torch.cli render --scene c3_grid64 \\
      --engine pallas --out c3.png      # the dense kernel engine, kernel 7
  python -m openglraytracer_tpu_torch.cli render --scene c4_mirror4096 \\
      --engine culled_pallas --child-cull --out c4m.png
  python -m openglraytracer_tpu_torch.cli render --scene c5_grid4096 \\
      --engine culled --out c5.png      # the XLA culled engine
  python -m openglraytracer_tpu_torch.cli render --scene c2_eight_spheres \\
      --depth 4 --bounce stack --out c2s.png   # the stack bounce engine
  python -m openglraytracer_tpu_torch.cli animate --frames 30 \\
      --width 1280 --height 720 --depth 1 --out-pattern frame_{:04d}.png
  python -m openglraytracer_tpu_torch.cli view --engine culled_pallas \\
      --port 8000                       # live PNG stream over HTTP
  python -m openglraytracer_tpu_torch.cli fit --grid-side 4 --width 256 \\
      --height 256 --steps 60 --lr 0.02
  python -m openglraytracer_tpu_torch.cli fit --target t.png \\
      --scene init.json --steps 100     # fit a scene JSON to a PNG
  python -m openglraytracer_tpu_torch.cli scale --scene c1_sphere_plane \\
      --height 256 --width 256          # Mrays/s against devices

The commands take the reference's flags where they apply, plus
``--device`` (default ``cuda``; there is no silent fall back to the CPU),
and ``render`` and ``fit`` ``--row-block``. The engines are the
reference's, with its default ``auto`` (= ``xla``, plain PyTorch):
``xla``, ``pallas`` (kernel 7), ``culled`` (the culled narrow phase in
plain PyTorch), ``culled_pallas`` and, in ``render`` and ``animate``,
``autodiff``, each at any depth. With the culled engines the bounce
children are traced densely on ``xla``, and on the culled path with a
child spec sized from a measured bounce pass with ``--child-cull`` (with
the reference's hot-primary budget on ``culled_pallas``, from the maximum
counts on ``culled``, whose children have no hot-primary pass).
``render --bounce stack`` runs the stack bounce engine on every engine but
``autodiff`` (which the reference rejects too); on the culled engines its
one spec for every step is sized by ``suggest_stack_cull_config`` (the
reference's CLI passes the primary spec, whose lists deep bundles
overflow). ``--time`` charges the reference's rays: the primary rays and
a shadow ray per static shadow-casting light, per cast of the static
bounce tree, whatever the engine. ``fit --soft BW,GAMMA`` runs the
soft-coverage fit against a soft render of the true scene,
``--checkpoint-dir`` saves and resumes the fit there, ``--target PNG
--scene init.json`` fits the scene of the JSON (and its camera) to the
PNG, and ``--sharded`` runs the tile-sharded fit over the process group
(one process per device, started by a launcher such as torchrun; a single
process is the (1, 1) mesh). ``view`` streams PNG frames, not the
reference's JPEG. ``animate --gif`` is rejected: it needs PIL, which the
port does not depend on.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

ENGINES = ["auto", "xla", "pallas", "culled", "culled_pallas"]
CULLED = ("culled", "culled_pallas")


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


def _profiled(profile_dir):
    """Context manager: a torch.profiler trace when --profile-dir is set
    (utils/profiling.trace)."""
    if not profile_dir:
        return contextlib.nullcontext()
    from openglraytracer_tpu_torch.utils.profiling import trace
    print(f"profiling to {profile_dir} (TensorBoard/Chrome trace)")
    return trace(profile_dir)


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


def _check_row_block(args):
    if args.row_block is not None and args.engine in CULLED:
        raise SystemExit(f"--row-block is not supported with --engine "
                         f"{args.engine} (the culled path is already "
                         "tile-blocked); drop it or use --engine xla")


def _check_render_flags(args, depth: int):
    if args.bounce == "stack" and args.engine == "autodiff":
        raise SystemExit("--bounce stack supports --engine auto, xla, "
                         "pallas, culled and culled_pallas, not autodiff")
    _check_row_block(args)
    if args.child_cull and args.engine not in CULLED:
        raise SystemExit("--child-cull requires --engine culled or "
                         "culled_pallas (it sizes the culled bounce-child "
                         f"lists; --engine {args.engine} traces children "
                         "densely)")
    if args.child_cull and args.bounce == "stack":
        raise SystemExit("--child-cull sizes the tree's bounce children; "
                         "--bounce stack traces every step with one spec "
                         "(suggest_stack_cull_config)")
    if args.child_cull and depth <= 0:
        raise SystemExit("--child-cull needs --depth >= 1 (it sizes the "
                         "bounce children's survivor lists)")


def _cull_spec(scene, cam, h: int, w: int, t: int, shadow_lights,
               stack: bool = False, **kw):
    """The culled engine's spec for (t, t) tiles, printed:
    suggest_cull_config with the keywords kw, or with stack the stack
    engine's suggest_stack_cull_config."""
    from openglraytracer_tpu_torch.ops.accel import (
        suggest_cull_config, suggest_stack_cull_config)
    if h % t or w % t:
        raise SystemExit(
            f"--cull-tile {t} must divide the image: {w}x{h} "
            f"(--width/--height); pick a dividing tile or resolution "
            f"(e.g. --height {h - h % t or t})")
    suggest = suggest_stack_cull_config if stack else suggest_cull_config
    spec = suggest(scene, cam, h, w, (t, t), shadow_lights=shadow_lights,
                   **kw)
    print(f"{'stack cull' if stack else 'cull'}: tile={t} "
          + " ".join(f"{k}={v}" for k, v in
                     zip(("kp", "ks", "hot_m", "kb", "ksb", "hot_p"),
                         spec[1:])))
    return spec


def _check_timing(device):
    if device.type != "cuda":
        raise SystemExit("--time measures with CUDA events: it needs "
                         "--device cuda")


def cmd_render(args):
    from openglraytracer_tpu_torch.models.scene import save_scene
    from openglraytracer_tpu_torch.ops.accel import suggest_child_cull_config
    from openglraytracer_tpu_torch.ops.render import render
    from openglraytracer_tpu_torch.ops.shading import (static_bounce_mask,
                                                       static_shadow_mask)
    from openglraytracer_tpu_torch.utils.image import save_png
    from openglraytracer_tpu_torch.utils.metrics import (MetricsLogger,
                                                         rays_per_frame,
                                                         time_fn)

    device = _device(args.device)
    if args.time:
        _check_timing(device)
    scene, cam, h, w, depth = _resolve_scene(args, device)
    _check_render_flags(args, depth)
    shadow_lights = static_shadow_mask(scene)
    bounce_mask = static_bounce_mask(scene) if depth > 0 else (True, True)
    kwargs = dict(depth=depth, engine=args.engine, bounce_mask=bounce_mask,
                  shadow_lights=shadow_lights, row_block=args.row_block,
                  bounce=args.bounce)
    if args.engine in CULLED:
        kwargs["cull"] = _cull_spec(scene, cam, h, w, args.cull_tile,
                                    shadow_lights,
                                    stack=args.bounce == "stack")
    if args.child_cull:
        spec = kwargs["cull"]
        # the hot-primary budget is kernel 2's; the children of 'culled'
        # get lists sized from the maximum counts, which never truncate
        cspec = suggest_child_cull_config(
            scene, cam, h, w, spec, shadow_lights=shadow_lights,
            hot_primary=args.engine == "culled_pallas")
        print("child cull: "
              + " ".join(f"{k}={v}" for k, v in
                         zip(("kp", "ks", "hot_m", "kb", "ksb", "hot_p"),
                             cspec[1:])))
        kwargs["child_cull"] = cspec
    with _profiled(args.profile_dir), torch.no_grad():
        img = render(scene, cam, h, w, **kwargs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    if args.time:
        with torch.no_grad():
            dt = time_fn(lambda: render(scene, cam, h, w, **kwargs))
        # the reference's count for every engine, though kernel 7 casts
        # every light's shadow ray
        n_rays = rays_per_frame(h, w, scene.lights.count, depth,
                                shadow_lights=shadow_lights,
                                bounce_mask=bounce_mask)
        MetricsLogger("render").log(
            h=h, w=w, depth=depth, sec=dt,
            mrays_per_s=round(n_rays / dt / 1e6, 2),
            device=torch.cuda.get_device_name(device))
    if args.save_scene:
        save_scene(scene, args.save_scene, camera=cam)
        print(f"wrote scene+camera JSON {args.save_scene}")
    save_png(img, args.out)
    print(f"wrote {args.out} ({w}x{h}, depth={depth})")


def _soft_spec(args, scene, cam, h, w):
    """--soft BW,GAMMA: ((bw, gamma), the soft cull spec sized with
    headroom 2 and printed), with the reference's checks."""
    from openglraytracer_tpu_torch.ops.soft import suggest_soft_cull
    try:
        bw, gamma = (float(x) for x in args.soft.split(","))
    except ValueError:
        raise SystemExit(f"--soft wants BW,GAMMA (got {args.soft!r})")
    if args.engine not in ("auto",):
        raise SystemExit("--soft replaces the hard engine; drop --engine")
    t = args.cull_tile
    if h % t or w % t:
        raise SystemExit(f"--cull-tile {t} must divide the fit "
                         f"resolution {w}x{h}")
    cull = suggest_soft_cull(scene, cam, h, w, (t, t), bw, headroom=2.0)
    print(f"soft cull: {cull}")
    return (bw, gamma), cull


def _fit_scene(args, device):
    """(scene_true, cam, target or None, h, w): with --target, the scene
    and camera of --scene init.json and the PNG as the target, loaded onto
    device; else the synthetic sphere_grid_scene(--grid-side, seed=1)."""
    from openglraytracer_tpu_torch.models.builders import sphere_grid_scene
    from openglraytracer_tpu_torch.models.scene import (load_scene_camera,
                                                        make_camera)
    from openglraytracer_tpu_torch.utils.image import load_png
    if not args.target:
        if args.scene:
            raise SystemExit("--scene is the initial scene of a --target "
                             "fit; pass --target too (the synthetic fit "
                             "takes --grid-side)")
        scene, cam = sphere_grid_scene(args.grid_side, seed=1, device=device)
        return scene, cam, None, args.height or 128, args.width or 128
    if not (args.scene and args.scene.endswith(".json")):
        raise SystemExit("--target needs --scene init.json (the initial "
                         "scene to optimize, with its camera; see "
                         "save_scene / render --save-scene)")
    scene, cam = load_scene_camera(args.scene, device=device)
    target = torch.from_numpy(load_png(args.target)).to(device)
    th, tw = target.shape[:2]
    if (args.height and args.height != th) or \
            (args.width and args.width != tw):
        raise SystemExit(f"--target {args.target} is {tw}x{th}; "
                         f"--width/--height must match (or be omitted)")
    if cam is None:
        cam = make_camera((0.0, -10.0, 4.0), (-15.0, 0.0, 0.0),
                          aspect=tw / th, device=device)
    return scene, cam, target, th, tw


def cmd_fit(args):
    """Fit a scene to a target. The synthetic fit renders
    sphere_grid_scene(--grid-side, seed=1) as the target, perturbs the
    spheres' centers and radii with noise from a torch.Generator seeded
    with 0, and fits back; with --target PNG --scene init.json the scene
    of the JSON is the starting point and the PNG the target. The
    synthetic target and the fitted scene's --out are rendered with the
    default engine, as the reference does; the fit runs --engine (a culled
    engine's children densely on 'xla'). With --soft the synthetic target
    is the soft render of the true scene at the same (bw, gamma), so the
    true scene is the exact optimum, and the fit runs the soft forward.
    --checkpoint-dir saves a checkpoint every 100 steps (FitConfig's
    default, as the reference) and resumes from the newest one there.
    --sharded fits over the tile mesh of the process group
    (parallel/distributed.init_distributed from a launcher's environment;
    one process is the (1, 1) mesh); the rank at (0, 0) writes the
    outputs."""
    from openglraytracer_tpu_torch.models.scene import save_scene
    from openglraytracer_tpu_torch.ops.accel import suggest_cull_config
    from openglraytracer_tpu_torch.ops.render import render
    from openglraytracer_tpu_torch.train.inverse import FitConfig, fit
    from openglraytracer_tpu_torch.utils.image import save_png

    _check_row_block(args)
    if args.sharded and args.row_block is not None:
        raise SystemExit("--row-block is not used by --sharded (each rank "
                         "renders its own tile); drop it")
    if args.sharded and args.soft:
        raise SystemExit("--soft stages run unsharded")
    device = _device(args.device)
    mesh = None
    if args.sharded:
        # the process group first: it picks this rank's card, on which the
        # scene, the target and the parameters are then built
        from openglraytracer_tpu_torch.parallel.distributed import (
            init_distributed, rank_device)
        from openglraytracer_tpu_torch.parallel.mesh import make_mesh
        init_distributed(device=device)
        device = rank_device(device)
        mesh = make_mesh()
        print(f"sharded: mesh {mesh.shape[0]}x{mesh.shape[1]}, this rank at "
              f"{mesh.coord} on {device}")
    scene_true, cam, target, h, w = _fit_scene(args, device)
    t = args.cull_tile
    cull = None
    if args.engine in CULLED:
        if h % t or w % t:
            raise SystemExit(f"--cull-tile {t} must divide the fit "
                             f"resolution {w}x{h}")
        # generous headroom: the scene moves during the fit
        cull = suggest_cull_config(scene_true, cam, h, w, (t, t),
                                   headroom=2.0)
        print(f"cull: {cull}")
    soft = None
    if args.soft:
        soft, cull = _soft_spec(args, scene_true, cam, h, w)
    if target is not None:
        scene_init = scene_true     # the loaded scene is the starting point
    else:
        with torch.no_grad():
            if soft is not None:
                from openglraytracer_tpu_torch.ops.soft import soft_render
                target = soft_render(scene_true, cam, h, w, bw=soft[0],
                                     gamma=soft[1], cull=cull)
            else:
                target = render(scene_true, cam, h, w, depth=args.depth)
        gen = torch.Generator().manual_seed(0)
        sph = scene_true.spheres
        noise_c = torch.randn(sph.center.shape, generator=gen).to(device)
        noise_r = torch.randn(sph.radius.shape, generator=gen).to(device)
        scene_init = scene_true._replace(spheres=sph._replace(
            center=sph.center + 0.3 * noise_c,
            radius=torch.clamp(sph.radius + 0.1 * noise_r, min=0.1)))

    cfg = FitConfig(height=h, width=w, depth=args.depth, steps=args.steps,
                    learning_rate=args.lr, engine=args.engine,
                    trainable=tuple(args.trainable.split(",")), cull=cull,
                    row_block=args.row_block, soft=soft,
                    checkpoint_dir=args.checkpoint_dir)
    t0 = time.time()
    with _profiled(args.profile_dir):
        fitted, losses = fit(scene_init, target, cam, cfg, mesh=mesh)
    if not losses:
        raise SystemExit(f"fit: the checkpoint in {args.checkpoint_dir} is "
                         f"at or past --steps {args.steps}; nothing to run")
    print(f"fit: {len(losses)} logged losses, first {losses[0][1]:.3e}, "
          f"final {losses[-1][1]:.3e}, {time.time() - t0:.1f}s")
    if mesh is not None and mesh.coord != (0, 0):
        return
    if args.save_scene:
        save_scene(fitted, args.save_scene, camera=cam)
        print(f"wrote fitted scene JSON {args.save_scene}")
    if args.out:
        with torch.no_grad():
            save_png(render(fitted, cam, h, w, depth=args.depth), args.out,
                     gather=False)
        print(f"wrote {args.out}")


def cmd_view(args):
    """The live viewer (utils/viewer.py): the animated reference world
    rendered continuously at the wall clock's time and streamed as PNG
    frames over HTTP, until Ctrl-C or --frames."""
    from openglraytracer_tpu_torch.utils.viewer import run_viewer
    device = _device(args.device)
    run_viewer(args.height, args.width, depth=args.depth,
               engine=args.engine, cull_tile=args.cull_tile,
               port=args.port, fps_cap=args.fps_cap,
               max_frames=args.frames, start_time=args.start_time,
               device=device)


def cmd_scale(args):
    """The scaling-efficiency harness (parallel/scaling.py) over the
    process group: --coordinator/--num-processes/--process-id start it
    explicitly, a launcher's environment (torchrun) implicitly; a single
    process measures one device."""
    from openglraytracer_tpu_torch.parallel.distributed import (
        init_distributed, rank_device)
    from openglraytracer_tpu_torch.parallel.scaling import (format_table,
                                                            measure_scaling)
    device = _device(args.device)
    init_distributed(coordinator_address=args.coordinator,
                     num_processes=args.num_processes,
                     process_id=args.process_id, device=device)
    device = rank_device(device)
    scene, cam, h, w, depth = _resolve_scene(args, device)
    rows = measure_scaling(scene, cam, h, w, depth=depth, mode=args.mode,
                           engine=args.engine, device_counts=args.devices,
                           iters=args.iters)
    print(format_table(rows))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {args.json}")
    worst = min(r["efficiency"] for r in rows)
    base_n = rows[0]["devices"]
    rel = "1 device" if base_n == 1 else \
        f"{base_n} devices, not the one-device baseline"
    print(f"worst-case efficiency: {worst:.1%} relative to {rel} "
          f"(target >= 85%, BASELINE.md)")


def cmd_animate(args):
    """The reference's animated world, reference_frame(start_time + i /
    fps) for i < frames, rendered to a PNG sequence. With a culled engine
    one cull spec (headroom 2) serves the moving sequence; each frame
    rechecks it on the host and resizes it when it would overflow (never
    silent)."""
    from openglraytracer_tpu_torch.models.animated import reference_frame
    from openglraytracer_tpu_torch.ops.accel import check_cull_overflow
    from openglraytracer_tpu_torch.ops.render import render
    from openglraytracer_tpu_torch.ops.shading import static_shadow_mask
    from openglraytracer_tpu_torch.utils.image import save_png

    if args.gif:
        raise SystemExit("--gif is not yet ported (it needs PIL, which the "
                         "port does not depend on; see ROADMAP.md); the PNG "
                         "sequence is written without it")
    device = _device(args.device)
    h, w = args.height, args.width
    cull = None
    if args.engine in CULLED:
        scene0, cam0 = reference_frame(args.start_time, device=device)
        cull = _cull_spec(scene0, cam0, h, w, args.cull_tile,
                          static_shadow_mask(scene0), headroom=2.0)
    for i in range(args.frames):
        t = args.start_time + i / args.fps
        scene, cam = reference_frame(t, device=device)
        if cull is not None:
            ovf = check_cull_overflow(scene, cam, h, w, cull)
            if ovf:
                print(f"frame {i}: cull overflow {ovf} — resizing")
                cull = _cull_spec(scene, cam, h, w, args.cull_tile,
                                  static_shadow_mask(scene), headroom=2.0)
                # K's rounded up to multiples of 16, as the reference does,
                # so that a scene oscillating around a threshold does not
                # resize every frame
                cull = (cull[0],) + tuple(-(-k // 16) * 16 if k else k
                                          for k in cull[1:])
        with torch.no_grad():
            img = render(scene, cam, h, w, depth=args.depth,
                         engine=args.engine, cull=cull)
        path = args.out_pattern.format(i)
        save_png(img, path)
        print(f"frame {i}: t={t:.3f}s -> {path}")


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
    r.add_argument("--engine", default="auto",
                   choices=ENGINES + ["autodiff"])
    r.add_argument("--cull-tile", type=int, default=32,
                   help="pixel tile side of the culled engines")
    r.add_argument("--child-cull", action="store_true",
                   help="cull the bounce children too (bounce cones; needs "
                        "--engine culled or culled_pallas and depth >= 1)")
    r.add_argument("--row-block", type=int, default=None,
                   help="dense engines: trace the image in blocks of this "
                        "many rows (bounds memory; must divide the height)")
    r.add_argument("--bounce", default="tree", choices=["tree", "stack"],
                   help="bounce engine: 'tree' (static unroll) or 'stack' "
                        "(one cast a tree node in depth-first order, "
                        "O(depth) memory; not with --engine autodiff)")
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
                   help="fit to this PNG (needs --scene init.json); default "
                        "is the synthetic self-rendered-target fit")
    f.add_argument("--scene", default=None,
                   help="initial scene JSON for --target fits")
    f.add_argument("--width", type=int, default=None)
    f.add_argument("--height", type=int, default=None)
    f.add_argument("--depth", type=int, default=0)
    f.add_argument("--steps", type=int, default=100)
    f.add_argument("--lr", type=float, default=1e-2)
    f.add_argument("--trainable",
                   default="spheres.center,spheres.radius,materials.diffuse")
    f.add_argument("--sharded", action="store_true",
                   help="tile-sharded fit over the process group (one "
                        "process per device, e.g. under torchrun)")
    f.add_argument("--engine", default="auto", choices=ENGINES)
    f.add_argument("--soft", default=None, metavar="BW,GAMMA",
                   help="soft-coverage forward for silhouette-aware "
                        "geometry fitting (ops/soft.py): e.g. --soft "
                        "0.05,0.2; the target is soft-rendered at the same "
                        "constants")
    f.add_argument("--cull-tile", type=int, default=32)
    f.add_argument("--row-block", type=int, default=None,
                   help="dense engines: render in blocks of this many rows")
    f.add_argument("--checkpoint-dir", default=None,
                   help="save the fit's checkpoints here and resume from "
                        "the newest one")
    f.add_argument("--out", default=None,
                   help="write the fitted scene's render here (PNG)")
    f.add_argument("--save-scene", default=None,
                   help="write the fitted scene+camera as JSON")
    f.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of the fit here")
    f.add_argument("--device", default="cuda",
                   help="torch device to fit on (default cuda)")
    f.set_defaults(fn=cmd_fit)

    a = sub.add_parser("animate", help="render the reference animated demo")
    a.add_argument("--frames", type=int, default=30)
    a.add_argument("--fps", type=float, default=30.0)
    a.add_argument("--start-time", type=float, default=0.0)
    a.add_argument("--width", type=int, default=640)
    a.add_argument("--height", type=int, default=360)
    a.add_argument("--depth", type=int, default=0)
    a.add_argument("--engine", default="auto",
                   choices=ENGINES + ["autodiff"])
    a.add_argument("--cull-tile", type=int, default=8,
                   help="pixel tile side of the culled engines")
    a.add_argument("--out-pattern", default="frame_{:04d}.png")
    a.add_argument("--gif", default=None,
                   help="not yet ported (rejected)")
    a.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda)")
    a.set_defaults(fn=cmd_animate)

    v = sub.add_parser("view", help="live viewer: render the animated "
                       "demo continuously and stream it over HTTP as PNG "
                       "frames")
    v.add_argument("--width", type=int, default=1280)
    v.add_argument("--height", type=int, default=720)
    v.add_argument("--depth", type=int, default=0)
    v.add_argument("--engine", default="auto", choices=ENGINES)
    v.add_argument("--cull-tile", type=int, default=8)
    v.add_argument("--port", type=int, default=8000)
    v.add_argument("--fps-cap", type=float, default=None,
                   help="cap the render rate (the vsync analog); default: "
                        "as fast as the card goes")
    v.add_argument("--frames", type=int, default=None,
                   help="stop after N frames (default: run until Ctrl-C)")
    v.add_argument("--start-time", type=float, default=0.0)
    v.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda)")
    v.set_defaults(fn=cmd_view)

    s = sub.add_parser("scale",
                       help="scaling-efficiency harness (Mrays/s vs devices)")
    s.add_argument("--scene", default="c3_grid64",
                   help="builtin config name or scene .json path")
    s.add_argument("--width", type=int, default=None)
    s.add_argument("--height", type=int, default=None)
    s.add_argument("--depth", type=int, default=None)
    s.add_argument("--mode", default="render", choices=["render", "step"],
                   help="forward render or full fwd+bwd training step")
    s.add_argument("--engine", default="auto",
                   choices=["auto", "xla", "pallas"])
    s.add_argument("--devices", type=int, nargs="+", default=None,
                   help="device counts to sweep (default 1,2,4,...,all)")
    s.add_argument("--iters", type=int, default=5)
    s.add_argument("--json", default=None, help="write rows to this file")
    s.add_argument("--coordinator", default=None,
                   help="the process group's address (host:port)")
    s.add_argument("--num-processes", type=int, default=None)
    s.add_argument("--process-id", type=int, default=None)
    s.add_argument("--camera-pos", type=float, nargs=3, default=None)
    s.add_argument("--camera-angles", type=float, nargs=3, default=None)
    s.add_argument("--device", default="cuda",
                   help="torch device to measure on (default cuda; cpu "
                        "runs a gloo world)")
    s.set_defaults(fn=cmd_scale)

    c = sub.add_parser("configs", help="list builtin configs")
    c.set_defaults(fn=cmd_configs)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
