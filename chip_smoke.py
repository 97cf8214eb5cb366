#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: python3 chip_smoke.py

Drives the port's main path — ``render`` of scene c3_grid64 (64 spheres, a
ground plane, 2 point lights) at 1024x1024, depth 0, engine culled_pallas
with 64x64 tiles — and exits non-zero on any failure. Phases:

  1. device: the card's name, and its name and power limit from nvidia-smi
  2. build: compile the CUDA kernels from csrc/ (nvcc, sm_90a)
  3. each kernel against its plain PyTorch version on the card, on the
     inputs the main path gives it at c3, and on a small hand-built scene
     with rotated boxes (the box paths of kernels A and B)
  4. the main path for 3 frames: every kernel launched on every frame, no
     cull overflow, a finite image within 1/255 of the plain versions'
     image on >= 99.9% of pixels, and a small render equal to the CPU's
  5. timing with CUDA events: 3 windows of 10 frames under
     torch.cuda.set_sync_debug_mode("error") (the frame never waits for
     the host), and each kernel beside its plain version

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Without a CUDA device it exits
with code 1 and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

H = W = 1024
TILE = (64, 64)
FRAMES = 3
WINDOWS, WINDOW_FRAMES = 3, 10
# discrete outputs (winner ids, inside flags, slots, occlusion bits) may
# differ between a kernel and its plain version on at most this share of
# rays: both round every op the same way, but rsqrtf and the float64
# emulation of fmaf in the plain version can still flip a tangent graze
DISCRETE_SHARE = 1e-4
# on rays whose discrete outputs agree: t as the reference's own test of
# its kernels (rtol 5e-5, atol 1e-4); unit normals to 1e-3
T_RTOL, T_ATOL, N_ATOL = 5e-5, 1e-4, 1e-3
# shade: same chain in the same order; rsqrtf/expf/logf round differently
# from PyTorch's own kernels by a few ulp, amplified by shininess up to 64
SHADE_ATOL = 2e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"FAIL: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Capture:
    """Record the arguments each kernel wrapper is called with, so that a
    kernel and its plain version can be compared on the main path's own
    inputs."""

    def __init__(self, culled, shade):
        self.targets = [(culled, "primary_hit"), (culled, "shadow_occlusion"),
                        (shade, "phong_fused")]
        self.args = {}

    def __enter__(self):
        self.saved = [getattr(m, n) for m, n in self.targets]
        for (mod, name), fn in zip(self.targets, self.saved):
            def spy(*a, _fn=fn, _name=name):
                self.args[_name] = a
                return _fn(*a)
            setattr(mod, name, spy)
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.targets, self.saved):
            setattr(mod, name, fn)


class PlainVersions:
    """Route the renderer through the plain PyTorch versions on the card."""

    def __init__(self, culled, shade, shading):
        self.swaps = [(culled, "primary_hit", culled.primary_hit_plain),
                      (culled, "shadow_occlusion",
                       culled.shadow_occlusion_plain),
                      (shade, "phong_fused", shading.phong_core)]

    def __enter__(self):
        self.saved = [getattr(m, n) for m, n, _ in self.swaps]
        for mod, name, fn in self.swaps:
            setattr(mod, name, fn)

    def __exit__(self, *exc):
        for (mod, name, _), fn in zip(self.swaps, self.saved):
            setattr(mod, name, fn)


def compare_primary(torch, k, p, what):
    """Kernel A outputs k vs plain p: (mismatch share, max abs err)."""
    t_k, n_k, ins_k, mat_k, gid_k, slot_k = k
    t_p, n_p, ins_p, mat_p, gid_p, slot_p = p
    agree = ((ins_k == ins_p) & (mat_k == mat_p) & (gid_k == gid_p)
             & (slot_k == slot_p) & ((t_k < 1e4) == (t_p < 1e4)))
    share = 1.0 - float(agree.float().mean())
    live = agree & (t_p < 1e4)
    dt = (t_k - t_p).abs()[live]
    dn = (n_k - n_p).abs()[live]
    t_bad = int((dt > T_ATOL + T_RTOL * t_p.abs()[live]).sum())
    n_bad = int((dn > N_ATOL).sum())
    err = max(float(dt.max()) if dt.numel() else 0.0,
              float(dn.max()) if dn.numel() else 0.0)
    log(f"  primary_hit [{what}]: discrete mismatches {share:.2e} of "
        f"{t_k.numel()} rays, t/n out of tolerance {t_bad}/{n_bad}, "
        f"max |t|,|n| err {err:.3e}")
    check(share <= DISCRETE_SHARE and t_bad == 0 and n_bad == 0,
          f"primary_hit kernel disagrees with its plain version ({what})")
    return share, err


def compare_shadow(torch, k, p, what):
    share_s = float((k[0] != p[0]).float().mean())
    share_o = float((k[1] != p[1]).float().mean())
    err = float(((k[0] ^ p[0]).any() | (k[1] ^ p[1]).any()).item())
    log(f"  shadow_occlusion [{what}]: occlusion mismatches sphere "
        f"{share_s:.2e}, box/plane {share_o:.2e} of {k[0].numel()} "
        f"(ray, light) pairs; occluded share {float(p[0].float().mean()):.4f}"
        f" / {float(p[1].float().mean()):.4f}")
    check(share_s <= DISCRETE_SHARE and share_o <= DISCRETE_SHARE,
          f"shadow_occlusion kernel disagrees with its plain version ({what})")
    return max(share_s, share_o), err


def compare_shade(torch, k, p, what):
    err = float((k - p).abs().max())
    log(f"  phong_fused [{what}]: max |rgb| err {err:.3e} "
        f"(tolerance {SHADE_ATOL})")
    check(err <= SHADE_ATOL,
          f"phong_fused kernel disagrees with its plain version ({what})")
    return err


def device_ms(torch, fn, args, reps: int = 10) -> float:
    """Device time per call: the calls are enqueued behind a spinning
    kernel that outlasts their enqueueing, so the events bracket
    back-to-back device work only, as long as the calls' launches fit in
    the stream's queue of pending launches (about a thousand); a plain
    version of thousands of small ops is paced by the host beyond that."""
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args)                           # host time to enqueue one call
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # spin for about twice the enqueue time (cycles at <= 2 GHz)
    torch.cuda._sleep(int(2e9 * (2.0 * host_s * reps + 0.01)))
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def box_scene(torch, device):
    """Rotated OBBs, a sphere and a plane: the box paths of A and B."""
    import numpy as np
    from openglraytracer_tpu_torch.models.scene import (
        Boxes, Planes, Spheres, make_camera, make_lights, make_materials,
        make_scene)
    rng = np.random.default_rng(7)

    def t(x, dtype=torch.float32):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    boxes = Boxes(mins=t([[-0.6, -0.4, -0.5], [-1.0, -0.2, -0.3],
                          [-0.3, -0.3, -0.9]]),
                  maxs=t([[0.6, 0.4, 0.5], [1.0, 0.2, 0.3],
                          [0.3, 0.3, 0.9]]),
                  position=t([[-1.5, 0.0, 0.6], [1.4, 0.5, 0.4],
                              [0.0, 1.5, 1.0]]),
                  angles=t(rng.uniform(-60.0, 60.0, (3, 3))),
                  material_id=t([0, 1, 2], torch.int32))
    spheres = Spheres(center=t([[0.2, -0.8, 0.7]]), radius=t([0.6]),
                      material_id=t([1], torch.int32))
    planes = Planes(normal=t([[0.0, 0.0, 1.0]]), offset=t([-0.2]),
                    material_id=t([3], torch.int32))
    mats = make_materials([
        dict(diffuse=(0.8, 0.3, 0.2, 1.0), shininess=12.0),
        dict(diffuse=(0.2, 0.7, 0.3, 1.0), shininess=40.0),
        dict(diffuse=(0.3, 0.4, 0.9, 1.0), shininess=6.0),
        dict(diffuse=0.5, specular=0.2)], device=device)
    lights = make_lights([
        dict(position=(4.0, -5.0, 6.0), ambient=0.1, diffuse=1.0,
             specular=1.0),
        dict(position=(-5.0, 2.0, 4.0), ambient=0.05, diffuse=0.6,
             specular=0.6)], device=device)
    scene = make_scene(spheres=spheres, boxes=boxes, planes=planes,
                       materials=mats, lights=lights)
    cam = make_camera((0.0, -6.0, 2.5), angles=(-18.0, 0.0, 0.0),
                      aspect=1.0, device=device)
    return scene, cam


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1

    from openglraytracer_tpu_torch import kernels
    from openglraytracer_tpu_torch.models.builders import sphere_grid_scene
    from openglraytracer_tpu_torch.ops import culled, shade, shading
    from openglraytracer_tpu_torch.ops.accel import suggest_cull_config
    from openglraytracer_tpu_torch.ops.render import render
    from openglraytracer_tpu_torch.utils.image import save_png
    from openglraytracer_tpu_torch.utils.metrics import rays_per_frame

    dev = torch.device("cuda", 0)
    wrappers = {"primary_hit": culled.primary_hit,
                "shadow_occlusion": culled.shadow_occlusion,
                "phong_fused": shade.phong_fused}

    # ---- 1. device
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"[1/5] device: {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    log(smi)

    # ---- 2. build
    t0 = time.perf_counter()
    lib_path, build_log = kernels.build()
    kernels.library()
    log(f"[2/5] build: {time.perf_counter() - t0:.1f} s -> {lib_path.parent}")
    for line in build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  {line.strip()}")

    # ---- 3. kernels vs plain versions at the c3 shapes
    log("[3/5] kernels vs plain versions")
    scene, cam = sphere_grid_scene(8, device=dev)
    shadow_lights = shading.static_shadow_mask(scene)
    spec = suggest_cull_config(scene, cam, H, W, TILE,
                               shadow_lights=shadow_lights)
    log(f"  c3 cull spec {spec}, shadow lights {shadow_lights}")
    with Capture(culled, shade) as cap:
        render(scene, cam, H, W, cull=spec, shadow_lights=shadow_lights)
    c3_args = cap.args
    a = c3_args["primary_hit"]
    log(f"  c3 shapes: dirs {tuple(a[0].shape)}, sphere rows "
        f"{tuple(a[1].shape)}, box rows {tuple(a[2].shape)}, planes "
        f"{tuple(a[3].shape)}; shadow rows "
        f"{tuple(c3_args['shadow_occlusion'][4].shape)}")
    errs = {}
    errs["primary_hit"] = compare_primary(
        torch, culled.primary_hit(*a), culled.primary_hit_plain(*a), "c3")[1]
    b = c3_args["shadow_occlusion"]
    errs["shadow_occlusion"] = compare_shadow(
        torch, culled.shadow_occlusion(*b),
        culled.shadow_occlusion_plain(*b), "c3")[1]
    s = c3_args["phong_fused"]
    errs["phong_fused"] = compare_shade(
        torch, shade.phong_fused(*s), shading.phong_core(*s), "c3")

    bscene, bcam = box_scene(torch, dev)
    bspec = suggest_cull_config(bscene, bcam, 256, 256, (16, 16))
    with Capture(culled, shade) as cap:
        render(bscene, bcam, 256, 256, cull=bspec)
    a, b, s = (cap.args[k] for k in wrappers)
    check(a[2].shape[1] > 0 and b[5].shape[2] > 0,
          "the box scene must reach the box paths")
    log(f"  box scene spec {bspec}")
    compare_primary(torch, culled.primary_hit(*a),
                    culled.primary_hit_plain(*a), "boxes")
    compare_shadow(torch, culled.shadow_occlusion(*b),
                   culled.shadow_occlusion_plain(*b), "boxes")
    compare_shade(torch, shade.phong_fused(*s), shading.phong_core(*s),
                  "boxes")

    # ---- 4. the main path
    log(f"[4/5] main path: render c3_grid64 {W}x{H}, depth 0, engine "
        f"culled_pallas, tile {TILE[0]}, {FRAMES} frames")
    kernels.LAUNCHES.clear()
    frames = [render(scene, cam, H, W, engine="culled_pallas", cull=spec,
                     shadow_lights=shadow_lights, with_cull_stats=True)
              for _ in range(FRAMES)]
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in wrappers}
    log(f"  launches over {FRAMES} frames: {launches}")
    check(all(n >= FRAMES for n in launches.values()),
          "every kernel must launch on every frame of the main path")
    ovfs = [int(ovf) for _, ovf in frames]
    log(f"  cull_overflow_events per frame: {ovfs}")
    check(all(o == 0 for o in ovfs), "cull overflow on the main path")
    img = frames[-1][0]
    check(tuple(img.shape) == (H, W, 3), f"image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "image has non-finite values")
    check(all(torch.equal(f[0], img) for f in frames), "frames differ")
    with PlainVersions(culled, shade, shading):
        img_plain = render(scene, cam, H, W, cull=spec,
                           shadow_lights=shadow_lights)
    diff = (img - img_plain).abs().amax(dim=-1)
    share = float((diff <= 1.0 / 255.0).float().mean())
    log(f"  image vs plain versions on the card: {share:.6f} of pixels "
        f"within 1/255, max diff {float(diff.max()):.3e}; mean "
        f"{float(img.mean()):.5f}")
    check(share >= 0.999, "image disagrees with the plain versions' image")
    # a small input against the CPU (the plain versions in PyTorch's CPU
    # kernels): rsqrt/exp/log round differently there, hence 1e-4
    sc, cc = sphere_grid_scene(8)
    small_spec = suggest_cull_config(sc, cc, 64, 64, (16, 16))
    small_cpu = render(sc, cc, 64, 64, cull=small_spec)
    small_gpu = render(scene, cam, 64, 64, cull=small_spec).cpu()
    small_err = float((small_cpu - small_gpu).abs().max())
    log(f"  64x64 render, card vs CPU: max diff {small_err:.3e}")
    check(small_err <= 1e-4, "small render disagrees with the CPU's")
    png = lib_path.parent / "c3_grid64.png"
    save_png(img, str(png))
    log(f"  wrote {png}")

    # ---- 5. timing
    log(f"[5/5] timing ({name}; {smi})")

    def frame():
        return render(scene, cam, H, W, cull=spec,
                      shadow_lights=shadow_lights, with_cull_stats=True)

    for _ in range(3):
        frame()
    torch.cuda.synchronize()
    windows, ovf_seen = [], []
    for _ in range(WINDOWS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.set_sync_debug_mode("error")
        try:
            start.record()
            for _ in range(WINDOW_FRAMES):
                ovf_seen.append(frame()[1])
            end.record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        end.synchronize()
        windows.append(start.elapsed_time(end) / WINDOW_FRAMES)
    check(int(torch.stack(ovf_seen).sum()) == 0, "overflow while timing")
    n_rays = rays_per_frame(H, W, scene.lights.count, 0,
                            shadow_lights=shadow_lights)
    med, best = statistics.median(windows), min(windows)
    # one frame at a time: its ~500 launches fit in the stream's queue of
    # pending launches, ten frames would not and the host would pace them
    frame_dev = statistics.median(device_ms(torch, frame, (), reps=1)
                                  for _ in range(5))
    log(f"  frame (raygen -> image), sync-free under "
        f"set_sync_debug_mode('error'): median {med:.4f} ms, min "
        f"{best:.4f} ms over {WINDOWS} windows of {WINDOW_FRAMES} "
        f"({[round(w, 4) for w in windows]}); {n_rays} rays/frame -> "
        f"{n_rays / (med / 1e3) / 1e6:.1f} Mrays/s median")
    log(f"  frame device time (one frame enqueued behind a spin kernel, "
        f"median of 5): {frame_dev:.4f} ms")

    plain_fns = {"primary_hit": culled.primary_hit_plain,
                 "shadow_occlusion": culled.shadow_occlusion_plain,
                 "phong_fused": shading.phong_core}
    sources = {"primary_hit": ("csrc/primary_hit.cu",
                               "openglraytracer_tpu/ops/pallas_culled.py:150"),
               "shadow_occlusion": (
                   "csrc/shadow_occlusion.cu",
                   "openglraytracer_tpu/ops/pallas_culled.py:351"),
               "phong_fused": ("csrc/phong_shade.cu",
                               "openglraytracer_tpu/ops/pallas_shade.py:45")}
    rows = []
    for k, fn in wrappers.items():
        args = c3_args[k]
        t_plain = [device_ms(torch, plain_fns[k], args)]
        t_kern = [device_ms(torch, fn, args), device_ms(torch, fn, args)]
        t_plain.append(device_ms(torch, plain_fns[k], args))
        ms, plain_ms = statistics.mean(t_kern), statistics.mean(t_plain)
        log(f"  {k}: kernel {ms:.4f} ms, plain version {plain_ms:.4f} ms "
            f"(device time per call at c3)")
        src, replaces = sources[k]
        rows.append({"name": k, "route": "cuda",
                     "source": f"openglraytracer_tpu_torch/{src}",
                     "replaces": replaces, "launches": launches[k],
                     "max_abs_err": errs[k], "ms": ms, "plain_ms": plain_ms})
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
