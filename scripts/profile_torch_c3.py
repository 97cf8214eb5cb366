"""Where a c3_grid64 frame of the PyTorch/CUDA port spends its device time.

    python scripts/profile_torch_c3.py [--frames 5] [--out-dir DIR]

Renders c3_grid64 (1024x1024, depth 0, engine culled_pallas, 64x64 tiles)
on the GPU under torch.profiler and prints the device time by kernel name,
the frame's wall time between CUDA events, and the device's busy share of
it (the rest is the device waiting on the host's launches). With --out-dir
it also writes the Chrome trace there.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    from torch.profiler import ProfilerActivity, profile

    from openglraytracer_tpu_torch.models.builders import sphere_grid_scene
    from openglraytracer_tpu_torch.ops.accel import suggest_cull_config
    from openglraytracer_tpu_torch.ops.render import render
    from openglraytracer_tpu_torch.ops.shading import static_shadow_mask

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=5)
    p.add_argument("--out-dir", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")

    dev = torch.device("cuda", 0)
    scene, cam = sphere_grid_scene(8, device=dev)
    lights = static_shadow_mask(scene)
    spec = suggest_cull_config(scene, cam, 1024, 1024, (64, 64),
                               shadow_lights=lights)

    def frame():
        return render(scene, cam, 1024, 1024, cull=spec,
                      shadow_lights=lights)

    for _ in range(3):
        frame()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(args.frames):
            frame()
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end) / args.frames

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted(((e.device_time_total / 1e3 / args.frames, e.count
                    // args.frames, e.key) for e in events), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"{torch.cuda.get_device_name(0)}; spec {spec}")
    print(f"frame wall {wall_ms:.4f} ms (CUDA events, profiler on); device "
          f"busy {busy:.4f} ms = {100 * busy / wall_ms:.1f}%; "
          f"{sum(r[1] for r in rows)} kernel launches per frame")
    print(f"{'ms/frame':>10} {'calls':>6}  kernel")
    for ms, n, key in rows[:30]:
        print(f"{ms:10.4f} {n:6d}  {key[:100]}")
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        path = os.path.join(args.out_dir, "c3_frame_trace.json")
        prof.export_chrome_trace(path)
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
