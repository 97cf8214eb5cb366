"""Loop 'render': a renderer or viewer asking for frames one at a time.

A closed loop, one client, one frame in flight. Each frame renders the
scene through the program's entry point, quantizes it to 8 bits on the
device, copies the bytes to pinned host memory and waits for them; its
latency runs from the start of its enqueue until its image is on the
host. Each frame's camera position is the configuration's plus a seeded
offset of at most ``camera_jitter_px`` pixels' footprint at the scene's
center, so no two frames share inputs; the cull spec sized at set-up on
the configuration's camera serves every frame. A frame whose cull
overflowed (objects dropped) counts as failed.

The check keeps ``check_frames`` frames of the window, drawn from the seed
by reservoir sampling (their pinned buffers are kept, nothing is copied),
and holds each against the reference's image of the same camera.
"""

from __future__ import annotations

import contextlib
import math
import random
import sys
import time

import torch

from benchmark.reference import tracer


def _jitter(camera: dict, cell, seed: int, count: int):
    """(count, 3) camera positions: the configuration's plus offsets
    uniform in a ball of camera_jitter_px pixels' footprint at the scene's
    center (the origin)."""
    cfg, traffic = cell.config, cell.traffic
    pos = camera["position"]
    dist = float(torch.linalg.vector_norm(pos.double()))
    pixel = 2.0 * dist * math.tan(math.radians(float(camera["v_fov"])) / 2) \
        / cfg["height"]
    radius = float(traffic["camera_jitter_px"]) * pixel
    g = torch.Generator(device=pos.device)
    g.manual_seed((int(seed) * 2 + 1) % (1 << 63))
    v = torch.randn((count, 3), generator=g, device=pos.device,
                    dtype=torch.float64)
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    u = torch.rand((count, 1), generator=g, device=pos.device,
                   dtype=torch.float64) ** (1.0 / 3.0)
    return (pos.double() + radius * u * v).to(pos.dtype)


def setup(cell, seed, seconds, scene, camera, system):
    traffic = cell.traffic
    h, w = cell.config["height"], cell.config["width"]
    cuda = scene["center"].device.type == "cuda"
    max_frames = int(math.ceil(seconds * traffic["max_frames_per_s"])) + 1
    positions = _jitter(camera, cell, seed, max_frames)
    p_scene = system.scene(scene)
    p_cam = system.camera(camera)
    lights = system.shadow_lights(p_scene)
    spec = system.cull_spec(p_scene, p_cam, lights)
    cell.extra["marks"].append(("cull spec", time.monotonic()))
    n_keep = int(traffic["check_frames"])
    buffers = [torch.empty((h, w, 3), dtype=torch.uint8, pin_memory=cuda)
               for _ in range(n_keep + 1)]
    ovf_host = torch.zeros((max_frames,), dtype=torch.int32, pin_memory=cuda)
    state = dict(system=system, scene=p_scene, camera=camera,
                 positions=positions, spec=spec, lights=lights,
                 buffers=buffers, ovf_host=ovf_host, seed=seed, cuda=cuda)
    for i in range(int(traffic["warmup_frames"])):
        _frame(state, max_frames - 1 - i, buffers[-1], spans=None)
    return state


def _frame(state, i, buf, spans):
    """Render frame i into buf (host); returns when its bytes are there."""
    system = state["system"]
    cam = system.camera(state["camera"], state["positions"][i])
    with _span(spans, "bench/frame/render"):
        img, ovf = system.render(state["scene"], cam, state["spec"],
                                 state["lights"])
    with _span(spans, "bench/frame/to_host"):
        u8 = system.to_uint8(img)
        buf.copy_(u8, non_blocking=True)
        state["ovf_host"][i].copy_(ovf, non_blocking=True)
        if state["cuda"]:
            torch.cuda.current_stream().synchronize()


def _span(spans, name):
    return spans.span(name) if spans is not None else contextlib.nullcontext()


def window(cell, state, seconds, spans):
    """Frames back to back for ``seconds``; every frame started before the
    deadline is completed and counted."""
    rng = random.Random(int(state["seed"]) * 7919 + 17)
    bufs = state["buffers"]
    n_keep = len(bufs) - 1
    current = bufs[-1]
    kept = []                                  # [(frame index, buffer)]
    spare = list(bufs[:-1])
    latencies = []
    limit = state["positions"].shape[0] - 1 - int(
        cell.traffic["warmup_frames"])
    with _span(spans, "bench/window"):
        t_start = time.perf_counter()
        deadline = t_start + seconds
        i = 0
        while True:
            t0 = time.perf_counter()
            if t0 >= deadline or i >= limit:
                break
            with _span(spans, "bench/unit"):
                _frame(state, i, current, spans)
            t1 = time.perf_counter()
            latencies.append(t1 - t0)
            # reservoir sample of the frames (Algorithm R): swap buffers
            if i < n_keep:
                kept.append((i, current))
                current = spare.pop()
            else:
                j = rng.randrange(i + 1)
                if j < n_keep:
                    kept[j], current = (i, current), kept[j][1]
            i += 1
        t_end = time.perf_counter()
    if i >= limit:
        raise RuntimeError(f"the window ran out of its {limit} seeded "
                           "cameras: raise traffic max_frames_per_s")
    q = max(1, i // 4)
    quarters = [sorted(latencies[k:k + q]) for k in range(0, q * 4, q)]
    print("frame latency ms, median of each quarter of the window: "
          + ", ".join(f"{1e3 * x[len(x) // 2]:.3f}" for x in quarters if x),
          file=sys.stderr)
    ovf = state["ovf_host"][:i]
    failed = int((ovf > 0).sum())
    return dict(units=i, attempted=i, failed=failed,
                seconds=t_end - t_start, latencies=latencies, kept=kept,
                start=t_start)


def release(cell, state, window):
    """What the check needs: the kept frames' bytes and cameras (positions
    moved to the host: the program's state is freed after this)."""
    return dict(kept=[(i, buf, state["positions"][i].clone())
                      for i, buf in window["kept"]])


def check(cell, scene, camera, data):
    """Share of pixels with a channel more than one code value from the
    reference's, the largest over the kept frames."""
    h, w = cell.config["height"], cell.config["width"]
    dtype = getattr(torch, cell.config["dtype"])
    worst = 0.0
    for _, buf, pos in data["kept"]:
        cam = dict(camera, position=pos)
        ref = tracer.to_uint8(tracer.render(scene, cam, h, w, dtype))
        got = buf.to(ref.device).int()
        off = (got - ref.int()).abs().amax(-1) > 1
        worst = max(worst, float(off.float().mean()))
    if not data["kept"]:
        return {}
    return {"px_off": worst}
