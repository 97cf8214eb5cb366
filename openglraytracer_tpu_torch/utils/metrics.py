"""Structured metrics/logging + render timing.

Port of ``openglraytracer_tpu/utils/metrics.py``: JSONL metric records, a
device timer and the per-frame ray count. Times come from CUDA events only;
timing without a CUDA device raises rather than reading a host clock.
"""

from __future__ import annotations

import json
import sys
import time

import torch


class MetricsLogger:
    """Emit one JSON object per event to stderr (and optionally a file)."""

    def __init__(self, name: str, path: str | None = None):
        self.name = name
        self.path = path

    def log(self, **kv):
        line = json.dumps({"name": self.name, "t": time.time(), **kv})
        print(line, file=sys.stderr)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")


def time_fn(fn, *args, warmup: int = 2, iters: int = 5) -> float:
    """Median seconds of fn(*args) on the current CUDA device, each call
    bracketed by CUDA events after a torch.cuda.synchronize()."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_fn times with CUDA events and needs a CUDA "
                           "device")
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    times.sort()
    return times[len(times) // 2]


def rays_per_frame(height: int, width: int, n_lights: int, depth: int = 0,
                   mirror_only: bool = False,
                   shadow_lights: tuple | None = None,
                   bounce_mask: tuple | None = None):
    """Primary + shadow ray count per frame, matching what the renderer
    casts: 2^(depth+1) - 1 casts per pixel for the full bounce tree
    (depth + 1 for a single live branch or mirror_only, 1 with none), and
    one shadow segment per cast per shadow-casting light."""
    if mirror_only:
        casts = depth + 1
    elif bounce_mask is not None and not all(bounce_mask):
        casts = (depth + 1) if any(bounce_mask) else 1
    else:
        casts = 2 ** (depth + 1) - 1
    casting = (sum(map(bool, shadow_lights)) if shadow_lights is not None
               else n_lights)
    return height * width * casts * (1 + casting)
