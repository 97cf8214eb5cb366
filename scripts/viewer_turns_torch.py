"""The live viewer's frame rate for two trees of the port, in turns, on one
CUDA card.

Drives ``FrameStreamer`` (the producer behind ``cli view``) at the CLI's
1280x720 with 8x8 cull tiles on ``culled_pallas`` and on ``pallas``, for
each tree in the order parent, change, change, parent, each turn in a
process of its own (both trees hold a package of the same name). Each turn
reports, per engine: the frames a second over the frames after the first
WARM (kernel builds and sizing left out), the streamer's last-2-s FPS, the
encode ms a frame in a worker, the dispatch loop's host ms a frame (best
of 5 calls of ``FrameStreamer.frame``, which enqueues the scene build, the
render and the frame's packing) and the ms to the end of that frame's
device work (best of 5, synchronised), the cull rebuilds, and the card's
name and power limit. Then, in the same process, ``frame`` of one t on
each transport the tree offers ('rgb', and 'yuv420' where it is ported),
the transports alternated REPS times, each call after a synchronise: the
median host ms to return and ms to the end of its device work, which
isolates what the transport's packing adds to the dispatch loop. One JSON
object a turn goes to stdout and all of them to --out.

    python scripts/viewer_turns_torch.py --parent OLD_ROOT [--change ROOT]
        [--cycles 5]

--cycles repeats parent, change, change, parent (2 pairs a cycle).

A root is the directory that holds ``openglraytracer_tpu_torch/``;
--change defaults to this checkout.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from statistics import median

HW, TILE = (720, 1280), 8
ENGINES = ("culled_pallas", "pallas")
WARM, REPS = 30, 10


def _best_ms(fn, reps: int = 5) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def _transport_ms(torch, FrameStreamer, engine: str, t: float) -> dict:
    """Median host ms to return and ms to the end of the device work of
    frame(t) on each transport the tree offers, alternated REPS times."""
    h, w = HW
    streamers = {}
    for transport in ("rgb", "yuv420"):
        try:
            s = FrameStreamer(h, w, engine=engine, cull_tile=TILE,
                              transport=transport, device="cuda")
        except ValueError:          # a tree without the transport
            continue
        s._render_setup()
        streamers[transport] = s
    times = {k: ([], []) for k in streamers}
    with torch.no_grad():
        for k, s in streamers.items():      # warm each once
            s.frame(t)
        for _ in range(REPS):
            for k, s in streamers.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s.frame(t)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                times[k][0].append((t1 - t0) * 1e3)
                times[k][1].append((t2 - t0) * 1e3)
    return {k: {"host_ms": median(a), "done_ms": median(b)}
            for k, (a, b) in times.items()}


def one_turn(root: str, frames: int) -> dict:
    """Drive the viewer of the tree at root on both engines."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from openglraytracer_tpu_torch.utils.viewer import FrameStreamer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"root": root, "card": smi, "engines": {}}
    h, w = HW
    for engine in ENGINES:
        s = FrameStreamer(h, w, engine=engine, cull_tile=TILE,
                          max_frames=frames, device="cuda").start()
        try:
            last = 0
            while last < WARM and not s.done:
                last, _ = s.wait_frame(last, timeout=900)
            t0, f0 = time.perf_counter(), s.frame_no
            while not s.done:
                s.wait_frame(s.frame_no, timeout=120)
            t1, f1 = time.perf_counter(), s.frame_no
        finally:
            s.stop()
        if s.error is not None or f1 != frames:
            raise RuntimeError(f"{engine}: {f1} of {frames} frames, "
                               f"error {s.error!r}")
        _, encoded, t = s.latest()

        def synced():
            s.frame(t)
            torch.cuda.synchronize()
        with torch.no_grad():
            enq = _best_ms(lambda: s.frame(t))
            torch.cuda.synchronize()
            done = _best_ms(synced)
        out["engines"][engine] = {
            "transport": s.transport,
            "format": "jpeg" if encoded[:2] == b"\xff\xd8" else "png",
            "fps_after_warm": (f1 - f0) / (t1 - t0),
            "frames_after_warm": f1 - f0,
            "fps_last_2s": s.fps,
            "encode_ms": 1e3 * s.encode_s / s.frame_no,
            "dispatch_host_ms": enq,
            "frame_done_ms": done,
            "rebuilds": s.rebuilds,
            "frame_by_transport": _transport_ms(torch, FrameStreamer,
                                                engine, t),
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of the parent tree")
    ap.add_argument("--change", default=str(Path(__file__).resolve()
                                            .parents[1]),
                    help="root of the changed tree (default: this checkout)")
    ap.add_argument("--frames", type=int, default=210,
                    help="frames a streamer publishes (the first 30 warm)")
    ap.add_argument("--cycles", type=int, default=1,
                    help="rounds of parent, change, change, parent")
    ap.add_argument("--out", default="chiprun_out/viewer_turns.json")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.one:
        print(json.dumps(one_turn(a.one, a.frames)), flush=True)
        return 0
    if not a.parent:
        ap.error("--parent is required")
    turns = []
    order = (("parent", a.parent), ("change", a.change),
             ("change", a.change), ("parent", a.parent))
    for side, root in order * a.cycles:
        proc = subprocess.run([sys.executable, __file__, "--one", root,
                               "--frames", str(a.frames)],
                              capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stdout + proc.stderr)
            return proc.returncode
        turn = json.loads(proc.stdout.strip().splitlines()[-1])
        turn["side"] = side
        print(json.dumps(turn), flush=True)
        turns.append(turn)
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(turns, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
