"""Readings from which the limits of a soft-fit cell are set
(``limits/<cell>.json``), on the chip, several seeds in one process, as
``calibrate.py`` takes them for the hard cells:

    python3 benchmark/calibrate_soft.py --workload <cell> --seeds 1,2,3 \
        --seconds 2 [--control] [--fault view_left_out|unchanged_state]

Prints one JSON line a seed: the numbers compared, whether the run came
out correct against the current limits, its window's attempted and failed
counts, each view's soft cull spec. Plain runs give the lower readings;
``--control`` puts the plain soft reference computed in bfloat16 in the
program's place (control_soft.py) and ``--fault`` plants a fault of the
soft step underneath the timed path (faults_soft.py); both give upper
readings. The benchmark's own runs run neither.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)

    import torch

    from benchmark import control_soft, faults_soft, harness
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.resolve(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        system = control_soft.SoftControl(cell.config, "cuda") \
            if args.control else None
        plant = (faults_soft.FAULTS[args.fault](cell.traffic["loop"])
                 if args.fault else contextlib.nullcontext())
        with plant:
            line = harness.run_cell(cell, seed, args.seconds, False, "cuda",
                                    t0, system=system)
        print(json.dumps({
            "workload": cell.name, "seed": seed,
            "what": ("control" if args.control else
                     f"fault {args.fault}" if args.fault else "program"),
            "compared": {k: v["value"] for k, v in line["compared"].items()},
            "correct": line["correct"], "attempted": line["attempted"],
            "failed": line["failed"],
            "specs": [list(s) if s is not None else None
                      for s in cell.extra.pop("soft_specs", [])],
            "detail": cell.extra.pop("detail", None),
            "step_ms": line["metrics"].get("step_ms", {}).get("value"),
            "memory_peak_bytes": line["device"]["memory_peak_bytes"],
            "seconds": time.monotonic() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())
