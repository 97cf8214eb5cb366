"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is a workload of BENCHMARK.json (its configuration, traffic mix
and files under benchmark/). With --trace 0 the line holds the cell's
end-to-end metrics, with --trace 1 its per-layer metrics from a profiled
window. The numbers compared with the plain reference are printed beside
their limits as the last lines of standard error and under "compared",
the last key of the line, which is the last line of standard output.
Exits 2 without a result when no CUDA device (or too few) is present, 3
when a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every build and kernel cache inside the checkout, at fixed paths
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))

    from benchmark import harness

    cell = harness.resolve(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {cell.chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    line = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            "cuda", T_START)
    found = harness.check_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    for key, v in line["compared"].items():
        print(f"compared {key} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT      # import the benchmark and the program from here
    sys.exit(main())
