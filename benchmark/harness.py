"""The benchmark's harness: resolve a cell of BENCHMARK.json from its files,
set it up, measure its window, trace it, check what the window produced
against the plain reference, and report one JSON line.

Everything that belongs to one configuration, traffic mix, layer or
metric is a file of its own, found by the name BENCHMARK.json gives it:

  configs/<config>.json      sizes, engine, cull tile, scene recipe
  scenes/<recipe>.py         make(spec, seed, device, dtype) -> tensors
  traffic/<mix>.json         the mix's parameters; its "loop" names
  loops/<loop>.py            setup / window / release / check of a loop
  layers/<layer>.json        the program's functions a traced run spans
  end_to_end/<metric>.py     read(window) -> the metric, host clock
  metrics/<metric>.py        read(trace) -> a per-layer metric or None
                             (a dotted name falls back to the part before
                             its first dot)
  limits/<workload>.json     the limit of each number compared

The program under test is reached only through ``port.py``.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "openglraytracer_tpu")
# a traced window lasts at most this long: its per-layer numbers are per
# frame or step, and a longer trace only costs its reduction's time
TRACE_SECONDS = 10.0


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: dict
    end_to_end: list
    per_layer: list
    extra: dict = field(default_factory=dict)


def load_module(path: Path):
    """Import a file of the benchmark by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_file_" + "_".join(path.relative_to(BENCH_DIR).with_suffix(
            "").parts).replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reader_path(kind: str, name: str) -> Path:
    """``<kind>/<name>.py``, else ``<kind>/<the part before the first
    dot>.py``."""
    exact = BENCH_DIR / kind / f"{name}.py"
    if exact.exists():
        return exact
    base = BENCH_DIR / kind / f"{name.split('.')[0]}.py"
    if base.exists():
        return base
    raise FileNotFoundError(f"no reader {exact} (nor {base})")


def resolve(workload: str, bench: dict | None = None) -> Cell:
    """The cell ``workload`` of BENCHMARK.json with its files."""
    if bench is None:
        bench = _json(ROOT / "BENCHMARK.json")
    wl = {w["name"]: w for w in bench["workloads"]}
    if workload not in wl:
        raise KeyError(f"no workload '{workload}' in BENCHMARK.json; "
                       f"cells: {sorted(wl)}")
    w = wl[workload]
    cfgs = {c["name"]: c for c in bench["configs"]}
    config = _json(ROOT / cfgs[w["config"]]["file"])
    traffic = _json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits = _json(BENCH_DIR / "limits" / f"{workload}.json")

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Cell(workload, config, traffic, int(w["chips"]), limits, e2e,
                per_layer)


def check_modules() -> list:
    """Modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def compare(compared: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit; correct if none is above its limit
    (a number that is not finite, or missing, is above it)."""
    out, ok = {}, True
    for key, lim in limits.items():
        value = compared.get(key)
        good = value is not None and math.isfinite(value) and \
            value <= lim["limit"]
        ok = ok and good
        out[key] = {"value": value, "limit": lim["limit"]}
    return ok, out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, system=None) -> dict:
    """One run of the cell: set-up, the measured (or traced) window, the
    check. Returns the result line as a dict. ``system`` replaces the
    program (the lower-precision control); device 'cpu' runs the port's
    plain CPU path (tests)."""
    import torch

    from benchmark import port, spans as spans_mod

    cuda = torch.device(device).type == "cuda"
    if system is None:
        system = port.Port(cell.config, device)
    recipe = load_module(BENCH_DIR / "scenes"
                         / f"{cell.config['scene']['recipe']}.py")
    loop = load_module(BENCH_DIR / "loops" / f"{cell.traffic['loop']}.py")
    dtype = getattr(torch, cell.config["dtype"])

    marks = cell.extra["marks"] = []
    marks.append(("imports", time.monotonic()))
    spans = None
    if trace:
        spans = spans_mod.Spans(sorted((BENCH_DIR / "layers").glob("*.json")))
        spans.install()
    scene, camera = recipe.make(cell.config["scene"], seed, device, dtype)
    camera["aspect"] = torch.tensor(
        cell.config["width"] / cell.config["height"], dtype=dtype,
        device=device)
    marks.append(("scene", time.monotonic()))
    state = loop.setup(cell, seed, seconds, scene, camera, system)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.monotonic() - t_start
    marks.append(("warm-up", time.monotonic()))
    print("set-up s: " + ", ".join(
        f"{name} {t - t_prev:.3f}" for (name, t), t_prev in
        zip(marks, [t_start] + [t for _, t in marks[:-1]])), file=sys.stderr)

    prof = None
    if trace:
        prof = spans_mod.start_profiler(cuda)
    window = loop.window(cell, state,
                         min(seconds, TRACE_SECONDS) if trace else seconds,
                         spans)
    summary = None
    if trace:
        prof.stop()
        summary = spans_mod.reduce(prof, window["units"], spans)
        del prof
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if spans is not None:
        spans.uninstall()

    check_in = loop.release(cell, state, window)
    del state
    if cuda:
        torch.cuda.empty_cache()
    compared = loop.check(cell, scene, camera, check_in)
    correct, shown = compare(compared, cell.limits)

    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = load_module(reader_path("metrics", m["name"])).read(
                summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                continue
            value = load_module(reader_path("end_to_end", m["name"])).read(
                window)
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": (torch.cuda.get_device_name(0) if cuda else "cpu"),
           "count": cell.chips if cuda else 1,
           "memory_peak_bytes": int(memory_peak)}
    line = {"correct": bool(correct and window["failed"] == 0),
            "attempted": int(window["attempted"]),
            "failed": int(window["failed"]),
            "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        line["breakdown"] = summary.breakdown()
        line["trace_links"] = summary.links
    line["compared"] = shown
    return line
