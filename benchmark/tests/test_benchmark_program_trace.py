"""The per-layer metrics read from the program's own spans and counters
(program_trace.py): a tiny traced run of each traffic mix prints each of
them as a finite number and an untraced run prints none; self time is
each span's duration less its children's, on the entry's threads; a
program that keeps no record gives no metric."""

import math
import time
from types import SimpleNamespace

import pytest

from benchmark import harness, program_trace

PROGRAM = {m["name"] for m in harness._json(harness.ROOT / "BENCHMARK.json")[
    "per_layer"] if m["source"] in ("program_span", "program_counter")}


@pytest.mark.parametrize("workload", ["c3_grid64.render", "c3_grid64.train"])
def test_traced_run_prints_each_program_metric(tiny_cell, workload):
    cell = tiny_cell(workload)
    want = {m["name"] for m in cell.per_layer} & PROGRAM
    assert len(want) == (9 if workload.endswith("render") else 10)
    line = harness.run_cell(cell, 2 ** 31 + 11, 0.4, True, "cpu",
                            time.monotonic())
    assert line["correct"]
    got = {k: v["value"] for k, v in line["metrics"].items() if k in PROGRAM}
    assert set(got) == want
    assert all(math.isfinite(v) and v >= 0 for v in got.values()), got
    assert got[f"primary_tests_per_ray.{workload.split('.')[1]}"] > 0
    line = harness.run_cell(tiny_cell(workload), 2 ** 31 + 11, 0.3, False,
                            "cpu", time.monotonic())
    assert not set(line["metrics"]) & PROGRAM


def _span(layer, start, end, parent=None, thread=1, unit=0):
    return SimpleNamespace(layer=layer, name=layer, start_ns=start,
                           end_ns=end, parent=parent, unit=unit,
                           thread=thread)


def test_self_time_on_the_entry_threads():
    spans = [_span("entry", 0, 100),                    # 0
             _span("raygen", 5, 15, 0),                  # 1
             _span("narrow_phase", 20, 80, 0),           # 2
             _span("broad_phase", 25, 35, 2),            # 3
             _span("narrow_phase", 40, 50, 2),           # 4: same layer
             _span("entry", 55, 60, 2),                  # 5: nested entry
             _span("backward", 85, 95, 0),               # 6
             _span("backward", 86, 94, None, thread=2),  # 7: other thread
             _span("quantize", 110, 112)]                # 8: after entry
    prog = program_trace.Program(spans, {})
    assert dict(prog.self_ns) == {"entry": 100 - 10 - 60 - 10 + 5,
                                  "raygen": 10, "narrow_phase": 60 - 10 - 5,
                                  "broad_phase": 10, "backward": 10,
                                  "quantize": 2}
    assert prog.enqueue_ns == 100
    trace = SimpleNamespace(units=2)
    program_trace._cache[:] = [trace, prog]
    assert program_trace.host_ms(trace, "narrow_phase") == 45 / 1e6 / 2
    assert program_trace.host_ms(trace, "optimizer") is None
    assert program_trace.enqueue_ms(trace) == 100 / 1e6 / 2
    tiles = SimpleNamespace(unit=3, value=4)
    prog.counters = {"narrow_tiles": tiles,
                     "primary_trips": SimpleNamespace(unit=3, value=10),
                     "shadow_trips": SimpleNamespace(unit=2, value=10)}
    assert program_trace.tests_per_ray(trace, "primary_trips") == 2.5
    assert program_trace.tests_per_ray(trace, "shadow_trips") is None


def test_a_program_without_a_record_gives_no_metric(monkeypatch):
    from openglraytracer_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "record")
    trace = SimpleNamespace(units=3)
    assert program_trace.read(trace) is None
    assert program_trace.host_ms(trace, "raygen") is None
    assert program_trace.tests_per_ray(trace, "primary_trips") is None
