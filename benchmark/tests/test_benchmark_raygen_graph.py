"""metrics/raygen_graph_share.py on records made by hand: the share of a
unit's ray grids that replayed a graph, nothing from a program that keeps
no such counters; a tiny traced run on the CPU (eager rays) reads 0."""

import time
from types import SimpleNamespace

import pytest

from benchmark import harness, program_trace

READER = harness.load_module(harness.reader_path(
    "metrics", "raygen_graph_share.render"))


def _read(counters):
    trace = SimpleNamespace(units=2)
    program_trace._cache[:] = [trace, SimpleNamespace(counters=counters)]
    return READER.read(trace)


def test_the_share_of_the_last_unit():
    def c(unit, value):
        return SimpleNamespace(unit=unit, value=value)
    assert _read({"raygen_calls": c(4, 3),
                  "raygen_graph_replays": c(4, 3)}) == 1.0
    assert _read({"raygen_calls": c(4, 4),
                  "raygen_graph_replays": c(4, 1)}) == 0.25
    # replays of an older unit only: the last unit replayed none
    assert _read({"raygen_calls": c(4, 1),
                  "raygen_graph_replays": c(3, 1)}) == 0.0
    assert _read({"raygen_calls": c(4, 1)}) == 0.0


def test_no_counters_no_metric():
    assert _read({}) is None
    assert _read({"raygen_calls": SimpleNamespace(unit=0, value=0)}) is None
    program_trace._cache[:] = [None, None]


@pytest.mark.parametrize("workload", ["c3_grid64.render", "c3_grid64.train"])
def test_a_cpu_run_replays_no_graph(tiny_cell, workload):
    line = harness.run_cell(tiny_cell(workload), 2 ** 31 + 13, 0.3, True,
                            "cpu", time.monotonic())
    assert line["correct"]
    name = f"raygen_graph_share.{workload.split('.')[1]}"
    assert line["metrics"][name]["value"] == 0.0
