"""Every cell of BENCHMARK.json resolves from its files by name, the file
keeps to the benchmark's contract, and a configuration, traffic mix and
metric added as new files are found without an edit to a file that is
there."""

import json
import re
import shutil
import sys
import time

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + CELLS
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] == "device_trace"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in {
            (v["config"], v["traffic"]) for v in BENCH["workloads"]
            if v is not w}
    for c in BENCH["configs"]:
        assert len(c["source"]) <= 200 and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves(workload):
    cell = harness.resolve(workload)
    assert cell.config["name"] == workload.split(".")[0]
    loop = cell.traffic["loop"]
    assert (harness.BENCH_DIR / "loops" / f"{loop}.py").exists()
    assert (harness.BENCH_DIR / "scenes"
            / f"{cell.config['scene']['recipe']}.py").exists()
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.end_to_end:
        if m["name"] != "setup_s":
            assert callable(harness.load_module(harness.reader_path(
                "end_to_end", m["name"])).read)
    for m in cell.per_layer:
        assert callable(harness.load_module(harness.reader_path(
            "metrics", m["name"])).read)
    for key, lim in cell.limits.items():
        assert lim["lower"] < lim["limit"] < lim["upper"], key


def test_config_files_match_benchmark():
    for c in BENCH["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert {"source", "assumed", "reduced", "why"} <= set(cfg)


def _copy_with_dummies(tmp_path):
    """A checkout's benchmark with a new configuration, traffic mix, layer
    and metric added as files, and BENCHMARK.json given their entries."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    bd = root / "benchmark"
    cfg = json.loads((bd / "configs" / "c3_grid64.json").read_text())
    cfg.update(name="dummy_grid", height=32, width=32, cull_tile=[16, 16])
    cfg["scene"]["side"] = 3
    (bd / "configs" / "dummy_grid.json").write_text(json.dumps(cfg))
    traffic = json.loads((bd / "traffic" / "render.json").read_text())
    traffic.update(check_frames=2, camera_jitter_px=0.5)
    (bd / "traffic" / "dummy_frames.json").write_text(json.dumps(traffic))
    (bd / "layers" / "dummy_layer.json").write_text(json.dumps(
        {"layer": "dummy", "functions": [
            "openglraytracer_tpu_torch.ops.raygen:generate_rays"]}))
    (bd / "metrics" / "dummy_ms.py").write_text(
        "def read(trace):\n    return trace.per_unit_ms('dummy_layer')\n")
    (bd / "limits" / "dummy_grid.dummy_frames.json").write_text(json.dumps(
        {"px_off": {"limit": 0.05, "lower": 0.0, "upper": 1.0}}))
    bench["configs"].append({"name": "dummy_grid", "source": "a test",
                             "file": "benchmark/configs/dummy_grid.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy_grid.dummy_frames",
                               "config": "dummy_grid",
                               "traffic": "dummy_frames", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("frame_ms", "frame_p95_ms"):
            m["workloads"].append("dummy_grid.dummy_frames")
    bench["per_layer"].append({"name": "dummy_ms", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "dummy", "moves": "frame_ms",
                               "workloads": ["dummy_grid.dummy_frames"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_new_files_are_found_without_edits(tmp_path):
    root = _copy_with_dummies(tmp_path)
    for path in harness.BENCH_DIR.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts \
                and "tests" not in path.parts:
            copy = root / "benchmark" / path.relative_to(harness.BENCH_DIR)
            assert copy.read_bytes() == path.read_bytes(), path
    copied = harness.load_module.__globals__["importlib"].util
    spec = copied.spec_from_file_location(
        "copied_harness", root / "benchmark" / "harness.py")
    h = copied.module_from_spec(spec)
    sys.modules["copied_harness"] = h       # a dataclass needs its module
    try:
        spec.loader.exec_module(h)
    finally:
        del sys.modules["copied_harness"]
    cell = h.resolve("dummy_grid.dummy_frames")
    assert cell.traffic["check_frames"] == 2
    assert [m["name"] for m in cell.per_layer] == ["dummy_ms"]
    assert h.reader_path("metrics", "dummy_ms").parent == root / \
        "benchmark" / "metrics"
    line = h.run_cell(cell, 3, 0.3, False, "cpu", time.monotonic())
    assert line["correct"] and line["attempted"] > 0
    assert set(line["metrics"]) == {"setup_s", "frame_ms", "frame_p95_ms"}
    line = h.run_cell(h.resolve("dummy_grid.dummy_frames"), 3, 0.3, True,
                      "cpu", time.monotonic())
    # the layer's spans fired; the CPU has no device time to give it
    assert line["metrics"]["dummy_ms"]["value"] == 0.0


def test_dotted_metric_falls_back_to_its_base_reader():
    assert harness.reader_path("metrics", "shade_ms.render").name == \
        "shade_ms.py"
    with pytest.raises(FileNotFoundError):
        harness.reader_path("metrics", "no_such_metric.render")
