"""The soft-fit cell (c5_grid4096_soft512.soft_fit) at a test's size on the
CPU: a sound run comes out correct, traced and not; each planted fault of
the soft step and the bfloat16 control come out not correct; the plain
soft reference's cull keeps what its dense scan needs; and the roofline
share reads at most 100 % on a synthetic trace whose device time is the
floor of the counted work."""

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import (control_soft, faults_soft, harness, program_trace,
                       soft_work, spans)
from benchmark.loops import soft_fit
from benchmark.reference import soft

CELL = "c5_grid4096_soft512.soft_fit"
SEED = 2 ** 31 + 21


@pytest.mark.parametrize("trace", [False, True])
def test_sound_soft_run_is_correct(tiny_cell, trace):
    cell = tiny_cell(CELL)
    line = harness.run_cell(cell, SEED, 0.3, trace, "cpu", time.monotonic())
    assert line["correct"], line["compared"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["compared"]) == set(cell.limits)
    if trace:
        got = line["metrics"]
        # the CPU has no device time: the program's own metrics only
        assert got["soft_kept_pairs_per_ray.soft_fit"]["value"] >= \
            got["soft_live_pairs_per_ray.soft_fit"]["value"] > 0
        assert got["soft_host_ms.soft_fit"]["value"] > 0
    else:
        assert set(line["metrics"]) == {"setup_s", "step_ms"}


@pytest.mark.parametrize("fault", sorted(faults_soft.FAULTS))
def test_soft_fault_is_caught(tiny_cell, fault):
    cell = tiny_cell(CELL)
    with faults_soft.FAULTS[fault](cell.traffic["loop"]):
        line = harness.run_cell(cell, SEED + 1, 0.3, False, "cpu",
                                time.monotonic())
    assert not line["correct"], line["compared"]


def test_soft_control_is_not_correct(tiny_cell):
    cell = tiny_cell(CELL)
    line = harness.run_cell(cell, SEED + 2, 0.3, False, "cpu",
                            time.monotonic(),
                            system=control_soft.SoftControl(cell.config,
                                                            "cpu"))
    assert not line["correct"], line["compared"]


def test_reference_cull_equals_dense(tiny_cell):
    cell = tiny_cell(CELL, side=5, size=48)
    recipe = harness.load_module(harness.BENCH_DIR / "scenes"
                                 / "sphere_grid.py")
    scene, cam = recipe.make(cell.config["scene"], SEED, "cpu")
    cam["aspect"] = torch.tensor(1.0)
    cams = soft_fit.views(cell, cam)
    s = cell.config["soft"]
    args = (scene, cams, 48, 48, s["bw"], s["gamma"], s["t_bg"])
    culled, dense = soft.render(*args), soft.render(*args, dense=True)
    assert float(culled.amax()) > 0.2
    torch.testing.assert_close(culled, dense, rtol=0.0, atol=1e-6)


def _synthetic(ms, live, rays, units=2):
    """A traced window's summary with the soft composite and backward
    layers' device time ``ms`` a step split in two, and the program's soft
    counters."""
    summary = spans.Summary(
        units, 1.0, 1.0,
        {"soft_composite": ms * units / 2, "backward": ms * units / 2},
        {"soft_composite": 10, "backward": 10}, {}, {}, {})
    counters = {"soft_live_pairs": SimpleNamespace(unit=1, value=live),
                "soft_rays": SimpleNamespace(unit=1, value=rays)}
    program_trace._cache[:] = [summary, SimpleNamespace(counters=counters)]
    return summary


def test_soft_roofline_reads_at_most_100_on_a_synthetic_trace():
    reader = harness.load_module(harness.reader_path(
        "metrics", "soft_roofline_pct.soft_fit"))
    live, rays = 2_500_000, 3 * 512 * 512
    floor = soft_work.ideal_ms(live, rays, lights=2, planes=1)
    assert floor > 0
    # a device at its peak on exactly the counted work: 100 %, not above
    assert reader.read(_synthetic(floor, live, rays)) == pytest.approx(100.0)
    assert reader.read(_synthetic(4 * floor, live, rays)) == \
        pytest.approx(25.0)
    # the counted work is a floor: a pair with every light costs more
    assert soft_work.pair_flops(2) > soft_work.pair_flops(1) > 0
    # no device time, or a program that keeps no soft counters: nothing
    assert reader.read(_synthetic(0.0, live, rays)) is None
    trace = _synthetic(floor, live, rays)
    program_trace._cache[1] = SimpleNamespace(counters={})
    assert reader.read(trace) is None
    program_trace._cache[:] = [None, None]


def test_a_program_without_a_block_size_is_refused_at_once(tiny_cell,
                                                          monkeypatch):
    """The configuration runs the culled soft forward in blocks of its
    block_pairs; a soft forward that takes no block size cannot run it,
    and the adapter says so before any set-up."""
    from openglraytracer_tpu_torch.ops import soft as soft_ops
    from benchmark import port_soft

    cell = tiny_cell(CELL)
    port_soft.SoftPort(cell.config, "cpu")

    def soft_render(scene, camera, height, width, *, bw=0.05, gamma=0.3,
                    cull=None, t_bg=200.0, with_cull_stats=False):
        raise AssertionError("not reached")

    monkeypatch.setattr(soft_ops, "soft_render", soft_render)
    with pytest.raises(RuntimeError, match="block size"):
        port_soft.SoftPort(cell.config, "cpu")
