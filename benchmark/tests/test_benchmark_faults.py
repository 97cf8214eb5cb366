"""A run with the timed path broken underneath comes out not correct: the
harness is driven as a run drives it (the look for a chip skipped, the
program's plain CPU path at a test's size, the cell's own limits), once
for each fault the cell can have, and once with the lower-precision
control in the program's place."""

import time

import pytest

from benchmark import control, faults, harness

CASES = [(w, f) for w in ("c3_grid64.render", "c5_grid4096.render",
                          "c3_grid64.train", "c5_grid4096.train")
         for f in faults.LOOP_FAULTS[w.split(".")[1]]]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_caught(tiny_cell, workload, fault):
    cell = tiny_cell(workload)
    with faults.FAULTS[fault](cell.traffic["loop"]):
        line = harness.run_cell(cell, 2 ** 31 + 9, 0.3, False, "cpu",
                                time.monotonic())
    assert not line["correct"], line["compared"]


@pytest.mark.parametrize("workload", [w for w, _ in CASES[::2]])
def test_control_is_not_correct(tiny_cell, workload):
    cell = tiny_cell(workload)
    line = harness.run_cell(cell, 2 ** 31 + 10, 0.3, False, "cpu",
                            time.monotonic(),
                            system=control.Control(cell.config, "cpu"))
    assert not line["correct"], line["compared"]


@pytest.mark.parametrize("workload", [w for w, _ in CASES[::2]])
def test_sound_run_at_test_size(tiny_cell, workload):
    """The same drive with nothing broken: it runs, fails no frame or step
    and reports every number compared."""
    cell = tiny_cell(workload)
    line = harness.run_cell(cell, 2 ** 31 + 11, 0.3, False, "cpu",
                            time.monotonic())
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["compared"]) == set(cell.limits)
    assert list(line)[-1] == "compared"
