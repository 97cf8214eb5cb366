"""The command as a benchmark run starts it: without a card it exits
non-zero and prints no result; on the card (marked ``cuda``) it prints
one line with the contract's keys."""

import json
import subprocess
import sys

import pytest

from benchmark import harness

CMD = [sys.executable, "benchmark/run.py", "--workload", "c3_grid64.render",
       "--seed", str(2 ** 31 + 5), "--seconds", "1"]


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(CMD + ["--trace", "0"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark."""
    import shutil
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(CMD + ["--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_on_the_card(trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(CMD + ["--trace", str(trace)], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["device"]["platform"] == "gpu" and line["correct"]
