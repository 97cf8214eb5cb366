"""The benchmark's own tests, on the CPU at a test's size (run from the
repository's root: python -m pytest benchmark/tests). Tests that need the
card are marked ``cuda`` and skip here."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny(workload: str, side: int = 4, size: int = 64, tile: int = 16):
    """The cell of BENCHMARK.json with its scene and image cut to a test's
    size (its limits, traffic and recipe as they are)."""
    from benchmark import harness
    cell = harness.resolve(workload)
    cfg = copy.deepcopy(cell.config)
    cfg["scene"]["side"] = side
    cfg["height"] = cfg["width"] = size
    cfg["cull_tile"] = [tile, tile]
    cell.config = cfg
    return cell


@pytest.fixture
def tiny_cell():
    return tiny
