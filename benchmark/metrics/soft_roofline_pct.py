"""Share of the soft step's floor time in its device time: max(bytes /
3.35 TB/s, float ops / 67 TFLOP/s) of the work any implementation must do
(benchmark/soft_work.py: the live pairs and the rays of the window's last
step, counted by the program, times fixed counts from the equations) over
the device ms a step of the soft composite and backward layers, in per
cent. None where the program keeps no soft counters or the layers ran
nothing on the device."""

import json
from pathlib import Path

from benchmark import soft_work

CONFIG = Path(__file__).resolve().parents[1] / "configs" / \
    "c5_grid4096_soft512.json"


def read(trace):
    got = soft_work.counters(trace, "soft_live_pairs", "soft_rays")
    composite = trace.per_unit_ms("soft_composite")
    backward = trace.per_unit_ms("backward")
    if got is None or composite is None or backward is None:
        return None
    ms = composite + backward
    if ms <= 0:
        return None
    scene = json.loads(CONFIG.read_text())["scene"]
    ideal = soft_work.ideal_ms(got[0], got[1], lights=len(scene["lights"]),
                               planes=1)
    return 100.0 * ideal / ms
