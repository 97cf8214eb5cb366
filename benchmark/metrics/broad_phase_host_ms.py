"""Host ms a frame or step in the broad phase: the tile cones, the survivor
compactions and the shadow cones, spanned at their call sites in
ops/culled.py culled_geometry (program spans, their self time:
benchmark/program_trace.py)."""

from benchmark import program_trace


def read(trace):
    return program_trace.host_ms(trace, "broad_phase")
