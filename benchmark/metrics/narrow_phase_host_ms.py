"""Host ms a frame or step in the narrow phase: ops/culled.py
culled_geometry less its broad-phase spans (the row packing, kernel A,
kernel B and the glue between them) (program spans, their self time:
benchmark/program_trace.py)."""

from benchmark import program_trace


def read(trace):
    return program_trace.host_ms(trace, "narrow_phase")
