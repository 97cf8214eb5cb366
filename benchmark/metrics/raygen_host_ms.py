"""Host ms a frame or step in the raygen layer: the camera rays
(ops/raygen.py generate_rays with camera_matrices' inv4) and the tile
order and untile of ops/render.py (program spans, their self time:
benchmark/program_trace.py)."""

from benchmark import program_trace


def read(trace):
    return program_trace.host_ms(trace, "raygen")
