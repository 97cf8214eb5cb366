"""Host ms a frame or step in the shade layer: ops/accel.py
culled_material_rows and ops/shade.py phong_fused (kernel 4) (program
spans, their self time: benchmark/program_trace.py)."""

from benchmark import program_trace


def read(trace):
    return program_trace.host_ms(trace, "shade")
