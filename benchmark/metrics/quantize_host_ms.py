"""Host ms a frame or step in the quantize: utils/image.py to_uint8_device
(program spans, their self time: benchmark/program_trace.py)."""

from benchmark import program_trace


def read(trace):
    return program_trace.host_ms(trace, "quantize")
