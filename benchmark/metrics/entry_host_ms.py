"""Host ms a frame or step in the entry layer itself: the glue of render
and step_fn that no other layer's span claims (program spans, their self
time: benchmark/program_trace.py)."""

from benchmark import program_trace


def read(trace):
    return program_trace.host_ms(trace, "entry")
