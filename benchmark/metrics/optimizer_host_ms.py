"""Host ms a frame or step in the optimizer: the step's opt.zero_grad and
opt.step (program spans, their self time: benchmark/program_trace.py)."""

from benchmark import program_trace


def read(trace):
    return program_trace.host_ms(trace, "optimizer")
