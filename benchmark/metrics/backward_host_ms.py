"""Host ms a frame or step in the backward: oglrt/backward/autograd around
the step's loss.backward() on the caller's thread (the spans inside it
on autograd's device thread are not added again) (program spans, their
self time: benchmark/program_trace.py)."""

from benchmark import program_trace


def read(trace):
    return program_trace.host_ms(trace, "backward")
