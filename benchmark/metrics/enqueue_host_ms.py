"""Host ms a frame or step inside the program's outermost entry spans
(oglrt/entry/render of a frame, oglrt/entry/step of a step): the whole
host time of its enqueue (benchmark/program_trace.py)."""

from benchmark import program_trace


def read(trace):
    return program_trace.enqueue_ms(trace)
