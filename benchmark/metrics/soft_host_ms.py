"""Host ms a step in the soft composite layer: the program's spans
oglrt/soft_composite/view (each view of train/inverse.py soft_loss) and
oglrt/soft_composite/block (a block's forward) less the broad phase's
spans inside them, on the caller's thread (program spans, their self time:
benchmark/program_trace.py). The recompute's spans run on autograd's
device thread and are not added."""

from benchmark import program_trace


def read(trace):
    return program_trace.host_ms(trace, "soft_composite")
