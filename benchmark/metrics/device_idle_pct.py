"""Share of the traced window in which no operation ran on the device
(the union of its kernels', copies' and sets' intervals)."""


def read(trace):
    return trace.idle_pct()
