"""Device ms of the backward layer (layers/backward.json) per frame or
step: the operations launched while one of its spans was the innermost
open."""


def read(trace):
    return trace.per_unit_ms("backward")
