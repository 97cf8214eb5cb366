"""Device ms of the broad phase layer (layers/broad_phase.json) per frame or
step: the operations launched while one of its spans was the innermost
open."""


def read(trace):
    return trace.per_unit_ms("broad_phase")
