"""Device ms of the narrow phase layer (layers/narrow_phase.json) per frame or
step: the operations launched while one of its spans was the innermost
open."""


def read(trace):
    return trace.per_unit_ms("narrow_phase")
