"""Device ms of the shade layer (layers/shade.json) per frame or
step: the operations launched while one of its spans was the innermost
open."""


def read(trace):
    return trace.per_unit_ms("shade")
