"""Device ms of the soft composite layer (layers/soft_composite.json:
ops/soft.py _composite_block, its forward and its recompute in the
backward) per step: the operations launched while one of its spans was
the innermost open."""


def read(trace):
    return trace.per_unit_ms("soft_composite")
