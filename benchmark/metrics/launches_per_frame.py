"""Device operations (kernels, copies, sets) launched inside the entry
layer's spans, per frame or step of the traced window."""


def read(trace):
    return trace.per_unit_launches("entry")
