"""Ray-object pair tests a primary ray makes in kernel A: its tile's trip
counts (the sphere and box survivors the broad phase left it) times the
tile's rays, over the rays (program counters primary_trips and
narrow_tiles of the window's last frame or step:
benchmark/program_trace.py)."""

from benchmark import program_trace


def read(trace):
    return program_trace.tests_per_ray(trace, "primary_trips")
