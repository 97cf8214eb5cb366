"""Ray-object pair tests a primary ray's shadow rays make in kernel B,
summed over the lights: its tile's trip counts (a hot tile's over the
whole sphere table) times the tile's rays, over the rays (program
counters shadow_trips and narrow_tiles of the window's last frame or
step: benchmark/program_trace.py)."""

from benchmark import program_trace


def read(trace):
    return program_trace.tests_per_ray(trace, "shadow_trips")
