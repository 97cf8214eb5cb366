"""Ray-sphere pairs of a ray whose coverage is non-zero after the cut and
the front gate, counted in the forward only, over the rays of the views
(program counters soft_live_pairs and soft_rays of the window's last step:
benchmark/soft_work.py). Any correct implementation has the same count."""

from benchmark import soft_work


def read(trace):
    return soft_work.per_ray(trace, "soft_live_pairs")
