"""Ray-sphere pairs the soft broad phase keeps for a ray: valid survivor
slots times their tile's rays, summed over the views, over the rays of
the views (program counters soft_kept_pairs and soft_rays of the window's
last step: benchmark/soft_work.py)."""

from benchmark import soft_work


def read(trace):
    return soft_work.per_ray(trace, "soft_kept_pairs")
