"""The 95th percentile of every frame's latency in the window, from the
start of its enqueue until its image is on the host (host clock;
statistics.quantiles, inclusive)."""

import statistics


def read(window):
    lat = window["latencies"]
    if len(lat) == 1:
        return 1e3 * lat[0]
    return 1e3 * statistics.quantiles(lat, n=100, method="inclusive")[94]
