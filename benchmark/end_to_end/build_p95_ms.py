"""The 95th percentile of every build's latency in the window, host clock from
the call to its synchronise (nearest rank), in milliseconds."""
import math


def read(window):
    lat = sorted(window.latencies_s)
    return 1e3 * lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
