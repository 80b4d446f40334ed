"""``frame_p95_ms``: the 95th percentile (nearest rank) of the latency of
every interactive request of the window, host clock from the request's
start to its image on the host.  A failed request counts as missing it (an
infinite latency); a percentile that falls on one is not reported."""

import math


def read(run):
    lat = sorted(run.latencies_s)
    if not lat:
        return None
    p95 = lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
    return 1e3 * p95 if math.isfinite(p95) else None
