"""request_p95_ms.<suffix> (ms, lower is better; host clock; the request
as its client feels it): the 95th percentile, nearest rank, over every call of
the window, each timed from its start to the return of its frame. A call
that failed or never returned counts as missing every limit, so it sorts
above all others; where more than 5% are missing there is no such
percentile."""

import math


def read(run):
    lat = sorted(c.end - c.start if c.end is not None else math.inf
                 for c in run.window.calls)
    if not lat:
        return None
    p95 = lat[math.ceil(0.95 * len(lat)) - 1]
    return 1e3 * p95 if math.isfinite(p95) else None
