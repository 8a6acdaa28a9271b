"""spmv_dispatch_us: host microseconds from a call of `spmv(p, v)` to its
return (not its completion), each call issued after a synchronize so that
no full queue blocks it; the median of the probe's calls."""

import statistics

MIN_CALLS = 200


def read(rec):
    times = rec.span("spmv_dispatch")
    if not times or len(times) < MIN_CALLS:
        return None
    return statistics.median(times) * 1e6
