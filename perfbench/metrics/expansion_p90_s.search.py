"""90th percentile of submit-to-candidates latency over every request
answered in the window, queue wait included (host clock). In this closed
loop above the service's capacity the queue is always full, so the tail is
the clients over the rate plus the waves' phase: it swings with the
smallest change, and it reads as a layer's metric, not an end-to-end one."""

from perfbench.stats import percentile


def read(w):
    lat = w.values.get("latencies_s")
    return percentile(lat, 90) if lat else None
