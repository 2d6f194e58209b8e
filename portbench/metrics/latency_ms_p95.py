"""latency_ms_p95: the 95th percentile over every request of the window, from
the call to its scores on the host."""
from portbench.stats import percentile


def read(run):
    return percentile(run.samples.latencies_s, 95) * 1e3 if run.samples.latencies_s else None
