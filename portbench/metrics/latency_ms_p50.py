"""latency_ms_p50: the median over every request of the window, from the call
to its scores on the host."""
from portbench.stats import percentile


def read(run):
    return percentile(run.samples.latencies_s, 50) * 1e3 if run.samples.latencies_s else None
