"""host_calls.latency: the median count of a profiled request's calls that put work on a stream
(kernel and graph launches, memcpys, memsets; ``devtrace.LAUNCH_CALLS``), from
the trace's host events."""


def read(run):
    return run.trace.calls() if run.trace else None
