"""idle_share.latency: the share of a request's time in which no kernel, copy or
memset runs on the device, in percent: one minus the device's busy time a
profiled request (``devtrace.Request.busy``, from the trace) over the mean
time a request of the same run's window took, which no profiler slowed.  The
profiler slows the host's launch calls far more than the device's work, so the
traced stretch's own idle share (the line's ``busy_s`` over ``window_s``) reads
higher than the program's."""


def read(run):
    if not run.trace or not run.completed:
        return None
    return 100.0 * (1.0 - run.trace.busy_per_request_s * run.completed / run.window_s)
