"""idle_share.bulk: the share of the traced stretch in which no kernel, copy or
memset runs on the device, in percent.  Both of its times are the profiled
requests' own, so they stand on one footing: one minus the device's busy time
over the requests kept (``devtrace.Trace.busy_s``: each request's kernels'
union plus its copies' union) over the same requests' spans on the host's
clock, each from its start to the next request's (``Trace.window_s``).  So it
lies in [0, 100], and equals one minus the line's ``busy_s`` over its
``window_s``.  The profiler slows the host's calls more than the device's
work, so it reads above the idle share of an unprofiled request; set against
an unprofiled request's time instead, the profiled busy time can exceed it
where the device is busy nearly all the time, as in bulk, and the share then
reads below zero."""


def read(run):
    tr = run.trace
    if not tr or not tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
