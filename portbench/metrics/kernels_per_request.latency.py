"""kernels_per_request.latency: the median count of device kernels of a profiled
request, copies and memsets left out: the length of the chain the schedule issues."""


def read(run):
    return run.trace.kernels() if run.trace else None
