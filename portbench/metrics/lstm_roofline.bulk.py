"""lstm_roofline.bulk: the least time the card could score one request in, the
larger of the model's FLOPs at the float32 peak and its least bytes at the
memory's peak (``work/<family>.py``, ``peaks.py``), over the summed device time
of every compute kernel of a profiled request, in percent.  The count is the
model's work, not a kernel's, so it holds whatever kernels compute it."""
from portbench.peaks import bound_s


def read(run):
    if not run.trace:
        return None
    bound = bound_s(run.request_flops(), run.request_bytes(), run.device_kind)
    return 100.0 * bound / run.trace.kernel_s()
