"""hbm_roofline.decode: the least bytes of a decode request (``work/<family>.py``:
the experts its steps route to, the shared experts, the attention, dense
and router weights, the head, and the latent cache of every position
attended to, each read once a step) at the memory's peak (``peaks.py``),
over a profiled request's device busy time (``devtrace.Request.busy``), in
percent.  The experts a step routes to are the run's own, as the window's
device counter read them (``experts_touched.decode``), where it did.  A
step is bound by memory: its FLOPs at the bf16 peak take a tenth of the
bytes' time."""
from portbench.peaks import peaks_of


def _experts(run):
    box = run.samples.extra.get("experts_touched.decode")
    if not box or box.get("start") is None or box.get("end") is None:
        return None
    distinct, routings = (e - s for e, s in zip(box["end"], box["start"]))
    return distinct / routings if routings else None


def read(run):
    if not run.trace:
        return None
    t = run.traffic
    nbytes = run.work.request_bytes(run.config, t.rows, t.seq_len, t.context, _experts(run))
    return 100.0 * nbytes / peaks_of(run.device_kind)["hbm_bytes"] / run.trace.busy_per_request_s
