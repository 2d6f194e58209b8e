"""lm_host_ms.decode: the host's time inside the program a decode request, in
ms: the median over the traced run's window of the ``repro_torch.lm.decode``
span's total (``serving.GreedyDecoder``'s root span: the copies into and out
of the capture's buffers and a graph replay a token), recorded with the
profiler off (``program_spans.recording``).  Logs a ``[program]`` line for
each span name.  A port without the span records nothing, and the metric is
left out of the line."""
from portbench.harness import log
from portbench.program_spans import recording

beside = recording
ROOT = "repro_torch.lm.decode"


def read(run):
    rec = run.samples.extra.get("lm_host_ms.decode")
    if rec is None:
        return None
    spans = rec.describe()["spans"]
    for span, s in spans.items():
        log(f"[program] {span}: total {s['total_ms_p50']:.4f} ms (mean {s['total_ms_mean']:.4f}), "
            f"self {s['self_ms_p50']:.4f} ms (mean {s['self_ms_mean']:.4f}), median of "
            f"{s['calls']} calls; {s['calls_per_request']:.3f} a request")
    root = spans.get(ROOT)
    return None if root is None else root["total_ms_p50"]
