"""The program's own spans, read beside a run's window: the port's tracer
(``repro_torch.obs.trace.PROGRAM``) records every span the window's requests
open, and the readers of ``engine_host_ms.*`` read that recording.  A port
without the tracer records nothing, and the metric is left out of the line."""
from __future__ import annotations

import contextlib

from portbench.harness import log

ROOT = "repro_torch.service.score"      # the root span of a request
CAPTURE = "repro_torch.engine.capture"  # a first call at a signature


@contextlib.contextmanager
def recording(device):
    """The window inside a recording of the program's spans; yields the
    recording, or None where the port has no tracer."""
    try:
        from repro_torch.obs.trace import PROGRAM
    except ImportError:
        PROGRAM = None
    if PROGRAM is None:
        yield None
        return
    with PROGRAM.recording() as rec:
        yield rec


def root_ms(run, name: str):
    """The median over the window's requests of the root span's total ms, from
    the recording kept under ``name``; None where nothing was recorded.  Logs a
    ``[program]`` line for each span name and one for the window's counters."""
    rec = run.samples.extra.get(name)
    if rec is None:
        return None
    d = rec.describe()
    for span, s in d["spans"].items():
        log(f"[program] {span}: total {s['total_ms_p50']:.4f} ms (mean {s['total_ms_mean']:.4f}), "
            f"self {s['self_ms_p50']:.4f} ms (mean {s['self_ms_mean']:.4f}), median of "
            f"{s['calls']} calls; {s['calls_per_request']:.3f} a request")
    h2d = d["h2d_bytes"]
    captures = d["spans"].get(CAPTURE, {}).get("calls", 0)
    log(f"[program] window: {d['requests']} requests; bytes copied in from pinned "
        f"{h2d['pinned']}, pageable {h2d['pageable']}, device {h2d['device']}; "
        f"{captures} captures; {d['dropped']} spans dropped")
    root = d["spans"].get(ROOT)
    return None if root is None else root["total_ms_p50"]
