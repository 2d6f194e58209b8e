"""mfu.decode: the model's FLOPs (``work/<family>.py``, counted in the
absorbed form of the latent attention) of every request answered in the
traced run's window, over the window's seconds times the card's bf16 peak
(dense, ``peaks.py``), in percent: the configuration computes in bf16."""
from portbench.peaks import peaks_of


def read(run):
    s, t = run.samples, run.traffic
    if not s.latencies_s:
        return None
    flops = run.work.request_flops(run.config, t.rows, t.seq_len, t.context)
    return 100.0 * flops * len(s.latencies_s) / s.window_s / peaks_of(run.device_kind)["bf16_flops"]
