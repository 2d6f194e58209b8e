"""mfu.bulk: the model's FLOPs of every request answered in the traced run's
window, over the window's seconds times the card's float32 peak, in percent.
The configurations are float32 and the port's kernels keep TF32 off, so the
float32 peak is the one that applies."""
from portbench.peaks import peaks_of


def read(run):
    s = run.samples
    if not s.timesteps:
        return None
    rate = s.timesteps * run.work.flops_per_row_timestep(run.config) / s.window_s
    return 100.0 * rate / peaks_of(run.device_kind)["fp32_flops"]
