"""timesteps_per_s: row-timesteps (windows x T) of every request answered in
the window, over the window's seconds."""


def read(run):
    s = run.samples
    return s.timesteps / s.window_s if s.timesteps else None
