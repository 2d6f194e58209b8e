"""h2d_ms.bulk: device milliseconds of host-to-device copies per profiled
request (the engine's copy-in), from the trace."""


def read(run):
    s = run.trace.copy_s("Memcpy HtoD") if run.trace else None
    return None if s is None else s * 1e3
