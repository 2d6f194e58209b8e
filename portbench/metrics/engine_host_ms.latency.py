"""engine_host_ms.latency: the host's time inside the program a request, in ms:
the median over the traced run's window of the ``repro_torch.service.score``
span's total, the program's own span, recorded with the profiler off
(``program_spans.py``).  At one window a request it holds the pageable copy-in
and its sync, the graph's launch and the outputs' clone."""
from portbench.program_spans import recording, root_ms

beside = recording


def read(run):
    return root_ms(run, "engine_host_ms.latency")
