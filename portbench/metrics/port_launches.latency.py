"""port_launches.latency: the port's own kernel launches a request, counted by
the program (``repro_torch.kernels.ops.launch_counts()``, summed over its
kernels, a captured graph's launches counted at each replay): the count at the
end of the traced run's window less the count at its start, over the requests
answered in it.  Exact, with no profiler involved."""
import contextlib


@contextlib.contextmanager
def beside(device):
    from repro_torch.kernels.ops import launch_counts

    counts = {"start": sum(launch_counts().values())}
    yield counts
    counts["end"] = sum(launch_counts().values())


def read(run):
    counts = run.samples.extra.get("port_launches.latency")
    if not counts or not run.completed:
        return None
    return (counts["end"] - counts["start"]) / run.completed
