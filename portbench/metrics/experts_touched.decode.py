"""experts_touched.decode: the distinct routed experts a decode step's MoE
layer routes its tokens to, the mean over the traced run's window's steps
and MoE layers: the port's device counter ``repro_torch.moe.experts_touched``
([distinct experts, routings], summed in the captured step on the device
while the program's tracer records), read at the window's start and end.
Each touched expert's weights are read once a step, so it sets the routed
experts' share of a step's bytes.  A port without the counter reads
nothing, and the metric is left out of the line."""
import contextlib

NAME = "repro_torch.moe.experts_touched"


def _read():
    from repro_torch.obs.trace import PROGRAM

    return PROGRAM.read_counter(NAME) if hasattr(PROGRAM, "read_counter") else None


@contextlib.contextmanager
def beside(device):
    """The counter at the window's start and end; a recording of the
    program's spans around the window where none is on (the counter counts
    in the step captured while a recording was on)."""
    try:
        from repro_torch.obs.trace import PROGRAM
    except ImportError:
        yield None
        return
    box = {"start": _read()}
    with contextlib.ExitStack() as stack:
        if PROGRAM.active is None:
            stack.enter_context(PROGRAM.recording())
        yield box
    box["end"] = _read()


def read(run):
    box = run.samples.extra.get("experts_touched.decode")
    if not box or box.get("start") is None or box.get("end") is None:
        return None
    distinct, routings = (e - s for e, s in zip(box["end"], box["start"]))
    return distinct / routings if routings else None
