"""The LSTM-AE family: the system under test, built from the seed, its control,
the judgement of answers against the plain reference, the checks of its
configuration files and the faults its cells can have.

The system is ``repro_torch.engine.AnomalyService(<config>, schedule="fused")``
with its programs captured as the engine does by default.  Its weights are drawn
here on the device from the seed, at PyTorch's LSTM init scale (every weight and
the bias U(-1/sqrt(H), 1/sqrt(H))), in one call, in the port's layout, handed to
the service with ``recalibrate(params=...)``, and kept as a copy for the
reference, which the program cannot write.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from portbench.reference import lstm_ae_plain
from portbench.work import lstm_ae as work


def make_weights(cfg: dict, gen: torch.Generator) -> list[dict]:
    """Per layer {"wx": (In, 4H), "wh": (H, 4H), "b": (4H,)}, float32 views of one
    buffer drawn by one call on ``gen``'s device."""
    shapes = work.layer_shapes(cfg)
    flat = torch.rand(work.weight_count(cfg), generator=gen, device=gen.device)
    flat.mul_(2.0).sub_(1.0)
    layers, at = [], 0
    for n_in, h in shapes:
        k = 1.0 / math.sqrt(h)
        layer = {}
        for name, shape in (("wx", (n_in, 4 * h)), ("wh", (h, 4 * h)), ("b", (4 * h,))):
            n = math.prod(shape)
            layer[name] = flat[at:at + n].view(shape).mul_(k)
            at += n
        layers.append(layer)
    return layers


@dataclass
class System:
    """The service under test and a copy of the weights it was given, kept
    apart from the program for the reference."""
    service: object
    weights: list

    def score(self, series: torch.Tensor) -> torch.Tensor:
        """One request: windows (B, T, F) on the host -> their scores on the host."""
        return self.service.score(series).cpu()

    def counters(self) -> dict:
        """The program's own counters, printed beside the result and never a
        metric: kernel launches so far and the engine's first-call profile."""
        from repro_torch.kernels.ops import launch_counts

        prof = self.service.engine.profile
        return {"launches": launch_counts(), "captures": prof["compiles"],
                "capture_ms": round(prof["compile_ms"], 3)}

    def close(self) -> None:
        self.service = None


def build(cfg: dict, gen: torch.Generator, device: torch.device) -> System:
    """The port's service for ``cfg`` on ``device``, with weights from ``gen``;
    refuses a port whose widths differ from the configuration file's."""
    from repro_torch.engine import AnomalyService

    svc = AnomalyService(cfg["port_config"], schedule="fused", device=device)
    ae = svc.cfg.lstm_ae
    got = (ae.input_features, list(ae.layer_sizes()))
    want = (int(cfg["input_features"]), [int(h) for h in cfg["layer_sizes"]])
    if got != want:
        raise ValueError(f"{cfg['port_config']} has widths {got} in the port, {want} in "
                         f"the configuration file")
    weights = make_weights(cfg, gen)
    kept = [{k: t.clone() for k, t in layer.items()} for layer in weights]
    svc.recalibrate(params={"layers": tuple(weights)})
    return System(service=svc, weights=kept)


@dataclass
class Control:
    """The plain reference in TF32, one precision below the configurations'
    float32, in the program's place: a sound limit fails its answers.  On a card
    each request's shape is captured once into a CUDA graph and replayed, as the
    program's is: at one window a request the reference is some 4,000 launches,
    and the control has to answer as many windows as a run of the program."""
    weights: list
    graphs: dict = field(default_factory=dict)   # input shape -> (graph, input, scores)

    def forward(self, series: torch.Tensor) -> torch.Tensor:
        return lstm_ae_plain.scores(self.weights, series, block=series.shape[0], tf32=True)

    def score(self, series: torch.Tensor) -> torch.Tensor:
        dev = self.weights[0]["wx"].device
        if dev.type != "cuda":
            return self.forward(series).cpu()
        if series.shape not in self.graphs:
            x = series.to(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.forward(x)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = self.forward(x)
            self.graphs[series.shape] = (graph, x, out)
        graph, x, out = self.graphs[series.shape]
        x.copy_(series)
        graph.replay()
        return out.cpu()

    def counters(self) -> dict:
        return {}

    def close(self) -> None:
        self.graphs.clear()


def control(cfg: dict, gen: torch.Generator, device: torch.device) -> Control:
    """The control, with the weights ``build`` draws from the same seed."""
    return Control(weights=make_weights(cfg, gen))


def reference_scores(weights: list, pool: torch.Tensor, *, block: int) -> torch.Tensor:
    """The reference's scores of every window of ``pool`` (N, B, T, F) as (N, B)
    on the host."""
    n, b = pool.shape[:2]
    flat = pool.reshape(n * b, *pool.shape[2:])
    return lstm_ae_plain.scores(weights, flat, block=block).cpu().view(n, b)


def score_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest gap between two sets of scores, each against the reference
    score of its window; infinite where a score is not a finite number or the
    shapes differ."""
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        return math.inf
    return float(((got.double() - want.double()).abs() / want.double().abs()).max())


def judge(system: System, traffic, answers: dict, limits: dict) -> dict:
    """Each compared number beside its limit.  ``answers`` maps a request's index
    to the scores the timed path returned for it; every one is compared with the
    reference's scores of that request's windows."""
    want = reference_scores(system.weights, traffic.pool, block=traffic.block)
    worst = 0.0
    for i, got in answers.items():
        worst = max(worst, score_rel_err(got, want[traffic.pool_index(i)]))
    return {"score_rel_err": {"value": worst, "limit": float(limits["score_rel_err"])}}


def check_config(cfg: dict) -> None:
    """Refuses a configuration file that describes no LSTM-AE: one hidden width
    a layer, ``depth`` of them, the last as wide as the input it reconstructs."""
    sizes = cfg["layer_sizes"]
    if len(sizes) != cfg["depth"]:
        raise ValueError(f"{cfg['name']}: {len(sizes)} layer sizes for depth {cfg['depth']}")
    if sizes[-1] != cfg["input_features"]:
        raise ValueError(f"{cfg['name']}: the last layer has {sizes[-1]} units for "
                         f"{cfg['input_features']} input features")


# -- faults planted underneath the timed path ---------------------------------
# Each takes (monkeypatch, the configuration file, the cell's limits).


def _state_unchanged(monkeypatch, cfg: dict, limits: dict) -> None:
    """Each K1 cell step returns its state unchanged."""
    from repro_torch.engine import schedules

    def unchanged(params, x, h, c, *, pwl=False, h_out=None, c_out=None):
        h_out.copy_(h)
        if c_out is not c:
            c_out.copy_(c)
        return h_out, c_out

    monkeypatch.setattr(schedules, "lstm_cell_op", unchanged)


def _state_unchanged_stack(monkeypatch, cfg: dict, limits: dict) -> None:
    """The whole-stack kernel run one timestep a launch, each from zero state:
    the kernel still runs, but no h or c is carried from a step to the next."""
    from repro_torch.engine import schedules

    real = schedules.lstm_stack_op

    def stepwise(layers, xs, *, pwl=False):
        return torch.cat([real(layers, xs[t:t + 1], pwl=pwl) for t in range(xs.shape[0])])

    monkeypatch.setattr(schedules, "lstm_stack_op", stepwise)


def _half_batch(monkeypatch, cfg: dict, limits: dict) -> None:
    """Half of a request's windows left out, the rest's mean given for them."""
    from repro_torch.engine.base import Engine

    score = Engine._score

    def half(self, params, series):
        keep = series.shape[0] // 2
        got = score(self, params, series[:keep])
        return torch.cat([got, got.mean().expand(series.shape[0] - keep)])

    monkeypatch.setattr(Engine, "_score", half)


def _answer_altered(monkeypatch, cfg: dict, limits: dict) -> None:
    """One score of the window's first request altered where the engine
    produces it, by ten times the cell's limit."""
    from repro_torch.engine.base import Engine

    score = Engine._score
    calls = []
    factor = 1 + 10 * float(limits["score_rel_err"])

    def altered(self, params, series):
        got = score(self, params, series)
        calls.append(1)
        if len(calls) == 2:        # the warm-up request is the first
            got = torch.cat([got[:1] * factor, got[1:]])
        return got

    monkeypatch.setattr(Engine, "_score", altered)


def faults(traffic_kind: str, on_card: bool = False) -> dict:
    """name -> planter of each fault a cell of ``traffic_kind`` can have, as
    it reaches the timed path at the kind's small size (``SMALL``) on the CPU,
    or with ``on_card`` on the card.

    On the CPU the ``fused`` forward runs K1's chain of plain cells (the
    stack's plain version step for step), so the state fault is planted in
    ``schedules.lstm_cell_op``; a one-window request has no half to leave out;
    no LSTM-AE cell spans chips, so no exchange can be left out.  On the card
    a one-window request runs the whole stack in one ``lstm_stack`` launch,
    which no CPU fault reaches: ``state_unchanged_stack`` plants the state
    fault there.  The other faults are the CPU's to plant: they break the
    engine's code, which both devices run, and ``answer_altered`` counts the
    engine's calls, which the replays of the card's captured graph do not
    make."""
    if on_card:
        return {"state_unchanged_stack": _state_unchanged_stack} if traffic_kind == "window" else {}
    found = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
             "answer_altered": _answer_altered}
    if traffic_kind == "window":
        del found["half_batch"]
    return found
