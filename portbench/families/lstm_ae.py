"""The LSTM-AE family: the system under test, built from the seed, its control,
and the judgement of answers against the plain reference.

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
