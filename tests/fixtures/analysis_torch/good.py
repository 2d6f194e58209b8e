import functools

import torch

_graph_cache = {}


class Pool:
    def __init__(self, engine):
        self.engine = engine
        self.calls = 0

    def step(self, x, keep, n: int):
        self.calls += 1
        if not keep.any():
            return None
        return self.engine.run_program(
            "mstep", functools.partial(self._advance, 0, n=n), (x, keep))

    def _advance(self, i, x, keep, n: int = 1):
        if x.shape[0] > 1 and x.dim() == 2 and n > 1:
            x = x[:, :n]
        if x.size(0) == 0 or x is None:
            return x
        total = torch.where(keep, x.sum(dim=-1), 0.0)
        total += x.mean(dim=-1)
        return total


def lookup(shape, dtype):
    return _graph_cache.get((tuple(shape), dtype))


def device_count():
    return torch.cuda.device_count()


def capture(graph, fn, x):
    with torch.cuda.graph(graph):
        out = fn(x) * 2
    return out
