"""One caller in a closed loop over a pool of inputs: the requests, warm-up and
window that the ``bulk`` and ``window`` traffic kinds share.

Request i sends ``pool[i mod len(pool)]`` once the request before it has its
answers on the host; its latency runs from the call to its answers on the host.
A kind of other arrivals, concurrency or entry writes its own ``warm``,
``drive`` and ``request`` (``harness.py`` says what each does).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from portbench.harness import Samples, log


@dataclass
class Pool:
    """A cell's distinct inputs: ``pool`` (N, B, T, F) on the host.  ``block``
    is how many windows the reference scores at a time; ``warmup`` requests run
    in set-up and ``trace_requests`` are profiled by the traced run."""
    pool: torch.Tensor
    seq_len: int
    block: int
    warmup: int
    trace_requests: int
    inputs: list = field(init=False, repr=False)

    def __post_init__(self):
        self.inputs = list(self.pool.unbind(0))

    @property
    def rows(self) -> int:
        return self.pool.shape[1]

    def pool_index(self, i: int) -> int:
        return i % len(self.inputs)

    def input(self, i: int) -> torch.Tensor:
        return self.inputs[i % len(self.inputs)]


def warm(system, traffic: Pool) -> None:
    """The warm-up requests; the first captures the program."""
    for i in range(traffic.warmup):
        system.score(traffic.input(i))


def request(system, traffic: Pool, samples: Samples) -> bool:
    """Send the loop's next request and keep its answers; False where the
    program refused or lost it."""
    i = traffic.warmup + samples.attempted
    try:
        samples.answers[i] = system.score(traffic.input(i))
    except RuntimeError as exc:
        samples.failed += 1
        log(f"request {i} failed: {exc}")
        return False
    return True


def drive(system, traffic: Pool, seconds: float) -> Samples:
    """The measured window: requests back to back for ``seconds``."""
    samples = Samples(start=time.perf_counter())
    deadline = samples.start + seconds
    now = samples.start
    while now < deadline:
        sent = now
        ok = request(system, traffic, samples)
        now = time.perf_counter()
        if ok:
            samples.latencies_s.append(now - sent)
            samples.timesteps += traffic.rows * traffic.seq_len
    samples.window_s = now - samples.start
    return samples
