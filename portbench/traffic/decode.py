"""Decode traffic: ``sessions`` live sessions, each with a prompt of
``context`` tokens prefilled in set-up, and requests of ``tokens`` greedy
tokens for every session from position ``context``, one caller in a closed
loop.

``build`` draws the prompts' ids uniformly from the vocabulary and a pool of
``first_pool`` first-token vectors (one id a session), from the seed on the
device.  ``warm`` prefills the prompts through the system, ``prefill_chunk``
sessions at a time, into one decode cache of ``context + tokens`` positions,
then runs the warm-up requests: the first captures the program's decode
step, the second captures it again with the program's tracer recording.  Request i is one call of the system's decoder: first tokens
``i mod first_pool``, then ``tokens`` greedy steps from position ``context``.
Each request overwrites positions ``context`` to ``context + tokens - 1``,
so every request attends over the same prompts; its latency runs from the
call to its tokens on the host.  The answers keep every request's tokens,
and the last step's logits of the first ``KEEP_FIRST`` requests answered
and of the last: the family's judge compares those (``reference_block``
sessions at a time), 256 rows at the cell's 32 sessions.  ``stop`` keeps
the latents the last request wrote at positions ``context`` to ``context +
tokens - 1`` of the first layers, which the judge holds to the reference's
too (``families/deepseek_v3.py``), and drops the decode cache before the
judgement.

``SMALL`` holds the parameters at which a test runs a cell: the cell's 32
sessions at a 24-token context, where a sound run is correct on the card as
on the CPU and every fault of the family fails a limit.
``CONTROL_SECONDS`` is the control's window: the control decodes with a
reference forward a token, seconds a request at the published widths, and
its judgement needs one answered request beside the warm-up's.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Any, Optional

import torch

from portbench.harness import Samples, log

SMALL = {"sessions": 32, "context": 24, "tokens": 3, "first_pool": 4, "prefill_chunk": 8,
         "reference_block": 8, "warmup_requests": 1, "trace_requests": 2}
CONTROL_SECONDS = 1.0
KEEP_FIRST = 7       # requests answered whose logits are kept, besides the last


@dataclass
class Decode:
    prompts: torch.Tensor     # (sessions, context) ids on the device
    firsts: torch.Tensor      # (first_pool, sessions) ids on the device
    seq_len: int              # tokens a request
    chunk: int                # sessions a prefill call
    block: int                # sessions a reference forward
    warmup: int
    trace_requests: int
    cache: Any = None
    last: Optional[int] = None    # the request answered last, whose latents the cache holds
    written: Any = None           # (last, its latents as the system wrote them), at stop

    @property
    def rows(self) -> int:
        return self.prompts.shape[0]

    @property
    def context(self) -> int:
        return self.prompts.shape[1]

    def first(self, i: int) -> torch.Tensor:
        """Request i's first tokens (sessions, 1)."""
        return self.firsts[i % self.firsts.shape[0]][:, None]


def vocab_size(cfg: dict, device: torch.device) -> int:
    """The vocabulary the system runs: the configuration's on a card, the
    port's reduced model's on the CPU (``families/deepseek_v3.py``)."""
    if device.type == "cuda":
        return int(cfg["vocab_size"])
    from repro_torch.config import reduced_config

    return reduced_config(cfg["port_config"]).vocab_size


def build(cfg: dict, params: dict, gen: torch.Generator, device: torch.device) -> Decode:
    b, s = int(params["sessions"]), int(params["context"])
    v = vocab_size(cfg, device)
    prompts = torch.randint(0, v, (b, s), generator=gen, device=device, dtype=torch.int32)
    firsts = torch.randint(0, v, (int(params["first_pool"]), b), generator=gen, device=device,
                           dtype=torch.int32)
    return Decode(prompts=prompts, firsts=firsts, seq_len=int(params["tokens"]),
                  chunk=int(params["prefill_chunk"]), block=int(params["reference_block"]),
                  warmup=int(params["warmup_requests"]),
                  trace_requests=int(params["trace_requests"]))


def _decode(system, traffic: Decode, i: int):
    return system.decode(traffic.cache, traffic.first(i), traffic.context, traffic.seq_len)


def warm(system, traffic: Decode) -> None:
    """The prefill of every prompt, then the warm-up requests."""
    t0 = time.perf_counter()
    traffic.cache = system.prefill(traffic.prompts, traffic.context + traffic.seq_len,
                                   traffic.chunk)
    log(f"[setup] prefill of {traffic.rows} x {traffic.context} tokens "
        f"{time.perf_counter() - t0:.3f} s (its last device work included)")
    for i in range(traffic.warmup):
        with _recorded(i > 0):
            _decode(system, traffic, i)


@contextlib.contextmanager
def _recorded(on: bool):
    """The block with the program's tracer recording, where ``on`` and the
    port has one.  The warm-up requests after the first run so: the program
    captures its decode step once with the tracer off, once recording
    (with the device counters a traced run reads), both in set-up, and a
    window replays the one its tracer's state asks for."""
    try:
        from repro_torch.obs.trace import PROGRAM
    except ImportError:
        PROGRAM = None
    if not on or PROGRAM is None:
        yield
        return
    with PROGRAM.recording():
        yield


def request(system, traffic: Decode, samples: Samples) -> bool:
    """The loop's next request, its answers kept; False where the program
    refused or lost it.  Of the logits, only the first ``KEEP_FIRST``
    requests' and the latest's stay."""
    i = traffic.warmup + samples.attempted
    try:
        tokens, logits = _decode(system, traffic, i)
    except RuntimeError as exc:
        samples.failed += 1
        log(f"request {i} failed: {exc}")
        return False
    earlier = i - 1
    if earlier in samples.answers and len(samples.answers) > KEEP_FIRST:
        samples.answers[earlier]["logits"] = None
    samples.answers[i] = {"tokens": tokens, "logits": logits}
    traffic.last = i
    return True


def drive(system, traffic: Decode, seconds: float) -> Samples:
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


def stop(system, traffic: Decode) -> None:
    """The latents the last request wrote kept (the family's ``written``),
    then the decode cache dropped: the judgement's reference needs the room."""
    if traffic.last is not None:
        traffic.written = (traffic.last,
                           system.written(traffic.cache, traffic.context, traffic.seq_len))
    traffic.cache = None
