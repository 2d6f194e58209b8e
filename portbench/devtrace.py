"""The device's work over a stretch of requests, read from one ``torch.profiler`` pass.

The benchmark wraps each profiled request in a ``record_function`` span
(:data:`REQUEST`).  Device operations (kernels, copies, memsets: the profiler's
CUDA events, those of a replayed CUDA graph included) and the host's launch
calls are given to the request whose span holds their start: a request ends with
its scores on the host, so none of its device work outlives its span.

The trace is lossy (CUPTI drops events; passes of ``chip_smoke.py`` lost every
K1 kernel of a request, or a few other events, and a pass here once gave one
request's kernels to its neighbour).  Every request of a cell runs the same
work, so the first request of a pass, the one the profiler warms up on, is left
out, and so is any request that recorded no device operation, another count
of copies than the pass's median, or a count of kernels more than a tenth off
its median; every number is read from the requests kept.  A pass that keeps fewer than three quarters of its requests is
profiled again, at most three times in all; after three such passes the run
fails: it never reads an idle share from an empty trace.

The union of device intervals and the launch calls counted are copies of
``chip_smoke.py``'s ``device_busy_over`` and ``LAUNCH_CALLS``.
"""
from __future__ import annotations

import bisect
import math
import statistics
from dataclasses import dataclass, field
from typing import Callable, Optional

REQUEST = "portbench.request"
# CUDA API calls (runtime and driver) that put work on a stream
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")
LOSSY_SHARE = 0.9      # a request keeps this share of the median's kernels, or is left out
KEEP_SHARE = 0.75      # a pass keeps this share of its requests, or is profiled again


class TraceLost(RuntimeError):
    """Every profiled pass lost part of its device trace."""


@dataclass
class Op:
    name: str
    start: float  # microseconds, the profiler's clock
    end: float

    @property
    def dur(self) -> float:
        return self.end - self.start


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of ``intervals`` as sorted, disjoint intervals."""
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def covered(intervals: list[tuple[float, float]], lo: float, hi: float) -> float:
    """The length of [lo, hi] that the union of ``intervals`` covers."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in union(intervals))


@dataclass
class Request:
    """What one profiled request put on the device and the host.  Its share of
    the stretch runs from its start to the next request's (``upto``): the
    caller's own time between two requests is the earlier one's."""
    start: float
    end: float
    upto: float = 0.0
    kernels: list = field(default_factory=list)   # compute kernels
    copies: list = field(default_factory=list)    # memcpys and memsets
    calls: int = 0                                # launch calls on the host

    @property
    def ops(self) -> list:
        return self.kernels + self.copies

    @property
    def busy(self) -> float:
        """Microseconds the device worked for this request: its kernels' union
        plus its copies' and memsets' union, each engine on its own timeline.
        The trace's copy timestamps drift against its kernels' (whole passes
        put a request's copy over its kernels, on one stream), while each
        engine's agree with themselves; a copy that truly ran beside a kernel
        would count twice, and no path the benchmark drives runs one so."""
        return sum(covered([(o.start, o.end) for o in ops], -math.inf, math.inf)
                   for ops in (self.kernels, self.copies))


@dataclass
class Trace:
    requests: list            # Request: the pass's requests, its first left out
    host: list                # Op: the host's operations on the requests' thread

    # -- which requests are read ------------------------------------------

    @property
    def kept(self) -> list:
        """The requests whose trace is whole: some device operation, the
        pass's median count of copies and memsets, and within a tenth of its
        median count of kernels (a request that lost events, or was given
        another's, is left out)."""
        if not self.requests:
            return []
        kernels = statistics.median(len(r.kernels) for r in self.requests)
        copies = statistics.median(len(r.copies) for r in self.requests)
        return [r for r in self.requests
                if r.ops and len(r.copies) == copies
                and abs(len(r.kernels) - kernels) <= (1 - LOSSY_SHARE) * kernels]

    def problem(self) -> Optional[str]:
        """Why this pass cannot be read, or None."""
        if not self.requests:
            return "no request was profiled"
        kept = self.kept
        if len(kept) < KEEP_SHARE * len(self.requests):
            counts = [len(r.kernels) for r in self.requests]
            return (f"{len(self.requests) - len(kept)} of {len(self.requests)} requests lost "
                    f"part of their trace (kernels a request from {min(counts)} to {max(counts)})")
        return None

    # -- the stretch of the kept requests -----------------------------------

    @property
    def window_s(self) -> float:
        return sum(r.upto - r.start for r in self.kept) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(r.busy for r in self.kept) / 1e6

    @property
    def busy_per_request_s(self) -> float:
        return self.busy_s / len(self.kept)

    def summary(self) -> str:
        """The kept requests' device time, for the run's log: their busy time,
        and by how much their kernels and copies overlap on the trace's
        timeline, which on one stream is the trace's own drift."""
        busy = sorted(r.busy for r in self.kept)
        drift = [r.busy - covered([(o.start, o.end) for o in r.ops], -math.inf, math.inf)
                 for r in self.kept]
        return (f"kept {len(self.kept)} of {len(self.requests)} requests; busy a request "
                f"{busy[0] / 1e3:.4f} / {statistics.median(busy) / 1e3:.4f} / "
                f"{busy[-1] / 1e3:.4f} ms (least / median / most); kernels and copies "
                f"overlap on the trace by {sum(drift) / len(drift) / 1e3:.4f} ms a request "
                f"({sum(d > 1.0 for d in drift)} requests by over 1 us)")

    # -- per request ------------------------------------------------------

    def mean(self, fn: Callable[[Request], float]) -> float:
        kept = self.kept
        return sum(fn(r) for r in kept) / len(kept)

    def kernel_s(self) -> float:
        """Device seconds of compute kernels per request."""
        return self.mean(lambda r: sum(o.dur for o in r.kernels)) / 1e6

    def kernels(self) -> float:
        """Kernels a request: the median, as a lost event moves a mean."""
        return float(statistics.median(len(r.kernels) for r in self.kept))

    def calls(self) -> float:
        """Launch calls a request: the median."""
        return float(statistics.median(r.calls for r in self.kept))

    def copy_s(self, prefix: str) -> Optional[float]:
        """Device seconds per request of the copies whose name starts with
        ``prefix`` (``"Memcpy HtoD"``); None where no request made one."""
        if not any(o.name.startswith(prefix) for r in self.kept for o in r.copies):
            return None
        return self.mean(lambda r: sum(o.dur for o in r.copies if o.name.startswith(prefix))) / 1e6

    # -- breakdown --------------------------------------------------------

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        by: dict = {}
        for r in self.kept:
            for o in r.ops:
                by[o.name] = by.get(o.name, 0.0) + o.dur / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[host operation, seconds]: the device's idle time over the kept
        requests, by the innermost host operation running at the middle of
        each gap; a gap is cut where its request's span ends."""
        gaps = []
        for r in self.kept:
            busy = union([(max(o.start, r.start), min(o.end, r.upto)) for o in r.ops])
            edges = [r.start] + [x for ab in busy for x in ab] + [r.upto]
            for g0, g1 in zip(edges[::2], edges[1::2]):
                if g0 < r.end < g1:
                    gaps += [(g0, r.end, True), (r.end, g1, False)]
                elif g1 > g0:
                    gaps.append((g0, g1, g1 <= r.end))
        # one sweep in time: the host's operations nest, so the open one
        # started last is the innermost at each gap's middle
        host = sorted(self.host, key=lambda o: (o.start, -o.end))
        open_ops: list = []
        j = 0
        by: dict = {}
        for g0, g1, inside in gaps:
            mid = (g0 + g1) / 2
            while j < len(host) and host[j].start <= mid:
                while open_ops and open_ops[-1].end < host[j].start:
                    open_ops.pop()
                open_ops.append(host[j])
                j += 1
            while open_ops and open_ops[-1].end < mid:
                open_ops.pop()
            if open_ops:
                name = open_ops[-1].name
            else:
                name = "python, inside a request" if inside else "python, between requests"
            by[name] = by.get(name, 0.0) + (g1 - g0) / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def read_events(events) -> Trace:
    """A :class:`Trace` from a profiler's ``events()``; the first request span
    and what it holds are left out."""
    from torch.autograd import DeviceType

    spans, device, host, calls = [], [], [], []
    for e in events:
        op = Op(e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            if e.name != REQUEST:       # the span's projection on the device's timeline
                device.append(op)
        elif e.name == REQUEST:
            spans.append((op, e.thread))
        else:
            host.append((op, e.thread))
            if e.name in LAUNCH_CALLS:
                calls.append(op)
    spans.sort(key=lambda s: s[0].start)
    threads = {t for _, t in spans}
    requests = [Request(op.start, op.end) for op, _ in spans[1:]]
    for r, nxt in zip(requests, requests[1:] + [None]):
        r.upto = r.end if nxt is None else nxt.start
    starts = [r.start for r in requests]

    def owner(op: Op) -> Optional[Request]:
        k = bisect.bisect_right(starts, op.start) - 1
        if k >= 0 and op.start <= requests[k].upto:
            return requests[k]
        return None

    for op in device:
        r = owner(op)
        if r is not None:
            is_copy = op.name.startswith("Memcpy") or op.name.startswith("Memset")
            (r.copies if is_copy else r.kernels).append(op)
    for op in calls:
        r = owner(op)
        if r is not None:
            r.calls += 1
    host_ops = [op for op, t in host if t in threads and owner(op) is not None]
    return Trace(requests=requests, host=host_ops)


def warm(request: Callable[[], object], n: int = 2) -> None:
    """Run ``n`` calls of ``request`` under the profiler and read nothing: the
    profiler's first start in a process is slow."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    torch.cuda.synchronize()
    with profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(n):
            request()


def profile(request: Callable[[], object], n: int, passes: int = 3,
            log: Callable[[str], None] = print) -> Trace:
    """Profile ``n`` + 1 calls of ``request`` and read them; a pass that
    :meth:`Trace.problem` refuses is profiled again, ``passes`` times at most."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as profiler

    for attempt in range(1, passes + 1):
        torch.cuda.synchronize()
        with profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n + 1):
                with record_function(REQUEST):
                    request()
        trace = read_events(prof.events())
        problem = trace.problem()
        if problem is None:
            return trace
        log(f"[trace] pass {attempt} of {passes}: {problem}")
    raise TraceLost(f"{passes} profiled passes lost part of their device trace")
