"""Captured programs: one CUDA graph per (program, input signature).

The port's counterpart of the reference's ``jax.jit`` (it has no JAX
counterpart of its own).  Where the reference compiles an engine program
once per input shape, the port captures it once into a
``torch.cuda.CUDAGraph`` and replays it: the host then issues one graph
launch per call instead of one launch per kernel (at a bulk batch, 384
K1 launches per lstm-ae-f64-d6 request under the ``fused`` schedule; at a
small one a single ``lstm_stack`` launch beside the score's kernels).

A :class:`CapturedProgram` is made on the first call at a signature:

1. static copies of the tensor arguments are allocated on the device and
   the call's arguments copied in;
2. ``fn`` runs once on a side stream over them (the warm-up: cuBLAS
   workspaces, the kernels' library load) — its result is the first
   call's result, so the first call launches each kernel once, as every
   later call does;
3. ``fn`` is captured over the same static tensors on that stream.

Each later call copies its arguments into the static tensors (a host
array or CPU tensor with a pageable, blocking copy: the host buffer may be
reused once the call returns), replays the graph, counts the kernels
recorded in it as launched (``kernels.ops.add_launches``) and returns
clones of the graph's outputs, so a later call never overwrites a tensor
an earlier one returned.  ``fn`` may also update tensors it closes over in
place and return None (the session pool's step).  While the port's tracer
is live (``obs.trace.PROGRAM``: a recording, or a profiler session), the
three stages run under spans of their own (``repro_torch.capture.copy_in``,
``.replay``, ``.clone_out``) and a recording counts the bytes copied in.

Nothing falls back: a capture that fails, or a kernel that refuses its
launch while it is captured, raises.  A replay is not re-entrant (the
static tensors are shared), so a :class:`GraphCache` runs one call at a
time: a second thread waits on the cache's lock until the first has copied
its arguments in, replayed and cloned its outputs.  A capture checks only
its own thread's CUDA calls (``capture_error_mode="thread_local"``), so
another thread's work on the device — a caller scoring in-process while
the gateway's server thread captures a new bucket — cannot break it;
and Python's cyclic collector is off while a graph is captured, so that
it cannot destroy an earlier program's graph in the middle of a capture
(``tests/test_torch_cuda.py``).  Graphs read whatever they closed over by address, so the engine keeps its
own copy of the bound params for them, copies new params into it in place
and drops its caches when it must allocate a new one (``Engine.bind``).
"""
from __future__ import annotations

import gc
import threading
from typing import Callable, Hashable, Optional

import torch

from repro_torch.kernels.ops import add_launches, captured_counts
from repro_torch.obs import trace
from repro_torch.utils import Params, tree_map


def _leaves(tree: Params) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def signature(args: tuple) -> tuple:
    """The shapes and dtypes of the tensors in ``args``, in order (their
    values and devices aside): a program is captured once per signature."""
    return tuple((tuple(t.shape), t.dtype) for t in _leaves(args))


def _clone(tree):
    return None if tree is None else tree_map(lambda t: t.clone(), tree)


class CapturedProgram:
    """``fn`` captured once over static copies of its tensor arguments."""

    def __init__(self, fn: Callable, args: tuple, device: torch.device,
                 stream: torch.cuda.Stream, name: str = ""):
        self.name = name     # the program's, an attribute of its spans
        static = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device), args)
        self._inputs = _leaves(static)
        self._copy_in(args, trace.PROGRAM.active)
        # the warm-up allocates on the side stream: with the device idle,
        # no block it reuses is still read by work queued elsewhere
        torch.cuda.synchronize(device)
        with torch.cuda.stream(stream):
            self.first = fn(*static)
        current = torch.cuda.current_stream(device)
        current.wait_stream(stream)
        before = captured_counts()
        self.graph = torch.cuda.CUDAGraph()
        # no cyclic garbage collection while capturing: a collected cycle
        # that holds an earlier program would destroy its graph mid-capture,
        # a call a capturing thread may not make, and the capture is lost
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, stream=stream,
                                  capture_error_mode="thread_local"):
                self.out = fn(*static)
        finally:
            if collecting:
                gc.enable()
            torch.cuda.set_stream(current)   # also when capture_end raised
        after = captured_counts()
        # kernels of the port recorded in the graph, launched at each replay
        self.launches = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        self.replays = 0

    def _copy_in(self, args: tuple, rec: Optional[trace.Recording] = None) -> None:
        """Copy ``args`` into the static inputs; ``rec`` counts the bytes."""
        for dst, src in zip(self._inputs, _leaves(args)):
            if src is not dst:
                if rec is not None:
                    rec.copied_in(src)
                dst.copy_(src)

    def __call__(self, args: tuple):
        if trace.PROGRAM.live():
            return self._traced_call(args)
        self._copy_in(args)
        self.graph.replay()
        add_launches(self.launches)
        self.replays += 1
        return _clone(self.out)

    def _traced_call(self, args: tuple):
        """:meth:`__call__` with a span around each of its three stages."""
        with trace.PROGRAM.span("repro_torch.capture.copy_in", self.name):
            self._copy_in(args, trace.PROGRAM.active)
        with trace.PROGRAM.span("repro_torch.capture.replay", self.name):
            self.graph.replay()
            add_launches(self.launches)
            self.replays += 1
        with trace.PROGRAM.span("repro_torch.capture.clone_out", self.name):
            return _clone(self.out)


class GraphCache:
    """The captured programs of one owner on one device, by key:
    ``run(key, fn, args)`` captures ``fn`` at its first key and replays it
    after, one call at a time, on the current stream of ``device``.  Each
    data shard of an engine (and of a pool) has its own cache, so two
    shards on one repeated device never share a static input."""

    def __init__(self, device: torch.device):
        self.device = device
        self.programs: dict[Hashable, CapturedProgram] = {}
        self.captures = 0        # programs captured, recaptures included
        self._stream = torch.cuda.Stream(device)
        self._lock = threading.Lock()

    def run(self, key: Hashable, fn: Callable, args: tuple, name: str = ""):
        """``name``, the program's, is given to a program captured here."""
        # a graph captures and replays on its own device, which need not be
        # the current one (a data shard's cache on another GPU)
        with self._lock, torch.cuda.device(self.device):
            prog = self.programs.get(key)
            if prog is None:
                prog = CapturedProgram(fn, args, self.device, self._stream, name)
                self.programs[key] = prog
                self.captures += 1
                out, prog.first = prog.first, None   # the caller owns it now
                return out
            return prog(args)

    @property
    def replays(self) -> int:
        return sum(p.replays for p in self.programs.values())

    def clear(self) -> None:
        """Drop every captured program (the next call at each key recaptures),
        once the device has finished any replay still reading them."""
        with self._lock:
            if self.programs:
                torch.cuda.synchronize(self.device)
            self.programs.clear()
