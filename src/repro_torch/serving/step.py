"""Serve-step builders: the LSTM-AE score step, and the LM's prefill (prompt
-> KV cache + first logits), decode (one token against the cache) and
greedy decoding.

Counterpart of ``repro/serving/step.py``.  The prefill, score and decode
steps take a ``mesh`` (a torch ``DeviceMesh``) and ``rules`` and run under
``mesh_context``, as the reference's: the model's ``constrain`` sites lay
activations out over the mesh, and what comes back are DTensors.  Greedy
decoding takes no mesh, as the reference's loop takes none.

The reference jits its greedy loop whole.  The port's counterpart is
:class:`GreedyDecoder`: on a CUDA device it captures one decode step into
a CUDA graph (``engine/capture.py``) per (batch, cache length, params)
signature and replays it once per token.  The step closes over static
buffers (the token, the position and the cache, which the decode step
writes in place: the transformer's KV cache, RWKV-6's recurrent state,
Jamba's KV cache and Mamba states, or Whisper's self-KV beside its
cross-KV, which the step only reads), so a replay clones only the next
token, never the cache, and the loop clones the last step's logits once,
from where the graph writes them; the argmax token and ``cache_len + 1``
stay on the device, so decoding syncs with the host once per loop, not per
token.  The step writes the next token into its static input by a
conversion (int64 into int32), which captures as a kernel, not as a copy
node.

While the port's tracer is live (``obs.trace.PROGRAM``: a recording or a
profiler session) a decoder call is a request of its own: the root span
``repro_torch.lm.decode`` around it, with the stages ``.lm.copy_in`` (the
caller's cache, token and position into the capture's buffers),
``.lm.replays`` (a replay a token) and ``.lm.copy_out`` (the cache back).
A step captured while a recording is on (``PROGRAM.counting()``) is
another graph from one captured while none is (the two share the static
buffers): sites that count on the device only then
(``moe.EXPERTS_TOUCHED``) are in the first and not in the second, so a call
outside a recording, under a profiler alone too, runs no counter and
captures nothing anew.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.distributed.sharding import mesh_context, rules_for_mesh
from repro_torch.engine.capture import GraphCache, signature
from repro_torch.models.api import ModelAPI
from repro_torch.obs import trace
from repro_torch.utils import Params, tree_leaves, tree_map

def _context(mesh, rules):
    return mesh_context(mesh, rules or (rules_for_mesh(mesh) if mesh is not None else None))


def build_prefill_step(api: ModelAPI, mesh=None, rules=None, q_chunks: int = 1,
                       kv_chunk: int = 1024):
    def prefill_step(params, batch):
        with _context(mesh, rules):
            return api.prefill(params, batch, q_chunks=q_chunks, kv_chunk=kv_chunk)
    return prefill_step


def build_score_step(engine, mesh=None, rules=None):
    """Anomaly-scoring step over a :class:`repro_torch.engine.Engine` — the
    LSTM-AE serving path: ``engine.score_with`` under the step's params.
    The engine owns the execution schedule and its placement; ``mesh``
    here only supplies sharding rules for any enclosing context."""
    def score_step(params, batch):
        with _context(mesh, rules):
            return engine.score_with(params, batch)
    return score_step


def build_decode_step(api: ModelAPI, mesh=None, rules=None):
    def decode_step(params, token, cache, cache_len):
        with _context(mesh, rules):
            return api.decode(params, token, cache, cache_len)
    return decode_step


def stitch_prefill_cache(api: ModelAPI, prefill_cache: Params, max_len: int) -> Params:
    """The decode cache of ``max_len`` positions that continues a prefill,
    as ``api.stitch`` builds it: the transformer's KV cache holding the
    prefill's K/V at every position it covered, RWKV-6's prefill state as
    it is (position-free), Jamba's states, its KV cache stitched and its
    Mamba states as they are, or Whisper's self-KV stitched and its
    cross-KV as it is."""
    if api.stitch is None:
        raise ValueError(f"family {api.cfg.family!r} has no decode cache to stitch")
    return api.stitch(prefill_cache, max_len)


class GreedyDecoder:
    """Greedy autoregressive decoding: ``decoder(params, cache, first_token,
    cache_len0, num_steps) -> (tokens (B, num_steps), cache)``, the
    reference's ``greedy_decode_loop``.

    The cache is updated in place (the K/V of every decoded token, or the
    recurrent state after the last) and returned; ``logits`` holds the last
    step's logits (B, V).  On a CUDA device with ``jit`` (the default) the
    step is captured once per (batch, cache length, params) signature and
    replayed per token: the caller's cache, token and position are copied
    into the capture's static buffers before the first step and the cache
    copied back after the last.  Params are read by address, like the
    Engine's captured programs: other param tensors capture anew.
    ``jit=False`` (the counterpart of ``EngineConfig(jit=False)``) and the
    CPU run the same step eagerly on the caller's tensors.

    ``in_place=True`` is for a caller that decodes over one cache, as
    ``launch/serve.py`` does: the step is captured over the caller's cache
    tensors themselves (keyed by their addresses), so nothing of the cache
    is copied in or back; a cache at other addresses is captured anew, so a
    caller with a fresh cache a call keeps the default."""

    def __init__(self, api: ModelAPI, *, jit: bool = True, in_place: bool = False):
        self.api = api
        self.jit = jit
        self.in_place = in_place
        self.logits: Optional[torch.Tensor] = None
        self._graphs: dict[torch.device, GraphCache] = {}
        self._buffers: dict = {}
        self._last: dict = {}      # graph key -> the step's last logits, eager and captured

    @property
    def captures(self) -> int:
        return sum(g.captures for g in self._graphs.values())

    @property
    def replays(self) -> int:
        return sum(g.replays for g in self._graphs.values())

    def _step(self, params, token, cache, cache_len):
        logits, _ = self.api.decode(params, token, cache, cache_len)
        last = logits[:, -1, :]
        return torch.argmax(last, dim=-1).to(torch.int32), last

    def __call__(self, params: Params, cache: Params, first_token: torch.Tensor,
                 cache_len0, num_steps: int) -> tuple[torch.Tensor, Params]:
        if not trace.PROGRAM.live():
            return self._decode(params, cache, first_token, cache_len0, num_steps, False)
        with trace.PROGRAM.span("repro_torch.lm.decode", self.api.cfg.name):
            return self._decode(params, cache, first_token, cache_len0, num_steps, True)

    def _stage(self, name: str, live: bool):
        return trace.PROGRAM.span(name, self.api.cfg.name) if live else contextlib.nullcontext()

    def _decode(self, params, cache, first_token, cache_len0, num_steps: int, live: bool):
        device = first_token.device
        if device.type != "cuda" or not self.jit:
            token = first_token
            n = torch.as_tensor(cache_len0, dtype=torch.int32, device=device)
            out = []
            for _ in range(num_steps):
                nxt, self.logits = self._step(params, token, cache, n)
                token, n = nxt[:, None], n + 1
                out.append(nxt)
            return torch.stack(out, dim=1), cache

        key = (signature((first_token, cache, params)),
               tuple(t.data_ptr() for t in tree_leaves(params)))
        if self.in_place:
            key += (tuple(t.data_ptr() for t in tree_leaves(cache)),)
        graphs = self._graphs.get(device)
        if graphs is None:
            graphs = self._graphs[device] = GraphCache(device)
        bufs = self._buffers.get(key)
        if bufs is None:
            bufs = self._buffers[key] = (
                torch.empty_like(first_token, dtype=torch.int32),
                torch.empty((), dtype=torch.int32, device=device),
                cache if self.in_place else tree_map(torch.empty_like, cache))
        token, n, static_cache = bufs

        gkey = key + (trace.PROGRAM.counting(),)
        last = self._last.setdefault(gkey, {})

        def step():
            logits, _ = self.api.decode(params, token, static_cache, n)
            last["graph" if torch.cuda.is_current_stream_capturing() else "eager"] = logits[:, -1, :]
            nxt = torch.argmax(logits[:, -1, :], dim=-1)
            token.copy_(nxt[:, None])       # int64 into int32: a kernel, not a graph copy node
            n.add_(1)
            return nxt

        with self._stage("repro_torch.lm.copy_in", live):
            # kernels, not copies: a conversion and a fill (with the
            # position as the fill's argument, not copied from the host)
            token.copy_(first_token.to(torch.int64))
            if isinstance(cache_len0, torch.Tensor):
                n.copy_(cache_len0)
            else:
                n.fill_(int(cache_len0))
            if static_cache is not cache:
                tree_map(lambda dst, src: dst.copy_(src), static_cache, cache)
        out = []
        replays = graphs.replays
        with self._stage("repro_torch.lm.replays", live):
            for _ in range(num_steps):
                out.append(graphs.run(gkey, step, ()))
        # the last step's logits, read where the graph writes them (its first
        # call's first step ran eagerly, so a capture and no replay reads those)
        self.logits = last["graph" if graphs.replays > replays else "eager"].clone()
        with self._stage("repro_torch.lm.copy_out", live):
            if static_cache is not cache:
                tree_map(lambda dst, src: dst.copy_(src), cache, static_cache)
        return torch.stack(out, dim=1).to(torch.int32), cache


def greedy_decode_loop(api: ModelAPI, params, cache, first_token, cache_len0,
                       num_steps: int, *, jit: bool = True):
    """Greedy autoregressive loop: (tokens (B, num_steps), cache), through a
    :class:`GreedyDecoder` of its own (on a CUDA device, one capture)."""
    return GreedyDecoder(api, jit=jit)(params, cache, first_token, cache_len0, num_steps)
