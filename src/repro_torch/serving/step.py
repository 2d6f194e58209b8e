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
cross-KV, which the step only reads), so the graph clones only the next
token and its logits, never the cache; the argmax token and
``cache_len + 1`` stay on the device, so decoding syncs with the host
once per loop, not per token.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed.sharding import mesh_context, rules_for_mesh
from repro_torch.engine.capture import GraphCache, signature
from repro_torch.models.api import ModelAPI
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
    CPU run the same step eagerly on the caller's tensors."""

    def __init__(self, api: ModelAPI, *, jit: bool = True):
        self.api = api
        self.jit = jit
        self.logits: Optional[torch.Tensor] = None
        self._graphs: dict[torch.device, GraphCache] = {}
        self._buffers: dict = {}

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
        graphs = self._graphs.get(device)
        if graphs is None:
            graphs = self._graphs[device] = GraphCache(device)
        bufs = self._buffers.get(key)
        if bufs is None:
            bufs = self._buffers[key] = (
                torch.empty_like(first_token, dtype=torch.int32),
                torch.empty((), dtype=torch.int32, device=device),
                tree_map(torch.empty_like, cache))
        token, n, static_cache = bufs

        def step():
            nxt, last = self._step(params, token, static_cache, n)
            token.copy_(nxt[:, None])
            n.add_(1)
            return nxt, last

        token.copy_(first_token)
        n.copy_(torch.as_tensor(cache_len0, dtype=torch.int32))
        tree_map(lambda dst, src: dst.copy_(src), static_cache, cache)
        out = []
        for _ in range(num_steps):
            nxt, self.logits = graphs.run(key, step, ())
            out.append(nxt)
        tree_map(lambda dst, src: dst.copy_(src), cache, static_cache)
        return torch.stack(out, dim=1), cache


def greedy_decode_loop(api: ModelAPI, params, cache, first_token, cache_len0,
                       num_steps: int, *, jit: bool = True):
    """Greedy autoregressive loop: (tokens (B, num_steps), cache), through a
    :class:`GreedyDecoder` of its own (on a CUDA device, one capture)."""
    return GreedyDecoder(api, jit=jit)(params, cache, first_token, cache_len0, num_steps)
