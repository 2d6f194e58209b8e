"""Cross-module contract rules (CON3xx), a copy of
``repro/analysis/rules_contract.py`` aimed at the port.

The wire protocol and the telemetry pipeline are contracts with no
shared schema object — the client, the server and the Prometheus
renderer each hard-code their half as string keys.  Nothing fails at
import time when the halves drift; a consumed-but-never-produced field
just reads ``None`` forever and a stats key the renderer doesn't know
silently vanishes from every scrape.  These rules diff the halves:

  CON301  response field read by a ``client.py`` but never produced by
          any ``server.py``/``workers.py`` — the read is dead (always
          missing), usually a renamed or deleted field
  CON302  request field sent by a ``client.py`` but never read by any
          ``server.py``/``workers.py`` — dead bytes on every request
  CON303  top-level scalar ``stats()`` key emitted by a gateway but
          absent from the Prometheus renderer's vocabulary — counters /
          gauges / histograms render generically, so the exposed
          contract surface is exactly the scalar top-level keys
          (``_SCALAR_GAUGES`` plus the section names)
  CON304  bare ``except:`` or an except whose whole body is ``pass`` on
          a serving path — failures vanish without even a debug line
          (per-file rule; the only non-cross-file one in this pack)

Role detection is by basename (``client.py``/``*_client.py`` consume,
``server.py``/``workers.py`` produce, ``prometheus.py`` renders), so
fixture trees exercise the rules without living under ``src/repro_torch``.
A rule that is missing one side of its contract in the analysed file
set reports nothing — a lone fixture file never misfires.
"""
from __future__ import annotations

import ast
from typing import Iterable, Optional

from repro_torch.analysis.engine import (
    FileContext, Finding, RepoContext, RepoRule, Rule, call_name, const_str,
    dotted_name,
)

_SERVING_TARGETS = (
    "src/repro_torch/gateway/**",
    "src/repro_torch/obs/**",
    "src/repro_torch/control/**",
)

# framing fields both sides handle generically — never part of a diff
_FRAMING = {"op", "id"}

# local variable names that (by repo convention) hold a wire response /
# request on the consuming side
_RESPONSE_VARS = {"resp", "response", "reply", "out"}
_REQUEST_VARS = {"req", "request", "msg"}
# calls whose result is a wire response (client.request(...)["score"])
_RESPONSE_CALLS = {"request", "collect", "step"}


def _read_key(node: ast.AST, varnames: set,
              calls: Optional[set] = None) -> Optional[str]:
    """The constant field name if ``node`` reads a key off a wire dict:
    ``resp["k"]`` / ``resp.get("k", ...)`` / ``"k" in req``."""
    if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
        if _is_wire_value(node.value, varnames, calls):
            return const_str(node.slice)
    elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        if node.func.attr == "get" and node.args and \
                _is_wire_value(node.func.value, varnames, calls):
            return const_str(node.args[0])
    elif isinstance(node, ast.Compare) and len(node.ops) == 1 and \
            isinstance(node.ops[0], (ast.In, ast.NotIn)):
        if _is_wire_value(node.comparators[0], varnames, calls):
            return const_str(node.left)
    return None


def _is_wire_value(node: ast.AST, varnames: set,
                   calls: Optional[set]) -> bool:
    if isinstance(node, ast.Name) and node.id in varnames:
        return True
    if calls and isinstance(node, ast.Call):
        name = call_name(node)
        return name.rsplit(".", 1)[-1] in calls
    return False


# -- consumer side (client.py) ---------------------------------------------


def _client_response_reads(ctx: FileContext) -> list:
    """``(field, node)`` for every response-field read in a client."""
    out = []
    for node in ast.walk(ctx.tree):
        key = _read_key(node, _RESPONSE_VARS, _RESPONSE_CALLS)
        if key is not None:
            out.append((key, node))
    return out


def _client_request_fields(ctx: FileContext) -> list:
    """``(field, node)`` for every request field a client sends: keys of
    dict literals that carry an ``"op"`` key, plus keyword names on the
    generic ``request(op, **fields)`` helper."""
    out = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Dict):
            keys = [const_str(k) for k in node.keys if k is not None]
            if "op" in keys:
                out.extend((k, node) for k in keys if k)
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("request",):
            out.extend((kw.arg, node) for kw in node.keywords
                       if kw.arg is not None)
    return out


# -- producer side (server.py / workers.py) --------------------------------


def _producer_response_fields(ctx: FileContext) -> set:
    """Every field a producer can put on the wire: dict-literal keys plus
    constant-key subscript assigns (``payload["alert"] = ...``)."""
    fields: set = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Dict):
            fields.update(k for k in (const_str(key) for key in node.keys
                                      if key is not None) if k)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    k = const_str(t.slice)
                    if k:
                        fields.add(k)
    return fields


def _producer_request_reads(ctx: FileContext) -> set:
    fields: set = set()
    for node in ast.walk(ctx.tree):
        key = _read_key(node, _REQUEST_VARS)
        if key is not None:
            fields.add(key)
    return fields


def _wire_roles(repo: RepoContext):
    consumers = repo.by_basename("client.py")
    producers = repo.by_basename("server.py", "workers.py")
    # one-sided file set (a lone fixture): nothing to diff against
    if not consumers or not producers:
        return [], []
    return consumers, producers


def check_wire_responses(repo: RepoContext) -> Iterable[Finding]:
    consumers, producers = _wire_roles(repo)
    produced: set = set()
    for p in producers:
        produced |= _producer_response_fields(p)
    for c in consumers:
        for field, node in _client_response_reads(c):
            if field not in produced and field not in _FRAMING:
                yield c.finding(
                    "CON301", node,
                    f"response field {field!r} is read here but no "
                    f"producer ({', '.join(p.path for p in producers)}) "
                    f"ever puts it on the wire — this read is always "
                    f"missing (renamed or deleted field?)",
                )


def check_wire_requests(repo: RepoContext) -> Iterable[Finding]:
    consumers, producers = _wire_roles(repo)
    consumed: set = set()
    for p in producers:
        consumed |= _producer_request_reads(p)
    for c in consumers:
        for field, node in _client_request_fields(c):
            if field not in consumed and field not in _FRAMING:
                yield c.finding(
                    "CON302", node,
                    f"request field {field!r} is sent here but no "
                    f"producer ({', '.join(p.path for p in producers)}) "
                    f"ever reads it — dead bytes on every request",
                )


# -- telemetry rendering contract ------------------------------------------


_SCALARISH_CALLS = {"int", "float", "len", "sum", "round", "min", "max",
                    "bool", "abs"}


def _scalarish(value: ast.AST) -> bool:
    """Statically plausible scalar: the shapes ``stats()`` methods use
    for gauge-able values.  Container literals/comprehensions are nested
    sections (rendered by their own handlers) and bare Names are opaque
    — neither is flagged."""
    if isinstance(value, ast.Constant):
        return isinstance(value.value, (int, float)) and \
            not isinstance(value.value, bool)
    if isinstance(value, ast.Attribute):
        return True
    if isinstance(value, (ast.BinOp, ast.UnaryOp, ast.IfExp)):
        return True
    if isinstance(value, ast.Call):
        return call_name(value).rsplit(".", 1)[-1] in _SCALARISH_CALLS
    return False


def _stats_emissions(ctx: FileContext) -> list:
    """``(key, value, node)`` for every top-level key a ``stats()``
    method emits: return-dict literals, ``out.update(k=v)`` keywords and
    ``out["k"] = v`` assigns."""
    out = []
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) or \
                fn.name != "stats":
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Return) and \
                    isinstance(node.value, ast.Dict):
                for key, value in zip(node.value.keys, node.value.values):
                    k = const_str(key) if key is not None else None
                    if k:
                        out.append((k, value, node.value))
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "update":
                for kw in node.keywords:
                    if kw.arg is not None:
                        out.append((kw.arg, kw.value, node))
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Subscript):
                k = const_str(node.targets[0].slice)
                if k:
                    out.append((k, node.value, node))
    return out


def _renderer_vocabulary(ctx: FileContext) -> set:
    """Every string constant in the renderer module — a superset of the
    keys it can render (``_SCALAR_GAUGES`` entries, section names,
    label names).  A key absent from this set cannot be rendered."""
    return {node.value for node in ast.walk(ctx.tree)
            if isinstance(node, ast.Constant)
            and isinstance(node.value, str)}


def check_telemetry_contract(repo: RepoContext) -> Iterable[Finding]:
    renderers = repo.by_basename("prometheus.py")
    if not renderers:
        return
    vocab: set = set()
    for r in renderers:
        vocab |= _renderer_vocabulary(r)
    rendered_in = ", ".join(r.path for r in renderers)
    for ctx in repo.files:
        if ctx in renderers:
            continue
        for key, value, node in _stats_emissions(ctx):
            if key not in vocab and _scalarish(value):
                yield ctx.finding(
                    "CON303", node,
                    f"stats key {key!r} emitted here is never rendered "
                    f"by the Prometheus exposition ({rendered_in}): "
                    f"scalar top-level keys only render when listed in "
                    f"_SCALAR_GAUGES, so every scrape silently drops it",
                )


# -- swallowed exceptions (per-file) ---------------------------------------


def _pass_only(body: list) -> bool:
    return all(isinstance(s, ast.Pass)
               or (isinstance(s, ast.Expr)
                   and isinstance(s.value, ast.Constant))
               for s in body)


def check_swallowed_except(ctx: FileContext) -> Iterable[Finding]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if node.type is None:
            yield ctx.finding(
                "CON304", node,
                "bare `except:` on a serving path also traps "
                "KeyboardInterrupt/SystemExit and hides the failure — "
                "catch a concrete exception type and at least "
                "debug-log it",
            )
        elif _pass_only(node.body):
            if isinstance(node.type, ast.Tuple):
                typ = "(" + ", ".join(
                    dotted_name(e) or "?" for e in node.type.elts) + ")"
            else:
                typ = dotted_name(node.type) or "Exception"
            yield ctx.finding(
                "CON304", node,
                f"`except {typ}: pass` swallows the failure with no "
                f"trace at all — log at debug level (or narrow the "
                f"type) so field incidents stay diagnosable",
            )


FILE_RULES = [
    Rule("CON304", "bare/swallowed except on a serving path",
         check_swallowed_except, _SERVING_TARGETS),
]

REPO_RULES = [
    RepoRule("CON301", "response field consumed but never produced",
             check_wire_responses),
    RepoRule("CON302", "request field sent but never consumed",
             check_wire_requests),
    RepoRule("CON303", "stats key emitted but never rendered",
             check_telemetry_contract),
]
