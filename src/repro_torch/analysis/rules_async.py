"""Concurrency-hazard rules (ASY2xx) for the port's serving tier.

A copy of ``repro/analysis/rules_async.py`` aimed at the port.  The
gateway's concurrency contract is narrow and documented — one event
loop owns the gateway, supervisor threads own the control plane, worker
processes are spawned (never forked: neither CUDA nor JAX state survives
a fork).
Each rule here flags a way that contract silently erodes:

  ASY201  blocking call (time.sleep / subprocess / sync socket / sync
          file I/O / Future.result) inside an ``async def`` — stalls
          every connection on the loop, not just the caller
  ASY202  a sync lock held across an ``await`` — the loop suspends with
          the lock held; any thread then contending deadlocks the loop
  ASY203  ``create_task``/``ensure_future`` result dropped — asyncio
          keeps only weak refs to tasks, a GC can cancel it mid-flight
          (and its exception is swallowed either way)
  ASY204  a dict attribute shared with a spawned thread mutated outside
          any lock — dict ops are GIL-atomic individually, but
          check-then-act sequences interleave
  ASY205  fork-method multiprocessing in a module that imports torch
          or JAX — a forked CUDA context (or XLA runtime) hangs or
          corrupts silently

Scope: ``gateway/`` and ``obs/`` (the modules that own threads, loops
and processes).
"""
from __future__ import annotations

import ast
from typing import Iterable, Optional

from repro_torch.analysis.engine import (
    FileContext, Finding, Rule, call_name, const_str, dotted_name,
)

_TARGETS = (
    "src/repro_torch/gateway/**",
    "src/repro_torch/obs/**",
    "src/repro_torch/control/**",
)

# dotted call names that block the calling thread
_BLOCKING_CALLS = {
    "time.sleep",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "subprocess.getoutput",
    "socket.create_connection", "socket.getaddrinfo",
    "requests.get", "requests.post", "requests.put", "requests.request",
    "urllib.request.urlopen",
    "os.waitpid", "os.wait",
}
# method names that block when called on obvious blocking carriers
_BLOCKING_METHODS = {
    # concurrent.futures / multiprocessing results and joins
    "result", "join",
    # sync socket/file surface
    "recv", "accept", "sendall", "makefile",
}
_BLOCKING_METHOD_HINTS = ("sock", "socket", "proc", "process", "thread",
                          "future", "fut", "conn")


def _lockish(expr: ast.AST) -> bool:
    name = dotted_name(expr)
    last = name.rsplit(".", 1)[-1].lower()
    return "lock" in last or "sem" in last or last in ("mutex",)


def _iter_async_defs(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.AsyncFunctionDef):
            yield node


def _walk_same_async(fn: ast.AsyncFunctionDef):
    """Walk an async def's body without descending into nested *sync*
    defs (their bodies run on whatever thread calls them, not the
    loop) — nested async defs stay in scope."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def check_blocking_in_async(ctx: FileContext) -> Iterable[Finding]:
    for fn in _iter_async_defs(ctx.tree):
        for node in _walk_same_async(fn):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name in _BLOCKING_CALLS or name == "open":
                label = ("sync file I/O `open(...)`" if name == "open"
                         else f"`{name}`")
                yield ctx.finding(
                    "ASY201", node,
                    f"{label} inside `async def {fn.name}`: blocks the "
                    f"event loop (every connection stalls, the pump "
                    f"stops flushing) — use the asyncio equivalent or "
                    f"run_in_executor",
                )
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _BLOCKING_METHODS:
                base = dotted_name(node.func.value)
                last = base.rsplit(".", 1)[-1].lower()
                if any(h in last for h in _BLOCKING_METHOD_HINTS):
                    yield ctx.finding(
                        "ASY201", node,
                        f"`{base}.{node.func.attr}(...)` looks like a "
                        f"blocking call inside `async def {fn.name}` — "
                        f"await the async form or move it off the loop",
                    )


def check_lock_across_await(ctx: FileContext) -> Iterable[Finding]:
    for fn in _iter_async_defs(ctx.tree):
        for node in _walk_same_async(fn):
            if not isinstance(node, ast.With):  # sync `with` only: an
                continue                        # async with lock is fine
            if not any(_lockish(item.context_expr)
                       or (isinstance(item.context_expr, ast.Call)
                           and _lockish(item.context_expr.func))
                       for item in node.items):
                continue
            for sub in ast.walk(node):
                if isinstance(sub, ast.Await):
                    yield ctx.finding(
                        "ASY202", node,
                        f"sync lock held across `await` in `async def "
                        f"{fn.name}`: the loop suspends while holding "
                        f"it; a thread contending on the same lock "
                        f"deadlocks the loop — release before awaiting "
                        f"or use asyncio.Lock",
                    )
                    break


_TASK_SPAWNERS = ("create_task", "ensure_future")


def check_dropped_task(ctx: FileContext) -> Iterable[Finding]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Expr):
            continue
        call = node.value
        if isinstance(call, ast.Call) and \
                isinstance(call.func, ast.Attribute) and \
                call.func.attr in _TASK_SPAWNERS:
            shown = call_name(call) or f"...{call.func.attr}"
            yield ctx.finding(
                "ASY203", node,
                f"`{shown}(...)` result dropped: the event "
                f"loop keeps only a weak reference to tasks, so GC can "
                f"cancel this one mid-flight and its exception is never "
                f"observed — keep a reference (add to a set, discard in "
                f"a done callback)",
            )


class _ClassThreads(ast.NodeVisitor):
    """Per-class facts for ASY204: dict-typed attrs, lock attrs, thread
    entry points, and self-method call edges."""

    def __init__(self, cls: ast.ClassDef):
        self.cls = cls
        self.dict_attrs: set = set()
        self.lock_attrs: set = set()
        self.thread_targets: set = set()
        self.methods: dict = {
            n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        for m in self.methods.values():
            self._scan(m)

    def _scan(self, method: ast.AST) -> None:
        for node in ast.walk(method):
            target = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target = node.targets[0]
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                target = node.target  # self._workers: dict[...] = {}
            if target is not None and self._self_attr(target):
                attr = target.attr
                v = node.value
                if isinstance(v, (ast.Dict, ast.DictComp)) or (
                        isinstance(v, ast.Call)
                        and call_name(v) in ("dict", "defaultdict",
                                             "collections.defaultdict",
                                             "OrderedDict",
                                             "collections.OrderedDict")):
                    self.dict_attrs.add(attr)
                elif isinstance(v, ast.Call) and _lock_ctor(call_name(v)):
                    self.lock_attrs.add(attr)
            elif isinstance(node, ast.Call):
                name = call_name(node)
                if name.rsplit(".", 1)[-1] in ("Thread",) or \
                        (isinstance(node.func, ast.Attribute)
                         and node.func.attr == "submit"):
                    for kw in node.keywords:
                        if kw.arg == "target" and self._self_attr(kw.value):
                            self.thread_targets.add(kw.value.attr)
                    for a in node.args:
                        if self._self_attr(a):
                            self.thread_targets.add(a.attr)

    @staticmethod
    def _self_attr(node: ast.AST) -> bool:
        return (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self")

    def reachable_from_threads(self) -> set:
        """Thread entry methods plus self-methods they call (one fixed
        point, intra-class)."""
        seen = set(t for t in self.thread_targets if t in self.methods)
        frontier = list(seen)
        while frontier:
            m = self.methods.get(frontier.pop())
            if m is None:
                continue
            for node in ast.walk(m):
                if isinstance(node, ast.Call) and \
                        self._self_attr(node.func) and \
                        node.func.attr in self.methods and \
                        node.func.attr not in seen:
                    seen.add(node.func.attr)
                    frontier.append(node.func.attr)
        return seen


def _lock_ctor(name: str) -> bool:
    last = name.rsplit(".", 1)[-1]
    return last in ("Lock", "RLock", "Condition", "Semaphore",
                    "BoundedSemaphore")


_DICT_MUTATORS = {"pop", "update", "setdefault", "clear", "popitem"}


def check_unlocked_shared_dict(ctx: FileContext) -> Iterable[Finding]:
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        facts = _ClassThreads(cls)
        if not facts.thread_targets or not facts.dict_attrs:
            continue
        threaded = facts.reachable_from_threads()
        for mname in sorted(threaded):
            method = facts.methods[mname]
            for node in ast.walk(method):
                attr = _dict_mutation(node, facts.dict_attrs)
                if attr is None:
                    continue
                if _under_lock(method, node):
                    continue
                yield ctx.finding(
                    "ASY204", node,
                    f"`self.{attr}` (a dict shared with spawned "
                    f"threads) mutated in `{cls.name}.{mname}` outside "
                    f"any lock: individual dict ops are GIL-atomic but "
                    f"check-then-act sequences interleave across "
                    f"threads — hold the class lock around the mutation",
                )


def _dict_mutation(node: ast.AST, dict_attrs: set) -> Optional[str]:
    """The mutated attr name if ``node`` mutates ``self.<dict_attr>``."""
    if isinstance(node, ast.Assign):
        for t in node.targets:
            if isinstance(t, ast.Subscript) and \
                    _ClassThreads._self_attr(t.value) and \
                    t.value.attr in dict_attrs:
                return t.value.attr
    elif isinstance(node, ast.Delete):
        for t in node.targets:
            if isinstance(t, ast.Subscript) and \
                    _ClassThreads._self_attr(t.value) and \
                    t.value.attr in dict_attrs:
                return t.value.attr
    elif isinstance(node, ast.Call) and \
            isinstance(node.func, ast.Attribute) and \
            node.func.attr in _DICT_MUTATORS and \
            _ClassThreads._self_attr(node.func.value) and \
            node.func.value.attr in dict_attrs:
        return node.func.value.attr
    return None


def _under_lock(method: ast.AST, target: ast.AST) -> bool:
    """Is ``target`` lexically inside a ``with <lock>:`` in ``method``?"""
    for node in ast.walk(method):
        if isinstance(node, ast.With) and any(
                _lockish(item.context_expr)
                or (isinstance(item.context_expr, ast.Call)
                    and _lockish(item.context_expr.func))
                for item in node.items):
            for sub in ast.walk(node):
                if sub is target:
                    return True
    return False


# runtimes whose device state a forked child inherits broken
_FORK_UNSAFE = ("torch", "jax")


def _fork_unsafe_import(tree: ast.AST) -> Optional[str]:
    """The first fork-unsafe runtime the module imports, else None."""
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names = [node.module or ""]
        for name in names:
            top = name.split(".", 1)[0]
            if top in _FORK_UNSAFE:
                return top
    return None


def check_fork_multiprocessing(ctx: FileContext) -> Iterable[Finding]:
    runtime = _fork_unsafe_import(ctx.tree)
    # contexts known to be spawn: X = mp.get_context("spawn") makes
    # X.Process safe; track those names
    spawn_ctxs: set = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and call_name(node.value).endswith("get_context"):
            args = node.value.args
            method = const_str(args[0]) if args else None
            for t in node.targets:
                names = [n for n in ast.walk(t) if isinstance(n, ast.Name)]
                attrs = [n.attr for n in ast.walk(t)
                         if isinstance(n, ast.Attribute)]
                if method in (None, "fork", "forkserver"):
                    continue
                spawn_ctxs.update(n.id for n in names)
                spawn_ctxs.update(attrs)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        last = name.rsplit(".", 1)[-1]
        if last in ("get_context", "set_start_method"):
            method = const_str(node.args[0]) if node.args else None
            if method in ("fork", "forkserver") and runtime:
                yield ctx.finding(
                    "ASY205", node,
                    f"`{name}({method!r})` in a {runtime}-importing "
                    f"module: forked device runtime state deadlocks or "
                    f"corrupts silently — use the spawn start method",
                )
        elif last == "Process" and runtime:
            base = name.rsplit(".", 1)[0] if "." in name else ""
            base_last = base.rsplit(".", 1)[-1]
            if base_last in ("multiprocessing", "mp") or base == "":
                yield ctx.finding(
                    "ASY205", node,
                    f"`{name}(...)` uses the ambient start method "
                    f"(fork, on Linux) in a {runtime}-importing module — "
                    f"build processes from mp.get_context('spawn')",
                )


FILE_RULES = [
    Rule("ASY201", "blocking call inside async def",
         check_blocking_in_async, _TARGETS),
    Rule("ASY202", "sync lock held across await",
         check_lock_across_await, _TARGETS),
    Rule("ASY203", "create_task result dropped",
         check_dropped_task, _TARGETS),
    Rule("ASY204", "thread-shared dict mutated without a lock",
         check_unlocked_shared_dict, _TARGETS),
    Rule("ASY205", "fork-method multiprocessing with torch or JAX",
         check_fork_multiprocessing, _TARGETS),
]
