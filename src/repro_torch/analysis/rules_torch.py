"""CUDA-graph capture-safety rules (TOR1xx): the port's counterpart of
``repro/analysis/rules_jax.py``.

The port has no tracer.  Its counterpart of ``jax.jit`` is a captured CUDA
graph (``engine/capture.py``): a program runs once as Python while the
graph records its kernels, and every later call replays the kernels
alone.  So the hazards of a jitted body return in a new form.  A Python
branch on a tensor's value syncs the host (illegal while capturing) or
freezes the branch taken at capture; Python state updated in the body
changes once, at capture, never on replay; a host read or a copy of fresh
host data inside the body is illegal while capturing, or replays the data
seen at capture.  All of these pass an eager CPU test run, because on the
CPU nothing is captured.

Scope: functions *reachable, within the same file, from a capture site*:

* the ``fn`` passed to ``GraphCache.run(key, fn, args)``,
  ``Engine.run_program(name, fn, args)`` and the engine's helpers that
  forward to it (``run_on_shards``, whose ``fn`` takes the shard index
  first, and ``_run_rows``), or to ``CapturedProgram(fn, ...)``;
* the callables given to ``torch.cuda.make_graphed_callables``;
* the body of a ``with torch.cuda.graph(...)`` block;

and the local functions and methods those call (fixed point; a method is
found by name through ``self.<name>``).  A captured function's tensor
params are its params less ``self``, those a ``functools.partial`` or the
capture site binds, and those annotated with a plain Python type; a light
forward taint pass follows assignments and tensor methods.

Rules::

  TOR101  Python branch (`if`/`while`/`assert`) on a tensor's value
  TOR102  Python side effect inside a captured body (print / global /
          mutation of closure or module state / a Python counter bumped)
  TOR103  host read of a tensor (.item() / .tolist() / .cpu() /
          .numpy() / np.* on a tensor / a synchronize)
  TOR104  host-to-device copy of fresh host data (torch.tensor /
          torch.as_tensor / torch.from_numpy)
  TOR105  f-string or id() used as a graph-cache key
  TOR106  torch.cuda touched at import time of a gateway/control module
          (the worker supervisor imports them before it spawns)
"""
from __future__ import annotations

import ast
from typing import Iterable, Optional

from repro_torch.analysis.engine import (
    FileContext, Finding, Rule, call_name, dotted_name,
)

_TARGETS = tuple(f"src/repro_torch/{pkg}/**"
                 for pkg in ("engine", "serving", "gateway", "kernels", "core"))
# the modules the worker supervisor imports before it spawns
_IMPORT_TARGETS = ("src/repro_torch/gateway/**", "src/repro_torch/control/**")

# capture sites called as methods: name -> (index of the captured callable
# among the positional args, leading params of it the site binds)
_CAPTURE_METHODS = {
    "run_program": (1, 0),     # Engine.run_program(name, fn, args)
    "run_on_shards": (1, 1),   # fn(shard_index, *block)
    "_run_rows": (1, 0),       # forwards program(params, *args) to run_program
    "run": (1, 0),             # GraphCache.run(key, fn, args)
}
# capture sites called as functions or constructors: name -> arg index
_CAPTURE_CALLS = {
    "CapturedProgram": 0,
    "capture.CapturedProgram": 0,
    "torch.cuda.make_graphed_callables": 0,
    "make_graphed_callables": 0,
}
_GRAPH_CONTEXTS = {"torch.cuda.graph", "cuda.graph"}
_PARTIALS = {"partial", "functools.partial"}

# tensor metadata: static while capturing
_SAFE_ATTRS = {
    "shape", "ndim", "dtype", "device", "is_cuda", "layout",
    "requires_grad", "is_leaf",
}
_SAFE_METHODS = {
    "size", "dim", "numel", "stride", "data_ptr", "element_size",
    "get_device", "is_contiguous", "is_floating_point", "is_complex",
}
_SAFE_CALLS = {
    "len", "isinstance", "hasattr", "getattr", "type", "issubclass",
    "callable", "repr", "str", "id",
}
_TENSOR_PRODUCERS = ("torch.", "F.", "torch.nn.functional.")
# torch.* calls that return host metadata, not a tensor
_TORCH_META_CALLS = {
    "torch.Size", "torch.device", "torch.dtype", "torch.finfo",
    "torch.iinfo", "torch.is_tensor", "torch.is_floating_point",
    "torch.get_default_dtype", "torch.is_grad_enabled",
}

_HOST_READ_METHODS = {"item", "tolist", "cpu", "numpy"}
_SYNC_CALLS = {"torch.cuda.synchronize", "cuda.synchronize"}
_H2D_CALLS = {"torch.tensor", "torch.as_tensor", "torch.from_numpy"}

_MUTATORS = {"append", "extend", "insert", "add", "update", "setdefault",
             "pop", "popitem", "clear", "remove", "discard"}

# annotations that mark a param as Python config, never a tensor
_STATIC_ANNOTATIONS = {"bool", "str", "bytes", "int", "float"}

# ---------------------------------------------------------------------------
# captured-function discovery
# ---------------------------------------------------------------------------


def _is_graph_cache(expr: ast.AST) -> bool:
    """Does ``expr`` name a graph cache (``graphs``, ``self._graphs``,
    ``cache``)?  Keeps ``asyncio.run`` and ``subprocess.run`` out."""
    last = dotted_name(expr).rsplit(".", 1)[-1].lower()
    return "graph" in last or "cache" in last


class _CapturedSet:
    """Functions reachable from a capture site, with their bound params."""

    def __init__(self, tree: ast.AST):
        # every def in the file by name (methods too: ``self.name``
        # resolves to them; the last definition wins)
        self.defs: dict[str, ast.AST] = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs[node.name] = node
        self.bound: dict[ast.AST, int] = {}        # fn -> leading params bound
        self.bound_names: dict[ast.AST, set] = {}  # fn -> keyword-bound params
        self.bodies: list = []                     # `with torch.cuda.graph` blocks
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                self._mark_site(node)
            elif isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    isinstance(item.context_expr, ast.Call)
                    and call_name(item.context_expr) in _GRAPH_CONTEXTS
                    for item in node.items):
                self.bodies.append(node)
                for stmt in node.body:
                    self._mark_calls(stmt)
        # fixed point: functions called from a captured function run while
        # the graph records, so they are captured too
        frontier = list(self.bound)
        while frontier:
            self._mark_calls(frontier.pop(), frontier)

    def _mark_site(self, call: ast.Call) -> None:
        name = call_name(call)
        index, bound = None, 0
        if name in _CAPTURE_CALLS:
            index = _CAPTURE_CALLS[name]
        elif isinstance(call.func, ast.Attribute) and \
                call.func.attr in _CAPTURE_METHODS:
            index, bound = _CAPTURE_METHODS[call.func.attr]
            if call.func.attr == "run" and not _is_graph_cache(call.func.value):
                return
        if index is None or len(call.args) <= index:
            return
        target = call.args[index]
        targets = target.elts if isinstance(target, (ast.Tuple, ast.List)) else [target]
        for t in targets:
            self._mark(t, bound, set())

    def _mark(self, expr: ast.AST, bound: int, names: set,
              frontier: Optional[list] = None) -> None:
        """Mark the function ``expr`` evaluates to as captured, with
        ``bound`` leading params (and ``names``) bound by the caller."""
        if isinstance(expr, ast.Call) and call_name(expr) in _PARTIALS and expr.args:
            self._mark(expr.args[0], bound + len(expr.args) - 1,
                       names | {kw.arg for kw in expr.keywords if kw.arg}, frontier)
            return
        fn = None
        if isinstance(expr, ast.Lambda):
            fn = expr
        elif isinstance(expr, ast.Name):
            fn = self.defs.get(expr.id)
        elif isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name) \
                and expr.value.id in ("self", "cls"):
            fn = self.defs.get(expr.attr)
        if fn is None or fn in self.bound:
            return
        self.bound[fn] = bound
        self.bound_names[fn] = names
        if frontier is not None:
            frontier.append(fn)

    def _mark_calls(self, node: ast.AST, frontier: Optional[list] = None) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._mark(sub.func, 0, set(), frontier)

    def data_params(self, fn: ast.AST) -> set:
        args = fn.args
        positional = [a for a in list(args.posonlyargs) + list(args.args)
                      if a.arg not in ("self", "cls")]
        positional = positional[self.bound.get(fn, 0):]
        params = positional + list(args.kwonlyargs)
        names = {a.arg for a in params
                 if a.annotation is None
                 or dotted_name(a.annotation) not in _STATIC_ANNOTATIONS}
        if args.vararg:
            names.add(args.vararg.arg)
        return names - self.bound_names.get(fn, set())


def _scopes(ctx: FileContext):
    """``(scope node, name, tensor-valued names)`` for every captured
    function and every ``with torch.cuda.graph`` block of the file."""
    cs = _CapturedSet(ctx.tree)
    for fn in list(cs.bound):
        yield fn, _fn_name(fn), _taint(fn, cs.data_params(fn))
    for block in cs.bodies:
        yield block, "a torch.cuda.graph block", _taint(block, set())


def _fn_name(fn: ast.AST) -> str:
    return getattr(fn, "name", "<lambda>")


# ---------------------------------------------------------------------------
# taint within one captured function
# ---------------------------------------------------------------------------


def _taint(fn: ast.AST, seeds: set) -> set:
    """Names carrying tensors: the data params plus anything assigned from
    a tainted expression or a torch producer call.  Two passes are enough
    for the straight-line bodies this repo writes."""
    tainted = set(seeds)
    for _ in range(2):
        for node in ast.walk(fn):
            value = None
            targets: list = []
            if isinstance(node, ast.Assign):
                value, targets = node.value, node.targets
            elif isinstance(node, ast.AugAssign):
                value, targets = node.value, [node.target]
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                value, targets = node.value, [node.target]
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                value, targets = node.iter, [node.target]
            if value is None or not _expr_tensor(value, tainted):
                continue
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        tainted.add(n.id)
    return tainted


def _expr_tensor(expr: ast.AST, tainted: set) -> bool:
    """Does ``expr`` (likely) evaluate to a tensor's value?"""
    if isinstance(expr, ast.Name):
        return expr.id in tainted
    if isinstance(expr, ast.Constant):
        return False
    if isinstance(expr, ast.Attribute):
        if expr.attr in _SAFE_ATTRS:
            return False
        return _expr_tensor(expr.value, tainted)
    if isinstance(expr, ast.Call):
        name = call_name(expr)
        if name in _SAFE_CALLS or name in _TORCH_META_CALLS:
            return False
        if isinstance(expr.func, ast.Attribute):
            if expr.func.attr in _SAFE_METHODS:
                return False
            if _expr_tensor(expr.func.value, tainted):
                return True   # a tensor method: x.sum(), x.to(...)
        if any(name.startswith(p) for p in _TENSOR_PRODUCERS):
            return True
        return any(_expr_tensor(a, tainted) for a in expr.args) or any(
            _expr_tensor(kw.value, tainted) for kw in expr.keywords)
    if isinstance(expr, ast.Compare):
        comparators = [expr.left] + list(expr.comparators)
        if all(isinstance(c, ast.Constant) and c.value is None
               for c in comparators[1:]):
            return False  # `x is None` asks about the object, not its value
        return any(_expr_tensor(c, tainted) for c in comparators)
    if isinstance(expr, (ast.BoolOp, ast.BinOp, ast.UnaryOp, ast.IfExp,
                         ast.Subscript, ast.Tuple, ast.List, ast.Starred)):
        return any(_expr_tensor(c, tainted)
                   for c in ast.iter_child_nodes(expr)
                   if isinstance(c, ast.expr))
    return False


def _local_bindings(scope: ast.AST) -> set:
    """Names bound inside ``scope``: params, assignments, loop vars,
    withitems, comprehension vars, nested defs — mutation of anything else
    changes state outside the captured body."""
    bound: set = set()
    args = getattr(scope, "args", None)
    if args is not None:
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)
                  + ([args.vararg] if args.vararg else [])
                  + ([args.kwarg] if args.kwarg else [])):
            bound.add(a.arg)
    for node in ast.walk(scope):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and node is not scope:
            bound.add(node.name)
        elif isinstance(node, ast.Name) and isinstance(
                node.ctx, (ast.Store, ast.Del)):
            bound.add(node.id)
        elif isinstance(node, ast.comprehension):
            for n in ast.walk(node.target):
                if isinstance(n, ast.Name):
                    bound.add(n.id)
    return bound


def _outer_state(target: ast.AST, local: set) -> bool:
    """Does assigning to ``target`` write state that outlives the body:
    an attribute or item of anything, or a name not bound locally?"""
    if isinstance(target, ast.Name):
        return target.id not in local
    return isinstance(target, (ast.Attribute, ast.Subscript))


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


def check_tensor_branch(ctx: FileContext) -> Iterable[Finding]:
    for scope, name, tainted in _scopes(ctx):
        for node in ast.walk(scope):
            if not isinstance(node, (ast.If, ast.While, ast.Assert)):
                continue
            if _expr_tensor(node.test, tainted):
                kind = type(node).__name__.lower()
                yield ctx.finding(
                    "TOR101", node,
                    f"`{kind}` on a tensor's value inside `{name}` "
                    f"(reachable from a CUDA-graph capture site): it syncs "
                    f"the host, which a capture forbids, and a replay keeps "
                    f"the branch taken at capture — use torch.where or a "
                    f"mask, or decide on the host before the call",
                )


def check_side_effect(ctx: FileContext) -> Iterable[Finding]:
    for scope, name, tainted in _scopes(ctx):
        local = _local_bindings(scope)
        for node in ast.walk(scope):
            if isinstance(node, ast.Call) and call_name(node) == "print":
                yield ctx.finding(
                    "TOR102", node,
                    f"print() inside captured `{name}`: runs once, at "
                    f"capture, never on replay — print outside the "
                    f"captured program",
                )
            elif isinstance(node, (ast.Global, ast.Nonlocal)):
                yield ctx.finding(
                    "TOR102", node,
                    f"`{type(node).__name__.lower()}` inside captured "
                    f"`{name}`: the rebinding happens at capture only; "
                    f"replays leave the outer name as it was",
                )
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _MUTATORS and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id not in local:
                yield ctx.finding(
                    "TOR102", node,
                    f"`{node.func.value.id}.{node.func.attr}(...)` "
                    f"mutates non-local state inside captured `{name}`: "
                    f"runs once at capture, never on replay",
                )
            elif isinstance(node, ast.AugAssign) and \
                    _outer_state(node.target, local) and \
                    not _expr_tensor(node.value, tainted):
                # a tensor's `+=` is an in-place kernel the graph records;
                # a Python number's is not
                yield ctx.finding(
                    "TOR102", node,
                    f"`{dotted_name(node.target) or 'state'} "
                    f"{type(node.op).__name__}=` of a Python value inside "
                    f"captured `{name}`: counts once, at capture, never on "
                    f"replay — keep the count outside the captured program "
                    f"(or in a device tensor)",
                )


def check_host_read(ctx: FileContext) -> Iterable[Finding]:
    for scope, name, tainted in _scopes(ctx):
        for node in ast.walk(scope):
            if not isinstance(node, ast.Call):
                continue
            cn = call_name(node)
            what = None
            if cn in _SYNC_CALLS or (isinstance(node.func, ast.Attribute)
                                     and node.func.attr == "synchronize"):
                what = f"`{cn or 'synchronize'}()`"
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _HOST_READ_METHODS and not node.args:
                what = f"`.{node.func.attr}()`"
            elif (cn.startswith("np.") or cn.startswith("numpy.")) and (
                    any(_expr_tensor(a, tainted) for a in node.args)
                    or any(_expr_tensor(kw.value, tainted)
                           for kw in node.keywords)):
                what = f"`{cn}` on a tensor"
            if what:
                yield ctx.finding(
                    "TOR103", node,
                    f"{what} inside captured `{name}`: a host read of the "
                    f"device waits for it, which a capture forbids, and a "
                    f"replay never repeats it — read results after the "
                    f"program returns",
                )


def check_fresh_host_copy(ctx: FileContext) -> Iterable[Finding]:
    for scope, name, _ in _scopes(ctx):
        for node in ast.walk(scope):
            if isinstance(node, ast.Call) and call_name(node) in _H2D_CALLS:
                yield ctx.finding(
                    "TOR104", node,
                    f"`{call_name(node)}(...)` inside captured `{name}`: "
                    f"the host data is copied once, at capture, and every "
                    f"replay reuses that copy — pass the data in as an "
                    f"argument (the capture copies arguments in per call)",
                )


def _unstable_key(expr: ast.AST) -> Optional[str]:
    for node in ast.walk(expr):
        if isinstance(node, ast.JoinedStr):
            return "an f-string"
        if isinstance(node, ast.Call) and call_name(node) == "id":
            return "id(...)"
    return None


def _graph_key(node: ast.AST) -> Optional[tuple]:
    """``(key expr, container expr)`` where ``node`` keys a graph cache:
    ``cache[k]``, ``cache.get(k)``, ``graphs.run(k, ...)`` or the program
    name of ``run_program``/``run_on_shards``/``_run_rows``."""
    if isinstance(node, ast.Subscript) and _is_graph_cache(node.value):
        return node.slice, node.value
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.args):
        return None
    attr, base = node.func.attr, node.func.value
    if attr in ("get", "setdefault", "pop", "run") and _is_graph_cache(base):
        return node.args[0], base
    if attr in _CAPTURE_METHODS and attr != "run":
        return node.args[0], node.func
    return None


def check_cache_key(ctx: FileContext) -> Iterable[Finding]:
    for node in ast.walk(ctx.tree):
        found = _graph_key(node)
        if found is None:
            continue
        what = _unstable_key(found[0])
        if what:
            yield ctx.finding(
                "TOR105", node,
                f"{what} used as a key into `{dotted_name(found[1])}`: "
                f"id() values are recycled after GC and f-strings hash by "
                f"rendered text — a recycled id replays another program's "
                f"graph, a text that differs captures anew; key on a "
                f"structural tuple",
            )


def _import_time_nodes(tree: ast.Module):
    """The nodes a module runs when it is imported: top-level statements,
    class bodies, decorators and defaults — not function bodies, and not an
    ``if __name__ == "__main__":`` block."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(node.decorator_list)
            stack.extend(d for d in node.args.defaults + node.args.kw_defaults
                         if d is not None)
            continue
        if isinstance(node, ast.Lambda):
            continue
        if isinstance(node, ast.If) and _is_main_guard(node.test):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _is_main_guard(test: ast.AST) -> bool:
    return (isinstance(test, ast.Compare) and isinstance(test.left, ast.Name)
            and test.left.id == "__name__")


def check_cuda_at_import(ctx: FileContext) -> Iterable[Finding]:
    for node in _import_time_nodes(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        if name.startswith("torch.cuda.") or name.startswith("cuda."):
            yield ctx.finding(
                "TOR106", node,
                f"`{name}(...)` runs when this module is imported: the "
                f"worker supervisor imports the gateway and the control "
                f"plane before it spawns its workers, so CUDA would be "
                f"initialised in a parent that must stay free of it — "
                f"call it inside the function that needs it",
            )


FILE_RULES = [
    Rule("TOR101", "Python branch on a tensor's value in a captured body",
         check_tensor_branch, _TARGETS),
    Rule("TOR102", "Python side effect inside a captured body",
         check_side_effect, _TARGETS),
    Rule("TOR103", "host read of a tensor in a captured body",
         check_host_read, _TARGETS),
    Rule("TOR104", "copy of fresh host data in a captured body",
         check_fresh_host_copy, _TARGETS),
    Rule("TOR105", "f-string / id() graph-cache key", check_cache_key, _TARGETS),
    Rule("TOR106", "torch.cuda touched at import time",
         check_cuda_at_import, _IMPORT_TARGETS),
]
