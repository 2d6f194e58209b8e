"""AST rule engine for the port's static-analysis gate.

A copy of ``repro/analysis/engine.py`` aimed at ``src/repro_torch``: the
same findings, fingerprints, baseline format and CLI contract, with the
port's own rule packs (``default_rules``) and its own baseline file
(``analysis/baseline_torch.json``).

The repo's core guarantee — every temporal schedule and every serving
layer above it is bit-equivalent to the solo oracle — is enforced
dynamically by the tier-1 suite, but whole hazard classes run fine,
pass the suite, and still bite later: a host sync inside a captured CUDA
graph, a lock held across an ``await`` that stalls the event loop, a
wire field produced by the client that the server never reads.  This
module is the mechanical checker for those classes.

Structure:

* :class:`Finding` — one diagnostic with a stable *fingerprint*
  (rule id + path + normalized source line + occurrence index, hashed)
  so baseline entries survive unrelated line drift.
* :class:`Rule` — a per-file check (``check(FileContext)``) targeted at
  path globs; :class:`RepoRule` — a cross-file check
  (``check_repo(RepoContext)``) for contracts that live between modules
  (wire protocol, telemetry rendering).
* :class:`AnalysisEngine` — parses each target file once, dispatches
  every matching rule, and splits the findings against a committed
  baseline: legacy findings carry a reviewed *reason* and don't block;
  anything new fails the run.

The engine is stdlib-only (``ast``): it imports neither torch nor numpy,
so the gate runs on a bare interpreter in seconds.
"""
from __future__ import annotations

import ast
import fnmatch
import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterable, Optional

BASELINE_VERSION = 1

# default analysis roots, relative to the repo root
DEFAULT_TARGETS = ("src/repro_torch",)


# ---------------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Finding:
    """One diagnostic: a rule id anchored to a file:line span."""

    rule_id: str
    path: str  # repo-relative, posix separators
    line: int
    col: int
    message: str
    snippet: str = ""
    # occurrence index among findings with identical (rule, path, snippet):
    # keeps fingerprints distinct when one line-shape repeats in a file
    occurrence: int = 0

    @property
    def fingerprint(self) -> str:
        """Stable id for baseline matching: hashes the rule, the path and
        the *normalized source line* (not the line number), so moving
        code within a file does not invalidate its baseline entry."""
        basis = "\x1f".join(
            (self.rule_id, self.path, " ".join(self.snippet.split()),
             str(self.occurrence))
        )
        return hashlib.sha1(basis.encode()).hexdigest()[:16]

    def to_dict(self) -> dict:
        return {
            "rule": self.rule_id,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "snippet": self.snippet,
            "fingerprint": self.fingerprint,
        }

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule_id} "
                f"{self.message}")


# ---------------------------------------------------------------------------
# parsed-file contexts
# ---------------------------------------------------------------------------


class FileContext:
    """One parsed target file handed to per-file rules."""

    def __init__(self, root: Path, path: Path, source: str, tree: ast.AST):
        self.root = root
        self.abspath = path
        try:
            self.path = path.relative_to(root).as_posix()
        except ValueError:  # explicit out-of-tree file (smoke gate tmp)
            self.path = path.as_posix()
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule_id: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(rule_id, self.path, line, col, message,
                       snippet=self.line_text(line))


class RepoContext:
    """Every parsed target file, for cross-file contract rules."""

    def __init__(self, root: Path, files: list[FileContext]):
        self.root = root
        self.files = files

    def by_basename(self, *names: str) -> list[FileContext]:
        return [f for f in self.files
                if Path(f.path).name in names
                or any(Path(f.path).name.endswith("_" + n) for n in names)]


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


@dataclass
class Rule:
    """A per-file check.  ``targets`` are repo-relative glob patterns the
    default walk applies; explicit file arguments bypass targeting so
    fixtures exercise every rule."""

    id: str
    title: str
    check: Callable[[FileContext], Iterable[Finding]]
    targets: tuple = ("src/repro_torch/**",)

    def matches(self, relpath: str) -> bool:
        return any(fnmatch.fnmatch(relpath, pat) for pat in self.targets)


@dataclass
class RepoRule:
    """A cross-file check over the whole parsed file set."""

    id: str
    title: str
    check_repo: Callable[[RepoContext], Iterable[Finding]]


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------


@dataclass
class Baseline:
    """Committed suppression set: fingerprint -> reviewed reason.

    Mirrors the benchmark gate's committed-baseline pattern: legacy
    findings are admitted explicitly (with a human reason — never
    silently) while anything new fails the run until fixed or reviewed.
    """

    entries: dict = field(default_factory=dict)  # fingerprint -> entry dict

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        if not path.exists():
            return cls()
        data = json.loads(path.read_text())
        if data.get("version") != BASELINE_VERSION:
            raise ValueError(
                f"unsupported baseline version {data.get('version')!r} "
                f"in {path} (expected {BASELINE_VERSION})"
            )
        entries = {}
        for e in data.get("entries", []):
            if not e.get("reason"):
                # the zero-silent-suppressions rule is structural: an
                # entry with no reason is invalid, not quietly honoured
                raise ValueError(
                    f"baseline entry {e.get('fingerprint')!r} in {path} "
                    f"has no reason; every suppression must say why"
                )
            entries[e["fingerprint"]] = e
        return cls(entries)

    def save(self, path: Path) -> None:
        payload = {
            "version": BASELINE_VERSION,
            "entries": sorted(self.entries.values(),
                              key=lambda e: (e["rule"], e["path"],
                                             e["fingerprint"])),
        }
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(payload, indent=2) + "\n")

    def split(self, findings: list) -> tuple[list, list, list]:
        """Partition ``findings`` into ``(new, suppressed, stale_entries)``:
        ``new`` fail the run, ``suppressed`` match a baseline entry,
        ``stale_entries`` are baseline entries whose finding no longer
        exists (fixed — prune them with ``--update-baseline``)."""
        new, suppressed = [], []
        seen = set()
        for f in findings:
            fp = f.fingerprint
            if fp in self.entries:
                suppressed.append(f)
                seen.add(fp)
            else:
                new.append(f)
        stale = [e for fp, e in sorted(self.entries.items())
                 if fp not in seen]
        return new, suppressed, stale

    def update(self, findings: list,
               default_reason: str = "unreviewed (added by "
                                     "--update-baseline; replace with a "
                                     "real reason before committing)") -> None:
        """Re-baseline: keep reviewed reasons for findings that persist,
        add new entries with a placeholder reason, prune fixed ones."""
        fresh: dict = {}
        for f in findings:
            fp = f.fingerprint
            old = self.entries.get(fp)
            fresh[fp] = {
                "fingerprint": fp,
                "rule": f.rule_id,
                "path": f.path,
                "line": f.line,
                "snippet": f.snippet,
                "reason": old["reason"] if old else default_reason,
            }
        self.entries = fresh


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


def default_rules() -> tuple[list, list]:
    """The shipped rule packs ``(file_rules, repo_rules)``."""
    from repro_torch.analysis import rules_async, rules_contract, rules_torch

    file_rules = (list(rules_torch.FILE_RULES)
                  + list(rules_async.FILE_RULES)
                  + list(rules_contract.FILE_RULES))
    repo_rules = list(rules_contract.REPO_RULES)
    return file_rules, repo_rules


class AnalysisEngine:
    """Parse once, dispatch every rule, report findings.

    >>> eng = AnalysisEngine(repo_root)
    >>> findings = eng.run()                       # default targeted walk
    >>> findings = eng.run([Path("bad.py")])       # explicit files: every
    ...                                            # rule runs, no targeting
    """

    def __init__(self, root, file_rules: Optional[list] = None,
                 repo_rules: Optional[list] = None):
        self.root = Path(root).resolve()
        if file_rules is None and repo_rules is None:
            file_rules, repo_rules = default_rules()
        self.file_rules = list(file_rules or [])
        self.repo_rules = list(repo_rules or [])
        self.parse_errors: list[Finding] = []

    def rule_ids(self) -> list[str]:
        return sorted([r.id for r in self.file_rules]
                      + [r.id for r in self.repo_rules])

    def _iter_default_files(self) -> list[Path]:
        out = []
        for target in DEFAULT_TARGETS:
            base = self.root / target
            if base.is_file():
                out.append(base)
            elif base.is_dir():
                out.extend(sorted(base.rglob("*.py")))
        return out

    def _parse(self, path: Path) -> Optional[FileContext]:
        try:
            source = path.read_text()
            tree = ast.parse(source, filename=str(path))
        except (SyntaxError, UnicodeDecodeError, OSError) as exc:
            rel = (path.relative_to(self.root).as_posix()
                   if path.is_relative_to(self.root) else str(path))
            self.parse_errors.append(Finding(
                "ENGINE000", rel, getattr(exc, "lineno", 1) or 1, 0,
                f"file could not be analysed: {type(exc).__name__}: {exc}",
                snippet=f"<parse error: {type(exc).__name__}>",
            ))
            return None
        return FileContext(self.root, path, source, tree)

    def run(self, paths: Optional[Iterable] = None) -> list[Finding]:
        """Analyse ``paths`` (default: the targeted repo walk).  With
        explicit paths every rule runs on every file — that is how the
        fixture tests and the smoke gate exercise single rules — while
        the default walk applies each rule's ``targets`` globs."""
        self.parse_errors = []
        explicit = paths is not None
        files = ([Path(p).resolve() for p in paths] if explicit
                 else self._iter_default_files())
        contexts = [ctx for ctx in (self._parse(p) for p in files)
                    if ctx is not None]
        findings: list[Finding] = list(self.parse_errors)
        for ctx in contexts:
            for rule in self.file_rules:
                if explicit or rule.matches(ctx.path):
                    findings.extend(rule.check(ctx))
        repo_ctx = RepoContext(self.root, contexts)
        for rule in self.repo_rules:
            findings.extend(rule.check_repo(repo_ctx))
        return _number_occurrences(
            sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule_id))
        )


def _number_occurrences(findings: list) -> list:
    """Assign occurrence indices so findings with identical
    (rule, path, snippet) keep distinct fingerprints in file order."""
    seen: dict = {}
    out = []
    for f in findings:
        key = (f.rule_id, f.path, " ".join(f.snippet.split()))
        n = seen.get(key, 0)
        seen[key] = n + 1
        out.append(Finding(f.rule_id, f.path, f.line, f.col, f.message,
                           f.snippet, occurrence=n) if n != f.occurrence
                   else f)
    return out


# ---------------------------------------------------------------------------
# shared AST helpers (used by the rule packs)
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> str:
    """``torch.cuda.synchronize`` for the matching Attribute/Name chain, else ''."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def call_name(call: ast.Call) -> str:
    return dotted_name(call.func)


def walk_scoped(node: ast.AST, *, into_functions: bool = True):
    """``ast.walk`` that can stop at nested function/class boundaries."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        yield child
        if not into_functions and isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                        ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(child))


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None
