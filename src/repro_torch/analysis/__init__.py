"""Repo-aware static analysis of the port: CUDA-graph capture-safety,
concurrency-hazard and wire/telemetry-contract lints with a
committed-baseline gate (``analysis/baseline_torch.json``).

Run as ``python -m repro_torch.analysis`` (see ``__main__.py``); the engine
and rule packs are importable for the fixture tests::

    from repro_torch.analysis import AnalysisEngine, Baseline, default_rules
"""
from repro_torch.analysis.engine import (
    AnalysisEngine, Baseline, FileContext, Finding, RepoContext, RepoRule,
    Rule, default_rules,
)

__all__ = [
    "AnalysisEngine", "Baseline", "FileContext", "Finding", "RepoContext",
    "RepoRule", "Rule", "default_rules",
]
