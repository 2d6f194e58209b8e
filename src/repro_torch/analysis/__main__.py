"""CLI for the static-analysis gate: ``python -m repro_torch.analysis``.

Mirrors ``benchmarks/check.py``'s conventions — exit 0 when the tree is
clean against the committed baseline, exit 1 on any non-baselined
finding, and an ``--update-baseline`` flag that admits the current
finding set instead of comparing (commit the result with reasons; the
loader rejects entries whose reason is missing, and fresh entries carry
an explicit "unreviewed" placeholder so nothing is suppressed silently).

Usage::

    PYTHONPATH=src python -m repro_torch.analysis                 # gate the port
    PYTHONPATH=src python -m repro_torch.analysis --format json   # machine output
    PYTHONPATH=src python -m repro_torch.analysis path/to/file.py # explicit files
                                                                  # (all rules run,
                                                                  # no targeting)
    PYTHONPATH=src python -m repro_torch.analysis --update-baseline

Stale baseline entries (their finding no longer occurs — it was fixed)
are reported as NOTEs and do not fail the run; prune them with
``--update-baseline``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.engine import AnalysisEngine, Baseline, default_rules

# the port's baseline, beside the reference's analysis/baseline.json
BASELINE_NAME = "baseline_torch.json"


def _default_root() -> Path:
    """The repo root: nearest ancestor of this file carrying ROADMAP.md
    (falls back to CWD for out-of-tree installs)."""
    here = Path(__file__).resolve()
    for parent in here.parents:
        if (parent / "ROADMAP.md").exists() and (parent / "src").is_dir():
            return parent
    return Path.cwd()


def _report_payload(new, suppressed, stale) -> dict:
    return {
        "ok": not new,
        "findings": [f.to_dict() for f in new],
        "suppressed": [
            {**f.to_dict(), "reason": e["reason"]}
            for f, e in suppressed
        ],
        "stale_baseline_entries": stale,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repo-aware static analysis of the port: CUDA-graph "
                    "capture-safety, concurrency-hazard and contract lints with a "
                    "committed-baseline gate",
    )
    ap.add_argument("paths", nargs="*", metavar="FILE",
                    help="explicit files to analyse (every rule runs, "
                         "targeting globs are bypassed); default: the "
                         "targeted src/repro_torch walk")
    ap.add_argument("--root", default=None,
                    help="repo root (default: auto-detected)")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="baseline file (default: <root>/analysis/"
                         "baseline_torch.json); pass an empty string to gate "
                         "with no baseline at all")
    ap.add_argument("--update-baseline", action="store_true",
                    help="write the current finding set to the baseline "
                         "instead of comparing (keeps reviewed reasons, "
                         "prunes fixed entries, marks new ones "
                         "'unreviewed' for you to justify before "
                         "committing)")
    ap.add_argument("--format", choices=("text", "json"), default="text",
                    help="stdout format (default text)")
    ap.add_argument("--report", default=None, metavar="FILE",
                    help="also write the JSON findings report here "
                         "(for a CI job to keep as an artifact)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print every registered rule id and exit")
    args = ap.parse_args(argv)

    root = Path(args.root).resolve() if args.root else _default_root()
    engine = AnalysisEngine(root)

    if args.list_rules:
        file_rules, repo_rules = default_rules()
        for rule in sorted(file_rules + repo_rules, key=lambda r: r.id):
            scope = ", ".join(getattr(rule, "targets", ())) or "repo-wide"
            print(f"{rule.id}  {rule.title}  [{scope}]")
        return 0

    findings = engine.run(args.paths or None)

    baseline_path = (Path(args.baseline) if args.baseline
                     else root / "analysis" / BASELINE_NAME
                     if args.baseline is None else None)
    baseline = Baseline.load(baseline_path) if baseline_path else Baseline()

    if args.update_baseline:
        if baseline_path is None:
            ap.error("--update-baseline needs a baseline path")
        baseline.update(findings)
        baseline.save(baseline_path)
        unreviewed = sum(1 for e in baseline.entries.values()
                         if e["reason"].startswith("unreviewed"))
        print(f"baseline written: {baseline_path} "
              f"({len(baseline.entries)} entries, {unreviewed} awaiting a "
              f"review reason)")
        return 0

    new, suppressed_findings, stale = baseline.split(findings)
    suppressed = [(f, baseline.entries[f.fingerprint])
                  for f in suppressed_findings]
    payload = _report_payload(new, suppressed, stale)

    if args.report:
        report_path = Path(args.report)
        report_path.parent.mkdir(parents=True, exist_ok=True)
        report_path.write_text(json.dumps(payload, indent=2) + "\n")

    if args.format == "json":
        print(json.dumps(payload, indent=2))
    else:
        for f in new:
            print(f"FAIL  {f.render()}")
            if f.snippet:
                print(f"      > {f.snippet}")
        for f, entry in suppressed:
            print(f"OK    {f.render()} [baselined: {entry['reason']}]")
        for entry in stale:
            print(f"NOTE  stale baseline entry {entry['fingerprint']} "
                  f"({entry['rule']} {entry['path']}): finding no longer "
                  f"occurs — prune with --update-baseline")
        print(f"\nanalysis: {len(new)} new finding(s), "
              f"{len(suppressed)} baselined, {len(stale)} stale "
              f"baseline entr{'y' if len(stale) == 1 else 'ies'}")
        if new:
            print("new findings fail the gate — fix them, or add a "
                  "reasoned baseline entry (--update-baseline, then "
                  "replace the 'unreviewed' placeholder)")
        else:
            print("analysis gate: OK")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
