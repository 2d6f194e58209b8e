"""The port's static-analysis gate (``repro_torch.analysis``): its ASY/CON
rules held to the reference engine's findings, on the reference's
fixtures and on the whole of ``src/repro_torch``; each TOR rule against a
known-bad fixture at exact lines (``tests/fixtures/analysis_torch/``);
the default walk of the port clean against ``analysis/baseline_torch.json``;
and the CLI's baseline round trip, JSON report and ``--update-baseline``.

Each case runs the engine with EXPLICIT paths, which bypasses targeting
globs and runs every rule, so each expected set doubles as a
no-false-positive check: any other rule firing fails the exact-set
assertion."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.analysis import AnalysisEngine as RefEngine  # noqa: E402
from repro_torch.analysis import AnalysisEngine, Baseline, default_rules  # noqa: E402
from repro_torch.analysis.__main__ import main as cli_main  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF_FIXTURES = Path(__file__).parent / "fixtures" / "analysis"
FIXTURES = Path(__file__).parent / "fixtures" / "analysis_torch"
PORT = ROOT / "src" / "repro_torch"
BASELINE = ROOT / "analysis" / "baseline_torch.json"

# tests/test_analysis.py's ASY, CON and ENGINE cases, on the reference's
# fixtures: rule id under test, fixture files, exact {(rule, line), ...}
REF_CASES = [
    ("ASY201", ["asy201.py"], {("ASY201", 5), ("ASY201", 6)}),
    ("ASY202", ["asy202.py"], {("ASY202", 7)}),
    ("ASY203", ["asy203.py"], {("ASY203", 2)}),
    ("ASY204", ["asy204.py"], {("ASY204", 11)}),
    ("ASY205", ["asy205.py"], {("ASY205", 7), ("ASY205", 8)}),
    ("CON301", ["wire_client.py", "wire_server.py"],
     {("CON301", 3), ("CON302", 7)}),
    ("CON302", ["wire_client.py", "wire_server.py"],
     {("CON301", 3), ("CON302", 7)}),
    ("CON303", ["tel_gateway.py", "tel_prometheus.py"], {("CON303", 5)}),
    ("CON304", ["con304.py"], {("CON304", 4), ("CON304", 8)}),
    ("ENGINE000", ["broken.py"], {("ENGINE000", 1)}),
]

# the port's own rules, on tests/fixtures/analysis_torch/
TOR_CASES = [
    ("TOR101", ["tor101.py"], {("TOR101", 6), ("TOR101", 8), ("TOR101", 10)}),
    ("TOR102", ["tor102.py"], {("TOR102", 12), ("TOR102", 13), ("TOR102", 14),
                               ("TOR102", 15)}),
    ("TOR103", ["tor103.py"], {("TOR103", 8), ("TOR103", 9), ("TOR103", 10),
                               ("TOR103", 11), ("TOR103", 12)}),
    ("TOR104", ["tor104.py"], {("TOR104", 9), ("TOR104", 10), ("TOR104", 11)}),
    ("TOR105", ["tor105.py"], {("TOR105", 5), ("TOR105", 9), ("TOR105", 13)}),
    ("TOR106", ["tor106.py"], {("TOR106", 3), ("TOR106", 7)}),
    # a `with torch.cuda.graph` body and make_graphed_callables are
    # capture sites too
    ("TOR103", ["capture_sites.py"], {("TOR103", 5), ("TOR103", 11)}),
]

# the findings of the ASY/CON rules on the port's tree, by (rule, path, line)
PORT_FINDINGS = {
    ("CON303", "src/repro_torch/gateway/__init__.py", 241),
    ("CON304", "src/repro_torch/gateway/server.py", 410),
    ("CON304", "src/repro_torch/gateway/server.py", 418),
    ("CON304", "src/repro_torch/gateway/tokens.py", 93),
    ("CON304", "src/repro_torch/gateway/workers.py", 140),
    ("CON304", "src/repro_torch/gateway/workers.py", 274),
    ("CON304", "src/repro_torch/gateway/workers.py", 1069),
}


def _shared(findings) -> set:
    """(rule, path, line) of the findings of the rule packs both engines
    share: JAX and TOR rules left out."""
    return {(f.rule_id, f.path, f.line) for f in findings
            if not f.rule_id.startswith(("JAX", "TOR"))}


@pytest.mark.parametrize("rule_id,files,expected", REF_CASES,
                         ids=[c[0] for c in REF_CASES])
def test_reference_rule_fires_at_exact_lines_on_the_port_engine(rule_id, files, expected):
    paths = [REF_FIXTURES / f for f in files]
    findings = AnalysisEngine(ROOT).run(paths)
    assert {(f.rule_id, f.line) for f in findings} == expected
    assert any(f.rule_id == rule_id for f in findings)
    assert _shared(findings) == _shared(RefEngine(ROOT).run(paths))


@pytest.mark.parametrize("name", sorted(p.name for p in REF_FIXTURES.glob("*.py")))
def test_every_reference_fixture_gives_the_reference_findings(name):
    path = [REF_FIXTURES / name]
    assert _shared(AnalysisEngine(ROOT).run(path)) == _shared(RefEngine(ROOT).run(path))


def test_port_tree_gives_the_reference_engines_findings():
    """Explicit paths over every file of the port: every rule runs on every
    file, and the rule packs the engines share agree finding for finding."""
    paths = sorted(PORT.rglob("*.py"))
    ours, ref = AnalysisEngine(ROOT).run(paths), RefEngine(ROOT).run(paths)
    assert _shared(ours) == _shared(ref) == PORT_FINDINGS
    assert not [f for f in ref if f.rule_id.startswith("JAX")]
    # the fingerprints match too (same rule, path, snippet, occurrence)
    assert sorted(f.fingerprint for f in ours if not f.rule_id.startswith("TOR")) == \
        sorted(f.fingerprint for f in ref if not f.rule_id.startswith("JAX"))


@pytest.mark.parametrize("rule_id,files,expected", TOR_CASES,
                         ids=[f"{c[0]}-{c[1][0][:-3]}" for c in TOR_CASES])
def test_tor_rule_fires_at_exact_lines(rule_id, files, expected):
    findings = AnalysisEngine(ROOT).run([FIXTURES / f for f in files])
    assert {(f.rule_id, f.line) for f in findings} == expected
    assert any(f.rule_id == rule_id for f in findings)


def test_every_registered_rule_has_a_fixture_case():
    file_rules, repo_rules = default_rules()
    registered = {r.id for r in file_rules} | {r.id for r in repo_rules}
    covered = {rid for _, _, expected in REF_CASES + TOR_CASES for rid, _ in expected}
    assert registered - {"ENGINE000"} <= covered, (
        f"rules without a fixture case: {sorted(registered - covered)}")
    assert {r for r in registered if r.startswith("TOR")} == {
        f"TOR10{i}" for i in range(1, 7)}


def test_known_good_patterns_are_clean():
    """A captured fn doing only tensor arithmetic, a shape read and a
    static (bound or int-annotated) param in a branch, a tensor `+=`, a
    structural graph-cache key, CUDA touched inside a function, and a
    `torch.cuda.graph` block over tensor ops: no finding."""
    assert AnalysisEngine(ROOT).run([FIXTURES / "good.py"]) == []


def test_port_default_walk_is_clean_against_its_baseline():
    """The gate: the targeted walk of src/repro_torch against
    analysis/baseline_torch.json, every entry with a reviewed reason."""
    findings = AnalysisEngine(ROOT).run()
    baseline = Baseline.load(BASELINE)
    new, suppressed, stale = baseline.split(findings)
    assert new == [], "\n".join(f.render() for f in new)
    assert stale == [], f"stale baseline entries: {stale}"
    for entry in baseline.entries.values():
        assert entry["reason"]
        assert not entry["reason"].startswith("unreviewed")
    # the seven ASY/CON findings and the one TOR false positive
    assert {(f.rule_id, f.path, f.line) for f in suppressed} == PORT_FINDINGS | {
        ("TOR105", "src/repro_torch/engine/base.py", 358)}
    # the default walk keeps each pack to its targets: no reference file
    assert all(f.path.startswith("src/repro_torch/") for f in findings)


def test_cli_gates_the_tree_and_fails_without_one_entry(tmp_path, capsys):
    assert cli_main(["--root", str(ROOT), "--baseline", str(BASELINE)]) == 0
    assert "analysis gate: OK" in capsys.readouterr().out
    data = json.loads(BASELINE.read_text())
    # one entry of each kind dropped in turn: the TOR one and a CON one
    for i in sorted({[e["rule"] for e in data["entries"]].index(r)
                     for r in ("TOR105", "CON304")}):
        short = dict(data, entries=data["entries"][:i] + data["entries"][i + 1:])
        path = tmp_path / f"baseline_{i}.json"
        path.write_text(json.dumps(short))
        assert cli_main(["--root", str(ROOT), "--baseline", str(path)]) == 1
        out = capsys.readouterr().out
        assert f"FAIL  {data['entries'][i]['path']}" in out


def test_cli_defaults_to_the_port_baseline(capsys):
    assert cli_main([]) == 0
    assert "8 baselined" in capsys.readouterr().out


def test_analysis_runs_on_an_interpreter_without_torch_or_numpy():
    """The gate imports no torch and no numpy: it runs where neither
    imports, as the reference's runs without jax."""
    code = ("import runpy, sys\n"
            "sys.modules['torch'] = None; sys.modules['numpy'] = None\n"
            "sys.argv = ['repro_torch.analysis']\n"
            "runpy.run_module('repro_torch.analysis', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "analysis gate: OK" in out.stdout
    for path in sorted((PORT / "analysis").glob("*.py")):
        tree = ast.parse(path.read_text())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
        mods |= {n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
        assert not {m for m in mods if m.split(".")[0] in ("torch", "numpy")}, path


def test_fingerprint_survives_line_drift(tmp_path):
    mod = tmp_path / "mod.py"
    body = ("import torch\n\n\ndef f(graphs, x):\n"
            "    return graphs.run(f'k{x}', lambda x: x.item(), (x,))\n")
    engine = AnalysisEngine(ROOT)
    mod.write_text(body)
    first = engine.run([mod])
    mod.write_text("# moved\n# down\n" + body)
    second = engine.run([mod])
    assert {f.rule_id for f in first} == {"TOR103", "TOR105"}
    assert [f.fingerprint for f in first] == [f.fingerprint for f in second]
    assert [f.line + 2 for f in first] == [f.line for f in second]


def test_baseline_requires_a_reason_and_a_known_version(tmp_path):
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({
        "version": 1,
        "entries": [{"fingerprint": "a" * 16, "rule": "TOR101",
                     "path": "x.py", "line": 1, "snippet": "s", "reason": ""}],
    }))
    with pytest.raises(ValueError, match="reason"):
        Baseline.load(path)
    path.write_text(json.dumps({"version": 99, "entries": []}))
    with pytest.raises(ValueError, match="version"):
        Baseline.load(path)


# -- CLI (tests/test_analysis.py's, on a TOR finding) ------------------------


def _write_bad(path: Path) -> None:
    path.write_text("def run(engine, x):\n"
                    "    def body(x):\n"
                    "        return x.sum().item()\n"
                    "    return engine.run_program('body', body, (x,))\n")


def test_cli_baseline_round_trip(tmp_path, capsys):
    bad = tmp_path / "bad_mod.py"
    _write_bad(bad)
    baseline = tmp_path / "baseline.json"
    common = [str(bad), "--root", str(ROOT), "--baseline", str(baseline)]

    assert cli_main(common) == 1                       # finding, no baseline
    assert cli_main(common + ["--update-baseline"]) == 0
    assert baseline.exists()
    capsys.readouterr()

    assert cli_main(common) == 0                       # baselined -> clean
    out = capsys.readouterr().out
    assert "TOR103" in out and "baselined" in out

    # the gate stays a gate: a NEW non-baselined finding still fails
    worse = tmp_path / "worse_mod.py"
    worse.write_text("import torch\n\nN = torch.cuda.device_count()\n")
    rc = cli_main([str(bad), str(worse), "--root", str(ROOT),
                   "--baseline", str(baseline)])
    out = capsys.readouterr().out
    assert rc == 1
    assert "TOR106" in out and "worse_mod.py:3" in out


def test_cli_json_format_and_report(tmp_path, capsys):
    bad = tmp_path / "bad_mod.py"
    _write_bad(bad)
    report = tmp_path / "report.json"
    rc = cli_main([str(bad), "--root", str(ROOT), "--baseline", "",
                   "--format", "json", "--report", str(report)])
    assert rc == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload == json.loads(report.read_text())
    assert payload["ok"] is False
    (finding,) = payload["findings"]
    assert finding["rule"] == "TOR103"
    assert finding["line"] == 3
    assert finding["fingerprint"]


def test_cli_update_keeps_reviewed_reasons(tmp_path, capsys):
    bad = tmp_path / "bad_mod.py"
    _write_bad(bad)
    baseline_path = tmp_path / "baseline.json"
    common = [str(bad), "--root", str(ROOT), "--baseline", str(baseline_path)]
    cli_main(common + ["--update-baseline"])
    data = json.loads(baseline_path.read_text())
    assert data["entries"][0]["reason"].startswith("unreviewed")
    data["entries"][0]["reason"] = "reviewed: fixture reads on purpose"
    baseline_path.write_text(json.dumps(data))
    capsys.readouterr()

    cli_main(common + ["--update-baseline"])           # re-run keeps reason
    data = json.loads(baseline_path.read_text())
    assert data["entries"][0]["reason"] == "reviewed: fixture reads on purpose"


def test_cli_list_rules(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule_id in ("TOR101", "TOR106", "ASY204", "CON303", "CON304"):
        assert rule_id in out
    assert "JAX101" not in out
    assert "src/repro_torch/gateway/**" in out
