"""BENCHMARK.json and the files it names: every cell, configuration, traffic
kind and metric is found by its name, and a new one is added by new files and
new entries alone.  What only one family's files can pass is that family's to
check (``families/<family>.py``'s ``check_config``)."""
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in METRICS]
    for n in names:
        assert NAME.match(n), n
    assert len(set(CELLS)) == len(CELLS)
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_exist_and_agree(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl, cfg = harness.load_cell(BENCH, cell)
    assert wl["why"] == entry["why"]
    family = harness.load("families", cfg["family"])
    for hook in ("build", "control", "check_config", "faults"):
        assert callable(getattr(family, hook)), (cfg["family"], hook)
    assert entry["chips"] in (1, 4)
    if entry["chips"] == 4:       # only what exists across chips takes four
        assert getattr(family, "SPANS_CHIPS", False) is True, cfg["family"]
    kind = harness.load("traffic", wl["traffic"])
    for hook in ("build", "warm", "drive", "request"):
        assert callable(getattr(kind, hook)), (wl["traffic"], hook)
    assert callable(getattr(kind, "judge", None) or family.judge)
    assert isinstance(kind.SMALL, dict) and kind.CONTROL_SECONDS > 0
    assert (harness.HERE / "work" / f"{cfg['family']}.py").is_file()
    assert wl["limits"], "a cell compares at least one number with its limit"
    for name, limit in wl["limits"].items():
        assert NAME.match(name) and name != "failed_requests", name
        assert math.isfinite(float(limit)) and float(limit) >= 0, (name, limit)
    e2e = [m["name"] for m in harness.cell_metrics(BENCH, cell, trace=False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = harness.cell_metrics(BENCH, cell, trace=True)
    assert per
    for m in per:     # each per-layer metric's end-to-end metric is reported here
        assert m["moves"] in e2e, (cell, m["name"])


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    """The family-independent checks, then the family's own.  ``reduced``
    agrees with BENCHMARK.json's, and each key it lists is recorded with its
    value at the source under ``published``, which the file's value differs
    from."""
    path = ROOT / config["file"]
    assert path.parent == harness.HERE / "configs"
    cfg = json.loads(path.read_text())
    assert cfg["name"] == config["name"]
    assert config["name"] in {w["config"] for w in BENCH["workloads"]}
    assert cfg["reduced"] == config["reduced"]
    assert len(config["reduced"]) <= 16 and len(set(config["reduced"])) == len(config["reduced"])
    published = cfg.get("published", {})
    for key in config["reduced"]:
        assert NAME.match(key), key
        assert key in cfg and key in published, key
        assert cfg[key] != published[key], key
    harness.load("families", cfg["family"]).check_config(cfg)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_its_reader(metric):
    reader = harness.load("metrics", metric["name"])
    assert callable(reader.read)
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for cell in metric.get("workloads", []):
        assert cell in CELLS


def test_per_layer_layers_and_moves():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["layer"] and "\n" not in m["layer"]
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["name"].split(".")[0].endswith(("_roofline", "mfu"))
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def _copy_with(tmp_path, files: dict, workloads: list, metrics: list) -> dict:
    """A copy of the benchmark with ``files`` added under ``portbench/`` and the
    entries added to its BENCHMARK.json, nothing of it edited."""
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for rel, text in files.items():
        path = tmp_path / "portbench" / rel
        assert not path.exists(), rel
        path.write_text(text)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"] += workloads
    bench["end_to_end"] += metrics
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench


def _run_in(tmp_path, cell):
    code = ("import json, sys, time, torch\n"
            "from portbench import harness\n"
            f"r = harness.run_cell({cell!r}, 5, 0.2, False, torch.device('cpu'),"
            " time.perf_counter())\n"
            "print(json.dumps(r))\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT / 'src'}")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_new_cell_and_metric_need_only_new_files(tmp_path):
    """A copy of the benchmark gains a cell (an existing configuration at
    another batch) and a per-layer metric by new files and new entries in its
    BENCHMARK.json, and its run finds both, on the CPU at a small size."""
    wl = json.loads((harness.HERE / "workloads" / "f32d2.bulk.json").read_text())
    wl.update(name="f32d2.bulk_b4", why="a smaller batch")
    wl["params"].update(batch=4, pool=2, warmup_requests=1)
    _copy_with(tmp_path, {
        "workloads/f32d2.bulk_b4.json": json.dumps(wl),
        "metrics/requests.new.py": "def read(run):\n    return float(run.completed)\n"},
        [{k: wl[k] for k in ("name", "config", "traffic", "chips", "why")}],
        [{"name": "requests.new", "unit": "requests", "better": "higher", "bound": 0.05,
          "source": "host_clock", "workloads": ["f32d2.bulk_b4"]}])
    result = _run_in(tmp_path, "f32d2.bulk_b4")
    assert result["correct"] is True
    assert result["metrics"]["requests.new"]["value"] >= 1
    # a metric that lists its cells is read only in them
    assert set(result["metrics"]) == {"setup_s", "requests.new"}


OPEN_LOOP = '''"""Open-loop single windows: arrivals at ``rate`` a second, the gaps drawn from
the seed; a request's latency runs from its arrival, its wait in the queue too."""
import time

import torch

from portbench.closed_loop import Pool, request, warm  # noqa: F401
from portbench.harness import Samples
from portbench.series import make_windows


def build(cfg, params, gen, device):
    n, t, f = int(params["pool"]), int(params["seq_len"]), int(cfg["input_features"])
    x, _ = make_windows(gen, n, t, f, 0.05)
    traffic = Pool(pool=x.cpu().view(n, 1, t, f), seq_len=t, block=n,
                   warmup=int(params["warmup_requests"]), trace_requests=2)
    gaps = torch.empty(256, device=gen.device).exponential_(float(params["rate"]), generator=gen)
    traffic.gaps = gaps.tolist()
    return traffic


def drive(system, traffic, seconds):
    samples = Samples(start=time.perf_counter())
    due, k = samples.start, 0
    while due < samples.start + seconds:
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        if request(system, traffic, samples):
            samples.latencies_s.append(time.perf_counter() - due)
            samples.timesteps += traffic.rows * traffic.seq_len
        due += traffic.gaps[k % len(traffic.gaps)]
        k += 1
    samples.window_s = time.perf_counter() - samples.start
    samples.extra["arrivals"] = k
    return samples


def stop(system, traffic):
    traffic.stopped = True


def judge(family, system, traffic, samples, limits):
    checks = family.judge(system, traffic, samples.answers, limits)
    checks["stopped_first"] = {"value": 0 if getattr(traffic, "stopped", False) else 1,
                               "limit": 0}
    return checks
'''

SAMPLED_BESIDE = '''"""beside_s.new: how long a sampler running beside the window ran."""
import contextlib
import time


@contextlib.contextmanager
def beside(device):
    box = {"t0": time.perf_counter()}
    yield box
    box["s"] = time.perf_counter() - box["t0"]


def read(run):
    return run.samples.extra["beside_s.new"]["s"]
'''


def test_an_open_loop_kind_and_a_sampled_metric_need_only_new_files(tmp_path):
    """A traffic kind of other arrivals (an open loop at a fixed rate, with its
    own window, an end to what it started and its own judgement) and an
    end-to-end metric sampled beside the window are added by new files and new
    entries alone, and a run drives and reads both."""
    wl = {"name": "f32d2.open", "config": "lstm-ae-f32-d2", "traffic": "open_loop", "chips": 1,
          "why": "single windows arriving at a fixed rate",
          "params": {"pool": 4, "seq_len": 16, "rate": 40.0, "warmup_requests": 1},
          "limits": {"score_rel_err": 1.5e-06}}
    _copy_with(tmp_path, {
        "traffic/open_loop.py": OPEN_LOOP,
        "workloads/f32d2.open.json": json.dumps(wl),
        "metrics/arrivals.new.py": "def read(run):\n    return float(run.samples.extra['arrivals'])\n",
        "metrics/beside_s.new.py": SAMPLED_BESIDE},
        [{k: wl[k] for k in ("name", "config", "traffic", "chips", "why")}],
        [{"name": n, "unit": u, "better": "higher", "bound": 0.05, "source": "host_clock",
          "workloads": ["f32d2.open"]} for n, u in (("arrivals.new", "requests"),
                                                    ("beside_s.new", "s"))])
    result = _run_in(tmp_path, "f32d2.open")
    assert result["correct"] is True, result["checks"]
    assert set(result["checks"]) == {"score_rel_err", "stopped_first", "failed_requests"}
    got = {n: m["value"] for n, m in result["metrics"].items()}
    assert set(got) == {"setup_s", "arrivals.new", "beside_s.new"}
    assert got["arrivals.new"] >= 2 and result["attempted"] == got["arrivals.new"]
    assert 0.1 < got["beside_s.new"] < 60
