"""On the card (``cuda``; skips elsewhere): the control fails every cell's
limit, a short traced run of each cell is correct and reads every metric, and
each fault that only the card's timed path can have (``faults(kind,
on_card=True)``) makes a run at the kind's small size not correct.

On a machine with one NVIDIA GPU: ``PYTHONPATH=src python -m pytest -m cuda
portbench/tests``.
"""
import json
import time

import pytest
import torch

from portbench import control, harness
from portbench.tests.test_portbench_faults import cell_files, over_limits

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
CARD_CASES = [(c, f) for c in CELLS
              for f in cell_files(c)[2].faults(cell_files(c)[0]["traffic"], on_card=True)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the port's kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limit(card, cell):
    """The control, put in the program's place at the cell's size and judged
    as a run's answers are, comes out not correct.  Its window is the traffic
    kind's ``CONTROL_SECONDS``, long enough to answer the cell's whole pool."""
    wl, _, _, kind = cell_files(cell)
    got = control.reading(cell, 2**32 + 101, kind.CONTROL_SECONDS, card)
    assert got["correct"] is False, got
    assert over_limits(wl, got["checks"]), got["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_traced_run_is_correct(card, cell):
    result = harness.run_cell(cell, 2**32 + 102, 1.0, True, card, time.perf_counter())
    assert result["correct"], result["checks"]
    want = {m["name"] for m in harness.cell_metrics(BENCH, cell, trace=True)}
    assert set(result["metrics"]) == want
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    for name, m in result["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100, (name, m)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", CARD_CASES)
def test_a_broken_timed_path_on_the_card_is_not_correct(card, monkeypatch, cell, fault):
    wl, cfg, family, kind = cell_files(cell)
    family.faults(wl["traffic"], on_card=True)[fault](monkeypatch, cfg, wl["limits"])
    result = harness.run_cell(cell, 2**32 + 103, 0.2, False, card, time.perf_counter(),
                              params=kind.SMALL)
    assert result["correct"] is False, result["checks"]
    assert over_limits(wl, result["checks"]), result["checks"]
