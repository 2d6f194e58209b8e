"""On the card (``cuda``; skips elsewhere): the control fails every cell's
limit, and a short traced run of each cell is correct and reads every metric.

On a machine with one NVIDIA GPU: ``PYTHONPATH=src python -m pytest -m cuda
portbench/tests``.
"""
import json
import time

import pytest
import torch

from portbench import control, harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the port's kernels have no CPU mode")
    return torch.device("cuda", 0)


# the control's window: long enough to answer every input of the cell's pool
CONTROL_SECONDS = {"bulk": 2.0, "window": 40.0}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limit(card, cell):
    """The reference in TF32, put in the program's place at the cell's size and
    judged as a run's answers are, comes out not correct."""
    traffic = next(w["traffic"] for w in BENCH["workloads"] if w["name"] == cell)
    got = control.reading(cell, 2**32 + 101, CONTROL_SECONDS[traffic], card)
    assert got["correct"] is False, got
    err = got["checks"]["score_rel_err"]
    assert err["value"] > err["limit"]


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
