"""A whole run of each cell past the look for a card, on the CPU at its traffic
kind's small size (``traffic/<kind>.py``'s ``SMALL``): sound, it comes out
correct; with the timed path broken underneath, it comes out not correct, once
for each fault its family says the cell can have there (``families/<family>.py``'s
``faults(kind)``: name -> planter(monkeypatch, cfg, limits)).

The compared numbers are those the cell's workload file gives limits for, so a
cell of a new family, traffic kind or check needs no edit here.  A broken run
has to put one of them over its limit: a fault, like the control, has to fail
one of a cell's numbers, not each."""
import json
import time

import pytest
import torch

from portbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**32 + 2**31 + 7


def cell_files(cell):
    """(workload file, configuration file, family, traffic kind) of ``cell``."""
    wl, cfg = harness.load_cell(BENCH, cell)
    return wl, cfg, harness.load("families", cfg["family"]), harness.load("traffic", wl["traffic"])


def _run(cell):
    return harness.run_cell(cell, SEED, 0.2, False, torch.device("cpu"), time.perf_counter(),
                            params=cell_files(cell)[3].SMALL)


def over_limits(wl, checks):
    """The names of the cell's limits whose check reads over its limit."""
    return [n for n in wl["limits"] if not checks[n]["value"] <= checks[n]["limit"]]


CASES = [(c, f) for c in CELLS for f in cell_files(c)[2].faults(cell_files(c)[0]["traffic"])]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    wl = cell_files(cell)[0]
    result = _run(cell)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert set(wl["limits"]) | {"failed_requests"} <= set(result["checks"])
    assert result["device"]["count"] == wl["chips"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    wl, cfg, family, _ = cell_files(cell)
    family.faults(wl["traffic"])[fault](monkeypatch, cfg, wl["limits"])
    result = _run(cell)
    assert result["correct"] is False
    assert over_limits(wl, result["checks"]), result["checks"]
