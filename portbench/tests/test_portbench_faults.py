"""A whole run of each cell past the look for a card, on the CPU at a small
size: sound, it comes out correct; with the timed path broken underneath, it
comes out not correct, once for each fault the cell can have.

The faults: a cell step that returns its state unchanged; half of a request's
windows left out, the rest's mean given for them; one answer altered where the
engine produces it, by ten times the cell's limit.  A one-window request has no
half to leave out, and no cell spans chips, so no exchange can be left out."""
import json
import time

import pytest
import torch

from portbench import harness

SMALL = {"bulk": {"batch": 8, "pool": 2, "warmup_requests": 1},
         "window": {"pool": 6, "reference_block": 6, "warmup_requests": 1}}
BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = {w["name"]: w["traffic"] for w in BENCH["workloads"]}
SEED = 2**32 + 2**31 + 7


def _run(cell):
    return harness.run_cell(cell, SEED, 0.2, False, torch.device("cpu"), time.perf_counter(),
                            params=SMALL[CELLS[cell]])


def _limit(cell):
    wl = json.loads((harness.HERE / "workloads" / f"{cell}.json").read_text())
    return float(wl["limits"]["score_rel_err"])


def _state_unchanged(monkeypatch, cell):
    from repro_torch.engine import schedules

    def unchanged(params, x, h, c, *, pwl=False, h_out=None, c_out=None):
        h_out.copy_(h)
        if c_out is not c:
            c_out.copy_(c)
        return h_out, c_out

    monkeypatch.setattr(schedules, "lstm_cell_op", unchanged)


def _half_batch(monkeypatch, cell):
    from repro_torch.engine.base import Engine

    score = Engine._score

    def half(self, params, series):
        keep = series.shape[0] // 2
        got = score(self, params, series[:keep])
        return torch.cat([got, got.mean().expand(series.shape[0] - keep)])

    monkeypatch.setattr(Engine, "_score", half)


def _answer_altered(monkeypatch, cell):
    from repro_torch.engine.base import Engine

    score = Engine._score
    calls = []

    def altered(self, params, series):
        got = score(self, params, series)
        calls.append(1)
        if len(calls) == 2:        # one answer of the window's first request
            got = torch.cat([got[:1] * (1 + 10 * _limit(cell)), got[1:]])
        return got

    monkeypatch.setattr(Engine, "_score", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}
CASES = [(c, f) for c in CELLS for f in FAULTS if not (f == "half_batch" and CELLS[c] == "window")]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == {"score_rel_err", "failed_requests"}


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch, cell)
    result = _run(cell)
    assert result["correct"] is False
    err = result["checks"]["score_rel_err"]
    assert err["value"] > err["limit"]
