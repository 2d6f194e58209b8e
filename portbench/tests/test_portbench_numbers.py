"""The benchmark's arithmetic: order statistics, the work count, the bound, and
the reading of a profiler trace, on known inputs."""
import json
from types import SimpleNamespace

import numpy as np
import pytest
from torch.autograd import DeviceType

from portbench import devtrace, harness, peaks, stats
from portbench.work import lstm_ae as work


def _cfg(name):
    return json.loads((harness.HERE / "configs" / f"{name}.json").read_text())


def test_percentile_matches_numpy_on_a_known_list():
    values = [5.0, 1.0, 4.0, 2.0, 3.0, 10.0, 7.0]
    assert stats.percentile(values, 50) == 4.0
    for q in (0, 5, 50, 95, 99, 100):
        assert stats.percentile(values, q) == pytest.approx(np.percentile(values, q))
    assert stats.percentile([2.0], 95) == 2.0
    with pytest.raises(ValueError):
        stats.percentile([], 50)


@pytest.mark.parametrize("name,per_step,weights", [
    ("lstm-ae-f64-d6", 96_768, 49_056), ("lstm-ae-f32-d2", 18_432, 9_408)])
def test_work_count(name, per_step, weights):
    cfg = _cfg(name)
    assert work.flops_per_row_timestep(cfg) == per_step
    assert work.weight_count(cfg) == weights
    assert work.request_flops(cfg, 8192, 64) == 8192 * 64 * per_step
    f = cfg["input_features"]
    assert work.request_bytes(cfg, 8192, 64) == 4 * (8192 * 64 * f + 8192 + weights)


def test_f64d6_bound_is_the_flops_at_the_fp32_peak():
    cfg = _cfg("lstm-ae-f64-d6")
    flops = work.request_flops(cfg, 8192, 64)
    assert flops == pytest.approx(5.07e10, rel=1e-3)
    bound = peaks.bound_s(flops, work.request_bytes(cfg, 8192, 64), "NVIDIA H100 80GB HBM3")
    assert bound == pytest.approx(flops / 67e12)
    assert bound * 1e3 == pytest.approx(0.757, abs=1e-3)
    with pytest.raises(KeyError):
        peaks.peaks_of("a card without a data sheet")


def test_union_and_covered():
    spans = [(5.0, 7.0), (0.0, 2.0), (1.0, 3.0), (7.0, 8.0), (10.0, 11.0)]
    assert devtrace.union(spans) == [(0.0, 3.0), (5.0, 8.0), (10.0, 11.0)]
    assert devtrace.covered(spans, 0.0, 12.0) == 7.0
    assert devtrace.covered(spans, 2.0, 6.0) == 2.0
    assert devtrace.union([]) == []


def _ev(name, start, end, cuda=False, thread=1):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
                           thread=thread)


def _request(t, kernels=3):
    """A request at t (us): a launch call, an H2D copy, ``kernels`` kernels, a
    copy out; 100 us long, the device busy 10 + 10 * kernels + 5 us of it."""
    evs = [_ev(devtrace.REQUEST, t, t + 100), _ev("aten::copy_", t + 1, t + 15),
           _ev("cudaMemcpyAsync", t + 2, t + 3), _ev("cudaGraphLaunch", t + 16, t + 18),
           _ev("cudaStreamSynchronize", t + 60, t + 99),
           _ev(devtrace.REQUEST, t + 4, t + 90, cuda=True),
           _ev("Memcpy HtoD (Pinned -> Device)", t + 4, t + 14, cuda=True)]
    for k in range(kernels):
        evs.append(_ev("lstm_cell_kernel", t + 20 + 12 * k, t + 30 + 12 * k, cuda=True))
    evs.append(_ev("Memcpy DtoH (Device -> Pageable)", t + 80, t + 85, cuda=True))
    return evs


def test_read_events_gives_each_request_its_device_work():
    events = [e for t in (0, 200, 400) for e in _request(t)]
    events.append(_ev("lstm_cell_kernel", 150, 160, cuda=True))   # between requests: nobody's
    tr = devtrace.read_events(events)
    assert len(tr.requests) == 2          # the first request is left out
    assert tr.problem() is None
    assert tr.kernels() == 3
    assert tr.calls() == 2
    assert tr.kernel_s() == pytest.approx(30e-6)
    assert tr.copy_s("Memcpy HtoD") == pytest.approx(10e-6)
    assert tr.copy_s("Memcpy PtoP") is None
    assert tr.window_s == pytest.approx(300e-6)
    assert tr.busy_s == pytest.approx(2 * 45e-6)
    assert tr.busy_per_request_s == pytest.approx(45e-6)
    ops = dict(tr.device_ops())
    assert ops["lstm_cell_kernel"] == pytest.approx(60e-6)
    assert devtrace.REQUEST not in ops
    gaps = dict(tr.idle_gaps())
    assert gaps["python, between requests"] == pytest.approx(100e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(2 * (26 + 15) * 1e-6)
    assert gaps["cudaGraphLaunch"] == pytest.approx(2 * 6e-6)
    assert gaps["python, inside a request"] == pytest.approx(2 * 4e-6)
    assert sum(gaps.values()) == pytest.approx(tr.window_s - tr.busy_s)


def test_busy_time_holds_when_the_copies_drift_against_the_kernels():
    """Whole passes of the card's trace put a request's copy over its kernels:
    each engine's own time is summed, so the busy time does not move."""
    events = [e for t in (0, 200, 400) for e in _request(t)]
    drifted = [_ev(e.name, e.time_range.start + 20, e.time_range.end + 20, cuda=True)
               if e.name.startswith("Memcpy") else e for e in events]
    tr = devtrace.read_events(drifted)
    assert tr.problem() is None
    assert tr.busy_s == pytest.approx(2 * 45e-6)
    assert "overlap on the trace by 0.0080 ms a request (2 requests by over 1 us)" in tr.summary()


def _pass(kernels_by_start):
    events = []
    for t, kernels in kernels_by_start.items():
        events.append(_ev(devtrace.REQUEST, t, t + 100))
        events += [_ev("lstm_cell_kernel", t + 10 + 4 * k, t + 12 + 4 * k, cuda=True)
                   for k in range(kernels)]
    return devtrace.read_events(events)


@pytest.mark.parametrize("lost", [0, 2, 40])
def test_a_pass_that_lost_many_requests_is_refused(lost):
    """One of the three requests read lost its kernels, or got a neighbour's."""
    tr = _pass({0: 20, 200: lost, 400: 20, 600: 20})
    assert "1 of 3 requests lost part of their trace" in tr.problem()
    assert devtrace.read_events([]).problem() == "no request was profiled"


def test_a_request_that_lost_a_copy_is_left_out():
    events = [e for t in range(0, 1000, 200) for e in _request(t)]
    events = [e for e in events if not (e.name.startswith("Memcpy HtoD") and
                                        e.time_range.start == 404)]
    tr = devtrace.read_events(events)
    assert tr.problem() is None
    assert [r.start for r in tr.kept] == [200, 600, 800]
    assert tr.copy_s("Memcpy HtoD") == pytest.approx(10e-6)


def test_a_request_that_lost_its_trace_is_left_out():
    counts = {t: 20 for t in range(0, 2000, 200)}
    counts[400], counts[800] = 0, 19
    tr = _pass(counts)
    assert tr.problem() is None
    assert len(tr.requests) == 9 and len(tr.kept) == 8
    assert tr.kernels() == 20
    assert tr.kernel_s() == pytest.approx((7 * 20 + 19) / 8 * 2e-6)
    assert tr.window_s == pytest.approx(8 * 200e-6 - 100e-6)   # the last ends at its span


def test_the_bf16_peak_is_the_data_sheets_dense_rate():
    """989.4 TFLOP/s, the H100 SXM's dense bf16 rate; the bound still reads the
    float32 peak, which the LSTM-AE configurations run at."""
    peak = peaks.peaks_of("NVIDIA H100 80GB HBM3")
    assert peak["bf16_flops"] == 989.4e12
    assert peak["fp32_flops"] == 67e12 and peak["hbm_bytes"] == 3.35e12
    assert peaks.bound_s(67e12, 0.0, "NVIDIA H100 80GB HBM3") == pytest.approx(1.0)


def test_idle_share_bulk_reads_the_traced_stretch_on_one_footing():
    """Busy time and request time are both the profiled requests' own: the share
    is one minus the line's busy_s over its window_s, whatever the untraced
    window's requests took, and lies in [0, 100]."""
    reader = harness.load("metrics", "idle_share.bulk")
    # back to back, the device busy 98 of each 100 us: the bulk cells' case
    events = []
    for t in range(0, 1000, 100):
        events.append(_ev(devtrace.REQUEST, t, t + 100))
        events.append(_ev("Memcpy HtoD (Pinned -> Device)", t + 1, t + 50, cuda=True))
        events.append(_ev("lstm_cell_kernel", t + 51, t + 100, cuda=True))
    tr = devtrace.read_events(events)
    assert tr.problem() is None
    # an untraced window whose requests ran faster than the profiled ones'
    # busy time: the two footings' share would read below zero
    samples = harness.Samples(start=0.0, window_s=1.0, latencies_s=[1 / 10500] * 10500)
    run = harness.Run(config={}, work=None, device_kind="cpu", setup_s=0.0, traffic=None,
                      samples=samples, trace=tr)
    assert 1.0 - tr.busy_per_request_s * run.completed / run.window_s < 0
    got = reader.read(run)
    assert got == pytest.approx(100.0 * (1 - tr.busy_s / tr.window_s)) == pytest.approx(2.0)
    assert 0.0 <= got <= 100.0
    run.trace = None
    assert reader.read(run) is None
