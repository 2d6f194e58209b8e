"""The readers of the program's own spans and counters (``engine_host_ms.*``,
``port_launches.latency``), each against a planted run: what they read beside
the window, what they log, and nothing (no raise) where the port has no
tracer."""
import contextlib
import json
import sys

import pytest
import torch

from portbench import harness, program_spans
from portbench.harness import Run, Samples

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NEW = {"engine_host_ms.latency": ("f64d6.latency", "f32d2.latency"),
       "engine_host_ms.bulk": ("f64d6.bulk", "f32d2.bulk"),
       "port_launches.latency": ("f64d6.latency", "f32d2.latency")}


def _run(extra, completed=4):
    samples = Samples(start=0.0, window_s=1.0, latencies_s=[0.25] * completed, extra=extra)
    return Run(config={}, work=None, device_kind="cpu", setup_s=0.0, traffic=None,
               samples=samples)


def _beside(name):
    """Enter ``name``'s ``beside`` as the harness does; (reader, what it yielded, stack)."""
    reader = harness.load("metrics", name)
    stack = contextlib.ExitStack()
    return reader, stack, stack.enter_context(reader.beside(torch.device("cpu")))


@pytest.mark.parametrize("name", sorted(NEW))
def test_each_program_metric_is_declared_with_its_cells_and_source(name):
    (entry,) = [m for m in BENCH["per_layer"] if m["name"] == name]
    assert entry["workloads"] == list(NEW[name])
    assert entry["source"] == ("program_counter" if name.startswith("port_") else "program_span")
    for cell in NEW[name]:
        assert name in {m["name"] for m in harness.cell_metrics(BENCH, cell, trace=True)}
        assert name not in {m["name"] for m in harness.cell_metrics(BENCH, cell, trace=False)}


@pytest.mark.parametrize("name", ["engine_host_ms.latency", "engine_host_ms.bulk"])
def test_engine_host_ms_reads_the_root_spans_median(name, capsys):
    from repro_torch.engine import AnomalyService

    svc = AnomalyService("lstm-ae-f32-d2", schedule="fused", device="cpu")
    x = torch.randn(1, 4, 32, generator=torch.Generator().manual_seed(3))
    svc.score(x)                              # the first call, before the window
    reader, stack, rec = _beside(name)
    with stack:
        for _ in range(5):
            svc.score(x)
    got = reader.read(_run({name: rec}))
    assert got == rec.total_ms[program_spans.ROOT].percentile(50) > 0
    assert rec.requests == 5 and rec.calls["repro_torch.engine.eager"] == 5
    err = capsys.readouterr().err
    for span in ("repro_torch.service.score", "repro_torch.engine.lookup",
                 "repro_torch.engine.eager"):
        assert f"[program] {span}: total " in err
    assert "[program] window: 5 requests; bytes copied in from pinned 0, pageable 0, device 0; " \
           "0 captures; 0 spans dropped" in err


def test_engine_host_ms_reads_nothing_from_a_window_without_the_root_span():
    from repro_torch.obs.trace import PROGRAM

    reader, stack, rec = _beside("engine_host_ms.latency")
    with stack:
        with PROGRAM.span("repro_torch.engine.lookup"):
            pass
    assert rec.requests == 1
    assert reader.read(_run({"engine_host_ms.latency": rec})) is None
    assert reader.read(_run({})) is None


def test_engine_host_ms_reads_nothing_from_a_port_without_the_tracer(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.obs.trace", None)   # import raises
    reader, stack, rec = _beside("engine_host_ms.bulk")
    with stack:
        pass
    assert rec is None
    assert reader.read(_run({"engine_host_ms.bulk": rec})) is None


def test_port_launches_counts_the_window_over_its_requests(monkeypatch):
    from repro_torch.kernels import ops

    counts = {"lstm_cell": 1000, "lstm_seq": 7, "wkv6": 0, "flash_attention": 0}
    monkeypatch.setattr(ops, "launch_counts", lambda: dict(counts))
    reader, stack, box = _beside("port_launches.latency")
    with stack:
        counts["lstm_cell"] += 4 * 384
    assert box == {"start": 1007, "end": 1007 + 4 * 384}
    assert reader.read(_run({"port_launches.latency": box}, completed=4)) == 384.0
    assert reader.read(_run({"port_launches.latency": box}, completed=0)) is None
    assert reader.read(_run({})) is None
