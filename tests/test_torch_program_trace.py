"""The port's own spans (``repro_torch.obs.trace.PROGRAM``) on the CPU: their
nesting, parents, request ids and self time; nothing kept with recording off;
the ranges a profiler session sees around an eager ``AnomalyService.score``;
the first call's profile read from its span; the bytes counted by memory; and
one recording shared by threads."""
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.engine import AnomalyService  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.obs.trace import PROGRAM, ProgramTracer, memory_kind  # noqa: E402

ARCH = "lstm-ae-f32-d2"


def _request(tracer, sleep_s=0.0):
    """A root span holding two children, the second holding one of its own."""
    with tracer.span("root") as root:
        with tracer.span("a", "score"):
            time.sleep(sleep_s)
        with tracer.span("b", "score"):
            with tracer.span("c", "score"):
                time.sleep(sleep_s)
    return root


def test_spans_nest_share_their_request_id_and_give_self_time():
    tracer = ProgramTracer()
    with tracer.recording() as rec:
        _request(tracer, 0.002)
        _request(tracer)
    assert rec.requests == 2 and rec.dropped == 0
    assert rec.calls == {"root": 2, "a": 2, "b": 2, "c": 2}
    first, second = rec.last
    root, a, b, c = first
    assert [s.name for s in first] == ["root", "a", "b", "c"]
    assert (root.parent, a.parent, b.parent, c.parent) == (None, root, root, b)
    assert len({s.request for s in first}) == 1 and first[0].request != second[0].request
    assert a.program == "score" and root.program is None
    for s in first:
        assert s.start_ns <= s.end_ns
    assert root.start_ns <= a.start_ns <= a.end_ns <= b.start_ns <= c.start_ns
    assert c.end_ns <= b.end_ns <= root.end_ns
    # self time: the total less what the children cover
    assert root.child_ns == (a.end_ns - a.start_ns) + (b.end_ns - b.start_ns)
    assert b.self_ms == pytest.approx(b.total_ms - c.total_ms, abs=1e-9)
    assert c.self_ms == c.total_ms and a.total_ms >= 2.0
    assert root.self_ms < root.total_ms - 4.0
    for name, hist in rec.total_ms.items():
        assert hist.count == 2 and rec.self_ms[name].count == 2
    assert rec.total_ms["root"].sum == pytest.approx(sum(r[0].total_ms for r in rec.last))
    described = rec.describe()
    assert described["requests"] == 2
    assert described["spans"]["c"]["calls_per_request"] == 1.0
    assert described["h2d_bytes"] == {"pinned": 0, "pageable": 0, "device": 0}


def test_recording_off_keeps_nothing():
    tracer = ProgramTracer()
    assert tracer.active is None and not tracer.live()
    root = _request(tracer)
    assert root.total_ms >= 0 and root.request is None and root.parent is None
    with tracer.recording() as rec:
        assert tracer.live()
    _request(tracer)                  # after the recording: not kept
    assert tracer.active is None
    assert rec.requests == 0 and rec.calls == {} and rec.total_ms == {} and not rec.last
    with tracer.recording() as outer:
        with tracer.recording() as inner:
            _request(tracer)
        assert tracer.active is outer
    assert (outer.requests, inner.requests) == (0, 1)


def test_a_request_keeps_at_most_max_spans(monkeypatch):
    monkeypatch.setattr(trace.Recording, "KEEP", 2)
    monkeypatch.setattr(trace.Recording, "MAX_SPANS", 3)
    tracer = ProgramTracer()
    with tracer.recording() as rec:
        for _ in range(3):
            _request(tracer)
    assert rec.dropped == 3 and len(rec.last) == 2
    assert [s.name for s in rec.last[-1]] == ["root", "a", "b"]
    assert rec.calls == {"root": 3, "a": 3, "b": 3}


@pytest.fixture(scope="module")
def service():
    svc = AnomalyService(ARCH, schedule="fused", device="cpu")
    return svc


def _series(b=2, t=5, seed=0):
    return torch.randn(b, t, 32, generator=torch.Generator().manual_seed(seed))


def test_an_eager_score_under_the_profiler_shows_nested_ranges(service):
    x = _series()
    service.score(x)                  # the first call at this signature
    assert PROGRAM.active is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        service.score(x)
    ranges = {}
    for e in prof.events():
        if e.name.startswith("repro_torch.") and e.device_type == DeviceType.CPU:
            ranges.setdefault(e.name, []).append((e.time_range.start, e.time_range.end, e.thread))
    assert set(ranges) == {"repro_torch.service.score", "repro_torch.engine.lookup",
                           "repro_torch.engine.eager"}
    (root,), (lookup,), (eager,) = (ranges[n] for n in ("repro_torch.service.score",
                                                        "repro_torch.engine.lookup",
                                                        "repro_torch.engine.eager"))
    assert root[2] == lookup[2] == eager[2]
    assert root[0] <= lookup[0] <= lookup[1] <= eager[0] <= eager[1] <= root[1]
    assert not PROGRAM.live()


def test_a_first_call_is_profiled_from_its_capture_span(service):
    x = _series(b=3, t=7, seed=1)
    profile_ = service.engine.profile
    compiles = profile_["compiles"]
    was = profile_["per_program"].get("score", {"compile_ms": 0.0})["compile_ms"]
    with PROGRAM.recording() as rec:
        first = service.score(x)
        again = service.score(x)
    torch.testing.assert_close(first, again)
    capture, eager = rec.last
    assert [s.name for s in capture] == ["repro_torch.service.score", "repro_torch.engine.lookup",
                                         "repro_torch.engine.capture"]
    assert [s.name for s in eager][2] == "repro_torch.engine.eager"
    assert profile_["compiles"] == compiles + 1
    assert profile_["per_program"]["score"]["compile_ms"] == was + capture[2].total_ms
    info = service.engine.profile_info()["per_program"]["score"]
    assert info["shapes"][-1] == [3, 7, 32]
    assert info["compile_ms"] == round(was + capture[2].total_ms, 3)
    assert rec.calls["repro_torch.engine.capture"] == 1 and rec.requests == 2


def test_the_bare_path_answers_as_the_traced_one(service):
    x = _series(seed=2)
    bare = service.score(x)
    with PROGRAM.recording():
        traced = service.score(x)
    torch.testing.assert_close(bare, traced, rtol=0, atol=0)


def test_memory_kind_on_the_cpu():
    """Pinned memory needs a card's allocator (``tests/test_torch_cuda.py``
    counts it); pageable host memory and memory on a device are told apart."""
    assert memory_kind(torch.zeros(4)) == "pageable"
    assert memory_kind(torch.zeros(4, device="meta")) == "device"


def test_the_recording_counts_bytes_by_memory_when_the_request_ends():
    tracer = ProgramTracer()
    pageable, meta = torch.zeros(4, 8), torch.zeros(3, device="meta")
    with tracer.recording() as rec:
        with tracer.span("root"):
            with tracer.span("copy_in"):
                rec.copied_in(pageable)
                rec.copied_in(meta)
            assert rec.h2d_bytes == {"pinned": 0, "pageable": 0, "device": 0}
        assert rec.h2d_bytes == {"pinned": 0, "pageable": 128, "device": 12}
        rec.copied_in(pageable)           # outside a request: counted at once
    assert rec.h2d_bytes == {"pinned": 0, "pageable": 256, "device": 12}


def test_profiling_reads_torchs_own_flag():
    assert trace._profiling() is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace._profiling() is True
    assert trace._profiling() is False


def test_threads_share_one_recording_without_losing_a_request():
    """More threads than cores, switching often: each thread's spans nest in
    its own requests and every request is folded once."""
    tracer = ProgramTracer()
    threads, per_thread = 12, 200
    one = torch.zeros(1, dtype=torch.int8)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracer.recording() as rec:
            def work():
                for _ in range(per_thread):
                    _request(tracer)
                    with tracer.span("copy_in"):
                        rec.copied_in(one)     # counted as its request ends
                    rec.copied_in(one)         # outside a request: at once

            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    n = threads * per_thread
    assert rec.requests == 2 * n and rec.h2d_bytes["pageable"] == 2 * n
    assert rec.calls == {"root": n, "a": n, "b": n, "c": n, "copy_in": n}
    assert len(rec.last) == trace.Recording.KEEP
    for records in rec.last:
        if records[0].name == "root":
            assert [s.name for s in records] == ["root", "a", "b", "c"]
            assert records[3].parent is records[2] and records[1].parent is records[0]
        assert len({s.request for s in records}) == 1
    assert len({records[0].request for records in rec.last}) == len(rec.last)
