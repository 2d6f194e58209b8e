"""The port's socket transport on the CPU: the contract of
tests/test_server.py, the socket cases of tests/test_wire.py and the
transport cases of tests/test_obs.py, held against a
``repro_torch.gateway.server.GatewayServer``; each package's client
against the other package's server; and the SIGTERM drain of
``python -m repro_torch.launch.serve --http`` with tickets in flight.

Real-socket round-trips must be value-identical to the in-process
serving paths, the background pump must complete one-shot tickets with
no caller pumping, backpressure and malformed input must surface as
typed protocol errors, and a drain must leave nothing unanswered.  The
drain must return while clients still hold their connections open (the
reference's ``drain`` awaits ``Server.wait_closed()`` first, which from
Python 3.12.1 waits for those connections; ROADMAP.md queue 3).

``tests/test_wire.py::test_priority_shed_over_binary_frames`` has no
counterpart here: it needs the control plane's admission controller,
which waits for ROADMAP.md, queue 1, item 9.  The durable-session cases
over the wire are in tests/test_torch_durability.py.
"""
import os
import queue
import signal
import socket as socketlib
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

from conftest import GATEWAY_ARCH as ARCH  # noqa: E402
from conftest import GATEWAY_FEATS as FEATS  # noqa: E402
from conftest import breaking_score_masked  # noqa: E402
from conftest import gateway_series as _series  # noqa: E402
from repro.engine import AnomalyService as JaxAnomalyService  # noqa: E402
from repro.gateway.client import GatewayClient as JaxGatewayClient  # noqa: E402
from repro.gateway.server import GatewayServer as JaxGatewayServer  # noqa: E402
from repro_torch.engine import AnomalyService  # noqa: E402
from repro_torch.gateway import wire  # noqa: E402
from repro_torch.gateway.client import GatewayClient, GatewayClientError  # noqa: E402
from repro_torch.gateway.server import GatewayServer  # noqa: E402
from repro_torch.obs import MetricsServer  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def pair():
    """The JAX service and the port's, on the same (JAX-initialised) weights."""
    ref = JaxAnomalyService(ARCH, schedule="wavefront")
    mine = AnomalyService(ARCH, schedule="fused", device="cpu")
    mine.recalibrate(params=jax.tree.map(np.asarray, ref.params))
    return ref, mine


@pytest.fixture(scope="module")
def svc(pair):
    return pair[1]


@pytest.fixture
def served(svc):
    """A port gateway served over a real socket on a private event-loop thread."""
    gw = svc.open_gateway(capacity=4, max_batch=4, max_wait_ms=10.0)
    server = GatewayServer(gw, port=0, pump_interval_ms=2.0)
    host, port = server.start_in_thread()
    yield host, port, gw
    server.stop_in_thread()


def _solo_errors(svc, samples) -> list:
    """Running errors of one stream stepped alone (B=1), per timestep."""
    sess = svc.stream_start(1)
    out = []
    for x in samples:
        errs, sess = svc.stream_step(torch.from_numpy(np.asarray(x)[None]), sess)
        out.append(float(errs[0]))
    return out


def _direct(svc, w) -> float:
    return float(svc.score(torch.from_numpy(np.asarray(w)[None]))[0])


def _wait_until(predicate, timeout: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


# -- streaming sessions ----------------------------------------------------


def test_stream_session_matches_solo_over_socket(served, svc):
    """A socket streaming session's running errors and final score equal
    solo ``stream_step``: the transport adds no semantics."""
    host, port, _ = served
    data = _series(0, 12)
    solo = _solo_errors(svc, data)
    with GatewayClient(host, port) as client:
        for t in range(len(data)):
            resp = client.step(data[t])
            np.testing.assert_allclose(resp["running_error"], solo[t], rtol=RTOL, atol=ATOL)
        final = client.end_session()["final"]
    np.testing.assert_allclose(final, solo[-1], rtol=RTOL, atol=ATOL)


def test_connection_drop_evicts_session(served):
    host, port, gw = served
    client = GatewayClient(host, port)
    client.step(_series(1, 4)[0])
    assert _wait_until(lambda: gw.pool.active == 1)
    client.close()  # abrupt: no explicit close op
    assert _wait_until(lambda: gw.pool.active == 0)  # slot reclaimed on teardown


def test_concurrent_stream_sessions(served, svc):
    """Several connections stream at once; each sees exactly its own
    stream's solo running errors despite sharing the pooled state block."""
    host, port, _ = served
    n, t_len = 3, 8
    data = [_series(10 + i, t_len) for i in range(n)]
    solo = [_solo_errors(svc, d) for d in data]
    results = [None] * n

    def run(i):
        with GatewayClient(host, port) as client:
            for t in range(t_len):
                client.step(data[i][t])
            results[i] = client.end_session()["final"]

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
        assert not th.is_alive()
    for i in range(n):
        np.testing.assert_allclose(results[i], solo[i][-1], rtol=RTOL, atol=ATOL)


def test_session_reopens_after_close(served):
    host, port, _ = served
    with GatewayClient(host, port) as client:
        client.step(_series(2, 4)[0])
        first = client.end_session()["final"]
        with pytest.raises(GatewayClientError) as ei:
            client.end_session()  # nothing open now
        assert ei.value.error == "ValueError"
        client.step(_series(2, 4)[0])  # a later step starts a fresh session
        assert client.end_session()["final"] == pytest.approx(first)


def test_streaming_over_binary_matches_solo(served, svc):
    host, port, _ = served
    data = _series(17, 10)
    solo = _solo_errors(svc, data)
    with GatewayClient(host, port, protocol="binary") as c:
        for t in range(len(data)):
            np.testing.assert_allclose(c.step(data[t])["running_error"], solo[t],
                                       rtol=RTOL, atol=ATOL)
        final = c.end_session()["final"]
    np.testing.assert_allclose(final, solo[-1], rtol=RTOL, atol=ATOL)
    with GatewayClient(host, port, protocol="binary") as c:
        many = c.step_many(data)  # the whole series in one STEP frame
        np.testing.assert_allclose(many, solo, rtol=RTOL, atol=ATOL)
        c.end_session()


# -- one-shot scoring through the background pump --------------------------


def test_one_shot_scores_match_direct(served, svc):
    """Concurrent one-shot scores over the wire (mixed lengths, out-of-order
    completion) match direct in-process ``AnomalyService.score``."""
    host, port, _ = served
    lens = [5, 9, 16, 7, 12, 6]
    windows = [_series(20 + i, n, seed=3) for i, n in enumerate(lens)]
    with GatewayClient(host, port) as client:
        scores = client.score_many(windows)
    for w, s in zip(windows, scores):
        np.testing.assert_allclose(s, _direct(svc, w), rtol=RTOL, atol=ATOL)


def test_background_pump_flushes_partial_bucket(served):
    """A single sub-max_batch request completes via the age-triggered
    background pump — no further traffic, no caller-driven pump()."""
    host, port, _ = served
    with GatewayClient(host, port) as client:
        t0 = time.perf_counter()
        score = client.score(_series(30, 6))  # blocks until the pump flushes
        assert time.perf_counter() - t0 < 20.0
        assert np.isfinite(score)


def test_interleaved_stream_and_scores_one_connection(served, svc):
    """One connection can interleave session steps with in-flight one-shot
    submissions; score responses arrive out of order and match by id."""
    host, port, _ = served
    data = _series(40, 6)
    solo = _solo_errors(svc, data)
    windows = [_series(41, 8), _series(42, 11)]
    with GatewayClient(host, port) as client:
        rids = [client.submit(w) for w in windows]
        for t in range(len(data)):  # step responses overtake the scores
            resp = client.step(data[t])
            np.testing.assert_allclose(resp["running_error"], solo[t], rtol=RTOL, atol=ATOL)
        scores = [client.collect(r)["score"] for r in rids]
    for w, s in zip(windows, scores):
        np.testing.assert_allclose(s, _direct(svc, w), rtol=RTOL, atol=ATOL)


def test_binary_json_inprocess_scores_bit_equal(served, svc):
    host, port, _ = served
    windows = [_series(200 + i, 12) for i in range(6)]
    direct = [_direct(svc, w) for w in windows]
    with GatewayClient(host, port, protocol="binary") as cb, \
            GatewayClient(host, port, protocol="json") as cj:
        assert cb.protocol == "bp1" and cj.protocol == "json"
        for w, d in zip(windows, direct):
            sb, sj = cb.score(w), cj.score(w)
            assert sb == sj  # the protocols are bit-identical, not close
            np.testing.assert_allclose(sb, d, rtol=RTOL, atol=ATOL)


def test_pipelined_frames_match_solo_oracle_any_depth(served):
    """score_many at every pipelining depth returns the same scores in
    submission order, equal to one-at-a-time submits."""
    host, port, _ = served
    windows = [_series(300 + i, 8 + (i % 3) * 4) for i in range(10)]
    with GatewayClient(host, port, protocol="binary") as c:
        solo = [c.score(w) for w in windows]
        for depth in (1, 3, 64):
            assert c.score_many(windows, windows_per_frame=depth) == solo


def test_pipelined_responses_collected_out_of_order(served):
    host, port, _ = served
    windows = [_series(400 + i, 8) for i in range(4)]
    with GatewayClient(host, port, protocol="binary") as c:
        expect = [c.score(w) for w in windows]
        rids = [c.submit(w) for w in windows]
        got = [c.collect(rid)["score"] for rid in reversed(rids)]
        assert got == expect[::-1]


def test_empty_batch_frame_is_legal(served):
    host, port, _ = served
    with GatewayClient(host, port, protocol="binary") as c:
        assert c.score_many([]) == []


# -- backpressure, admission and malformed input over the wire -------------


def test_overload_rejection_over_socket(svc):
    """Queue overload answers GatewayOverloadedError on the offending
    request only; the drain answers the rest."""
    gw = svc.open_gateway(capacity=1, max_batch=8, max_queue=2, max_wait_ms=60_000.0)
    server = GatewayServer(gw, port=0, pump_interval_ms=1000.0)
    host, port = server.start_in_thread()
    try:
        with GatewayClient(host, port) as client:
            rids = [client.submit(_series(50 + i, 6)) for i in range(3)]
            with pytest.raises(GatewayClientError) as ei:
                client.collect(rids[2])
            assert ei.value.error == "GatewayOverloadedError"
            assert gw.batcher.queue_depth == 2  # the two admitted are pending
    finally:
        server.stop_in_thread()  # drain flushes the two pending tickets
    assert gw.batcher.queue_depth == 0
    assert gw.stats()["counters"]["queue.completed"] == 2


def test_pool_full_rejects_fifth_session(served):
    host, port, _ = served  # capacity=4
    clients = [GatewayClient(host, port) for _ in range(5)]
    try:
        for c in clients[:4]:
            c.step(np.zeros(FEATS, np.float32))
        with pytest.raises(GatewayClientError) as ei:
            clients[4].step(np.zeros(FEATS, np.float32))
        assert ei.value.error == "PoolFullError"
        clients[0].end_session()
        clients[4].step(np.zeros(FEATS, np.float32))  # freed slot admits
    finally:
        for c in clients:
            c.close()


def test_oversized_and_malformed_requests(served):
    host, port, gw = served
    with GatewayClient(host, port) as client:
        with pytest.raises(GatewayClientError) as ei:
            client.score(np.zeros((2048, FEATS), np.float32))
        assert ei.value.error == "ValueError" and "max_seq_len" in ei.value.message
        with pytest.raises(GatewayClientError) as ei:
            client.request("warp")  # unknown op
        assert "unknown op" in ei.value.message
        with pytest.raises(GatewayClientError) as ei:
            client.step(np.zeros(FEATS + 1, np.float32))  # bad first step
        assert "sample shape" in ei.value.message
        assert gw.pool.active == 0  # ...must not pin a phantom pool slot
        assert client.ping()  # connection survived all three


def test_typed_errors_cross_binary_frames(served):
    host, port, _ = served
    with GatewayClient(host, port, protocol="binary") as c:
        with pytest.raises(GatewayClientError) as ei:
            c.score(np.zeros((2048, FEATS), np.float32))
        assert ei.value.error == "ValueError" and "max_seq_len" in ei.value.message
        with pytest.raises(GatewayClientError) as ei:
            c.request("definitely_not_an_op")
        assert "unknown opcode" in ei.value.message
        with pytest.raises(GatewayClientError) as ei:
            c.request("resume", token="rt1.x.y")  # no durability here
        assert ei.value.error == "ValueError" and "durability" in ei.value.message
        c.ping()  # connection survives payload-level errors


def test_garbage_frames_do_not_wedge_the_server(served):
    """A hostile connection (bad preamble, truncated header, oversize
    length field) may lose itself, never the server: fresh well-formed
    clients on both protocols keep getting correct answers."""
    host, port, _ = served
    window = _series(700, 8)
    with GatewayClient(host, port, protocol="binary") as c:
        expect = c.score(window)
    attacks = [
        b"\xb2Q1\n" + wire.pack_frame(wire.OP_PING, 1),
        wire.PREAMBLE + wire.pack_header(wire.OP_PING, 0, 1, 0)[:9],
        wire.PREAMBLE + wire.pack_header(wire.OP_SCORE, 0, 2, 0xFFFFFFF0),
        wire.PREAMBLE + b"\x00" * 64,
    ]
    for attack in attacks:
        with socketlib.create_connection((host, port), timeout=30) as s:
            s.sendall(attack)
            s.settimeout(30)
            try:
                s.recv(4096)
            except OSError:
                pass
        for proto in ("binary", "json"):
            with GatewayClient(host, port, protocol=proto) as c:
                assert c.score(window) == expect


# -- negotiation ------------------------------------------------------------


def test_auto_negotiation_falls_back_to_json(svc):
    """Against a server with the binary path disabled the preamble is
    answered with a JSON error line; an auto client falls back and works,
    a binary-required client raises — and the server still drains while
    that refused client's socket is open (it is never closed here)."""
    gw = svc.open_gateway(capacity=2, max_batch=2, max_wait_ms=5.0)
    server = GatewayServer(gw, port=0, pump_interval_ms=2.0, enable_binary=False)
    host, port = server.start_in_thread()
    try:
        with GatewayClient(host, port) as c:  # default: auto
            assert c.protocol == "json"
            assert c.ping()
            c.score(_series(500, 8))
        with pytest.raises(GatewayClientError) as ei:
            GatewayClient(host, port, protocol="binary")
        assert ei.value.error == "ProtocolError"
    finally:
        t0 = time.monotonic()
        server.stop_in_thread()
        assert time.monotonic() - t0 < 5.0


def test_explicit_json_client_skips_preamble(served):
    host, port, _ = served
    with GatewayClient(host, port, protocol="json") as c:
        assert c.protocol == "json" and c.server_info == {}
        assert c.ping()


def test_hello_reports_server_limits(served):
    host, port, gw = served
    with GatewayClient(host, port, protocol="binary") as c:
        assert c.server_info["protocol"] == "bp1"
        assert c.server_info["version"] == wire.VERSION
        assert c.server_info["features"] == gw.pool.features
        assert c.server_info["max_frame_bytes"] > 0


# -- live recalibration and failure injection ------------------------------


def test_recalibrate_over_socket_flips_alerts(served):
    host, port, gw = served
    data = _series(60, 6)
    try:
        with GatewayClient(host, port) as client:
            base = client.score(data)
            assert "alert" not in client.request("score", series=data.tolist())
            out = client.recalibrate(base - 1e-6)
            assert out["threshold"] == pytest.approx(base - 1e-6)
            assert client.request("score", series=data.tolist())["alert"] is True
            # the resident-session path alerts off the same live threshold
            client.step(data[0])
            assert "alert" in client.step(data[1])
            out = client.recalibrate(None)  # live disable
            assert out["threshold"] is None
            assert "alert" not in client.request("score", series=data.tolist())
    finally:
        gw.recalibrate(threshold=None)  # svc is module-scoped: restore


def test_engine_failure_mid_flush_leaves_server_serving(svc, monkeypatch):
    """A forced engine failure mid-flush answers the affected requests with
    the engine's error and the server keeps serving (no depth leak)."""
    gw = svc.open_gateway(capacity=1, max_batch=2, max_wait_ms=5.0)
    fail = [1]
    monkeypatch.setattr(svc.engine, "score_masked", breaking_score_masked(svc.engine, fail))
    server = GatewayServer(gw, port=0, pump_interval_ms=2.0)
    host, port = server.start_in_thread()
    try:
        with GatewayClient(host, port) as client:
            rids = [client.submit(_series(70 + i, 6)) for i in range(2)]
            for rid in rids:
                with pytest.raises(GatewayClientError) as ei:
                    client.collect(rid)
                assert "injected engine failure" in ei.value.message
            assert gw.batcher.queue_depth == 0
            score = client.score(_series(72, 6))  # server still serving
            np.testing.assert_allclose(score, _direct(svc, _series(72, 6)), rtol=RTOL, atol=ATOL)
        assert gw.stats()["counters"]["queue.failed"] == 2
    finally:
        server.stop_in_thread()


def test_stop_answers_pending_tickets_with_connections_open(svc):
    """stop_in_thread with tickets only the drain can flush and the
    clients' connections still open: every ticket is answered and the
    drain returns promptly, then the connections see EOF."""
    gw = svc.open_gateway(capacity=2, max_batch=64, max_wait_ms=3_600_000.0)
    server = GatewayServer(gw, port=0, pump_interval_ms=2.0)
    host, port = server.start_in_thread()
    clients = [GatewayClient(host, port, protocol=p) for p in ("binary", "json")]
    try:
        rids = [[c.submit(_series(80 + 3 * i + k, 6)) for k in range(3)]
                for i, c in enumerate(clients)]
        for c in clients:
            assert c.ping()  # same-connection order: the submits are queued
        assert gw.batcher.queue_depth == 6
        t0 = time.monotonic()
        server.stop_in_thread()
        assert time.monotonic() - t0 < 5.0
        for i, (c, rs) in enumerate(zip(clients, rids)):
            for k, rid in enumerate(rs):
                np.testing.assert_allclose(c.collect(rid)["score"],
                                           _direct(svc, _series(80 + 3 * i + k, 6)),
                                           rtol=RTOL, atol=ATOL)
            with pytest.raises((ConnectionError, OSError)):
                c.ping()
    finally:
        for c in clients:
            c.close()
    assert gw.stats()["counters"]["queue.completed"] == 6


# -- observability over the wire (tests/test_obs.py) -----------------------


def test_metrics_server_serves_live_gateway(served):
    host, port, gw = served
    ms = MetricsServer(gw.stats, port=0).start()
    try:
        with GatewayClient(host, port) as client:
            client.score(_series(0, 6))
            client.step(_series(0, 6)[0])
        url = f"http://127.0.0.1:{ms.port}/metrics"
        body = urllib.request.urlopen(url, timeout=10).read().decode()
        assert "repro_queue_completed_total 1" in body
        assert 'repro_request_ms_bucket{le="+Inf"} 1' in body
        assert 'repro_pool_step_ms_bucket{le="+Inf"} 1' in body
        assert "repro_uptime_s" in body and "repro_queue_depth 0" in body
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{ms.port}/other", timeout=10)
        assert ei.value.code == 404
    finally:
        ms.stop()


def test_traced_score_stages_cover_e2e(served):
    host, port, gw = served
    with GatewayClient(host, port) as client:
        client.score(_series(1, 6))  # warm the bucket
        out = client.traced_score(_series(2, 6))
    assert out["trace_id"].startswith("c")
    stages = out["stages"]
    assert {"dispatch", "queue_wait", "assemble", "compute"} <= set(stages)
    assert {"serialize", "wire"} <= set(stages)
    assert sum(stages.values()) == pytest.approx(out["e2e_ms"], rel=0.05)
    assert all(v >= 0.0 for v in stages.values())
    assert out["server_ms"] <= out["e2e_ms"]
    s = gw.stats()
    assert s["histograms"]["compute_ms"]["count"] >= 2
    assert s["histograms"]["wire_ms"]["count"] >= 2


def test_untraced_requests_carry_no_trace(served):
    host, port, _ = served
    with GatewayClient(host, port) as client:
        resp = client.collect(client.submit(_series(3, 6)))
    assert "trace" not in resp


def test_step_trace_over_wire(served):
    host, port, _ = served
    with GatewayClient(host, port) as client:
        resp = client.request("step", x=_series(4, 1)[0].tolist(), trace="t-abc")
        assert resp["trace"]["id"] == "t-abc"
        assert set(resp["trace"]["stages"]) >= {"dispatch", "compute"}
        client.end_session()


def test_stats_op_answers_the_gateway_stats(served):
    host, port, gw = served
    with GatewayClient(host, port, protocol="binary") as c:
        c.score(_series(5, 6))
        stats = c.stats()
    assert stats["capacity"] == gw.pool.capacity and stats["schedule"] == "fused"
    assert stats["counters"]["wire.req_bp1"] >= 2
    assert "durability" not in stats  # no store attached


@pytest.mark.parametrize("protocol", ["json", "binary"])
@pytest.mark.parametrize("kind", ["plain", "awaitable"])
def test_providers_answer_stats_and_recalibrate(svc, kind, protocol):
    """With ``stats_provider``/``recalibrate_provider`` set (the worker
    front's fan-out), the stats and recalibrate ops answer from the
    providers, whether they return a value or an awaitable, and the
    server's own gateway is left alone; a provider's failure comes back as
    a typed error and the connection keeps serving."""
    import asyncio

    calls = []

    def stats_fn():
        calls.append(("stats",))
        return {"workers": 2, "front": True}

    def recalibrate_fn(**kw):
        calls.append(("recalibrate", kw))
        if kw.get("threshold") == -1.0:
            raise ValueError("fan-out refused")
        return {"threshold": kw.get("threshold"), "workers": 2}

    def as_provider(fn):
        if kind == "plain":
            return fn

        async def provider(**kw):
            await asyncio.sleep(0.001)   # answered from a task, as over a pipe
            return fn(**kw)
        return provider

    gw = svc.open_gateway(capacity=2, max_batch=2, max_wait_ms=5.0)
    server = GatewayServer(gw, port=0, pump_interval_ms=2.0,
                           stats_provider=as_provider(stats_fn),
                           recalibrate_provider=as_provider(recalibrate_fn))
    before = gw.threshold
    host, port = server.start_in_thread()
    try:
        with GatewayClient(host, port, protocol=protocol) as c:
            assert c.stats() == {"workers": 2, "front": True}
            out = c.recalibrate(0.25)
            assert out["ok"] and out["op"] == "recalibrate"
            assert (out["threshold"], out["workers"]) == (0.25, 2)
            with pytest.raises(GatewayClientError) as ei:
                c.recalibrate(-1.0)
            assert ei.value.error == "ValueError" and "fan-out refused" in ei.value.message
            assert c.ping()
    finally:
        server.stop_in_thread()
    assert calls == [("stats",), ("recalibrate", {"threshold": 0.25}),
                     ("recalibrate", {"threshold": -1.0})]
    assert gw.threshold == before  # the providers answered; the local gateway untouched


# -- across packages ---------------------------------------------------------


def test_jax_client_against_the_port_server(pair, served):
    """The reference's client, both protocols, against the port's server:
    scores within 1e-5 / 1e-6 of the reference's in-process gateway on the
    same weights, and a stream within the same of its solo run."""
    ref, _ = pair
    host, port, _ = served
    windows = [_series(900 + i, 6 + 2 * i) for i in range(5)]
    want = ref.open_gateway(capacity=1, max_batch=4, max_wait_ms=0.0).score(windows)
    data = _series(910, 8)
    sess, solo = ref.stream_start(1), []
    for x in data:
        errs, sess = ref.stream_step(x[None], sess)
        solo.append(float(errs[0]))
    for protocol in ("binary", "json"):
        with JaxGatewayClient(host, port, protocol=protocol) as c:
            np.testing.assert_allclose(c.score_many(windows), want, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(c.step_many(data), solo, rtol=RTOL, atol=ATOL)
            c.end_session()


def test_port_client_against_the_jax_server(pair):
    """The port's client against the reference's server: scores within
    1e-5 / 1e-6 of the port's in-process gateway.  Every client is closed
    before the reference server stops (its drain waits on open ones)."""
    ref, mine = pair
    windows = [_series(920 + i, 5 + 3 * i) for i in range(5)]
    want = mine.open_gateway(capacity=1, max_batch=4, max_wait_ms=0.0).score(windows)
    server = JaxGatewayServer(ref.open_gateway(capacity=2, max_batch=4, max_wait_ms=5.0),
                              port=0, pump_interval_ms=2.0)
    host, port = server.start_in_thread()
    try:
        for protocol in ("binary", "json"):
            with GatewayClient(host, port, protocol=protocol) as c:
                assert c.protocol == ("bp1" if protocol == "binary" else "json")
                np.testing.assert_allclose(c.score_many(windows), want, rtol=RTOL, atol=ATOL)
    finally:
        server.stop_in_thread()


# -- SIGTERM drain of the launcher (tests/test_drain.py, single server) -----


def spawn_http_server(extra_args, arch=ARCH):
    """``python -m repro_torch.launch.serve --http --device cpu --port 0`` in
    a subprocess; returns ``(proc, port, metrics_port, output)`` once the
    ready line is printed.  ``output(timeout)`` waits for the process and
    returns everything it printed."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--http",
         "--device", "cpu", "--port", "0", *extra_args],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue" = queue.Queue()
    collected: list = []

    def _pump() -> None:
        for line in proc.stdout:
            collected.append(line)
            lines.put(line)

    reader = threading.Thread(target=_pump, daemon=True)
    reader.start()
    deadline = time.monotonic() + 120.0
    ready = None
    while ready is None and time.monotonic() < deadline:
        try:
            line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
        except queue.Empty:
            break
        if "listening on" in line:
            ready = line
    if ready is None:
        proc.kill()
        proc.wait(30)
        pytest.fail(f"server never reported its port: {''.join(collected)}")
    port = int(ready.split("listening on ")[1].split()[0].rsplit(":", 1)[1])
    metrics_port = (int(ready.split("metrics_port=")[1].split()[0])
                    if "metrics_port=" in ready else None)

    def output(timeout: float) -> str:
        proc.wait(timeout)
        reader.join(10.0)
        return "".join(collected)

    return proc, port, metrics_port, output


def test_sigterm_with_inflight_tickets_answers_everything():
    proc, port, _, output = spawn_http_server(
        # max_batch > pending and an hour-scale max_wait: nothing can flush
        # the bucket before the SIGTERM — except the drain itself
        ["--train-steps", "0", "--capacity", "4", "--max-batch", "64",
         "--max-wait-ms", "3600000"])
    rng = np.random.default_rng(0)
    clients, rids = [], []
    try:
        for protocol in ("binary", "json"):
            c = GatewayClient("127.0.0.1", port, protocol=protocol)
            clients.append(c)
            rids.append([c.submit(rng.standard_normal((6, FEATS)).astype(np.float32) * 0.1)
                         for _ in range(3)])
            assert c.ping()  # same-connection order: the submits are queued
        proc.send_signal(signal.SIGTERM)
        for c, rs in zip(clients, rids):
            for rid in rs:
                resp = c.collect(rid)  # written during the drain
                assert resp["ok"] and np.isfinite(resp["score"])
    finally:
        for c in clients:
            c.close()
        try:
            out = output(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            pytest.fail("server did not exit after SIGTERM drain")
    assert proc.returncode == 0, out
    assert "[http] drained: 6 one-shot scores (0 failed, 0 rejected)" in out
