"""The port's multi-worker front (``repro_torch.gateway.workers``) on the
CPU: the cases of tests/test_workers.py held against it.  N spawned
worker processes behind one SO_REUSEPORT port must serve scores
bit-equal to the in-process port gateway, survive worker crashes
(respawn + session-loss accounting), answer stats/recalibrate
front-wide, scale up and down, and drain under load with zero dropped
tickets.  One cross-package case: the JAX package's client against the
port's front.

Spawn imports the module that defines a worker factory in every worker,
so this module imports no JAX at its top: the factory below builds the
port's gateway on the CPU with one intra-op thread (six test processes
each spawn workers), and the JAX client is imported inside its test.
The drain and scale-down cases assert what tests/test_workers.py
describes (every ticket answered, 0 dropped, every worker clean), not
what the reference does today (ROADMAP.md queue 3).
"""
import functools
import os
import signal
import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from conftest import GATEWAY_ARCH as ARCH  # noqa: E402
from conftest import GATEWAY_FEATS as FEATS  # noqa: E402
from conftest import gateway_series as _series  # noqa: E402
from repro_torch.engine import AnomalyService  # noqa: E402
from repro_torch.gateway.client import GatewayClient  # noqa: E402
from repro_torch.gateway.workers import WorkerFront, default_gateway_factory  # noqa: E402

pytestmark = pytest.mark.skipif(
    not hasattr(socket, "SO_REUSEPORT"), reason="WorkerFront needs SO_REUSEPORT"
)

GW_KW = {"capacity": 4, "max_batch": 4, "max_wait_ms": 10.0}


def cpu_gateway(**kw):
    """Per-worker factory (module-level: it must pickle under spawn).
    Every worker builds the same seed-0 service on the CPU, so workers
    serve identical params — and match this process's oracle."""
    torch.set_num_threads(1)
    return default_gateway_factory(ARCH, "wavefront", device="cpu", **{**GW_KW, **kw})


def wait_until(predicate, timeout: float = 90.0, interval: float = 0.05) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def solo_errors(svc, samples) -> list:
    """Running errors of one stream stepped alone (B=1) on the port."""
    sess = svc.stream_start(1)
    out = []
    for x in samples:
        errs, sess = svc.stream_step(torch.from_numpy(x[None]), sess)
        out.append(float(errs[0]))
    return out


@pytest.fixture(scope="module")
def svc():
    """The in-process oracle: same arch/schedule/seed/device as every worker."""
    return AnomalyService(ARCH, schedule="wavefront", device="cpu")


@pytest.fixture(scope="module")
def front(tmp_path_factory):
    obs_dir = tmp_path_factory.mktemp("obs")
    f = WorkerFront(functools.partial(cpu_gateway), n_workers=2, heartbeat_ms=100.0,
                    event_dir=str(obs_dir), metrics_port=0)
    f.start(ready_timeout=180.0)
    yield f
    f.shutdown()


def _touch_every_worker(front, host, port, fn, attempts: int = 24) -> None:
    """Run ``fn(client)`` on fresh connections until every worker of the
    front has completed one-shot work (the kernel picks the worker)."""
    for _ in range(attempts):
        with GatewayClient(host, port) as c:
            fn(c)
        per = front.stats()["per_worker"]
        if all(w["counters"].get("queue.completed", 0) > 0 for w in per):
            return
    raise AssertionError("the kernel never balanced a connection onto every worker")


# -- equivalence: the worker tier adds no semantics -------------------------


def test_stream_session_matches_in_process_through_front(front, svc):
    """A streaming session through whichever worker the kernel picks is
    bit-equal to the in-process port gateway's pool, and within the
    reference's tolerance of solo ``stream_step``."""
    data = _series(0, 10)
    gw = svc.open_gateway(**GW_KW)
    gw.admit("s")
    local = [gw.step({"s": data[t]})["s"] for t in range(len(data))]
    solo = solo_errors(svc, data)
    with GatewayClient(front.host, front.port) as client:
        got = [client.step(data[t])["running_error"] for t in range(len(data))]
        final = client.end_session()["final"]
    assert np.array_equal(np.float32(got), np.float32(local))
    np.testing.assert_allclose(got, solo, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(final, solo[-1], rtol=1e-5, atol=1e-5)


def test_one_shot_scores_match_in_process(front, svc):
    """One-shot scores over several connections (landing on every worker)
    are bit-equal to the in-process port gateway's, request by request,
    and within 1e-5 of ``AnomalyService.score``."""
    windows = [_series(20 + i, n, seed=3) for i, n in enumerate([5, 9, 16, 7])]
    gw = svc.open_gateway(**GW_KW)
    local = [float(gw.score([w])[0]) for w in windows]
    direct = [float(svc.score(torch.from_numpy(w[None]))[0]) for w in windows]

    def check(client):
        got = [client.score(w) for w in windows]
        assert np.array_equal(np.float32(got), np.float32(local))
        np.testing.assert_allclose(client.score_many(windows), direct, rtol=1e-5, atol=1e-5)

    _touch_every_worker(front, front.host, front.port, check)


def test_jax_client_against_port_front(front):
    """The JAX package's client speaks to the port's front: bp1 and JSON
    scores equal the port client's, and a wire ``stats`` answers for the
    whole front."""
    pytest.importorskip("jax")
    from repro.gateway.client import GatewayClient as JaxGatewayClient

    windows = [_series(80 + i, 8) for i in range(4)]
    with GatewayClient(front.host, front.port) as c:
        want = c.score_many(windows)
    for protocol in ("binary", "json"):
        with JaxGatewayClient(front.host, front.port, protocol=protocol) as jc:
            assert jc.score_many(windows) == want
            agg = jc.stats()
    assert agg["workers"]["count"] == 2 and len(agg["per_worker"]) == 2


# -- aggregated control plane ----------------------------------------------


def test_front_stats_aggregate_sums_workers(front):
    with GatewayClient(front.host, front.port) as client:
        client.score(_series(30, 6))
        agg = client.stats()  # over the wire: one worker asks, all answer
    assert agg["workers"]["count"] == 2
    assert agg["workers"]["configured"] == 2
    assert len(agg["per_worker"]) == 2
    assert agg["capacity"] == sum(w["capacity"] for w in agg["per_worker"])
    total_completed = sum(w["counters"].get("queue.completed", 0) for w in agg["per_worker"])
    assert agg["counters"]["queue.completed"] == total_completed >= 1
    sup = front.stats()
    assert sup["counters"]["queue.completed"] >= total_completed
    assert sup["features"] == FEATS


def test_front_stats_are_plain_python(front):
    """Nothing crosses a control pipe as a tensor: every value in the
    per-worker stats is plain Python, so no shared-memory handle or CUDA
    IPC handle ever rides a pipe."""
    plain = (str, int, float, bool, type(None))

    def walk(x, path="stats"):
        if isinstance(x, dict):
            for k, v in x.items():
                assert isinstance(k, plain), path
                walk(v, f"{path}.{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]")
        else:
            assert isinstance(x, plain), f"{path} is {type(x)!r}"

    walk(front.stats())


def test_front_latency_percentiles_are_exact_merge(front):
    """The front's latency percentiles are BIT-EQUAL to percentiles of the
    merged per-worker histograms — of the union of every worker's samples."""
    from repro_torch.gateway.telemetry import REQUEST_HIST
    from repro_torch.obs import Histogram

    windows = [_series(40 + i, 6) for i in range(4)]
    for _ in range(3):
        with GatewayClient(front.host, front.port) as client:
            client.score_many(windows)
    agg = front.stats()
    merged = Histogram()
    for w in agg["per_worker"]:
        merged.merge_from(Histogram.from_dict((w.get("histograms") or {}).get(REQUEST_HIST)))
    lat = agg["latency_ms"]
    assert merged.count == lat["count"] >= 12
    assert lat["p50"] == merged.percentile(50)
    assert lat["p95"] == merged.percentile(95)
    assert lat["p99"] == merged.percentile(99)
    assert lat["sum_ms"] == pytest.approx(merged.sum)
    assert lat["buckets"] == {str(i): n for i, n in sorted(merged.counts.items())}
    assert agg["histograms"][REQUEST_HIST]["count"] == merged.count


def test_front_metrics_endpoints_and_event_logs(front):
    """One /metrics per process: the supervisor serves the front
    aggregate, each worker its own labelled view; every process appended
    a boot event to its JSONL log."""
    import json
    import urllib.request

    assert front.metrics is not None  # metrics_port=0 bound ephemerally
    body = urllib.request.urlopen(f"http://{front.host}:{front.metrics.port}/metrics",
                                  timeout=15).read().decode()
    assert 'repro_workers_count{scope="front"} 2' in body
    assert "repro_queue_completed_total" in body
    assert 'repro_request_ms_bucket{le="+Inf",scope="front"}' in body
    agg = front.stats()
    for w in agg["per_worker"]:
        assert w["metrics_port"]
        wb = urllib.request.urlopen(f"http://127.0.0.1:{w['metrics_port']}/metrics",
                                    timeout=15).read().decode()
        assert f'worker="{w["index"]}"' in wb
    sup = [json.loads(line) for line in open(f"{front.event_dir}/supervisor.jsonl")]
    assert sup[0]["kind"] == "boot" and sup[0]["workers"] == 2
    for i in range(2):
        rows = [json.loads(line) for line in open(f"{front.event_dir}/worker-{i}.jsonl")]
        assert rows[0]["kind"] == "boot" and rows[0]["worker"] == i


def test_recalibrate_fans_out_to_every_worker(front):
    with GatewayClient(front.host, front.port) as client:
        out = client.recalibrate(0.25)
        assert out["threshold"] == pytest.approx(0.25)
        assert out["workers"] == 2
    try:
        per = front.stats()["per_worker"]
        assert [w["threshold"] for w in per] == [0.25, 0.25]
        for _ in range(3):
            with GatewayClient(front.host, front.port) as client:
                resp = client.request("score", series=_series(31, 6).tolist())
                assert "alert" in resp
    finally:
        front.recalibrate(threshold=None)
        per = front.stats()["per_worker"]
        assert [w["threshold"] for w in per] == [None, None]


def test_set_batching_fans_out_without_new_captures(front):
    """The control plane's actuation path: knobs reach every worker,
    max_batch clamped to the captured lanes, and moving them captures
    nothing new (the engines' first-call counts stay put)."""
    before = [w["engine"]["compiles"] for w in front.stats()["per_worker"]]
    try:
        out = front.set_batching(max_batch=64, max_wait_ms=2.5)
        assert out == {"max_batch": GW_KW["max_batch"], "max_wait_ms": 2.5,
                       "workers": 2, "attempted": 2}
        with GatewayClient(front.host, front.port) as c:
            assert np.isfinite(c.score(_series(33, 16)))
        per = front.stats()["per_worker"]
        assert [w["max_batch"] for w in per] == [GW_KW["max_batch"]] * 2
        assert [w["engine"]["compiles"] for w in per] == before
    finally:
        front.set_batching(max_batch=GW_KW["max_batch"], max_wait_ms=GW_KW["max_wait_ms"])


# -- crash -> respawn with session-loss accounting --------------------------


def test_worker_crash_respawns_and_accounts_lost_sessions():
    f = WorkerFront(functools.partial(cpu_gateway), n_workers=2, heartbeat_ms=50.0)
    host, port = f.start(ready_timeout=180.0)
    victim_client = GatewayClient(host, port)
    try:
        f.recalibrate(threshold=0.125)  # live state a respawn must inherit
        victim_client.step(np.zeros(FEATS, np.float32))

        def _find_victim():
            for w in f.stats()["per_worker"]:
                if w["active_streams"] == 1:
                    return w["pid"]
            return None

        assert wait_until(lambda: _find_victim() is not None)
        victim_pid = _find_victim()
        os.kill(victim_pid, signal.SIGKILL)
        assert wait_until(lambda: f.restarts == 1 and f.alive_workers == 2, timeout=120.0), \
            f"no respawn: restarts={f.restarts} alive={f.alive_workers}"
        assert f.sessions_lost == 1  # the victim's resident stream
        assert victim_pid not in f.worker_pids()
        with GatewayClient(host, port) as client:
            assert np.isfinite(client.score(_series(40, 6)))
        # the supervisor replayed the live recalibration onto the respawn
        assert wait_until(lambda: [w["threshold"] for w in f.stats()["per_worker"]]
                          == [0.125, 0.125], timeout=60.0), f.stats()["per_worker"]
        summary = f.shutdown()
    finally:
        try:
            victim_client.close()
        except OSError:
            pass
    assert summary["clean_exits"] == 2
    assert summary["dropped_tickets"] == 0
    assert summary["restarts"] == 1 and summary["sessions_lost"] == 1


# -- coordinated drain under load ------------------------------------------


def test_shutdown_drains_pending_tickets_across_workers():
    """Tickets parked in several workers' queues (max_wait too long to
    flush, max_batch too big to trigger) are all answered by the
    coordinated drain; the summary reports zero dropped."""
    f = WorkerFront(functools.partial(cpu_gateway, max_batch=64, max_wait_ms=1e9),
                    n_workers=2, heartbeat_ms=100.0)
    host, port = f.start(ready_timeout=180.0)
    clients = [GatewayClient(host, port) for _ in range(3)]
    try:
        rids = []
        for i, c in enumerate(clients):
            rids.append([c.submit(_series(50 + i, 6)) for _ in range(3)])
            assert c.ping()  # same-connection ordering: submits are in
        assert wait_until(lambda: f.stats()["queue_depth"] == 9, timeout=30.0)
        summary = f.shutdown()
        assert summary["clean_exits"] == 2
        assert summary["dropped_tickets"] == 0
        assert summary["counters"]["queue.completed"] == 9
        for c, rs in zip(clients, rids):
            for rid in rs:
                resp = c.collect(rid)  # answered at drain, before close
                assert resp["ok"] and np.isfinite(resp["score"])
    finally:
        for c in clients:
            c.close()


# -- elastic fleet: scale-up replay + zero-drop scale-down ------------------


def test_scale_up_then_scale_down_drains_clean():
    """``scale_up`` adds a live worker on the shared port (replaying the
    live knobs), ``scale_down`` retires exactly one via the coordinated
    drain — zero dropped tickets, even with tickets parked on it — and the
    survivor keeps serving new connections."""
    f = WorkerFront(functools.partial(cpu_gateway, max_batch=64),
                    n_workers=1, heartbeat_ms=100.0)
    try:
        host, port = f.start(ready_timeout=180.0)
        f.set_batching(max_wait_ms=1e9)  # replayed onto the scale-up worker
        up = f.scale_up()
        assert up["workers"] == 2
        st = f.stats()["workers"]
        assert st["count"] == 2 and st["target"] == 2
        assert st["scale_ups"] == 1
        # park tickets on both workers (only the replayed knob keeps the new
        # worker from flushing them), then retire the higher index
        clients, rids = [], []
        for i in range(6):
            c = GatewayClient(host, port)
            clients.append(c)
            rids.append(c.submit(_series(60 + i, 8)))
            assert c.ping()
        assert wait_until(lambda: f.stats()["queue_depth"] == 6, timeout=30.0)
        drain = f.scale_down()
        assert drain["clean"] and drain["exitcode"] == 0
        assert drain["dropped_tickets"] == 0
        assert drain["workers"] == 1
        st = f.stats()["workers"]
        assert st["count"] == 1 and st["target"] == 1
        assert st["scale_downs"] == 1
        with pytest.raises(RuntimeError, match="below one worker"):
            f.scale_down()  # the floor: never drain the last worker
        # the victim's tickets were answered by its drain, the survivor's
        # stay parked until the knob comes back down
        f.set_batching(max_wait_ms=10.0)
        for c, rid in zip(clients, rids):  # every ticket answered, either way
            resp = c.collect(rid)
            assert resp["ok"] and np.isfinite(resp["score"])
        with GatewayClient(host, port) as client:  # the survivor still serves
            assert np.isfinite(client.score(_series(70, 6)))
        for c in clients:
            c.close()
    finally:
        summary = f.shutdown()
    assert summary["dropped_tickets"] == 0 and summary["clean_exits"] == 1


# -- no CPU fallback --------------------------------------------------------


def test_factory_needs_a_device_or_cpu(monkeypatch):
    """The factory resolves ``device=None`` to the GPU and raises without
    one; ``mesh=2`` on the CPU lays the gateway out over two emulated CPU
    devices, and a worker whose device claim names fewer CUDA devices than
    ``mesh`` raises; a front whose factory raises fails its start with the
    worker's error."""
    from repro_torch.engine import Placement
    from repro_torch.gateway import claims

    gw = default_gateway_factory(ARCH, mesh=2, device="cpu", capacity=4, max_batch=3)
    assert gw.placement == Placement.data(2) and gw.batcher.lanes == 4
    assert gw.engine.shard_devices == [torch.device("cpu")] * 2
    monkeypatch.setattr(claims, "_process_claim", ("cuda:0",))
    with pytest.raises(ValueError, match=r"mesh=2 needs 2 CUDA devices.*\['cuda:0'\]"):
        default_gateway_factory(ARCH, mesh=2, device="cpu")
    monkeypatch.undo()
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_gateway_factory(ARCH)
    f = WorkerFront(functools.partial(default_gateway_factory, ARCH), n_workers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        f.start(ready_timeout=180.0)
