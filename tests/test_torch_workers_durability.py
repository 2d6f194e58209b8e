"""The port's multi-worker front with durable sessions, device claims and
the SIGTERM drain, on the CPU: the claims and worker-front cases of
tests/test_durability.py and the worker-front cases of tests/test_drain.py
held against ``repro_torch.gateway.workers`` and ``repro_torch.gateway.claims``.

* claims — per-worker device claims (``"cuda:N"``) are enforced disjoint,
  dead owners reaped, overlaps named in the error; a worker registers its
  claim at boot and releases it at exit.
* over the wire — SIGKILL the worker serving a live stream, resume by
  token on the respawned front: every running error bit-equal to an
  uninterrupted in-process run; the drain migrates residents
  (``sessions_lost == 0``) and a NEW front on the same store resumes them.
* ``recalibrate(params=...)`` fans the JAX package's params (as numpy)
  out over the worker pipes: scores then match the JAX service within
  1e-5 / 1e-6 and the in-process port gateway bit for bit, and a respawn
  gets the params replayed.
* ``python -m repro_torch.launch.serve --workers 2 --device cpu`` in a
  subprocess answers every in-flight ticket on SIGTERM and exits 0.

These assert what the reference tests describe (every ticket answered,
0 dropped, every worker clean, sessions migrated), not what the
reference outputs today (ROADMAP.md queue 3).  The worker factory comes
from tests/test_torch_workers.py, which imports no JAX at its top.
"""
import functools
import os
import queue
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

from conftest import GATEWAY_ARCH as ARCH  # noqa: E402
from conftest import GATEWAY_FEATS as FEATS  # noqa: E402
from conftest import gateway_series as _series  # noqa: E402
from test_torch_workers import GW_KW, cpu_gateway, solo_errors, wait_until  # noqa: E402
from repro.engine import AnomalyService as JaxAnomalyService  # noqa: E402
from repro_torch.engine import AnomalyService  # noqa: E402
from repro_torch.gateway.claims import (  # noqa: E402
    DeviceClaimError,
    DeviceClaimRegistry,
    claimed_cuda_index,
    validate_disjoint,
)
from repro_torch.gateway.client import GatewayClient, GatewayClientError  # noqa: E402
from repro_torch.gateway.tokens import TokenSigner, load_or_create_secret  # noqa: E402
from repro_torch.gateway.workers import WorkerFront  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
ROOT = Path(__file__).resolve().parent.parent
needs_reuseport = pytest.mark.skipif(
    not hasattr(socket, "SO_REUSEPORT"), reason="WorkerFront needs SO_REUSEPORT"
)


@pytest.fixture(scope="module")
def svc():
    return AnomalyService(ARCH, schedule="wavefront", device="cpu")


# -- device-claim registry --------------------------------------------------


def test_validate_disjoint_names_both_owners():
    validate_disjoint({"worker-0": ("cuda:0",), "worker-1": ("cuda:1",)})
    bad = {"worker-0": ("cuda:0", "cuda:1"), "worker-1": ("cuda:1",)}
    with pytest.raises(DeviceClaimError) as ei:
        validate_disjoint(bad)
    assert "worker-0" in str(ei.value) and "worker-1" in str(ei.value)
    assert "cuda:1" in str(ei.value)
    # an int names the same CUDA device as its "cuda:N" spelling
    with pytest.raises(DeviceClaimError, match="cuda:3"):
        validate_disjoint({"worker-0": (3,), "worker-1": ("cuda:3",)})


def test_registry_conflict_and_release(tmp_path):
    reg = DeviceClaimRegistry(tmp_path)
    reg.claim("worker-0", [0, 1])
    with pytest.raises(DeviceClaimError) as ei:
        reg.claim("worker-1", [1])
    assert "worker-0" in str(ei.value)
    reg.release("worker-0")
    reg.claim("worker-1", [1])  # freed by release
    assert set(reg.claims()) == {"worker-1"}
    assert reg.claims()["worker-1"]["devices"] == ["cuda:1"]


def test_registry_reaps_dead_owner(tmp_path):
    reg = DeviceClaimRegistry(tmp_path)
    # a claim left behind by a PID that no longer exists must not block
    reg.claim("worker-ghost", [2], pid=2 ** 22 + 12345)
    reg.claim("worker-0", [2])  # reaps the ghost instead of raising
    assert set(reg.claims()) == {"worker-0"}
    # but the SAME owner re-claiming (respawn, same name, new pid) is fine
    reg.claim("worker-0", [2], pid=os.getpid())


def test_claimed_cuda_index():
    assert claimed_cuda_index([3]) == 3
    assert claimed_cuda_index(["cuda:1", "cuda:2"]) == 1
    assert claimed_cuda_index(["cpu"]) is None
    assert claimed_cuda_index([]) is None


@needs_reuseport
def test_front_rejects_overlapping_device_claims(tmp_path):
    with pytest.raises(DeviceClaimError):
        WorkerFront(functools.partial(cpu_gateway), n_workers=2,
                    device_claims={0: [0], 1: ["cuda:0"]}, claims_dir=str(tmp_path))
    with pytest.raises(ValueError, match="nonexistent worker"):
        WorkerFront(functools.partial(cpu_gateway), n_workers=1,
                    device_claims={1: [1]}, claims_dir=str(tmp_path))


@needs_reuseport
def test_workers_register_and_release_their_claims(tmp_path):
    """Each worker registers its claim at boot (before it builds its
    gateway) and releases it at a clean exit; a claim that names no CUDA
    device leaves the worker's current device alone, so CPU workers run."""
    f = WorkerFront(functools.partial(cpu_gateway), n_workers=2, heartbeat_ms=100.0,
                    device_claims={0: ["cpu:0"], 1: ["cpu:1"]}, claims_dir=str(tmp_path))
    f.start(ready_timeout=180.0)
    try:
        claims = DeviceClaimRegistry(tmp_path).claims()
        assert {o: c["devices"] for o, c in claims.items()} == {
            "worker-0": ["cpu:0"], "worker-1": ["cpu:1"]}
        assert sorted(c["pid"] for c in claims.values()) == sorted(f.worker_pids())
    finally:
        summary = f.shutdown()
    assert summary["clean_exits"] == 2
    assert DeviceClaimRegistry(tmp_path).claims() == {}


# -- over the wire: SIGKILL -> token resume -> drain handoff ----------------


@needs_reuseport
def test_sigkill_resume_matches_oracle_and_drain_migrates(svc, tmp_path):
    """Kill the worker serving a stream, resume by token on the respawned
    front: every running error bit-equal to an uninterrupted in-process
    run; then drain with the session resident — MIGRATED, not lost — and
    resume it once more on a brand-new front over the same store."""
    t_len, kill_at, snap_at = 16, 9, 6
    data = _series(7, t_len)
    gw = svc.open_gateway(**GW_KW)
    gw.admit("s")
    oracle = [gw.step({"s": data[t]})["s"] for t in range(t_len)]
    np.testing.assert_allclose(oracle, solo_errors(svc, data), rtol=1e-5, atol=1e-6)
    store = str(tmp_path / "store")
    f = WorkerFront(functools.partial(cpu_gateway), n_workers=2, heartbeat_ms=50.0,
                    store_dir=store, snapshot_interval_ms=200.0)
    host, port = f.start(ready_timeout=180.0)
    c1 = GatewayClient(host, port)
    summary = None
    try:
        scores = []
        for t in range(kill_at):
            scores.append(c1.step(data[t])["running_error"])
            if t + 1 == snap_at:
                c1.request("snapshot")  # deterministic snapshot barrier
        token, replay = c1.session_token, c1.replay_buffer()
        assert token and c1.session_seq == kill_at

        victim = next(w["pid"] for w in f.stats()["per_worker"] if w["active_streams"] == 1)
        os.kill(victim, signal.SIGKILL)
        assert wait_until(lambda: f.restarts == 1 and f.alive_workers == 2)
        assert f.sessions_lost == 0  # durable: recoverable, not lost
        c1.close()

        with GatewayClient(host, port) as c2:
            out = c2.resume(token, replay=replay)
            assert out["seq"] == kill_at
            assert 0 <= out["replayed"] <= kill_at - snap_at
            for t in range(kill_at, t_len):
                scores.append(c2.step(data[t])["running_error"])
            assert np.array_equal(np.float32(scores), np.float32(oracle))
            c2.request("snapshot")
            mig_token = c2.session_token
            summary = f.shutdown()  # session still resident on some worker
        assert summary["sessions_migrated"] == 1
        assert summary["sessions_lost"] == 0
        assert summary["clean_exits"] == 2 and summary["dropped_tickets"] == 0
    finally:
        if summary is None:
            f.shutdown()

    f2 = WorkerFront(functools.partial(cpu_gateway), n_workers=1, heartbeat_ms=100.0,
                     store_dir=store)
    host2, port2 = f2.start(ready_timeout=180.0)
    try:
        with GatewayClient(host2, port2) as c3:
            out = c3.resume(mig_token)
            assert out["seq"] == t_len
            assert np.float32(out["running_error"]) == np.float32(oracle[-1])
    finally:
        assert f2.shutdown()["clean_exits"] == 1


@needs_reuseport
def test_wire_rejects_tampered_expired_unknown_tokens(tmp_path):
    store = str(tmp_path / "store")
    f = WorkerFront(functools.partial(cpu_gateway), n_workers=1, heartbeat_ms=100.0,
                    store_dir=store)
    host, port = f.start(ready_timeout=180.0)
    try:
        with GatewayClient(host, port) as c:
            c.step(np.zeros(FEATS, np.float32))
            good = c.session_token
        secret = load_or_create_secret(store)

        def resume_error(token) -> str:
            with GatewayClient(host, port) as c2:
                with pytest.raises(GatewayClientError) as ei:
                    c2.request("resume", token=token)
            return ei.value.error

        mid = len(good) // 2
        flipped = good[:mid] + ("A" if good[mid] != "A" else "B") + good[mid + 1:]
        assert resume_error(flipped) == "TamperedTokenError"
        assert resume_error("garbage") == "TamperedTokenError"
        expired = TokenSigner(secret, ttl_s=3600.0,
                              clock=lambda: time.time() - 7200.0).issue("s-feedfacefeedface", 3)
        assert resume_error(expired) == "ExpiredTokenError"
        unknown = TokenSigner(secret).issue("s-feedfacefeedface", 3)
        assert resume_error(unknown) == "UnknownSessionError"
    finally:
        f.shutdown()


# -- control plane: param swap over the pipes + respawn replay --------------


@needs_reuseport
def test_recalibrate_params_fans_out_and_survives_respawn():
    """The JAX package's params, scaled, cross the pipes as numpy: every
    worker then scores within 1e-5 / 1e-6 of the JAX service on those
    params and bit-equal to the in-process port gateway bound to them; a
    SIGKILLed worker's respawn gets the swap replayed."""
    ref = JaxAnomalyService(ARCH, schedule="wavefront")
    scaled = jax.tree.map(lambda p: np.asarray(p) * np.float32(1.25), ref.params)
    ref._bind(jax.tree.map(jax.numpy.asarray, scaled))
    mine = AnomalyService(ARCH, schedule="wavefront", device="cpu")
    mine.recalibrate(params=scaled)
    window = _series(55, 8)
    want = float(ref.score(jax.numpy.asarray(window[None]))[0])
    local = float(mine.open_gateway(**GW_KW).score([window])[0])
    base = float(AnomalyService(ARCH, schedule="wavefront", device="cpu")
                 .score(torch.from_numpy(window[None]))[0])
    assert abs(want - base) > 1e-6  # the swap must be observable
    np.testing.assert_allclose(local, want, rtol=RTOL, atol=ATOL)

    f = WorkerFront(functools.partial(cpu_gateway), n_workers=2, heartbeat_ms=50.0)
    host, port = f.start(ready_timeout=180.0)
    summary = None
    try:
        out = f.recalibrate(params=scaled)
        assert out["workers"] == 2 and out["params_swapped"]

        def every_worker_serves(value) -> bool:
            for _ in range(6):  # several connections: exercise both workers
                with GatewayClient(host, port) as c:
                    if np.float32(c.score(window)) != np.float32(value):
                        return False
            return True

        assert every_worker_serves(local)
        victim = f.stats()["per_worker"][0]["pid"]
        os.kill(victim, signal.SIGKILL)
        assert wait_until(lambda: f.restarts == 1 and f.alive_workers == 2)
        assert wait_until(lambda: every_worker_serves(local), timeout=90.0)
        summary = f.shutdown()
        assert summary["clean_exits"] == 2
    finally:
        if summary is None:
            f.shutdown()


# -- SIGTERM drain of the launcher (tests/test_drain.py, worker front) -------


def _spawn_server(extra_args):
    """``python -m repro_torch.launch.serve --workers 2 --device cpu`` in a
    subprocess (a real SIGTERM exercises the real drain); returns
    ``(proc, port, output)`` once the ready line is printed."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"  # the workers inherit it: one intra-op thread
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--device", "cpu", "--port", "0", "--train-steps", "0", "--capacity", "4",
         # max_batch > pending and an hour-scale max_wait: nothing can
         # flush the bucket before the SIGTERM — except the drain itself
         "--max-batch", "64", "--max-wait-ms", "3600000", *extra_args],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    lines: "queue.Queue" = queue.Queue()
    collected: list = []

    def _pump() -> None:
        for line in proc.stdout:
            collected.append(line)
            lines.put(line)

    reader = threading.Thread(target=_pump, daemon=True)
    reader.start()
    deadline = time.monotonic() + 180.0
    port = None
    while time.monotonic() < deadline:
        try:
            line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
        except queue.Empty:
            break
        if "listening on" in line:
            port = int(line.split("listening on ")[1].split()[0].rsplit(":", 1)[1])
            break
    if port is None:
        proc.kill()
        pytest.fail(f"server never reported its port: {''.join(collected)}")

    def output(timeout: float) -> str:
        proc.wait(timeout)
        reader.join(10.0)
        return "".join(collected)

    return proc, port, output


@needs_reuseport
def test_sigterm_with_inflight_tickets_answers_everything_worker_front():
    proc, port, output = _spawn_server(["--workers", "2"])
    rng = np.random.default_rng(0)
    clients, rids = [], []
    try:
        # two connections x three tickets: they may land on different
        # workers — the drain must cover all
        for _ in range(2):
            c = GatewayClient("127.0.0.1", port)
            clients.append(c)
            rids.append([c.submit(rng.standard_normal((6, FEATS)).astype(np.float32) * 0.1)
                         for _ in range(3)])
            assert c.ping()  # same-connection ordering: queued before SIGTERM
        proc.send_signal(signal.SIGTERM)
        for c, rs in zip(clients, rids):
            for rid in rs:
                resp = c.collect(rid)  # written during drain
                assert resp["ok"] and np.isfinite(resp["score"])
    finally:
        for c in clients:
            c.close()
        try:
            out = output(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            pytest.fail("server did not exit after SIGTERM drain")
    assert proc.returncode == 0, out
    assert "[workers] listening on" in out and "mesh=1xdata" in out
    assert "2/2 workers exited cleanly" in out
    assert "0 dropped tickets" in out
    assert "6 one-shot scores" in out


@needs_reuseport
def test_worker_front_drain_answers_streaming_session_close():
    """A resident streaming session survives until the drain closes its
    connection; its steps all answered, the server exits 0."""
    proc, port, output = _spawn_server(["--workers", "2"])
    try:
        with GatewayClient("127.0.0.1", port) as c:
            for _ in range(4):
                assert c.step(np.zeros(FEATS, np.float32))["ok"]
            proc.send_signal(signal.SIGTERM)
            # the drain evicts the session and closes the connection;
            # further requests fail with a closed connection, not a hang
            with pytest.raises((ConnectionError, OSError, GatewayClientError)):
                for _ in range(200):
                    c.step(np.zeros(FEATS, np.float32))
                    time.sleep(0.05)
    finally:
        try:
            out = output(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            pytest.fail("server did not exit after SIGTERM drain")
    assert proc.returncode == 0, out
    m = re.search(r"(\d+) stream-steps over 1 sessions", out)
    assert m and int(m.group(1)) >= 4, out
