"""Port parity of the application layer: data, detection metrics and the
AnomalyService against the JAX package with carried weights; and the
launcher end to end on the CPU, ``--http`` included (a subprocess, so a
real SIGTERM drives the drain)."""
import dataclasses
import json
import signal
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

from repro.core import anomaly as ja  # noqa: E402
from repro.data import TimeseriesConfig as JaxTimeseriesConfig  # noqa: E402
from repro.data import make_batch as jax_make_batch  # noqa: E402
from repro.engine import AnomalyService as JaxAnomalyService  # noqa: E402
from repro.engine import build_engine as jax_build_engine  # noqa: E402
from repro_torch.core import anomaly as ta  # noqa: E402
from repro_torch.data import TimeseriesConfig, make_batch  # noqa: E402
from repro_torch.engine import AnomalyService  # noqa: E402
from repro_torch.gateway.client import GatewayClient  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from test_torch_server import spawn_http_server  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("seed,index,rate", [(0, 0, 0.0), (0, 3, 0.5), (7, 1, 0.2), (3, 9, 1.0)])
def test_make_batch_bit_equal(seed, index, rate):
    kw = dict(features=16, seq_len=24, batch=12, anomaly_rate=rate, seed=seed)
    x, y = make_batch(TimeseriesConfig(**kw), index)
    jx, jy = jax_make_batch(JaxTimeseriesConfig(**kw), index)
    assert x.device.type == "cpu" and x.dtype == torch.float32 and y.dtype == torch.int32
    assert np.array_equal(x.numpy(), np.asarray(jx))
    assert np.array_equal(y.numpy(), np.asarray(jy))


def test_detection_metrics_equal():
    rng = np.random.default_rng(0)
    errors = rng.gamma(2.0, 0.5, 64).astype(np.float32)
    labels = (rng.uniform(size=64) < 0.3).astype(np.int32)
    assert ta.calibrate_threshold(torch.from_numpy(errors), 2.5) == \
        ja.calibrate_threshold(errors, 2.5)
    assert ta.auroc(errors, labels) == ja.auroc(errors, labels)
    assert np.isnan(ta.auroc(errors, np.zeros(64, np.int32)))
    thr = float(np.median(errors))
    assert dataclasses.asdict(ta.evaluate_detection(torch.from_numpy(errors),
                                                    torch.from_numpy(labels), thr)) == \
        dataclasses.asdict(ja.evaluate_detection(errors, labels, thr))


@pytest.fixture(scope="module")
def services():
    """The JAX service and the port's, on the same (JAX-initialised) weights."""
    ref = JaxAnomalyService("lstm-ae-f32-d6", schedule="wavefront")
    mine = AnomalyService("lstm-ae-f32-d6", schedule="fused", device="cpu")
    mine.recalibrate(params=jax.tree.map(np.asarray, ref.params))
    return ref, mine


def test_service_matches_reference(services):
    ref, mine = services
    benign = dict(features=32, seq_len=12, batch=16)
    thr = mine.calibrate(TimeseriesConfig(**benign))
    assert thr == pytest.approx(ref.calibrate(JaxTimeseriesConfig(**benign)), rel=RTOL)
    kw = dict(features=32, seq_len=12, batch=10, anomaly_rate=0.5, seed=3)
    series, labels = make_batch(TimeseriesConfig(**kw), 0)
    jseries, jlabels = jax_make_batch(JaxTimeseriesConfig(**kw), 0)
    scores = mine.score(series)
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref.score(jseries)), rtol=RTOL, atol=ATOL)
    # alerts/detect against the same threshold (scores agree to float noise)
    mine.recalibrate(threshold=ref.threshold)
    assert np.array_equal(mine.alerts(series).numpy(), np.asarray(ref.alerts(jseries)))
    got, want = mine.detect(series, labels), ref.detect(jseries, jlabels)
    for field in ("precision", "recall", "f1", "auroc", "anomaly_rate"):
        assert getattr(got, field) == pytest.approx(getattr(want, field), rel=RTOL)
    sess, jsess = mine.stream_start(10), ref.stream_start(10)
    for t in range(series.shape[1]):
        errors, sess = mine.stream_step(series[:, t], sess)
        jerrors, jsess = ref.stream_step(jseries[:, t], jsess)
        np.testing.assert_allclose(errors.numpy(), np.asarray(jerrors), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(errors.numpy(), scores.numpy(), rtol=RTOL, atol=ATOL)
    # Eq-1 accounting follows the bound schedule ("fused" walks layer by layer)
    ref_fused = jax_build_engine(ref.cfg, "fused")
    assert dataclasses.asdict(mine.latency_model(12)) == \
        dataclasses.asdict(ref_fused.latency_model(12))


def test_recalibrate_semantics(services):
    _, mine = services
    mine.recalibrate(threshold=0.25)
    assert mine.threshold == 0.25
    assert mine.recalibrate() == 0.25                   # nothing given: unchanged
    assert mine.recalibrate(threshold=None) is None     # explicit None disables alerting
    with pytest.raises(ValueError, match="calibrate"):
        mine.alerts(torch.zeros(2, 4, 32))
    thr = mine.recalibrate(TimeseriesConfig(features=32, seq_len=8, batch=8))
    assert thr is not None and thr > 0


def test_service_seed_and_device():
    a = AnomalyService("lstm-ae-f32-d2", device="cpu", seed=0)
    b = AnomalyService("lstm-ae-f32-d2", device="cpu", seed=0)
    c = AnomalyService("lstm-ae-f32-d2", device="cpu", seed=7)
    x = torch.ones(2, 6, 32)
    torch.testing.assert_close(a.score(x), b.score(x), rtol=0, atol=0)
    assert float((a.score(x) - c.score(x)).abs().max()) > 0
    assert a.score(x).device.type == "cpu" and a.features == 32


@pytest.mark.parametrize("schedule", ["fused", "wavefront"])
def test_launcher_runs_on_cpu_when_asked(schedule, capsys):
    serve.main(["--arch", "lstm-ae-f64-d6", "--full-config", "--schedule", schedule,
                "--batch", "4", "--seq-len", "6", "--requests", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"[serve] lstm-ae-f64-d6 [{schedule}]: 2 requests" in out
    assert "timesteps/s" in out and "[serve] Eq-1 model" in out


def test_launcher_fits_then_serves(capsys):
    serve.main(["--arch", "lstm-ae-f32-d2", "--device", "cpu", "--train-steps", "2",
                "--batch", "4", "--seq-len", "8", "--requests", "2"])
    out = capsys.readouterr().out
    fitted = [ln for ln in out.splitlines() if ln.startswith("[serve] fitted lstm-ae-f32-d2")]
    assert len(fitted) == 1 and "mse=" in fitted[0] and "threshold=" in fitted[0]
    assert "alerts=" in out and "[serve] lstm-ae-f32-d2-reduced [wavefront]: 2 requests" in out


def test_launcher_fits_then_opens_the_gateway(capsys):
    serve.main(["--arch", "lstm-ae-f32-d2", "--device", "cpu", "--train-steps", "2", "--gateway",
                "--seq-len", "8", "--requests", "4", "--capacity", "4", "--max-batch", "4"])
    out = capsys.readouterr().out
    fitted = [ln for ln in out.splitlines() if ln.startswith("[gateway] fitted lstm-ae-f32-d2")]
    assert len(fitted) == 1 and "threshold=" in fitted[0]
    assert "[gateway] scored 4 one-shot requests" in out and "alerts=" in out


@pytest.mark.parametrize("flag,item", [(["--workers", "2"], "item 8"),
                                       (["--slo-p95-ms", "50"], "item 9"),
                                       (["--priority-classes", "3"], "item 9"),
                                       (["--tenant-rate", "100"], "item 9"),
                                       (["--tenant-rate", "0"], "item 9"),
                                       (["--slo-p95-ms", "0"], "item 9"),
                                       (["--control-tick-s", "0"], "item 9"),
                                       (["--autoscale", "1:4"], "item 9"),
                                       (["--control-tick-s", "0.5"], "item 9")])
def test_launcher_rejects_unported_modes(flag, item, capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", "lstm-ae-f32-d2", "--device", "cpu", "--http", *flag])
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert "not ported" in err and "ROADMAP.md" in err and item in err


def test_launcher_http_without_a_gpu_raises():
    """``--http`` without ``--device`` resolves the GPU first: with none
    visible it raises, and never serves from the CPU instead."""
    import os
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device resolves")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                          "lstm-ae-f32-d2", "--http", "--port", "0"],
                         env={**os.environ, "PYTHONPATH": os.path.join(root, "src")},
                         cwd=root, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert "listening on" not in out.stdout


def _drive_and_terminate(proc, port, output, durable: bool) -> str:
    """Ping, score over bp1 and JSON, stream a few steps, SIGTERM; returns
    the server's output once it has drained and exited with rc 0."""
    window = np.random.default_rng(5).standard_normal((8, 32)).astype(np.float32)
    try:
        with GatewayClient("127.0.0.1", port, protocol="binary") as cb, \
                GatewayClient("127.0.0.1", port, protocol="json") as cj:
            assert cb.protocol == "bp1" and cb.ping() and cj.ping()
            assert cb.score(window) == cj.score(window)
            steps = cb.step_many(window[:3])
            assert len(steps) == 3 and (cb.session_token is not None) == durable
        proc.send_signal(signal.SIGTERM)
        out = output(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out
    return out


def test_launcher_http_serves_and_drains_on_sigterm():
    proc, port, _, output = spawn_http_server(["--capacity", "4", "--max-batch", "4"],
                                              arch="lstm-ae-f32-d2")
    out = _drive_and_terminate(proc, port, output, durable=False)
    assert "protocols=bp1+json (device=cpu, schedule=wavefront, capacity=4" in out
    assert "[http] drained: 2 one-shot scores (0 failed, 0 rejected), " \
        "3 stream-steps over 1 sessions" in out


def test_launcher_http_with_store_and_metrics(tmp_path):
    store = tmp_path / "store"
    proc, port, metrics_port, output = spawn_http_server(
        ["--capacity", "4", "--max-batch", "4", "--store-dir", str(store),
         "--snapshot-interval-ms", "50", "--metrics-port", "0",
         "--event-dir", str(tmp_path)], arch="lstm-ae-f32-d2")
    body = urllib.request.urlopen(f"http://127.0.0.1:{metrics_port}/metrics",
                                  timeout=10).read().decode()
    assert "repro_capacity 4" in body
    with GatewayClient("127.0.0.1", port) as c:
        c.step(np.zeros(32, np.float32))
        token = c.session_token
    assert token and token.startswith("rt1.")
    out = _drive_and_terminate(proc, port, output, durable=True)
    assert f"store={store}" in out
    assert (store / "token.secret").exists() and list((store / "shards" / "worker-0").iterdir())
    kinds = [json.loads(line)["kind"] for line in (tmp_path / "server.jsonl").read_text().splitlines()]
    assert kinds[0] == "boot" and "snapshot" in kinds and "migration" in kinds
