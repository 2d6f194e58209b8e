"""The port's control plane (``repro_torch.control``) on the CPU: the
cases of tests/test_control.py held against the port — windowed rate
sensing, priority-aware admission, SLO-feedback batching with hysteresis
and bounded steps, the autoscaler's band, the in-process
``GatewayControl`` on ``submit()``/pump ticks and the supervisor's
``ControlLoop`` over injected front stats — and the copies held to the
reference: the same tick sequences (telemetry snapshots, arrival rates,
queue depths) go through the JAX package's controllers and the port's,
and every decision must be equal.  Also the reference's
``test_priority_shed_over_binary_frames`` against the port's server.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

from conftest import GATEWAY_ARCH as ARCH  # noqa: E402
from conftest import gateway_series as _series  # noqa: E402
from repro import control as ref_control  # noqa: E402
from repro.obs.histogram import bucket_index  # noqa: E402
from repro_torch.control import (  # noqa: E402
    CONTROLLER_LOG,
    AdmissionController,
    Autoscaler,
    BatchingController,
    ControlConfig,
    ControlLoop,
    TokenBucket,
    enable_control,
)
from repro_torch.engine import AnomalyService  # noqa: E402
from repro_torch.gateway import AnomalyGateway, GatewayOverloadedError  # noqa: E402
from repro_torch.gateway.telemetry import Telemetry, _RateWindow  # noqa: E402
from repro_torch.obs.prometheus import render_stats  # noqa: E402


@pytest.fixture(scope="module")
def svc():
    return AnomalyService(ARCH, schedule="wavefront", device="cpu")


# -- sliding-window rates ---------------------------------------------------


def test_rate_window_tracks_recent_not_lifetime():
    w = _RateWindow(0.0, window_s=10.0, intervals=20)
    for i in range(100):  # 100 events in the first second
        w.add(i / 100.0)
    assert w.rate(1.0) == pytest.approx(100.0, rel=0.05)
    # 60 idle seconds later the lifetime mean is ~1.6/s; the window is 0
    assert w.rate(61.0) == 0.0


def test_rate_window_partial_fill_is_unbiased():
    w = _RateWindow(0.0, window_s=10.0, intervals=20)
    w.add(0.2)
    w.add(0.4)
    # 2 events in 0.5s elapsed: ~4/s, NOT 2/10s
    assert w.rate(0.5) == pytest.approx(4.0, rel=0.1)


def test_telemetry_windowed_rates_in_stats():
    clock = [0.0]
    tel = Telemetry(clock=lambda: clock[0])
    for i in range(50):
        clock[0] = i * 0.1
        tel.count("queue.submitted")
    clock[0] = 5.0
    s = tel.stats()
    assert s["arrival_rps_window"] == pytest.approx(10.0, rel=0.1)
    assert s["completed_rps_window"] == 0.0
    clock[0] = 100.0  # long idle: windows drain to zero, lifetime would not
    assert tel.stats()["arrival_rps_window"] == 0.0


# -- runtime batching knobs -------------------------------------------------


def test_set_knobs_clamps_to_captured_lanes(svc):
    gw = AnomalyGateway(svc, capacity=1, max_batch=4, max_wait_ms=5.0)
    lanes = gw.batcher.lanes
    applied = gw.batcher.set_knobs(max_batch=10 * lanes, max_wait_ms=-3.0)
    # max_batch never escapes [1, lanes] (the captured shapes), wait
    # floors at 0 — a controller can actuate freely without new captures
    assert applied == {"max_batch": lanes, "max_wait_ms": 0.0}
    assert gw.batcher.set_knobs(max_batch=0)["max_batch"] == 1
    assert gw.batcher.set_knobs(max_wait_ms=2.5) == {
        "max_batch": 1, "max_wait_ms": 2.5}


# -- admission: priority classes + tenant buckets ---------------------------


def test_admission_sheds_bottom_class_first():
    adm = AdmissionController(classes=3, clock=lambda: 0.0)
    assert adm.depth_limit(0, 60) == 60
    assert adm.depth_limit(1, 60) == 40
    assert adm.depth_limit(2, 60) == 20
    adm.admit(depth=19, max_queue=60, priority=2)
    with pytest.raises(GatewayOverloadedError):
        adm.admit(depth=20, max_queue=60, priority=2)
    adm.admit(depth=20, max_queue=60, priority=1)   # p1 still fits
    adm.admit(depth=59, max_queue=60, priority=0)   # p0 keeps the flat limit
    with pytest.raises(GatewayOverloadedError):
        adm.admit(depth=60, max_queue=60, priority=0)
    d = adm.describe()
    assert d["shed_by_class"] == {"0": 1.0, "1": 0.0, "2": 1.0}


def test_admission_none_priority_is_flat_class0():
    adm = AdmissionController(classes=3, clock=lambda: 0.0)
    assert adm.normalize(None) == 0
    assert adm.normalize(99) == 2   # clamped into [0, classes)
    assert adm.normalize(-5) == 0
    adm.admit(depth=59, max_queue=60)           # no priority kwarg at all
    with pytest.raises(GatewayOverloadedError):
        adm.admit(depth=60, max_queue=60)
    assert adm.describe()["shed_by_class"]["0"] == 1.0


def test_token_bucket_refill_and_burst_cap():
    b = TokenBucket(rate=2.0, burst=4.0, now=0.0)
    assert all(b.try_take(0.0) for _ in range(4))   # burst drained
    assert not b.try_take(0.0)
    assert b.try_take(0.5)                          # 0.5s * 2/s = 1 token
    assert not b.try_take(0.5)
    b.try_take(100.0)                               # refill caps at burst
    assert b.tokens == pytest.approx(3.0)


def test_admission_tenant_rate_limit_is_per_tenant():
    clock = [0.0]
    adm = AdmissionController(classes=1, tenant_rate=5.0, clock=lambda: clock[0])
    for _ in range(10):  # burst defaults to 2*rate
        adm.admit(depth=0, max_queue=64, tenant="mallory")
    with pytest.raises(GatewayOverloadedError, match="rate limit"):
        adm.admit(depth=0, max_queue=64, tenant="mallory")
    adm.admit(depth=0, max_queue=64, tenant="alice")  # other tenants fine
    d = adm.describe()
    assert d["rate_limited"] == 1.0
    assert d["tenants_tracked"] == 2


# -- batching controller: feedforward, hysteresis, bounded steps ------------


def _bc(**kw):
    kw.setdefault("slo_p95_ms", 10.0)
    kw.setdefault("floor_ms", 2.0)
    kw.setdefault("lanes", 16)
    return BatchingController(**kw)


def _obs(bc, p95, **kw):
    kw.setdefault("fill", 0.5)
    kw.setdefault("depth", 0)
    kw.setdefault("arrival_rps", 100.0)
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_ms", 4.0)
    return bc.decide(p95_ms=p95, **kw)


def test_batching_prior_spends_quarter_of_budget():
    bc = _bc()  # budget = 8ms -> prior wait 2ms, capped by wait_cap 6.4ms
    knobs = bc.prior_knobs(32, 0.0)
    assert knobs["max_batch"] == 16  # clamped to lanes
    assert knobs["max_wait_ms"] == pytest.approx(2.0)


def test_batching_infeasible_slo_pins_wait_once():
    bc = _bc(slo_p95_ms=1.0, floor_ms=2.0)
    assert not bc.feasible
    first = _obs(bc, 5.0)
    assert first["action"] == "pin_wait"
    assert first["knobs"] == {"max_wait_ms": 0.0}
    assert _obs(bc, 5.0)["action"] == "hold"
    assert _obs(bc, 0.5)["reason"] == "slo_infeasible"


def test_batching_hysteresis_needs_patience_then_cools_down():
    bc = _bc(patience=2, cooldown_ticks=2)
    assert _obs(bc, 15.0)["action"] == "hold"       # 1st hot tick: wait
    act = _obs(bc, 15.0)                            # 2nd: act
    assert act["action"] == "shrink_wait"
    assert act["knobs"]["max_wait_ms"] == pytest.approx(2.0)  # bounded /2
    assert _obs(bc, 15.0)["reason"] == "cooldown"   # then quiet
    assert _obs(bc, 15.0)["reason"] == "cooldown"
    assert bc.actions == 1


def test_batching_over_slo_with_full_batches_grows_batch():
    bc = _bc(patience=1)
    d = _obs(bc, 15.0, fill=0.95, max_batch=8)
    assert d["action"] == "grow_batch"
    assert d["knobs"]["max_batch"] == 16  # doubled, clamped to lanes


def test_batching_under_slo_grows_wait_toward_cap():
    bc = _bc(patience=1)
    d = _obs(bc, 1.0, max_wait_ms=4.0)  # far under 0.6*slo
    assert d["action"] == "grow_wait"
    assert d["knobs"]["max_wait_ms"] == pytest.approx(6.4)  # wait_cap
    assert _obs(bc, 7.0)["reason"] in ("cooldown", "in_band")


def test_batching_idle_ticks_hold():
    bc = _bc(patience=1)
    # p95 of 0 means "no traffic this window", not "fast": hold
    assert _obs(bc, 0.0)["action"] == "hold"


# -- autoscaler -------------------------------------------------------------


def test_autoscaler_scales_up_on_sustained_overload():
    a = Autoscaler(min_workers=1, max_workers=4, worker_rps=100.0,
                   patience=2, cooldown_ticks=1)
    assert a.decide(arrival_rps=150.0, workers=1)["delta"] == 0  # patience
    d = a.decide(arrival_rps=150.0, workers=1)
    assert d["delta"] == +1 and d["reason"] == "over_capacity"
    assert d["utilization"] == pytest.approx(1.5)
    assert a.decide(arrival_rps=150.0, workers=2)["reason"] == "cooldown"


def test_autoscaler_scales_down_only_to_min():
    a = Autoscaler(min_workers=1, max_workers=4, worker_rps=100.0,
                   patience=2, cooldown_ticks=0)
    for _ in range(2):
        d = a.decide(arrival_rps=10.0, workers=2)
    assert d["delta"] == -1 and d["reason"] == "under_utilized"
    for _ in range(2):
        d = a.decide(arrival_rps=10.0, workers=1)
    assert d["delta"] == 0 and d["reason"] == "idle_at_min"


def test_autoscaler_depth_saturation_triggers_without_rate():
    a = Autoscaler(min_workers=1, max_workers=4, worker_rps=1e6,
                   patience=1, cooldown_ticks=0)
    d = a.decide(arrival_rps=1.0, workers=1, queue_depth=600, max_queue=1024)
    assert d["delta"] == +1  # depth_frac 0.59 > 0.5 despite idle util


def test_autoscaler_respects_bounds_immediately():
    a = Autoscaler(min_workers=2, max_workers=3, worker_rps=100.0)
    assert a.decide(arrival_rps=0.0, workers=1)["reason"] == "below_min"
    assert a.decide(arrival_rps=9e9, workers=5)["reason"] == "above_max"


# -- in-process plane: gateway.submit() + pump ticks ------------------------


def test_gateway_priority_shed_order_and_counters(svc):
    gw = AnomalyGateway(svc, capacity=1, max_batch=8, max_queue=6, max_wait_ms=1e9)
    enable_control(gw, ControlConfig(priority_classes=3))
    for i in range(4):
        gw.submit(_series(i, 6), priority=0)
    # depth 4 >= class-2 limit (2) and class-1 limit (4): both shed
    with pytest.raises(GatewayOverloadedError):
        gw.submit(_series(90, 6), priority=2)
    with pytest.raises(GatewayOverloadedError):
        gw.submit(_series(91, 6), priority=1)
    gw.submit(_series(92, 6), priority=0)           # p0 still admitted
    gw.submit(_series(93, 6))                       # legacy: class 0
    with pytest.raises(GatewayOverloadedError):
        gw.submit(_series(94, 6), priority=0)       # flat limit reached
    s = gw.stats()
    assert s["counters"]["admission.shed_p2"] == 1
    assert s["counters"]["admission.shed_p1"] == 1
    assert s["counters"]["admission.shed_p0"] == 1
    assert s["counters"]["admission.admitted_p0"] == 6
    assert s["control"]["admission"]["shed_by_class"]["2"] == 1.0
    text = render_stats(s)
    assert "repro_admission_shed_p2_total 1" in text
    assert "repro_control_ticks" in text
    gw.flush()


def test_gateway_without_control_ignores_priority(svc):
    gw = AnomalyGateway(svc, capacity=1, max_batch=8, max_queue=3, max_wait_ms=1e9)
    assert gw.control is None
    for i in range(3):
        gw.submit(_series(i, 6), priority=2, tenant="x")
    with pytest.raises(GatewayOverloadedError):
        gw.submit(_series(9, 6), priority=0)  # priority buys nothing
    assert "admission.shed_p0" not in gw.stats()["counters"]
    assert "control" not in gw.stats()
    gw.flush()


def test_gateway_control_ticks_on_pump_and_journals(tmp_path):
    clock = [0.0]
    svc = AnomalyService(ARCH, schedule="wavefront", device="cpu")
    gw = AnomalyGateway(svc, capacity=1, max_batch=4, max_wait_ms=2.0,
                        clock=lambda: clock[0])
    ctl = enable_control(
        gw,
        ControlConfig(slo_p95_ms=500.0, tick_interval_s=1.0, arch=ARCH, floor_timesteps=16),
        event_dir=str(tmp_path),
    )
    assert ctl.batching is not None and ctl.floor_ms > 0.0
    # the feedforward prior already bounded the wait below the budget
    assert gw.batcher.max_wait_ms <= ctl.batching.wait_cap_ms
    gw.submit(_series(0, 6))
    assert ctl.maybe_tick() is None     # not due yet
    clock[0] = 1.5
    assert ctl.maybe_tick() is not None
    assert ctl.ticks == 1
    clock[0] = 1.7
    assert ctl.maybe_tick() is None     # next tick not due
    assert ctl.ticks == 1
    s = gw.stats()
    assert s["control"]["ticks"] == 1
    assert s["control"]["slo_p95_ms"] == 500.0
    lines = [json.loads(ln) for ln in (tmp_path / CONTROLLER_LOG).read_text().splitlines()]
    assert lines and lines[0]["kind"] == "control_tick"
    assert lines[0]["scope"] == "gateway"
    assert lines[0]["tick"] == 1
    assert "action" in lines[0] and "p95_ms" in lines[0]


def test_priority_shed_over_binary_frames(svc):
    """tests/test_wire.py's case on the port's server: priority and tenant
    ride bp1 SCORE frame meta; low priority sheds with a typed
    GatewayOverloadedError frame, priority 0 still lands."""
    from repro_torch.gateway.client import GatewayClient, GatewayClientError
    from repro_torch.gateway.server import GatewayServer

    gw = svc.open_gateway(capacity=1, max_batch=8, max_queue=3, max_wait_ms=60_000.0)
    enable_control(gw, ControlConfig(priority_classes=3))
    server = GatewayServer(gw, port=0, pump_interval_ms=1000.0)
    host, port = server.start_in_thread()
    try:
        with GatewayClient(host, port, protocol="binary") as c:
            c.submit(_series(600, 6), priority=2, tenant="bulk")
            with pytest.raises(GatewayClientError) as ei:
                c.collect(c.submit(_series(601, 6), priority=2, tenant="bulk"))
            assert ei.value.error == "GatewayOverloadedError"
            c.submit(_series(602, 6), priority=0)  # top class still admitted
            assert c.ping()
            assert gw.batcher.queue_depth == 2
    finally:
        server.stop_in_thread()  # drain answers the two admitted tickets
    assert gw.batcher.queue_depth == 0


# -- supervisor plane: ControlLoop over injected front stats ----------------


class _FakeFront:
    """Records actuations; stats are injected per tick, so no workers."""

    def __init__(self):
        self.batching_calls = []
        self.ups = 0
        self.downs = 0
        self.control = None

    def set_batching(self, **kw):
        self.batching_calls.append(kw)
        return {**kw, "workers": 2, "attempted": 2}

    def scale_up(self):
        self.ups += 1
        return {"index": self.ups, "workers": 1 + self.ups}

    def scale_down(self):
        self.downs += 1
        return {"dropped_tickets": 0, "clean": True, "workers": 2}


def _front_stats(p95_bucket_counts, *, arrival=0.0, depth=0, workers=2,
                 filled=0, slots=0):
    return {
        "arrival_rps_window": arrival,
        "queue_depth": depth,
        "max_batch": 8,
        "workers": {"count": workers},
        "counters": {"batch.filled": filled, "batch.slots": slots},
        "histograms": {"request_ms": {"counts": p95_bucket_counts,
                                      "count": sum(p95_bucket_counts.values()),
                                      "sum": 0.0}},
    }


def test_control_loop_ticks_scale_and_journal(tmp_path):
    from repro_torch.config import get_config

    cfg = get_config(ARCH)
    front = _FakeFront()
    loop = ControlLoop(
        front,
        ControlConfig(slo_p95_ms=1e4, autoscale_min=1, autoscale_max=4,
                      worker_rps=100.0, patience=1, arch=ARCH, floor_timesteps=16,
                      extra={"max_wait_ms": 2.0}),
        lanes=8, max_queue=64, model_cfg=cfg.lstm_ae, event_dir=str(tmp_path),
    )
    assert front.control is loop    # attached like gateway.control
    assert loop.floor_ms > 0.0
    loop.tick(_front_stats({}, arrival=500.0, workers=2))
    d = loop.tick(_front_stats({}, arrival=500.0, workers=2))
    assert d["scale"]["delta"] == +1 and front.ups == 1
    for _ in range(8):
        d = loop.tick(_front_stats({}, arrival=1.0, workers=3))
    assert front.downs == 1
    assert d["scale"]["delta"] <= 0
    desc = loop.describe()
    assert desc["ticks"] == 10
    assert desc["autoscale"]["actions"] == 2
    lines = [json.loads(ln) for ln in (tmp_path / CONTROLLER_LOG).read_text().splitlines()]
    assert len(lines) == 10
    assert all(ln["scope"] == "front" for ln in lines)
    assert lines[1]["scale"]["reason"] == "over_capacity"


def test_control_loop_batching_actuates_through_front(tmp_path):
    front = _FakeFront()
    loop = ControlLoop(
        front,
        ControlConfig(slo_p95_ms=10.0, patience=1, cooldown_ticks=0,
                      min_wait_ms=0.25, extra={"max_wait_ms": 4.0}),
        lanes=8, event_dir=str(tmp_path),
    )
    assert loop.batching is not None
    assert loop.floor_ms == 0.0     # no model_cfg: pure-feedback mode
    hot = {bucket_index(50.0): 10}  # every request far over the 10ms SLO
    loop.tick(_front_stats(hot, arrival=100.0))
    assert front.batching_calls     # shrink_wait fanned out
    assert front.batching_calls[0]["max_wait_ms"] == pytest.approx(2.0)
    assert loop.describe()["knobs"]["max_wait_ms"] == pytest.approx(2.0)
    loop.stop()                     # never started: stop is a clean no-op


# -- the copies held to the reference: same tick sequences, same decisions --


def _p95_sequence(rng, n):
    """Per-tick p95 readings around a 10 ms SLO: idle (0), far under, in
    band and over, in random runs so hysteresis and cooldown both act."""
    levels = np.array([0.0, 1.5, 4.0, 7.5, 9.9, 12.0, 30.0])
    return [float(levels[rng.integers(len(levels))]) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("slo,floor", [(10.0, 2.0), (10.0, 0.0), (1.0, 2.0)])
def test_batching_decisions_equal_reference(seed, slo, floor):
    rng = np.random.default_rng(seed)
    kw = dict(slo_p95_ms=slo, floor_ms=floor, lanes=16, patience=2, cooldown_ticks=1)
    mine, ref = BatchingController(**kw), ref_control.BatchingController(**kw)
    assert mine.prior_knobs(32, 0.0) == ref.prior_knobs(32, 0.0)
    knobs = {"max_batch": 8, "max_wait_ms": 4.0}
    for p95 in _p95_sequence(rng, 60):
        obs = dict(p95_ms=p95, fill=float(rng.choice([0.3, 0.95])),
                   depth=int(rng.integers(0, 64)), arrival_rps=float(rng.uniform(0, 500)),
                   **knobs)
        a, b = mine.decide(**obs), ref.decide(**obs)
        assert a == b
        if a["knobs"]:
            knobs.update(a["knobs"])
    assert mine.describe() == ref.describe()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_autoscaler_decisions_equal_reference(seed):
    rng = np.random.default_rng(seed)
    kw = dict(min_workers=1, max_workers=4, worker_rps=100.0, patience=2, cooldown_ticks=2)
    mine, ref = Autoscaler(**kw), ref_control.Autoscaler(**kw)
    workers = 2
    for _ in range(80):
        obs = dict(arrival_rps=float(rng.choice([5.0, 60.0, 150.0, 400.0])),
                   workers=workers, queue_depth=int(rng.choice([0, 10, 700])),
                   max_queue=1024)
        a, b = mine.decide(**obs), ref.decide(**obs)
        assert a == b
        workers = max(1, workers + a["delta"])
    assert mine.describe() == ref.describe()


def test_admission_decisions_equal_reference():
    """A random stream of (depth, priority, tenant, clock) through both
    admission controllers: the same requests admitted (same class) or shed
    with the same error text, the same counters."""
    from repro.gateway.queue import GatewayOverloadedError as RefOverloaded

    rng = np.random.default_rng(5)
    t = [0.0]
    mine = AdmissionController(classes=4, tenant_rate=20.0, clock=lambda: t[0])
    ref = ref_control.AdmissionController(classes=4, tenant_rate=20.0, clock=lambda: t[0])
    for _ in range(400):
        t[0] += float(rng.exponential(0.02))
        req = dict(depth=int(rng.integers(0, 70)), max_queue=64,
                   priority=[None, 0, 1, 2, 3, 7][rng.integers(6)],
                   tenant=["a", "b", None][rng.integers(3)])
        outs = []
        for adm, err in ((mine, GatewayOverloadedError), (ref, RefOverloaded)):
            try:
                outs.append(("admit", adm.admit(**req)))
            except err as exc:
                outs.append(("shed", str(exc)))
        assert outs[0] == outs[1]
    assert mine.describe() == ref.describe()
    assert mine.telemetry.counters == ref.telemetry.counters


def _front_stats_sequence(rng, n):
    """Front-aggregated stats snapshots as a supervisor would read them:
    lifetime histograms and fill counters that only grow, windowed
    arrival rates and depths that wander."""
    counts: dict = {}
    filled = slots = 0.0
    out = []
    for _ in range(n):
        for ms in rng.choice([0.8, 3.0, 9.0, 25.0, 80.0], size=int(rng.integers(0, 40))):
            idx = bucket_index(float(ms))
            counts[idx] = counts.get(idx, 0) + 1
        slots += 16 * float(rng.integers(0, 5))
        filled = min(slots, filled + float(rng.integers(0, 70)))
        out.append({
            "arrival_rps_window": float(rng.choice([1.0, 50.0, 900.0])),
            "queue_depth": int(rng.choice([0, 5, 700])),
            "max_batch": 16,
            "workers": {"count": int(rng.integers(1, 4))},
            "counters": {"batch.filled": filled, "batch.slots": slots},
            "histograms": {"request_ms": {"counts": dict(counts),
                                          "count": sum(counts.values()), "sum": 0.0}},
        })
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_control_loop_decisions_equal_reference(seed, tmp_path):
    from repro.config import get_config as ref_get_config
    from repro_torch.config import get_config

    ccfg = dict(slo_p95_ms=10.0, autoscale_min=1, autoscale_max=3, worker_rps=300.0,
                patience=2, cooldown_ticks=1, arch=ARCH, floor_timesteps=16,
                extra={"max_wait_ms": 4.0})
    fronts = (_FakeFront(), _FakeFront())
    mine = ControlLoop(fronts[0], ControlConfig(**ccfg), lanes=16, max_queue=1024,
                       model_cfg=get_config(ARCH).lstm_ae, event_dir=str(tmp_path / "mine"))
    ref = ref_control.ControlLoop(fronts[1], ref_control.ControlConfig(**ccfg), lanes=16,
                                  max_queue=1024, model_cfg=ref_get_config(ARCH).lstm_ae,
                                  event_dir=str(tmp_path / "ref"))
    assert mine.floor_ms == ref.floor_ms
    for stats in _front_stats_sequence(np.random.default_rng(seed), 40):
        assert mine.tick(stats) == ref.tick(stats)
    assert mine.describe() == ref.describe()
    assert fronts[0].batching_calls == fronts[1].batching_calls
    assert (fronts[0].ups, fronts[0].downs) == (fronts[1].ups, fronts[1].downs)
    logs = []
    for name in ("mine", "ref"):
        rows = [json.loads(ln) for ln in (tmp_path / name / CONTROLLER_LOG).read_text().splitlines()]
        logs.append([{k: v for k, v in r.items() if k != "ts"} for r in rows])
    assert logs[0] == logs[1]


def test_gateway_control_ticks_equal_reference(tmp_path):
    """The in-process plane on both packages' gateways, on the same clock
    and the same request latencies: equal prior knobs, equal tick
    decisions, equal knobs after each tick."""
    from repro.engine import AnomalyService as JaxAnomalyService
    from repro.gateway import AnomalyGateway as JaxAnomalyGateway

    clock = [0.0]
    gws = (AnomalyGateway(AnomalyService(ARCH, schedule="wavefront", device="cpu"),
                          capacity=1, max_batch=8, max_wait_ms=5.0, clock=lambda: clock[0]),
           JaxAnomalyGateway(JaxAnomalyService(ARCH, schedule="wavefront"),
                             capacity=1, max_batch=8, max_wait_ms=5.0, clock=lambda: clock[0]))
    ccfg = dict(slo_p95_ms=20.0, tick_interval_s=1.0, arch=ARCH, floor_timesteps=16,
                patience=1, cooldown_ticks=0)
    ctls = (enable_control(gws[0], ControlConfig(**ccfg)),
            ref_control.enable_control(gws[1], ref_control.ControlConfig(**ccfg)))
    assert ctls[0].floor_ms == ctls[1].floor_ms
    assert [(g.batcher.max_batch, g.batcher.max_wait_ms) for g in gws][0] == \
        [(g.batcher.max_batch, g.batcher.max_wait_ms) for g in gws][1]
    rng = np.random.default_rng(3)
    for tick in range(12):
        lat = rng.choice([2.0, 15.0, 60.0], size=int(rng.integers(0, 30)))
        filled = int(rng.integers(1, 9))
        for g in gws:
            for ms in lat:
                g.telemetry.observe_latency_ms(float(ms))
                g.telemetry.count("queue.submitted")
            g.telemetry.record_batch(filled, 8)
        clock[0] = tick + 1.0
        decisions = [c.maybe_tick() for c in ctls]
        assert decisions[0] == decisions[1]
        assert (gws[0].batcher.max_batch, gws[0].batcher.max_wait_ms) == \
            (gws[1].batcher.max_batch, gws[1].batcher.max_wait_ms)
    assert ctls[0].describe() == ctls[1].describe()
