"""The port's streaming gateway on the CPU: the contract of
tests/test_gateway.py (pooled sessions indistinguishable from solo
streaming, micro-batched scores equal to direct scores, admission control,
flush failure, recalibration, telemetry), plus parity with the JAX gateway
on the same weights and inputs, and the launcher's --gateway mode."""
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

from _hypothesis_compat import given, settings, st  # noqa: E402
from conftest import GATEWAY_ARCH as ARCH  # noqa: E402
from conftest import GATEWAY_FEATS as FEATS  # noqa: E402
from conftest import breaking_score_masked  # noqa: E402
from conftest import gateway_series as _series  # noqa: E402
from repro.engine import AnomalyService as JaxAnomalyService  # noqa: E402
from repro.gateway import AnomalyGateway as JaxAnomalyGateway  # noqa: E402
from repro.gateway import bucket_for as jax_bucket_for  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.data import TimeseriesConfig  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    AnomalyService,
    Placement,
    available_schedules,
    build_engine,
    schedule_cache_info,
)
from repro_torch.gateway import (  # noqa: E402
    AnomalyGateway,
    GatewayOverloadedError,
    PoolFullError,
    UnknownStreamError,
    bucket_for,
    drive_stream_churn,
)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _svc(schedule="wavefront", seed=0):
    return AnomalyService(ARCH, schedule=schedule, device="cpu", seed=seed)


@pytest.fixture(scope="module")
def svc():
    return _svc()


def _solo_errors(svc, samples) -> list:
    """Running errors of one stream stepped alone (B=1), per timestep."""
    sess = svc.stream_start(1)
    out = []
    for x in samples:
        errs, sess = svc.stream_step(torch.from_numpy(np.asarray(x)[None]), sess)
        out.append(float(errs[0]))
    return out


def _direct(svc, w) -> float:
    return float(svc.score(torch.from_numpy(w[None]))[0])


# -- pool semantics --------------------------------------------------------


def test_pool_admit_evict_capacity(svc):
    gw = AnomalyGateway(svc, capacity=3)
    assert [gw.admit(i) for i in range(3)] == [0, 1, 2]   # lowest slot first
    with pytest.raises(PoolFullError):
        gw.admit(99)
    with pytest.raises(ValueError, match="already resident"):
        gw.admit(0)
    gw.evict(1)
    assert gw.admit(99) == 1  # the freed slot is reused
    with pytest.raises(UnknownStreamError):
        gw.step({1: np.zeros(FEATS, np.float32)})
    with pytest.raises(UnknownStreamError):
        gw.evict("never-admitted")
    assert gw.stats()["counters"]["pool.rejected"] == 1


def test_pool_rejects_bad_sample_shape(svc):
    gw = AnomalyGateway(svc, capacity=2)
    gw.admit("a")
    with pytest.raises(ValueError, match="sample shape"):
        gw.step({"a": np.zeros(FEATS + 1, np.float32)})


@pytest.mark.parametrize("schedule", sorted(available_schedules()))
def test_pool_interleaved_matches_solo(schedule):
    """Eight streams stepped on irregular subsets of rounds match solo
    ``stream_step`` runs, for every registered schedule."""
    svc = _svc(schedule)
    n, t_len = 8, 10
    gw = AnomalyGateway(svc, capacity=n)
    data = [_series(i, t_len) for i in range(n)]
    solo = [_solo_errors(svc, data[i]) for i in range(n)]
    cursor = [0] * n
    for i in range(n):
        gw.admit(i)
    round_ = 0
    while any(c < t_len for c in cursor):
        stepping = {i: data[i][cursor[i]] for i in range(n)
                    if cursor[i] < t_len and (round_ + i) % 3 != i % 2}
        if stepping:
            running = gw.step(stepping)
            for i in stepping:
                np.testing.assert_allclose(running[i], solo[i][cursor[i]], rtol=RTOL, atol=ATOL)
                cursor[i] += 1
        round_ += 1
    for i in range(n):
        np.testing.assert_allclose(gw.evict(i), solo[i][-1], rtol=RTOL, atol=ATOL)


@settings(max_examples=4, deadline=None)
@given(
    masks=st.lists(st.integers(0, 255), min_size=3, max_size=5),
    churn=st.lists(st.integers(0, 7), min_size=1, max_size=3),
)
def test_pool_property_any_interleaving(svc, masks, churn):
    """Any interleaving of admit/step/evict gives each stream the running
    errors it would see alone through ``AnomalyService.stream_step``."""
    n = 8
    gw = AnomalyGateway(svc, capacity=n)
    gen = [0] * n
    consumed: dict = {}

    def sid(i):
        return (i, gen[i])

    for i in range(n):
        gw.admit(sid(i))
        consumed[sid(i)] = []
    for r, mask in enumerate(masks):
        stepping = {}
        for i in range(n):
            if (mask >> i) & 1:
                x = _series(i, seed=100 + gen[i])[len(consumed[sid(i)]) % 16]
                consumed[sid(i)].append(x)
                stepping[sid(i)] = x
        if stepping:
            running = gw.step(stepping)
            for s in stepping:
                np.testing.assert_allclose(running[s], _solo_errors(svc, consumed[s])[-1],
                                           rtol=RTOL, atol=ATOL)
        i = churn[r % len(churn)]
        final = gw.evict(sid(i))
        if consumed[sid(i)]:
            np.testing.assert_allclose(final, _solo_errors(svc, consumed[sid(i)])[-1],
                                       rtol=RTOL, atol=ATOL)
        del consumed[sid(i)]
        gen[i] += 1
        gw.admit(sid(i))
        consumed[sid(i)] = []


def test_pool_reset_restarts_error_accumulation(svc):
    gw = AnomalyGateway(svc, capacity=2)
    gw.admit("a")
    data = _series(3, 6)
    for t in range(3):
        gw.step({"a": data[t]})
    gw.reset("a")
    for t in range(3):
        running = gw.step({"a": data[t]})
    np.testing.assert_allclose(running["a"], _solo_errors(svc, data[:3])[-1], rtol=RTOL, atol=ATOL)


def test_pool_export_and_restore_round_trip(svc):
    """A stream exported from one pool and restored into another carries
    on exactly as if it had never moved; exports are copies."""
    data = _series(4, 8)
    a = AnomalyGateway(svc, capacity=3)
    a.admit("x")
    for t in range(4):
        a.step({"x": data[t]})
    rows, sq, steps = a.pool.export_slot("x")
    leaves, sq_block, steps_block = a.pool.export_block()
    slot = a.pool.slot_of("x")
    for row, leaf in zip(rows, leaves):
        np.testing.assert_array_equal(row, leaf[slot])
    assert (sq, steps) == (float(sq_block[slot]), int(steps_block[slot])) and steps == 4
    leaves[0][slot] = 123.0          # the export shares no memory with the pool
    assert a.pool.export_block()[0][0][slot].max() != 123.0
    b = AnomalyGateway(svc, capacity=3)
    b.admit("other")
    assert b.pool.restore("x", rows, sq, steps) == 1
    for t in range(4, 8):
        running = b.step({"x": data[t]})
    np.testing.assert_allclose(running["x"], _solo_errors(svc, data)[-1], rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="state layout"):
        b.pool.restore("y", rows[:-1], sq, steps)
    assert b.stats()["counters"]["pool.restored"] == 1


def test_drive_stream_churn_accounts_for_all_streams(svc):
    gw = AnomalyGateway(svc, capacity=2)
    windows = np.stack([_series(i, 10) for i in range(6)])
    finals, unserved = drive_stream_churn(gw, windows, churn_every=4)
    assert set(finals) | set(unserved) == set(range(6))
    assert not set(finals) & set(unserved)
    assert len(finals) == 4  # 2 slots + 2 churn rotations (t=4, t=8)
    assert gw.pool.active == 0
    # stream 0 was evicted after t=4: it saw samples 0..4 alone
    np.testing.assert_allclose(finals[0], _solo_errors(svc, windows[0, :5])[-1],
                               rtol=RTOL, atol=ATOL)
    # stream 2 was admitted after t=4: it scored its tail 5..9
    np.testing.assert_allclose(finals[2], _solo_errors(svc, windows[2, 5:])[-1],
                               rtol=RTOL, atol=ATOL)


# -- micro-batching queue --------------------------------------------------


def test_bucket_ladder():
    for t in (1, 7, 8, 9, 16, 17, 64, 65, 1024, 1025, 5000):
        assert bucket_for(t) == jax_bucket_for(t)
    assert (bucket_for(1), bucket_for(9), bucket_for(1025)) == (8, 16, 2048)


@pytest.mark.parametrize("schedule", ["wavefront", "fused"])
def test_batcher_matches_direct_score_across_buckets(schedule):
    """Mixed lengths across bucket boundaries: padded bucket scoring equals
    direct (B=1, exact-length) scoring per request."""
    svc = _svc(schedule)
    gw = AnomalyGateway(svc, capacity=1, max_batch=4, max_wait_ms=0.0)
    lens = [5, 8, 9, 16, 17, 31, 12, 7]
    windows = [_series(i, n, seed=5) for i, n in enumerate(lens)]
    scores = gw.score(windows)
    for w, s in zip(windows, scores):
        np.testing.assert_allclose(s, _direct(svc, w), rtol=RTOL, atol=ATOL)
    shapes = gw.stats()["engine"]["per_program"]["score_masked"]["shapes"]
    assert sorted({tuple(s) for s in shapes}) == [(4, 8, FEATS), (4, 16, FEATS), (4, 32, FEATS)]


def test_batcher_takes_tensors(svc):
    gw = AnomalyGateway(svc, capacity=1, max_batch=2, max_wait_ms=0.0)
    w = _series(1, 9)
    got = gw.score([torch.from_numpy(w), w])
    np.testing.assert_allclose(got, [_direct(svc, w)] * 2, rtol=RTOL, atol=ATOL)


def test_batcher_backpressure(svc):
    gw = AnomalyGateway(svc, capacity=1, max_batch=8, max_queue=3, max_wait_ms=1e9)
    for i in range(3):
        gw.submit(_series(i, 6))
    with pytest.raises(GatewayOverloadedError):
        gw.submit(_series(9, 6))
    assert gw.stats()["counters"]["queue.rejected"] == 1
    gw.flush()
    gw.submit(_series(9, 6))


def test_batcher_flush_on_max_batch(svc):
    gw = AnomalyGateway(svc, capacity=1, max_batch=3, max_wait_ms=1e9)
    tickets = [gw.submit(_series(i, 6)) for i in range(3)]
    assert all(t.done for t in tickets)
    assert gw.batcher.queue_depth == 0


def test_batcher_flush_on_max_wait(svc):
    clock_now = [0.0]
    gw = AnomalyGateway(svc, capacity=1, max_batch=8, max_wait_ms=50.0,
                        clock=lambda: clock_now[0])
    t = gw.submit(_series(0, 6))
    assert gw.pump() == 0 and not t.done
    clock_now[0] = 0.049
    assert gw.pump() == 0 and not t.done
    clock_now[0] = 0.051
    assert gw.pump() == 1 and t.done
    assert t.stage_ms["queue_wait"] == pytest.approx(51.0)
    with pytest.raises(RuntimeError, match="pump"):
        AnomalyGateway(svc, capacity=1).submit(_series(0, 6)).score  # noqa: B018


def test_batcher_set_knobs_clamps_to_lanes(svc):
    gw = AnomalyGateway(svc, capacity=1, max_batch=4, max_wait_ms=1e9)
    assert gw.batcher.lanes == 4
    assert gw.batcher.set_knobs(max_batch=100, max_wait_ms=-3) == {"max_batch": 4,
                                                                    "max_wait_ms": 0.0}
    assert gw.batcher.set_knobs(max_batch=2)["max_batch"] == 2
    tickets = [gw.submit(_series(i, 6)) for i in range(2)]
    assert all(t.done for t in tickets)


def test_batcher_rejects_bad_shapes_and_oversized_windows(svc):
    gw = AnomalyGateway(svc, capacity=1, max_seq_len=32)
    with pytest.raises(ValueError, match="window"):
        gw.submit(np.zeros((4, FEATS + 1), np.float32))
    with pytest.raises(ValueError, match="window"):
        gw.submit(np.zeros((FEATS,), np.float32))
    with pytest.raises(ValueError, match="empty window"):
        gw.submit(np.zeros((0, FEATS), np.float32))
    gw.submit(_series(0, 32))
    with pytest.raises(ValueError, match="max_seq_len"):
        gw.submit(_series(1, 33))
    assert gw.batcher.queue_depth == 1
    assert AnomalyGateway(svc, capacity=1).batcher.max_seq_len == 1024


# -- flush failure ---------------------------------------------------------


class _Boom(RuntimeError):
    pass


def _breaking(engine, fail_times):
    return breaking_score_masked(engine, fail_times, lambda: _Boom("engine exploded mid-flush"))


def test_flush_failure_fails_tickets_and_recovers(monkeypatch):
    svc = _svc()
    gw = AnomalyGateway(svc, capacity=1, max_batch=4, max_queue=4, max_wait_ms=1e9)
    monkeypatch.setattr(svc.engine, "score_masked", _breaking(svc.engine, [1]))
    tickets = [gw.submit(_series(i, 6)) for i in range(4)]
    assert all(t.done and t.failed for t in tickets)
    assert isinstance(tickets[0].exception(), _Boom)
    with pytest.raises(_Boom):
        tickets[0].score  # noqa: B018
    assert gw.batcher.queue_depth == 0
    s = gw.stats()
    assert s["counters"]["queue.failed"] == 4
    assert s["counters"].get("queue.completed", 0) == 0
    fresh = [gw.submit(_series(i, 6, seed=2)) for i in range(4)]
    assert all(t.done and not t.failed for t in fresh)
    np.testing.assert_allclose(fresh[0].score, _direct(svc, _series(0, 6, seed=2)),
                               rtol=RTOL, atol=ATOL)
    assert gw.stats()["counters"]["queue.completed"] == 4


def test_flush_failure_via_pump_keeps_queue_usable(monkeypatch):
    svc = _svc()
    clock_now = [0.0]
    gw = AnomalyGateway(svc, capacity=1, max_batch=8, max_wait_ms=10.0,
                        clock=lambda: clock_now[0])
    monkeypatch.setattr(svc.engine, "score_masked", _breaking(svc.engine, [1]))
    dead = gw.submit(_series(0, 6))
    clock_now[0] = 0.02
    assert gw.pump() == 0 and dead.failed
    assert gw.batcher.queue_depth == 0
    live = gw.submit(_series(1, 6))
    clock_now[0] = 0.04
    assert gw.pump() == 1 and live.done and not live.failed


def test_ticket_callbacks_fire_on_success_and_error(monkeypatch):
    svc = _svc()
    gw = AnomalyGateway(svc, capacity=1, max_batch=2, max_wait_ms=1e9)
    seen = []
    t1 = gw.submit(_series(0, 6))
    t1.add_done_callback(lambda t: seen.append(("a", t.failed)))
    t1.add_done_callback(lambda t: 1 / 0)  # must not block t2's callback
    t2 = gw.submit(_series(1, 6))
    t2.add_done_callback(lambda t: seen.append(("b", t.failed)))  # after completion
    assert seen == [("a", False), ("b", False)]
    monkeypatch.setattr(svc.engine, "score_masked", _breaking(svc.engine, [1]))
    t3 = gw.submit(_series(2, 6))
    t3.add_done_callback(lambda t: seen.append(("c", t.failed)))
    gw.submit(_series(3, 6))
    assert seen[-1] == ("c", True)


# -- live recalibration ----------------------------------------------------


def test_recalibrate_under_resident_streams():
    svc = _svc()
    gw = AnomalyGateway(svc, capacity=2, max_batch=2, max_wait_ms=0.0)
    gw.admit("a")
    data = _series(0, 8)
    for t in range(4):
        running = gw.step({"a": data[t]})
    before = running["a"]
    assert gw.threshold is None
    out = gw.recalibrate(threshold=0.25)
    assert out == {"threshold": 0.25, "params_swapped": False}
    assert gw.threshold == 0.25 and svc.threshold == 0.25
    assert gw.pool.active == 1
    assert gw.pool.error_of("a") == before
    for t in range(4, 8):
        running = gw.step({"a": data[t]})
    np.testing.assert_allclose(running["a"], _solo_errors(svc, data)[-1], rtol=RTOL, atol=ATOL)
    assert bool(svc.alerts(torch.from_numpy(data[None]))[0]) == (running["a"] > 0.25)
    gw.recalibrate(threshold=None)
    assert gw.threshold is None
    assert gw.stats()["counters"]["gateway.recalibrated"] == 2


def test_recalibrate_swaps_params_atomically():
    svc, other = _svc(), _svc(seed=123)
    gw = AnomalyGateway(svc, capacity=2, max_batch=1, max_wait_ms=0.0)
    gw.admit("a")
    gw.step({"a": _series(5, 6)[0]})
    out = gw.recalibrate(params=other.params, threshold=0.5)
    assert out["params_swapped"] and gw.pool.active == 1
    w = _series(6, 8)
    np.testing.assert_allclose(gw.score([w])[0], _direct(other, w), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_direct(svc, w), _direct(other, w), rtol=RTOL, atol=ATOL)


def test_recalibrate_restores_a_params_snapshot():
    """The reference's swap and restore (tests/test_gateway.py::
    test_recalibrate_swaps_params_atomically): a snapshot of ``svc.params``
    taken before a swap or a fit is not written by either, and rebinding it
    serves it again."""
    svc, other = _svc(), _svc(seed=123)
    gw = AnomalyGateway(svc, capacity=2, max_batch=1, max_wait_ms=0.0)
    w = _series(6, 8)
    old, want = svc.params, (gw.score([w])[0], _direct(svc, w))
    kept = [t.clone() for t in tree_leaves(old)]
    gw.recalibrate(params=other.params)
    np.testing.assert_allclose(gw.score([w])[0], _direct(other, w), rtol=RTOL, atol=ATOL)
    svc.fit(TimeseriesConfig(features=FEATS, seq_len=8, batch=4), steps=1)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(old), kept))
    gw.recalibrate(params=old)
    assert (gw.score([w])[0], _direct(svc, w)) == want


def test_gateway_over_bare_engine_owns_threshold(svc):
    gw = AnomalyGateway(svc.engine, capacity=1)
    assert gw.service is None and gw.threshold is None
    gw.recalibrate(threshold=1.5)
    assert gw.threshold == 1.5 and gw.stats()["threshold"] == 1.5
    other = _svc(seed=7)
    gw.recalibrate(params=other.params)   # a bare engine rebinds itself
    w = _series(2, 8)
    np.testing.assert_allclose(gw.score([w])[0], _direct(other, w), rtol=RTOL, atol=ATOL)


# -- wiring ----------------------------------------------------------------


def test_stats_keys_match_the_reference():
    ref_svc = JaxAnomalyService(ARCH, schedule="wavefront")
    ref, mine = JaxAnomalyGateway(ref_svc, capacity=4, max_batch=4, max_wait_ms=0.0), \
        AnomalyGateway(_svc(), capacity=4, max_batch=4, max_wait_ms=0.0)
    for gw in (ref, mine):
        gw.admit("a")
        gw.admit("b")
        for t in range(4):
            gw.step({"a": _series(0, 8)[t], "b": _series(1, 8)[t]})
        gw.score([_series(2, 10), _series(3, 10)])
    s, r = mine.stats(), ref.stats()
    assert sorted(s) == sorted(r)
    assert sorted(s["engine"]) == sorted(r["engine"])
    assert sorted(s["engine"]["schedule_cache"]) == sorted(r["engine"]["schedule_cache"])
    assert sorted(s["counters"]) == sorted(r["counters"])
    assert sorted(s["gauges"]) == sorted(r["gauges"])
    assert sorted(s["histograms"]) == sorted(r["histograms"])
    assert s["schedule"] == "wavefront" and s["capacity"] == 4 and s["active_streams"] == 2
    assert s["counters"]["pool.stream_steps"] == 8 and s["counters"]["queue.completed"] == 2
    assert s["batch_fill_ratio"] == r["batch_fill_ratio"] == 0.5
    assert s["latency_ms"]["count"] == 2
    assert s["gauges"]["pool.occupancy"] == 0.5 and s["gauges"]["pool.step_fill"] == 0.5
    assert s["stream_steps_per_s"] > 0
    assert s["engine"]["schedule_cache"]["placements"] == ["Placement.single()"]
    per = s["engine"]["per_program"]
    assert per["mstep"]["shapes"] == [[4, FEATS]] and per["score_masked"]["shapes"] == [[4, 16, FEATS]]


def test_schedule_cache_counts_hits_and_misses():
    before = schedule_cache_info()
    build_engine(get_config(ARCH), "sequential", device="cpu")
    build_engine(get_config(ARCH), "sequential", device="cpu")
    after = schedule_cache_info()
    assert after["hits"] + after["misses"] == before["hits"] + before["misses"] + 2
    assert after["hits"] >= before["hits"] + 1
    assert after["capacity"] == 32 and after["always_keyed"] == ("schedule", "placement")


def test_engine_placement_and_profile(svc):
    eng = svc.engine
    assert eng.placement == Placement.single()
    assert eng.with_placement(Placement.single()) is eng
    assert AnomalyGateway(svc, capacity=1, placement=Placement.single()).engine is eng
    # another placement: the gateway's own engine, rows over two emulated CPUs
    gw2 = AnomalyGateway(svc, capacity=1, placement=Placement.data(2))
    assert gw2.engine is not eng and gw2.engine.placement == Placement.data(2)
    assert gw2.engine.shard_devices == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="needs 2 devices"):
        AnomalyGateway(svc, capacity=1, placement=Placement.data(2, devices=("cpu",)))
    for bad in (1, "data=1"):
        with pytest.raises(TypeError, match="placement must be a Placement"):
            AnomalyGateway(svc, capacity=1, placement=bad)
    info = eng.profile_info()
    assert set(info) == {"schedule", "compiles", "compile_ms", "per_program"}


def test_service_open_gateway_binds_engine(svc):
    gw = svc.open_gateway(capacity=2, max_batch=4)
    assert gw.engine is svc.engine and gw.service is svc
    assert gw.pool.capacity == 2 and gw.batcher.max_batch == 4
    assert gw.durability is None and gw.control is None
    assert gw in svc._gateways


def test_recalibrate_rebinds_every_open_gateway_engine():
    """A registered gateway whose engine is not the service's own is rebound
    on every param swap, and a dropped gateway leaves the registry."""
    svc, other = _svc(), _svc(seed=9)
    own = svc.open_gateway(capacity=1, max_batch=1)
    side = AnomalyGateway(build_engine(svc.cfg, "fused", params=svc.params, device="cpu"),
                          capacity=1, max_batch=1)
    svc._gateways.add(side)
    svc.recalibrate(params=other.params)
    w = _series(3, 8)
    for gw in (own, side):
        np.testing.assert_allclose(gw.score([w])[0], _direct(other, w), rtol=RTOL, atol=ATOL)
    del side, gw
    gc.collect()
    assert list(svc._gateways) == [own]


def test_gateway_requires_bound_params_and_a_port_engine(svc):
    with pytest.raises(ValueError, match="bind"):
        AnomalyGateway(build_engine(get_config(ARCH), "wavefront", device="cpu"), capacity=2)
    with pytest.raises(TypeError, match="AnomalyService or Engine"):
        AnomalyGateway(object(), capacity=2)
    with pytest.raises(TypeError, match="AnomalyService or Engine"):
        AnomalyGateway(JaxAnomalyService(ARCH, schedule="wavefront"), capacity=2)


# -- cross-package parity --------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    """The JAX gateway and the port's, on the same (JAX-initialised) weights."""
    ref_svc = JaxAnomalyService(ARCH, schedule="wavefront")
    mine = _svc("fused")
    mine.recalibrate(params=jax.tree.map(np.asarray, ref_svc.params))
    return ref_svc, mine


def test_pool_and_export_match_jax_gateway(pair):
    ref_svc, mine = pair
    ref = JaxAnomalyGateway(ref_svc, capacity=6)
    gw = AnomalyGateway(mine, capacity=6)
    data = {i: _series(i, 12, seed=21) for i in range(8)}
    cursor = dict.fromkeys(data, 0)
    for i in range(6):
        assert ref.admit(i) == gw.admit(i)
    for r in range(10):
        stepping = {i: data[i][cursor[i]] for i in gw.pool.resident if (r + i) % 4}
        got, want = gw.step(stepping), ref.step(stepping)
        for i in stepping:
            np.testing.assert_allclose(got[i], want[i], rtol=RTOL, atol=ATOL)
            cursor[i] += 1
        if r in (3, 6):   # churn: the same slots free and refill in both
            old, new = r // 3 - 1, 5 + r // 3
            np.testing.assert_allclose(gw.evict(old), ref.evict(old), rtol=RTOL, atol=ATOL)
            assert gw.admit(new) == ref.admit(new)
    leaves, sq, steps = gw.pool.export_block()
    jleaves, jsq, jsteps = ref.pool.export_block()
    assert [l.shape for l in leaves] == [l.shape for l in jleaves]
    assert [l.shape[1] for l in leaves] == [16, 32, 16, 32]   # every c leaf, then every h leaf
    for got, want in zip(leaves, jleaves):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sq, jsq, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(steps, jsteps)
    # a snapshot of the JAX pool restores into the port's and carries on
    rows, jsq1, jsteps1 = ref.pool.export_slot(2)
    gw.evict(2)
    gw.pool.restore(2, rows, jsq1, jsteps1)
    x = data[2][cursor[2]]
    np.testing.assert_allclose(gw.step({2: x})[2], ref.step({2: x})[2], rtol=RTOL, atol=ATOL)


def test_batcher_scores_match_jax_gateway(pair):
    ref_svc, mine = pair
    ref = JaxAnomalyGateway(ref_svc, capacity=1, max_batch=4, max_wait_ms=0.0)
    gw = AnomalyGateway(mine, capacity=1, max_batch=4, max_wait_ms=0.0)
    lens = [3, 8, 9, 16, 17, 30, 12, 5, 40]
    windows = [_series(i, n, seed=33) for i, n in enumerate(lens)]
    np.testing.assert_allclose(gw.score(windows), ref.score(windows), rtol=RTOL, atol=ATOL)
    assert gw.stats()["batch_fill_ratio"] == ref.stats()["batch_fill_ratio"]


# -- launcher --------------------------------------------------------------


def test_launcher_gateway_mode(capsys):
    serve.main(["--arch", ARCH, "--gateway", "--device", "cpu", "--capacity", "3",
                "--max-batch", "2", "--seq-len", "10", "--requests", "5", "--streams", "5"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[gateway]")]
    assert len(lines) == 5
    assert "AnomalyGateway(schedule=wavefront, capacity=3" in lines[1]
    assert "streamed 4/5 logical streams over 3 slots" in lines[2]
    assert "1 still waiting at end" in lines[2]
    assert "scored 5 one-shot requests" in lines[3]
    assert "stream_steps_per_s=" in lines[4] and "rejected=0" in lines[4]
    # --train-steps fits and calibrates first, then serves as above
    serve.main(["--arch", ARCH, "--gateway", "--device", "cpu", "--train-steps", "2",
                "--capacity", "3", "--max-batch", "2", "--seq-len", "10", "--requests", "5",
                "--streams", "5"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[gateway]")]
    assert len(lines) == 6 and lines[0].startswith(f"[gateway] fitted {ARCH}")
    assert "threshold=" in lines[0]
    assert "scored 5 one-shot requests" in lines[4] and "alerts=" in lines[4]
