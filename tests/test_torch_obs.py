"""The port's copies of the pure-Python observability modules (histograms,
spans, event log, telemetry) and its Placement, held to the originals:
the same samples give bit-for-bit the same buckets, merges, percentiles,
serialised dicts and stats."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.engine.placement import Placement as JaxPlacement  # noqa: E402
from repro.gateway import telemetry as jt  # noqa: E402
from repro.obs import events as jev  # noqa: E402
from repro.obs import histogram as jh  # noqa: E402
from repro.obs import trace as jtr  # noqa: E402
from repro_torch.engine.placement import Placement  # noqa: E402
from repro_torch.gateway import telemetry as tt  # noqa: E402
from repro_torch.obs import events as tev  # noqa: E402
from repro_torch.obs import histogram as th  # noqa: E402
from repro_torch.obs import trace as ttr  # noqa: E402


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _samples(seed: int, n: int = 500) -> list:
    """Latencies over many decades, the floor and overflow buckets included
    (finite, so the histograms' sums compare)."""
    rng = np.random.default_rng(seed)
    vals = np.concatenate([rng.lognormal(0.0, 2.5, n), [0.0, -1.0, 1e12, 1e-5]])
    return [float(v) for v in vals]


def test_bucket_layout_matches():
    assert (th.NUM_BUCKETS, th.OVERFLOW_INDEX) == (jh.NUM_BUCKETS, jh.OVERFLOW_INDEX)
    for v in _samples(0) + [float("inf"), float("nan")]:
        assert th.bucket_index(v) == jh.bucket_index(v)
    for idx in range(-1, th.NUM_BUCKETS + 1):
        assert th.bucket_bound(idx) == jh.bucket_bound(idx)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_histograms_merges_and_percentiles_match(seed):
    parts = [_samples(seed + 10 * k, 200) for k in range(3)]
    mine = [th.Histogram() for _ in parts]
    ref = [jh.Histogram() for _ in parts]
    for m, r, vals in zip(mine, ref, parts):
        m.record_many(vals)
        r.record_many(vals)
    merged_m, merged_r = th.Histogram.merged(mine), jh.Histogram.merged(ref)
    union = th.Histogram()
    union.record_many([v for vals in parts for v in vals])
    assert merged_m.counts == merged_r.counts == union.counts
    assert merged_m.count == merged_r.count and merged_m.sum == merged_r.sum
    for p in (0, 1, 25, 50, 90, 95, 99, 99.9, 100):
        assert merged_m.percentile(p) == merged_r.percentile(p)
    assert merged_m.cumulative() == merged_r.cumulative()
    assert merged_m.to_dict() == merged_r.to_dict()
    back_m = th.Histogram.from_dict(json.loads(json.dumps(merged_r.to_dict())))
    back_r = jh.Histogram.from_dict(json.loads(json.dumps(merged_m.to_dict())))
    assert back_m.to_dict() == back_r.to_dict() == merged_r.to_dict()
    assert th.Histogram.from_dict(None).to_dict() == jh.Histogram.from_dict(None).to_dict()


def test_percentile_helper_matches():
    vals = sorted(_samples(4, 50)[:50])
    for p in (0, 10, 50, 95, 100):
        assert tt.percentile(vals, p) == jt.percentile(vals, p)
    assert tt.percentile([], 50) == jt.percentile([], 50) == 0.0


def _drive(tel, clock):
    """One deterministic script of telemetry events."""
    for i in range(40):
        clock.t += 0.05
        tel.count("queue.submitted")
        tel.observe_latency_ms(0.5 + (i % 7) * 1.3)
        if i % 5 == 0:
            tel.record_batch(3, 4, wait_ms=float(i))
            tel.count("queue.completed", 3)
        if i % 3 == 0:
            tel.record_pool_step(2 + i % 4, 8)
        tel.observe_stage("assemble_ms", 0.01 * i)
        tel.gauge("queue.depth", i % 9)
    tel.gauge_vec("pool.device_active", [3, 1])


@pytest.mark.parametrize("detail", [True, False])
def test_telemetry_stats_match(detail):
    cm, cr = FakeClock(1.0), FakeClock(1.0)
    mine, ref = tt.Telemetry(clock=cm, detail=detail), jt.Telemetry(clock=cr, detail=detail)
    _drive(mine, cm)
    _drive(ref, cr)
    assert mine.stats() == ref.stats()
    assert mine.windowed_rate("queue.submitted") == ref.windowed_rate("queue.submitted")
    cm.t += 30.0
    cr.t += 30.0
    assert mine.stats() == ref.stats()      # the rate windows have drained
    mine.reset()
    ref.reset()
    assert mine.stats() == ref.stats()
    assert tt.REQUEST_HIST == jt.REQUEST_HIST


def test_spans_and_event_log_match(tmp_path):
    cm, cr = FakeClock(), FakeClock()
    logs = (tev.EventLog(tmp_path / "mine.jsonl", clock=lambda: 5.0),
            jev.EventLog(tmp_path / "ref.jsonl", clock=lambda: 5.0))
    tracers = (ttr.Tracer(clock=cm, events=logs[0], sample_every=2),
               jtr.Tracer(clock=cr, events=logs[1], sample_every=2))
    outs = []
    for tracer, clock in zip(tracers, (cm, cr)):
        spans = []
        for k in range(5):
            span = tracer.start("score", trace_id=f"id{k}")
            clock.t += 0.002
            span.mark("queue_wait")
            span.stage("compute", 1.25)
            clock.t += 0.001
            spans.append(tracer.finish(span).to_dict())
        outs.append((spans, tracer.describe()))
    for log in logs:
        log.emit("recalibrate", threshold=0.5)
        log.close()
        log.emit("dropped")                 # a closed log drops, never raises
    assert outs[0] == outs[1]
    mine, ref = ((tmp_path / n).read_text() for n in ("mine.jsonl", "ref.jsonl"))
    assert mine == ref and len(mine.splitlines()) == 4
    assert not tev.EventLog(None).enabled
    assert repr(tev.EventLog(None)) == repr(jev.EventLog(None))


def test_placement_single_matches():
    mine, ref = Placement.single(), JaxPlacement.single()
    assert mine == Placement() and hash(mine) == hash(Placement())
    assert not mine.is_sharded and mine.data_shards == 1
    assert repr(mine) == repr(ref)
    assert mine.describe() == ref.describe()
    for n in (0, 1, 7, 1024):
        assert mine.pad_rows(n) == ref.pad_rows(n)
    assert mine.shard_of_row(5, 8) == ref.shard_of_row(5, 8) == 0
    assert Placement.from_spec("data=1") == mine
    with pytest.raises(ValueError, match="bad mesh spec"):
        Placement.from_spec("model=2")
    with pytest.raises(ValueError, match="data_shards must be >= 1"):
        Placement(data_shards=0)


def test_placement_beyond_one_gpu_raises():
    """A data placement constructs as the reference's does; laying it out
    over more GPUs than are visible raises, naming ``devices=`` as the way
    to emulate them, and never degrades to fewer shards."""
    for mine, ref in ((Placement.data(2), JaxPlacement.data(2)),
                      (Placement.from_spec("data=4"), JaxPlacement.from_spec("data=4")),
                      (Placement(data_shards=3), JaxPlacement(data_shards=3))):
        assert mine.is_sharded and repr(mine) == repr(ref)
        assert mine.describe() == ref.describe()
        assert [mine.pad_rows(n) for n in (1, 5, 30)] == [ref.pad_rows(n) for n in (1, 5, 30)]
        n = mine.data_shards
        if torch.cuda.device_count() < n:
            with pytest.raises(ValueError, match=r"GPU\(s\) are visible; pass devices="):
                mine.mesh("cuda")
        with pytest.raises(ValueError, match=f"needs {n} devices.*1 devices are named"):
            Placement.data(n, devices=("cpu",)).mesh("cpu")
        assert mine.mesh("cpu").devices == (torch.device("cpu"),) * n
