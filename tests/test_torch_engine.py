"""Port parity of the execution engine: every schedule of repro_torch against
the JAX package's Engine on the four paper configs, with carried weights;
plus the registry, streaming and Eq-1 accounting surfaces."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

from repro.config import get_config as jax_get_config  # noqa: E402
from repro.core import init_lstm_ae as jax_init_lstm_ae  # noqa: E402
from repro.engine import build_engine as jax_build_engine  # noqa: E402
from repro_torch.config import ModelConfig, get_config  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    Engine,
    EngineConfig,
    Placement,
    Schedule,
    available_schedules,
    build_engine,
    register_schedule,
    resolve_schedule,
    unregister_schedule,
)
from repro_torch.engine import schedules  # noqa: E402
from repro_torch.models import prefill  # noqa: E402

PAPER_ARCHS = ["lstm-ae-f32-d2", "lstm-ae-f32-d6", "lstm-ae-f64-d2", "lstm-ae-f64-d6"]
SCHEDULES = ["sequential", "wavefront", "pipelined", "fused"]
RTOL, ATOL = 1e-5, 1e-6


@functools.lru_cache(maxsize=None)
def _setup(arch: str, t: int = 7, b: int = 3):
    cfg = jax_get_config(arch)
    params = jax.tree.map(np.asarray, jax_init_lstm_ae(jax.random.PRNGKey(0), cfg))
    series = np.random.default_rng(1).standard_normal((b, t, cfg.lstm_ae.input_features))
    return params, series.astype(np.float32)


def _pair(arch, schedule):
    params, series = _setup(arch)
    ref = jax_build_engine(jax_get_config(arch), schedule, params=params)
    mine = build_engine(get_config(arch), schedule, params=params, device="cpu")
    return ref, mine, series


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", PAPER_ARCHS)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_reconstruct_matches_reference(arch, schedule):
    ref, mine, series = _pair(arch, schedule)
    assert mine.schedule.tag == ref.schedule.tag
    got = mine.reconstruct({"series": torch.from_numpy(series)})
    assert tuple(got.shape) == series.shape
    _close(got, ref.reconstruct({"series": series}))


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_score_and_score_masked_match_reference(schedule):
    ref, mine, series = _pair("lstm-ae-f32-d6", schedule)
    _close(mine.score({"series": series}), ref.score({"series": series}))
    # end-padded rows (and one all-padding row): only valid steps count
    padded = series.copy()
    lengths = np.array([7, 4, 0], np.int32)
    for i, n in enumerate(lengths):
        padded[i, n:] = 0.0
    batch = {"series": padded, "lengths": lengths}
    got = mine.score_masked(batch)
    _close(got, ref.score_masked(batch))
    solo = mine.score({"series": series[1:2, :4]})
    np.testing.assert_allclose(got[1:2].numpy(), solo.numpy(), rtol=RTOL, atol=ATOL)
    assert float(got[2]) == 0.0


@pytest.mark.parametrize("arch", ["lstm-ae-f32-d2", "lstm-ae-f64-d6"])
def test_stream_and_stream_masked_match_reference(arch):
    ref, mine, series = _pair(arch, "wavefront")
    ref_state, state = ref.init_stream_state(3), mine.init_stream_state(3)
    mask = np.array([True, False, True])
    for t in range(series.shape[1]):
        x_t = series[:, t]
        ref_y, ref_state = ref.stream_masked(x_t, ref_state, mask)
        y, state = mine.stream_masked(torch.from_numpy(x_t), state, torch.from_numpy(mask))
        _close(y, ref_y)
    for key in ("h", "c"):
        for got, want in zip(state[key], ref_state[key]):
            _close(got, want)
    # unmasked streaming == batch reconstruction
    state, ys = mine.init_stream_state(3), []
    for t in range(series.shape[1]):
        y, state = mine.stream(series[:, t], state)
        ys.append(y)
    _close(torch.stack(ys, dim=1), ref.reconstruct({"series": series}))


def test_prefill_routes_through_the_registry():
    params, series = _setup("lstm-ae-f32-d2")
    engine = build_engine(get_config("lstm-ae-f32-d2"), "sequential", params=params, device="cpu")
    want = engine.score({"series": series})
    for schedule in ("sequential", "wavefront", "fused"):
        got, _ = prefill(engine.params, {"series": torch.from_numpy(series)},
                         get_config("lstm-ae-f32-d2"), schedule=schedule)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="unknown schedule"):
        prefill(engine.params, {"series": torch.from_numpy(series)},
                get_config("lstm-ae-f32-d2"), schedule="bogus")


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("arch", PAPER_ARCHS)
def test_latency_model_equals_reference(arch, schedule):
    ref = jax_build_engine(jax_get_config(arch), schedule)
    mine = build_engine(get_config(arch), schedule, device="cpu")
    for t in (1, 16, 64):
        assert dataclasses.asdict(mine.latency_model(t)) == dataclasses.asdict(ref.latency_model(t))
    assert dataclasses.asdict(mine.latency_model(64, rh_m=3)) == \
        dataclasses.asdict(ref.latency_model(64, rh_m=3))


def test_registry_lists_builtin_schedules_and_rejects_unknown():
    assert set(SCHEDULES) <= set(available_schedules())
    with pytest.raises(ValueError, match="unknown schedule 'bogus'.*available"):
        build_engine(get_config("lstm-ae-f32-d2"), "bogus", device="cpu")


def test_pipelined_resolves_to_wavefront_on_one_gpu():
    engine = build_engine(get_config("lstm-ae-f32-d6"), "pipelined", device="cpu")
    assert (engine.schedule.name, engine.schedule.resolved) == ("pipelined", "wavefront")
    assert engine.schedule.tag == "pipelined->wavefront"
    assert engine.schedule.latency_kind == "dataflow"
    # two explicit stages on the CPU emulate two devices: the pipeline runs
    two = build_engine(get_config("lstm-ae-f32-d6"), EngineConfig("pipelined", n_stages=2),
                       device="cpu")
    assert two.schedule.tag == "pipelined" and two.schedule.prejitted
    # too few devices is refused, never degraded to fewer stages or shards
    with pytest.raises(ValueError, match=r"needs 2 devices \(1 data x 2 stages\), have 1"):
        build_engine(get_config("lstm-ae-f32-d6"),
                     EngineConfig("pipelined", n_stages=2, placement=Placement(devices=("cpu",))),
                     device="cpu")
    with pytest.raises(ValueError, match="needs at least 4 devices"):
        build_engine(get_config("lstm-ae-f32-d6"),
                     EngineConfig("pipelined", placement=Placement.data(2)), device="cpu")


def test_fused_schedule_keeps_sequential_accounting():
    engine = build_engine(get_config("lstm-ae-f32-d2"), "fused", device="cpu")
    assert engine.schedule.resolved == "fused"
    assert engine.schedule.latency_kind == "sequential"


def test_resolve_cache_keyed_and_capped():
    cfg = get_config("lstm-ae-f32-d2")
    s0 = resolve_schedule("wavefront", cfg, EngineConfig("wavefront"))
    assert s0 is resolve_schedule("wavefront", cfg, EngineConfig("wavefront", n_stages=5))
    assert s0 is not resolve_schedule("wavefront", cfg, EngineConfig("wavefront", pwl=True))

    @register_schedule("_cache_probe")  # no config_fields: keys on everything
    def _probe(cfg, ecfg):
        return Schedule("_cache_probe", "_cache_probe", "sequential", lambda p, xs: xs)

    try:
        for i in range(1, 3 * schedules.SCHEDULE_CACHE_CAPACITY):
            resolve_schedule("_cache_probe", cfg, EngineConfig("_cache_probe", n_stages=i))
            assert len(schedules._RESOLVE_CACHE) <= schedules.SCHEDULE_CACHE_CAPACITY
    finally:
        unregister_schedule("_cache_probe")
    assert "_cache_probe" not in available_schedules()


def test_engine_rejects_non_lstm_ae_and_requires_params():
    with pytest.raises(ValueError, match="lstm_ae"):
        Engine(ModelConfig(name="tiny-lm", family="transformer"), "wavefront", device="cpu")
    with pytest.raises(TypeError, match="ModelConfig"):
        build_engine("lstm-ae-f32-d2", device="cpu")
    params, series = _setup("lstm-ae-f32-d2")
    engine = build_engine(get_config("lstm-ae-f32-d2"), "wavefront", device="cpu")
    with pytest.raises(ValueError, match="bind"):
        engine.score({"series": series})
    assert engine.bind(params) is engine
    assert tuple(engine.score({"series": series}).shape) == (3,)
    assert "bound=True" in repr(engine) and "device=cpu" in repr(engine)
