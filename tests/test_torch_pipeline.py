"""The port's stage pipeline on emulated CPU devices: ``build_stage_params``
bit-equal to the JAX package's, ``pipelined_forward`` on (1, 4) and (2, 4)
meshes against the JAX ``lstm_ae_sequential`` (the sizes of the
reference's ``_PIPELINE_SCRIPT`` in tests/test_temporal.py, whose
``shard_map`` path does not run on the installed jax), the depth-1 FIFO,
and the Engine's ``pipelined`` schedule (``_MULTI_DEVICE_SCRIPT`` of
tests/test_engine.py).  A mesh over ``("cpu",) * N`` is the CPU
counterpart of the reference's ``--xla_force_host_platform_device_count``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.config import get_config  # noqa: E402
from repro_torch.core import temporal as tt  # noqa: E402
from repro_torch.core.lstm import init_lstm_ae, lstm_ae_sequential  # noqa: E402
from repro_torch.engine import EngineConfig, Placement, build_engine  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.utils import params_from_numpy  # noqa: E402

PAPER_ARCHS = ["lstm-ae-f32-d2", "lstm-ae-f32-d6", "lstm-ae-f64-d2", "lstm-ae-f64-d6"]
ARCH, T, B = "lstm-ae-f32-d6", 11, 4          # the reference script's sizes
RTOL, ATOL = 1e-4, 1e-5                       # and its tolerance


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's params and modules (skips where JAX is absent)."""
    jax = pytest.importorskip("jax")
    from repro.config import get_config as jax_get_config
    from repro.core import lstm as jl
    from repro.core import temporal as jt

    def params(arch, seed=0):
        return jax.tree.map(np.asarray, jl.init_lstm_ae(jax.random.PRNGKey(seed),
                                                        jax_get_config(arch)))

    return {"jax": jax, "lstm": jl, "temporal": jt, "config": jax_get_config, "params": params}


def _cpu_mesh(shape):
    return make_host_mesh(shape, ("data", "model"), devices=("cpu",) * int(np.prod(shape)))


def _port_params(seed=0, arch=ARCH):
    return init_lstm_ae(torch.Generator().manual_seed(seed), get_config(arch), "cpu")


@pytest.mark.parametrize("n_stages", [2, 3, 4])
@pytest.mark.parametrize("arch", PAPER_ARCHS)
def test_build_stage_params_bit_equal_to_reference(jax_ref, arch, n_stages):
    tree = jax_ref["params"](arch)
    want_sp, want_counts, want_assign = jax_ref["temporal"].build_stage_params(
        tree, jax_ref["config"](arch), n_stages)
    sp, counts, assign = tt.build_stage_params(params_from_numpy(tree, "cpu"),
                                               get_config(arch), n_stages)
    assert assign == list(want_assign)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    assert set(sp) == set(want_sp)
    for k in sp:
        got, want = sp[k].numpy(), np.asarray(want_sp[k])
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_every_paper_config_puts_all_but_the_last_layer_on_stage_0():
    """A fact of the balancing DP the pipeline inherits: for every paper
    config the last (widest) layer alone outweighs the rest, so stages 2 and
    up are empty pass-through stages."""
    for arch in PAPER_ARCHS:
        depth = len(get_config(arch).lstm_ae.layer_sizes())
        for s in (2, 3, 4, 6):
            _, counts, assign = tt.build_stage_params(_port_params(arch=arch), get_config(arch), s)
            assert assign == [0] * (depth - 1) + [1]
            assert counts.tolist() == [depth - 1, 1] + [0] * (s - 2)


@pytest.mark.parametrize("pwl", [False, True])
@pytest.mark.parametrize("shape", [(1, 4), (2, 4)])
def test_pipelined_forward_matches_reference_sequential(jax_ref, shape, pwl):
    """The reference's _PIPELINE_SCRIPT: lstm-ae-f32-d6, T=11, B=4, four
    stages, one or two data shards, against ``lstm_ae_sequential``."""
    jnp = jax_ref["jax"].numpy
    tree = jax_ref["params"](ARCH)
    xs = np.random.default_rng(1).standard_normal((T, B, 32)).astype(np.float32)
    sp, counts, _ = tt.build_stage_params(params_from_numpy(tree, "cpu"), get_config(ARCH),
                                          shape[1])
    ys = tt.pipelined_forward(sp, counts, torch.from_numpy(xs), mesh=_cpu_mesh(shape),
                              cfg=get_config(ARCH), stage_axis="model",
                              batch_axes=("data",), pwl=pwl)
    want = np.asarray(jax_ref["lstm"].lstm_ae_sequential(tree, jnp.asarray(xs), pwl=pwl))
    assert tuple(ys.shape) == xs.shape
    np.testing.assert_allclose(ys.numpy(), want, rtol=RTOL, atol=ATOL)
    wave = tt.wavefront_forward(params_from_numpy(tree, "cpu"), torch.from_numpy(xs), pwl=pwl)
    np.testing.assert_allclose(ys.numpy(), wave.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape,t_len,b", [((1, 2), 11, 5), ((3, 2), 2, 7), ((1, 6), 1, 3)])
def test_pipelined_forward_uneven_rows_and_short_windows(shape, t_len, b):
    """Rows that do not divide over the data shards split into near-equal
    contiguous blocks; a window shorter than the pipeline (T < S) still
    drains through every stage."""
    params = _port_params(3)
    xs = torch.randn(t_len, b, 32, generator=torch.Generator().manual_seed(4))
    sp, counts, _ = tt.build_stage_params(params, get_config(ARCH), shape[1])
    ys = tt.pipelined_forward(sp, counts, xs, mesh=_cpu_mesh(shape), cfg=get_config(ARCH))
    np.testing.assert_allclose(ys.numpy(), lstm_ae_sequential(params, xs).numpy(),
                               rtol=RTOL, atol=ATOL)


def test_fifo_has_depth_one(monkeypatch):
    """Stage s's input at step k is exactly stage s-1's output at step k-1:
    the FIFO between stages holds one step.  A single buffer (depth 0) would
    hand stage s its neighbour's output of the same step."""
    seen: dict = {}
    real = tt._stage_step

    def record(s, k, layers, cur, h, c, pwl, in_max, h_max):
        inp = cur.clone()
        out = real(s, k, layers, cur, h, c, pwl, in_max, h_max)
        seen[(s, k)] = (inp, out.clone())
        return out

    monkeypatch.setattr(tt, "_stage_step", record)
    n_stages = 4
    params = _port_params(5)
    xs = torch.randn(6, 2, 32, generator=torch.Generator().manual_seed(6))
    sp, counts, _ = tt.build_stage_params(params, get_config(ARCH), n_stages)
    ys = tt.pipelined_forward(sp, counts, xs, mesh=_cpu_mesh((1, n_stages)), cfg=get_config(ARCH))
    np.testing.assert_allclose(ys.numpy(), lstm_ae_sequential(params, xs).numpy(),
                               rtol=RTOL, atol=ATOL)
    # stage s runs timesteps 0..T-1 at steps s..s+T-1, and nothing else
    assert sorted(seen) == sorted((s, s + t) for s in range(n_stages) for t in range(6))
    for (s, k), (inp, _) in seen.items():
        if s == 0:
            assert torch.equal(inp, xs[k])        # in_max == F for the paper's models
        else:
            assert torch.equal(inp, seen[(s - 1, k - 1)][1]), (s, k)
    # the pass-through stages (no layers) hand their input on unchanged
    for (s, k), (inp, out) in seen.items():
        if counts[s] == 0:
            assert torch.equal(inp, out)


def test_pipelined_forward_refuses_inconsistent_layouts():
    params = _port_params()
    sp, counts, _ = tt.build_stage_params(params, get_config(ARCH), 2)
    xs = torch.zeros(3, 2, 32)
    with pytest.raises(ValueError, match="stage counts"):
        tt.pipelined_forward(sp, torch.tensor([5, 0]), xs, mesh=_cpu_mesh((1, 2)),
                             cfg=get_config(ARCH))
    with pytest.raises(ValueError, match="2 stage counts for a stage axis of 4"):
        tt.pipelined_forward(sp, counts, xs, mesh=_cpu_mesh((1, 4)), cfg=get_config(ARCH))
    with pytest.raises(ValueError, match="lack the stage axis"):
        tt.pipelined_forward(sp, counts, xs, mesh=make_host_mesh((2,), ("data",), ("cpu",) * 2),
                             cfg=get_config(ARCH))
    with pytest.raises(RuntimeError, match="need 4 devices, have 2"):
        make_host_mesh((1, 4), ("data", "model"), devices=("cpu",) * 2)


def test_host_mesh_is_cached_and_has_no_streams_on_the_cpu():
    a, b = _cpu_mesh((2, 2)), _cpu_mesh((2, 2))
    assert a is b and a.shape == (2, 2) and a.axis_names == ("data", "model")
    assert a.device(1, 1) == torch.device("cpu") and a.stream(1, 0) is None
    assert a.axis_size("model") == 2 and a.size == 4
    with pytest.raises(IndexError):
        a.device(2, 0)


# -- the Engine's "pipelined" schedule ----------------------------------------


@pytest.mark.parametrize("placement", [Placement.single(), Placement.data(2)],
                         ids=["single", "data2"])
def test_pipelined_engine_matches_reference(jax_ref, placement):
    """The reference's _MULTI_DEVICE_SCRIPT: four stages, with and without
    2-way data parallelism (8 emulated devices), resolve to the pipeline
    and reconstruct as ``lstm_ae_sequential`` does."""
    jnp = jax_ref["jax"].numpy
    tree = jax_ref["params"](ARCH)
    series = np.random.default_rng(1).standard_normal((4, T, 32)).astype(np.float32)
    want = np.swapaxes(np.asarray(jax_ref["lstm"].lstm_ae_sequential(
        tree, jnp.asarray(np.swapaxes(series, 0, 1)))), 0, 1)
    e = build_engine(get_config(ARCH), EngineConfig("pipelined", n_stages=4, placement=placement),
                     params=params_from_numpy(tree, "cpu"), device="cpu")
    assert e.schedule.resolved == "pipelined" and e.schedule.tag == "pipelined"
    np.testing.assert_allclose(e.reconstruct({"series": series}).numpy(), want,
                               rtol=RTOL, atol=ATOL)
    scores = e.score({"series": series}).numpy()
    np.testing.assert_allclose(scores, ((want - series) ** 2).mean(axis=(1, 2)),
                               rtol=RTOL, atol=ATOL)
    # the streaming programs shard over the placement (the pipeline lays its
    # own batch out): every per-shard step is the unsharded step
    if placement.is_sharded:
        state = e.init_stream_state(4)
        y, _ = e.stream(series[:, 0], state)
        solo = build_engine(get_config(ARCH), "wavefront", params=e.params, device="cpu")
        assert torch.equal(y, solo.stream(series[:, 0], solo.init_stream_state(4))[0])
        assert set(e.profile_info()["per_program"]) >= {"step@shard0", "step@shard1"}


def test_pipelined_engine_stage_params_once_per_bind():
    """Stage cells are built at bind, not per call, and a rebind rebuilds
    them: the engine never serves stale stage weights."""
    cfg = get_config(ARCH)
    a, b = _port_params(7), _port_params(8)
    e = build_engine(cfg, EngineConfig("pipelined", n_stages=3), params=a, device="cpu")
    grid = e._prepared
    series = torch.randn(2, 5, 32, generator=torch.Generator().manual_seed(9))
    e.score({"series": series})
    e.score({"series": series})
    assert e._prepared is grid and len(grid.cells) == 1 and len(grid.cells[0]) == 3
    e.bind(b)
    assert e._prepared is not grid
    want = lstm_ae_sequential(b, series.transpose(0, 1)).transpose(0, 1)
    np.testing.assert_allclose(e.reconstruct({"series": series}).numpy(), want.numpy(),
                               rtol=RTOL, atol=ATOL)


def test_pipelined_schedule_resolution_rules():
    """``n_stages`` defaults to min(devices // data, depth) over the
    placement's devices; the CPU without explicit devices counts as one
    device, so the pipeline degenerates to the wavefront schedule; a
    1-stage request resolves to wavefront; too few devices raise."""
    cfg, params = get_config(ARCH), _port_params()
    auto = build_engine(cfg, EngineConfig("pipelined", placement=Placement(devices=("cpu",) * 3)),
                        params=params, device="cpu")
    assert auto.schedule.resolved == "pipelined" and len(auto._prepared.cells[0]) == 3
    capped = build_engine(cfg, EngineConfig("pipelined",
                                            placement=Placement(devices=("cpu",) * 9)),
                          params=params, device="cpu")
    assert len(capped._prepared.cells[0]) == 6            # the model's depth
    for ecfg in (EngineConfig("pipelined"), EngineConfig("pipelined", n_stages=1)):
        engine = build_engine(cfg, ecfg, params=params, device="cpu")
        assert engine.schedule.tag == "pipelined->wavefront"
    data2 = build_engine(cfg, EngineConfig("pipelined", placement=Placement.data(
        2, devices=("cpu",) * 4)), params=params, device="cpu")
    assert len(data2._prepared.cells) == 2 and len(data2._prepared.cells[0]) == 2
    with pytest.raises(ValueError, match=r"needs 6 devices \(2 data x 3 stages\), have 4"):
        build_engine(cfg, EngineConfig("pipelined", n_stages=3, placement=Placement.data(
            2, devices=("cpu",) * 4)), params=params, device="cpu")
    with pytest.raises(ValueError, match="needs at least 4 devices"):
        build_engine(cfg, EngineConfig("pipelined", placement=Placement.data(
            2, devices=("cpu",) * 3)), params=params, device="cpu")
