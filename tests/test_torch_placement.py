"""Data-parallel placement in the port: the declarative surface (the
single-device cases of tests/test_placement.py, case for case), the
Engine's sharded row programs, and every assertion of that file's
``_SHARDED_SCRIPT`` on four emulated CPU devices (``Placement.data(4)`` on
the CPU): pooled streaming and bucket scores bit-equal to the port's
unsharded gateway and, from carried params, within the script's rtol 1e-6 /
atol 1e-7 of the JAX package's single-placement gateway and
``stream_step`` (the reference's own sharded script does not run on the
installed jax).  Also: a sharded pool's snapshot restored into an
unsharded pool and into the JAX pool, and ``serve --http --mesh data=2``."""
import dataclasses
import signal
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from conftest import GATEWAY_ARCH as ARCH  # noqa: E402
from conftest import GATEWAY_FEATS as FEATS  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.engine import AnomalyService, EngineConfig, Placement, build_engine  # noqa: E402
from repro_torch.gateway import AnomalyGateway, PoolFullError  # noqa: E402
from repro_torch.utils import params_to_numpy, tree_leaves  # noqa: E402

RTOL, ATOL = 1e-6, 1e-7            # _SHARDED_SCRIPT's bar against the oracle
T = 7


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's service and gateway (skips where JAX is absent)."""
    jax = pytest.importorskip("jax")
    from repro.engine import AnomalyService as JaxService
    from repro.gateway import AnomalyGateway as JaxGateway

    return {"jax": jax, "service": JaxService, "gateway": JaxGateway}


def _svc(seed=0):
    return AnomalyService(ARCH, schedule="wavefront", device="cpu", seed=seed)


# -- declarative surface ---------------------------------------------------


def test_placement_defaults_and_constructors():
    assert Placement() == Placement.single() == Placement.data(1)
    assert not Placement.single().is_sharded
    pl = Placement.data(4)
    assert pl.is_sharded and pl.devices_needed == 4
    assert pl == Placement(data_shards=4)
    assert hash(pl) == hash(Placement(data_shards=4))
    assert "Placement.data(4" in repr(pl)
    assert repr(Placement.single()) == "Placement.single()"
    # devices join equality and the hash, normalised to names first
    emu = Placement.data(2, devices=(torch.device("cuda", 0), "cuda:0"))
    assert emu.devices == ("cuda:0", "cuda:0") and emu != Placement.data(2)
    assert emu == Placement.data(2, devices=("cuda:0", torch.device("cuda:0")))
    assert hash(emu) == hash(Placement.data(2, devices=("cuda:0", "cuda:0")))
    assert repr(emu) == "Placement.data(2, data_axis='data', devices=('cuda:0', 'cuda:0'))"


def test_placement_pad_rows_and_row_mapping():
    pl = Placement.data(4)
    assert [pl.pad_rows(n) for n in (1, 4, 5, 8, 30)] == [4, 4, 8, 8, 32]
    assert Placement.single().pad_rows(7) == 7
    # contiguous blocks: rows [d*rows/n, (d+1)*rows/n) live on shard d
    assert [pl.shard_of_row(r, 8) for r in range(8)] == [0, 0, 1, 1, 2, 2, 3, 3]
    assert pl.row_blocks(8) == [slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    assert [pl.shard_of_row(r, 8) for b in pl.row_blocks(8) for r in range(b.start, b.stop)] \
        == [0, 0, 1, 1, 2, 2, 3, 3]
    assert Placement.single().row_blocks(5) == [slice(0, 5)]


def test_placement_validation():
    with pytest.raises(ValueError, match="data_shards"):
        Placement(data_shards=0)
    with pytest.raises(ValueError, match="must differ"):
        Placement(data_axis="x", stage_axis="x")
    with pytest.raises(ValueError, match="unsupported device"):
        Placement(devices=("meta",))


def test_placement_from_spec():
    assert Placement.from_spec("data=4") == Placement.data(4)
    assert Placement.from_spec(" data=2 ,") == Placement.data(2)
    assert Placement.from_spec("") == Placement.single()
    with pytest.raises(ValueError, match="axes supported"):
        Placement.from_spec("model=2")
    with pytest.raises(ValueError, match="not an int"):
        Placement.from_spec("data=two")


def test_placement_matches_reference_surface(jax_ref):
    from repro.engine import Placement as JaxPlacement

    for n in (1, 2, 4):
        mine, ref = Placement.data(n), JaxPlacement.data(n)
        assert repr(mine) == repr(ref) and mine.describe() == ref.describe()
        assert [mine.pad_rows(r) for r in range(10)] == [ref.pad_rows(r) for r in range(10)]
    assert Placement(data_axis="rows", stage_axis="stages").describe() == \
        JaxPlacement(data_axis="rows", stage_axis="stages").describe()


def test_placement_mesh_requires_devices():
    """A placement wider than the device pool fails loudly at mesh build
    (engines and pools fail fast at construction, not at first call)."""
    if torch.cuda.device_count() < 1999:
        with pytest.raises(ValueError, match="devices="):
            Placement.data(1999).mesh("cuda")
    with pytest.raises(ValueError, match="devices"):
        Placement.data(4, devices=("cpu",) * 2).mesh("cpu")
    with pytest.raises(ValueError, match="devices"):
        build_engine(get_config(ARCH), EngineConfig(
            schedule="wavefront", placement=Placement.data(3, devices=("cpu", "cpu"))),
            device="cpu")
    # a named GPU that is not there is refused too
    if torch.cuda.device_count() < 8:
        with pytest.raises(ValueError, match=r"mesh names cuda:\d, but \d GPU\(s\) are visible"):
            Placement.data(2, devices=("cuda:0", "cuda:7")).mesh()
    # on the CPU the default pool emulates as many devices as asked for
    mesh = Placement.data(3).mesh("cpu")
    assert mesh.devices == (torch.device("cpu"),) * 3 and mesh.axis_names == ("data",)
    assert Placement.data(3).mesh("cpu") is mesh


# -- the port has no deprecated data_parallel spelling -----------------------


def test_data_parallel_shim_warns_and_maps():
    """The reference keeps ``EngineConfig(data_parallel=N)`` as a
    deprecated spelling; the port never had it: it is refused, and the
    placement is the one way to ask for N shards."""
    with pytest.raises(TypeError, match="data_parallel"):
        EngineConfig(schedule="wavefront", data_parallel=3)
    a = EngineConfig(schedule="wavefront", placement=Placement.data(3))
    b = EngineConfig(schedule="wavefront", placement=Placement.data(3))
    assert a == b and hash(a) == hash(b) and a.placement.data_shards == 3


def test_dataclasses_replace_placement_unshards_cleanly():
    sharded = EngineConfig(schedule="wavefront", placement=Placement.data(2))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cfg = dataclasses.replace(sharded, placement=Placement.single())
        back = dataclasses.replace(cfg, placement=Placement.data(4))
    assert cfg.placement == Placement.single() and back.placement == Placement.data(4)


def test_default_config_carries_single_placement():
    assert EngineConfig().placement == Placement.single()


# -- single-device no-op guarantee ----------------------------------------


@pytest.fixture(scope="module")
def svc():
    return _svc()


def test_single_placement_is_noop(svc):
    engine = svc.engine
    assert engine.placement == Placement.single()
    assert engine.shard_devices == []        # no shards, no mesh built
    assert engine.with_placement(Placement.single()) is engine

    gw = svc.open_gateway(capacity=4, max_batch=4)
    assert gw.engine is svc.engine           # no engine re-layout
    assert gw.batcher.lanes == 4             # lanes == max_batch, unchanged
    assert gw.pool.slots_per_device == 4     # one device holds everything
    assert "placement" not in gw.stats()     # telemetry unchanged
    assert gw.pool.per_device_active() == [0]


def test_open_gateway_single_placement_kw(svc):
    gw = svc.open_gateway(capacity=2, placement=Placement.single())
    assert gw.engine is svc.engine and gw.service is svc


def test_gateway_placement_needs_devices(svc):
    with pytest.raises(ValueError, match="devices"):
        AnomalyGateway(svc, capacity=4, placement=Placement.data(1998, devices=("cpu",)))
    with pytest.raises(ValueError, match="devices"):
        svc.open_gateway(capacity=4, placement=Placement.data(3, devices=("cpu",) * 2))
    with pytest.raises(TypeError, match="placement must be a Placement"):
        AnomalyGateway(svc, capacity=4, placement="data=2")


# -- the Engine's sharded row programs -------------------------------------


@pytest.mark.parametrize("schedule", ["wavefront", "sequential", "fused"])
def test_sharded_engine_programs_bit_equal_to_unsharded(schedule):
    """Every row program under ``Placement.data(2)`` equals the unsharded
    program bit for bit, each shard counted as its own program."""
    cfg = get_config(ARCH)
    one = build_engine(cfg, schedule, params=_svc(1).params, device="cpu")
    two = one.with_placement(Placement.data(2))
    assert two is not one and two.shard_devices == [torch.device("cpu")] * 2
    rng = np.random.default_rng(2)
    series = rng.standard_normal((6, 5, FEATS)).astype(np.float32)
    lengths = np.array([5, 1, 3, 4, 2, 5], np.int32)
    for name, batch in (("reconstruct", {"series": series}), ("score", {"series": series}),
                        ("score_masked", {"series": series, "lengths": lengths})):
        assert torch.equal(getattr(two, name)(batch), getattr(one, name)(batch))
    state = one.init_stream_state(6)
    x_t = series[:, 0]
    mask = np.array([1, 0, 1, 1, 0, 1], bool)
    for got, want in ((two.stream(x_t, state), one.stream(x_t, state)),
                      (two.stream_masked(x_t, state, mask), one.stream_masked(x_t, state, mask))):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))
    per = two.profile_info()["per_program"]
    for name in ("reconstruct", "score", "score_masked", "step", "mstep"):
        assert per[f"{name}@shard0"]["shapes"] == per[f"{name}@shard1"]["shapes"]
        assert name not in per
    # rows that do not divide run the unsharded program, with the same values
    assert torch.equal(two.score({"series": series[:5]}), one.score({"series": series[:5]}))
    assert two.profile_info()["per_program"]["score"]["shapes"] == [[5, 5, FEATS]]


def test_sharded_engine_bind_refreshes_every_replica():
    a, b = _svc(3), _svc(4)
    two = build_engine(get_config(ARCH), EngineConfig(placement=Placement.data(
        2, devices=("cpu", "cpu"))), params=a.params, device="cpu")
    series = np.random.default_rng(5).standard_normal((4, 6, FEATS)).astype(np.float32)
    assert torch.equal(two.score({"series": series}), a.score(series))
    two.bind(params_to_numpy(b.params))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(two.shard_params(1)),
                                                   tree_leaves(b.params)))
    assert torch.equal(two.score({"series": series}), b.score(series))


# -- _SHARDED_SCRIPT on four emulated CPU devices ---------------------------


def _data(rng, n, t_len=T):
    return [rng.standard_normal((t_len, FEATS)).astype(np.float32) for _ in range(n)]


def test_sharded_gateway_multi_device(jax_ref):
    """Pooled streaming and bucket scores bit-equal to the unsharded pool,
    within 1e-6 of solo stream_step and of the JAX gateway from carried
    params; admission control at slots_per_device x devices, balanced
    admission, per-device telemetry, block padding, relayout, param swaps
    through the service and a sibling gateway, the non-divisible
    fallback."""
    jnp = jax_ref["jax"].numpy
    pl = Placement.data(4)
    svc = _svc()
    ref_svc = jax_ref["service"](ARCH, schedule="wavefront")
    ref_svc.recalibrate(params=params_to_numpy(svc.params))
    rng = np.random.default_rng(0)

    cap = 2 * 4
    gws = svc.open_gateway(capacity=cap, max_batch=4, placement=pl)
    gwu = svc.open_gateway(capacity=cap, max_batch=4)
    gwj = jax_ref["gateway"](ref_svc, capacity=cap, max_batch=4)
    assert gws.engine is not svc.engine and gws.placement == pl
    assert gws.pool.slots_per_device == 2 and gws.batcher.lanes == 4
    assert [blk.sq_sum.shape[0] for blk in gws.pool._blocks] == [2] * 4
    assert gws.engine.shard_devices == [torch.device("cpu")] * 4

    data = _data(rng, cap)
    for i in range(cap):
        gws.admit(i), gwu.admit(i), gwj.admit(i)
    with pytest.raises(PoolFullError):
        gws.admit("overflow")
    assert gws.pool.per_device_active() == [2, 2, 2, 2]     # balanced admission
    assert [gws.pool.device_of_slot(gws.pool.slot_of(i)) for i in range(cap)] == \
        [0, 1, 2, 3, 0, 1, 2, 3]

    for t in range(T):
        stepping = [i for i in range(cap) if (t + i) % 3 != 2]
        rs = gws.step({i: data[i][t] for i in stepping})
        ru = gwu.step({i: data[i][t] for i in stepping})
        rj = gwj.step({i: data[i][t] for i in stepping})
        for i in stepping:
            assert rs[i] == ru[i]
            np.testing.assert_allclose(rs[i], rj[i], rtol=RTOL, atol=ATOL)

    for i in (0, 3, 7):
        sess, ref_sess = svc.stream_start(1), ref_svc.stream_start(1)
        for t in range(T):
            if (t + i) % 3 != 2:
                errs, sess = svc.stream_step(data[i][t][None], sess)
                ref_errs, ref_sess = ref_svc.stream_step(jnp.asarray(data[i][t][None]), ref_sess)
        np.testing.assert_allclose(gws.pool.error_of(i), float(errs[0]), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(gws.pool.error_of(i), float(ref_errs[0]),
                                   rtol=RTOL, atol=ATOL)

    final_s, final_u = gws.evict(5), gwu.evict(5)
    assert final_s == final_u
    gws.admit("fresh")
    assert gws.pool.per_device_active() == [2, 2, 2, 2]

    lens = [5, 9, 16, 7, 12, 6, 31, 8]
    windows = [rng.standard_normal((n, FEATS)).astype(np.float32) for n in lens]
    ss, su, sj = gws.score(windows), gwu.score(windows), gwj.score(windows)
    # each flush puts one lane on each of the 4 shards here, and on the CPU
    # PyTorch multiplies a one-row matrix as a matrix-vector product, whose
    # sums run in another order than the many-row product's: within an ulp
    np.testing.assert_allclose(ss, su, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ss, sj, rtol=RTOL, atol=ATOL)
    # with two lanes a shard the products take the same path: bit-equal
    gw8s = svc.open_gateway(capacity=1, max_batch=8, placement=pl)
    gw8u = svc.open_gateway(capacity=1, max_batch=8)
    np.testing.assert_array_equal(gw8s.score(windows), gw8u.score(windows))
    for w, s in zip(windows[:3], ss[:3]):
        np.testing.assert_allclose(s, float(svc.score(w[None])[0]), rtol=RTOL, atol=ATOL)

    st = gws.stats()
    assert st["placement"]["data"] == 4
    assert st["placement"]["slots_per_device"] == 2
    assert st["placement"]["device_active"] == [2, 2, 2, 2]
    assert st["placement"]["score_lanes"] == 4
    assert len(st["gauge_vecs"]["pool.device_active"]) == 4
    assert len(st["gauge_vecs"]["queue.device_fill"]) == 4
    assert "placement" not in gwu.stats()
    assert "placement=Placement.data(4" in repr(gws)

    gw6 = svc.open_gateway(capacity=6, placement=pl)
    assert gw6.pool._block == 8 and gw6.pool.slots_per_device == 2
    for i in range(6):
        gw6.admit(i)
    with pytest.raises(PoolFullError):
        gw6.admit("pad-row")
    assert gw6.pool.per_device_active() == [2, 2, 2, 0]   # slots 6, 7 are padding

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        down = gws.engine.with_placement(Placement.single())
    assert down.placement == Placement.single() and down.shard_devices == []

    # a service-side param swap reaches the placement gateway's own engine
    orig = params_to_numpy(svc.params)
    other = _svc(123)
    svc.recalibrate(params=other.params)
    for x, y in zip(tree_leaves(gws.engine.params), tree_leaves(other.params)):
        assert torch.equal(x, y)
    w0 = windows[0]
    np.testing.assert_allclose(gws.score([w0])[0], float(other.score(w0[None])[0]),
                               rtol=RTOL, atol=ATOL)
    # ... and so does one started on a sibling gateway
    gwu.recalibrate(params=orig)
    for x, y in zip(tree_leaves(gws.engine.shard_params(3)), tree_leaves(orig)):
        np.testing.assert_array_equal(x.numpy(), y)

    # a non-divisible batch runs the unsharded program, with the same values
    b5 = np.stack([w[:5] for w in windows[:5]])
    assert torch.equal(gws.engine.score({"series": b5}), svc.engine.score({"series": b5}))


def test_queue_device_fill_per_flush():
    gw = _svc().open_gateway(capacity=2, max_batch=7, max_wait_ms=0.0,
                             placement=Placement.data(4))
    assert gw.batcher.lanes == 8
    gw.score([np.zeros((4, FEATS), np.float32)] * 3)
    assert gw.stats()["gauge_vecs"]["queue.device_fill"] == [1.0, 0.5, 0.0, 0.0]


def test_sharded_snapshot_restores_unsharded_and_in_jax(jax_ref):
    """A sharded pool's exported block, gathered in global row order,
    restores stream by stream into an unsharded port pool and into the JAX
    pool, and the streams go on as if never moved."""
    svc = _svc(9)
    ref_svc = jax_ref["service"](ARCH, schedule="wavefront")
    ref_svc.recalibrate(params=params_to_numpy(svc.params))
    rng = np.random.default_rng(3)
    data = _data(rng, 6, t_len=6)
    gws = svc.open_gateway(capacity=6, placement=Placement.data(2))
    for i in range(6):
        gws.admit(i)
    for t in range(3):
        gws.step({i: data[i][t] for i in range(6) if (i + t) % 4})
    leaves, sq, steps = gws.pool.export_block()
    assert [leaf.shape[0] for leaf in leaves] == [6] * len(leaves) and sq.shape == (6,)
    gwu = svc.open_gateway(capacity=6)
    gwj = jax_ref["gateway"](ref_svc, capacity=6)
    for i in range(6):
        slot = gws.pool.slot_of(i)
        rows = [leaf[slot] for leaf in leaves]
        np.testing.assert_array_equal(np.concatenate([r.ravel() for r in rows]),
                                      np.concatenate([r.ravel() for r in gws.pool.export_slot(i)[0]]))
        gwu.pool.restore(i, rows, float(sq[slot]), int(steps[slot]))
        gwj.pool.restore(i, rows, float(sq[slot]), int(steps[slot]))
        assert gwu.pool.error_of(i) == gws.pool.error_of(i)
    for t in range(3, 6):
        inputs = {i: data[i][t] for i in range(6)}
        rs, ru, rj = gws.step(inputs), gwu.step(inputs), gwj.step(inputs)
        for i in range(6):
            assert rs[i] == ru[i]
            np.testing.assert_allclose(rs[i], rj[i], rtol=RTOL, atol=ATOL)


def test_serve_http_mesh_data2_on_cpu():
    """``serve --http --mesh data=2 --device cpu`` serves from two emulated
    CPU devices: its ready line names the mesh, a client scores and
    streams, and the SIGTERM drain exits 0."""
    from repro_torch.gateway.client import GatewayClient
    from test_torch_server import spawn_http_server

    proc, port, _, output = spawn_http_server(["--mesh", "data=2", "--max-batch", "3"])
    try:
        svc = _svc()
        w = np.random.default_rng(4).standard_normal((6, FEATS)).astype(np.float32)
        with GatewayClient("127.0.0.1", port) as c:
            assert c.score(w) == pytest.approx(float(svc.score(w[None])[0]), rel=1e-6, abs=1e-7)
            c.step(w[0])
            stats = c.stats()
        assert stats["placement"]["data"] == 2 and stats["placement"]["score_lanes"] == 4
        proc.send_signal(signal.SIGTERM)
        out = output(120.0)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out
    assert "mesh=2xdata" in out and "[http] drained: 1 one-shot" in out, out
