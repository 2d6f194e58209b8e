"""Port parity of training: AdamW, the lr schedule, int8 error-feedback
compression, the train step on the LSTM-AE (plain, microbatched and
compressed), the checkpointable data iterator and ``AnomalyService.fit``,
against the JAX package from carried weights.  JAX runs jitted, as the
reference's own tests run it."""
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro.config import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.config import get_config as jax_get_config  # noqa: E402
from repro.data import TimeseriesConfig as JaxTimeseriesConfig  # noqa: E402
from repro.data import TimeseriesIterator as JaxTimeseriesIterator  # noqa: E402
from repro.engine import AnomalyService as JaxAnomalyService  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.training import build_train_step as jax_build_train_step  # noqa: E402
from repro.training import init_train_state as jax_init_train_state  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.config import TrainConfig, get_config  # noqa: E402
from repro_torch.data import TimeseriesConfig, TimeseriesIterator, make_batch  # noqa: E402
from repro_torch.engine import AnomalyService  # noqa: E402
from repro_torch.engine import service as service_mod  # noqa: E402
from repro_torch.models import train_loss  # noqa: E402
from repro_torch.training import build_train_step, init_train_state  # noqa: E402
from repro_torch.utils import params_from_numpy, tree_leaves  # noqa: E402

ARCH = "lstm-ae-f32-d2"
T_LEN, BATCH, STEPS = 12, 16, 5


def _tree(rng, scale=1.0):
    """A nested tree of the params' kinds of containers, numpy f32."""
    def draw(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {"layers": ({"wx": draw(6, 8), "wh": draw(2, 8), "b": draw(8)},
                       {"wx": draw(2, 4), "wh": draw(1, 4), "b": draw(4)}),
            "w": draw(5, 5)}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return params_from_numpy(tree, "cpu")


def _close(got, want, atol, rtol=0.0):
    """Every leaf of a port tree against the reference tree (same order)."""
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=rtol, atol=atol)


def test_train_config_is_a_field_for_field_copy():
    assert TrainConfig().__dict__ == JaxTrainConfig().__dict__


@pytest.mark.parametrize("grad_clip", [0.0, 1.0])
def test_adamw_update_matches_reference(grad_clip):
    """Three chained updates (bias correction past step 1) on random trees,
    with and without the global-norm clip, at atol 1e-6."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    tc = dict(learning_rate=1e-2, weight_decay=0.1, grad_clip=grad_clip,
              warmup_steps=2, total_steps=10)
    jp, jst = _jax(params), jopt.init_opt_state(_jax(params))
    tp, tst = _torch(params), topt.init_opt_state(_torch(params))
    update = jax.jit(functools.partial(jopt.adamw_update, tc=JaxTrainConfig(**tc)))
    for _ in range(3):
        grads = _tree(rng, scale=3.0)
        jp, jst, jm = update(jp, _jax(grads), jst)
        tp, tst, tm = topt.adamw_update(tp, _torch(grads), tst, TrainConfig(**tc))
        _close(tp, jp, atol=1e-6)
        _close(tst.mu, jst.mu, atol=1e-6)
        _close(tst.nu, jst.nu, atol=1e-6)
        assert int(tst.step) == int(jst.step) and tst.step.dtype == torch.int32
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    if grad_clip:
        assert float(tm["grad_norm"]) > grad_clip   # the clip was active


def test_adamw_weight_decay_shrinks():
    tc = TrainConfig(learning_rate=1e-2, weight_decay=0.5, grad_clip=0)
    params = {"w": torch.ones((8, 8))}
    opt = topt.init_opt_state(params)
    new, opt, _ = topt.adamw_update(params, {"w": torch.zeros((8, 8))}, opt, tc)
    assert float(new["w"].abs().max()) < 1.0  # pure decay shrinks
    assert float(params["w"].min()) == 1.0    # the caller's params are not written


def test_lr_schedule_shape():
    tc = dict(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(topt.lr_schedule(torch.tensor(s, dtype=torch.int32), TrainConfig(**tc)))
           for s in range(100)]
    want = [float(jopt.lr_schedule(jnp.int32(s), JaxTrainConfig(**tc))) for s in range(100)]
    np.testing.assert_allclose(lrs, want, rtol=1e-6)
    lr = tc["learning_rate"]
    assert lrs[0] < lrs[9] <= lr * (1 + 1e-6)     # warmup (f32 eps)
    assert abs(lrs[10] - lr) / lr < 0.02
    assert lrs[-1] < 0.2 * lr                      # decayed
    assert lrs[-1] >= 0.09 * lr                    # floor 0.1x


def test_quantize_and_compress_bit_equal_to_reference():
    rng = np.random.default_rng(4)
    for scale in (1.0, 1e-3, 50.0):
        g = (scale * rng.standard_normal((33, 17))).astype(np.float32)
        q, s = topt.quantize_int8(torch.from_numpy(g))
        jq, js = jopt.quantize_int8(jnp.asarray(g))
        assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
    # halves land on even quanta, as jnp.round rounds them
    half = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], np.float32)
    assert np.array_equal(topt.quantize_int8(torch.from_numpy(half))[0].numpy(),
                          np.asarray(jopt.quantize_int8(jnp.asarray(half))[0]))
    grads, err = _tree(rng), _tree(rng, scale=0.01)
    deq, new_err = topt.compress_grads(_torch(grads), _torch(err))
    jdeq, jerr = _reference_compress(_jax(grads), _jax(err))
    _close(deq, jdeq, atol=0.0)
    _close(new_err, jerr, atol=0.0)
    # the reference's own tree walk takes the params' tuples for its
    # (deq, err) pairs, so on such trees it returns another structure
    whole, _ = jopt.compress_grads(_jax(grads), _jax(err))
    assert jax.tree.structure(whole) != jax.tree.structure(_jax(grads))


def _reference_compress(grads, error):
    """The reference's ``compress_grads`` one leaf at a time.  Its tree walk
    (``is_leaf`` on tuples) misreads trees with tuple containers, such as
    the LSTM-AE's ``{"layers": (...)}``, so it is applied per leaf here."""
    leaves, treedef = jax.tree.flatten(grads)
    out = [jopt.compress_grads({"g": g}, {"g": e})
           for g, e in zip(leaves, treedef.flatten_up_to(error))]
    return (treedef.unflatten([d["g"] for d, _ in out]),
            treedef.unflatten([e["g"] for _, e in out]))


def test_grad_compression_error_feedback():
    """EF property: the quantisation error is carried, so the running sum
    of dequantised grads plus the residual tracks the running sum of the
    true grads; and one quantisation round-trips within its scale."""
    rng = np.random.default_rng(2)
    err = topt.init_error_feedback({"w": torch.zeros((64, 64))})
    total_true = torch.zeros((64, 64))
    total_deq = torch.zeros((64, 64))
    for _ in range(20):
        g = {"w": torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))}
        deq, err = topt.compress_grads(g, err)
        total_true += g["w"]
        total_deq += deq["w"]
    torch.testing.assert_close(total_deq + err["w"], total_true, rtol=1e-4, atol=1e-4)
    w = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    q, s = topt.quantize_int8(w)
    torch.testing.assert_close(topt.dequantize_int8(q, s), w, rtol=0, atol=float(s) * 0.51)


@functools.lru_cache(maxsize=None)
def _reference_params():
    api = build_model(jax_get_config(ARCH))
    return api, jax.tree.map(np.asarray, api.init(jax.random.PRNGKey(0)))


def _port_api():
    return types.SimpleNamespace(loss=functools.partial(train_loss, cfg=get_config(ARCH)))


def _drive_both(tc_kw: dict, ef=None):
    """STEPS train steps of both packages from the same params and batches;
    yields (step, port state, port metrics, reference state, reference metrics)."""
    api, params = _reference_params()
    jtc, tc = JaxTrainConfig(**tc_kw), TrainConfig(**tc_kw)
    jstate = jax_init_train_state(api, jax.random.PRNGKey(0), jtc)
    state = init_train_state(params_from_numpy(params, "cpu"), tc)
    if ef is not None:
        jstate = jstate.__class__(params=jstate.params, opt=jstate.opt, ef=_jax(ef))
        state = state.__class__(params=state.params, opt=state.opt, ef=_torch(ef))
    step = build_train_step(_port_api(), tc)
    jstep = jax.jit(_reference_int8_step(api, jtc) if ef is not None
                    else jax_build_train_step(api, jtc))
    dc = dict(features=32, seq_len=T_LEN, batch=BATCH)
    for i in range(STEPS):
        series, _ = make_batch(TimeseriesConfig(**dc), i)
        state, metrics = step(state, {"series": series})
        jseries = jnp.asarray(series.numpy())
        jstate, jmetrics = jstep(jstate, {"series": jseries})
        yield i, state, metrics, jstate, jmetrics


def _reference_int8_step(api, tc):
    """The reference's int8_ef train step (``training/step.py:84-114``,
    microbatch 1) with its compression applied per leaf (see
    :func:`_reference_compress`): the reference's own step raises on the
    LSTM-AE's tuple params."""
    def train_step(state, batch):
        def loss_fn(p):
            return api.loss(p, batch, remat=tc.remat != "none", loss_chunk=tc.loss_chunk)

        (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        metrics = dict(metrics, loss=loss)
        grads, ef = _reference_compress(grads, state.ef)
        params, opt, opt_metrics = jopt.adamw_update(state.params, grads, state.opt, tc)
        metrics.update(opt_metrics)
        return state.__class__(params=params, opt=opt, ef=ef), metrics

    return train_step


def _hold_train_step(tc_kw: dict, ef=None):
    """The loss per step within rtol 1e-5 over STEPS steps, params after one
    step at atol 1e-6 and after STEPS at atol 1e-5 (mu too).  With ``ef``
    (int8_ef), elements whose int8 level flipped are left out of the final
    check, see :func:`_quantum_flips`."""
    for i, state, metrics, jstate, jmetrics in _drive_both(tc_kw, ef):
        assert set(metrics) == set(jmetrics)
        for k in ("loss", "mse"):
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5)
        if i == 0:
            _close(state.params, jstate.params, atol=1e-6)
    flips = _quantum_flips(state, jstate) if ef is not None else None
    for tree, jtree in ((state.params, jstate.params), (state.opt.mu, jstate.opt.mu)):
        for n, (g, w) in enumerate(zip(tree_leaves(tree), jax.tree.leaves(jtree))):
            keep = np.ones(g.shape, bool) if flips is None else ~flips[n]
            np.testing.assert_allclose(g.numpy()[keep], np.asarray(w)[keep], rtol=0, atol=1e-5)
    assert int(state.opt.step) == STEPS
    return state, jstate


def _quantum_flips(state, jstate) -> list:
    """Per leaf, the elements whose error buffers differ by more than f32
    noise (1e-7; the rest agree within 1e-9 here): int8 levels that
    flipped.  Rounding is discontinuous, so gradients one ulp apart on
    either side of a tie (k + 0.5 quanta) land one quantum apart; that
    moves the element's error by a quantum and its param by up to about
    lr·(1-b1)/(1-b1^t).  At most 0.1% of the elements may flip."""
    flips = [np.abs(e.numpy() - np.asarray(je)) > 1e-7
             for e, je in zip(tree_leaves(state.ef), jax.tree.leaves(jstate.ef))]
    n = sum(int(f.sum()) for f in flips)
    assert n <= 1e-3 * sum(f.size for f in flips), f"{n} int8 levels flipped"
    return flips


def test_train_step_matches_reference():
    """lstm-ae-f32-d2 (T=12, B=16) from carried params: the loss per step
    within rtol 1e-5 over 5 steps, params after 1 step at atol 1e-6 and
    after 5 at atol 1e-5."""
    state, _ = _hold_train_step(dict(learning_rate=5e-3, warmup_steps=2, total_steps=STEPS))
    assert state.ef is None


def test_microbatch_equivalent_gradients():
    """microbatch=2 (contiguous row halves, f32 accumulation) holds to the
    reference's microbatched step, and its params equal the full-batch
    step's within the reference's own bar for this test."""
    kw = dict(learning_rate=5e-3, warmup_steps=2, total_steps=STEPS)
    micro, _ = _hold_train_step({**kw, "microbatch": 2})
    full = list(_drive_both(kw))[-1][1]
    for a, b in zip(tree_leaves(micro.params), tree_leaves(full.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=2e-4)
    with pytest.raises(ValueError, match="not divisible"):
        build_train_step(_port_api(), TrainConfig(microbatch=3))(
            init_train_state(params_from_numpy(_reference_params()[1], "cpu"),
                             TrainConfig()), {"series": torch.zeros(16, 4, 32)})


def test_grad_compression_in_train_step():
    """int8_ef from a non-zero error buffer: the step holds to the
    reference's arithmetic (its compression per leaf), and the error it
    carries out is non-zero."""
    rng = np.random.default_rng(5)
    ef = jax.tree.map(lambda p: (1e-4 * rng.standard_normal(p.shape)).astype(np.float32),
                      _reference_params()[1])
    state, jstate = _hold_train_step(
        dict(learning_rate=5e-3, warmup_steps=2, total_steps=STEPS, grad_compression="int8_ef"),
        ef=ef)
    flips = _quantum_flips(state, jstate)
    for f, e, je in zip(flips, tree_leaves(state.ef), jax.tree.leaves(jstate.ef)):
        np.testing.assert_allclose(e.numpy()[~f], np.asarray(je)[~f], rtol=0, atol=1e-7)
    assert sum(float(e.abs().sum()) for e in tree_leaves(state.ef)) > 0


def test_train_step_refuses_a_mesh(tmp_path):
    """The LSTM-AE's step on a (1, 1) mesh of one gloo rank, its state
    placed by its specs, equals the unsharded step (the (2, 2) and
    (2, 1, 2) meshes: tests/test_torch_sharded_step.py)."""
    from test_torch_sharded_step import hold_one_rank_mesh_steps, steps_on_one_rank_mesh

    from repro_torch.models import build_model as port_build_model

    api = port_build_model(get_config(ARCH))
    params = init_lstm_ae_params(api)
    rng = np.random.default_rng(5)
    batches = [{"series": torch.from_numpy(rng.standard_normal(
        (4, 8, api.cfg.lstm_ae.input_features)).astype(np.float32))} for _ in range(2)]
    hold_one_rank_mesh_steps(*steps_on_one_rank_mesh(
        api, TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4), params, batches,
        tmp_path))


def init_lstm_ae_params(api):
    return api.init(torch.Generator().manual_seed(0), "cpu")


def test_timeseries_iterator_round_trip():
    kw = dict(features=8, seq_len=10, batch=4, anomaly_rate=0.5, seed=3)
    it, jit_ = TimeseriesIterator(TimeseriesConfig(**kw)), JaxTimeseriesIterator(
        JaxTimeseriesConfig(**kw))
    for _ in range(3):
        (x, y), (jx, jy) = next(it), next(jit_)
        assert np.array_equal(x.numpy(), np.asarray(jx)) and np.array_equal(y.numpy(), np.asarray(jy))
    state = it.state_dict()
    assert state == jit_.state_dict() == {"index": 3, "seed": 3}
    want = next(it)[0]
    fresh = TimeseriesIterator(TimeseriesConfig(**kw))
    fresh.load_state_dict(state)
    assert iter(fresh) is fresh and torch.equal(next(fresh)[0], want)
    with pytest.raises(ValueError, match="seed mismatch"):
        TimeseriesIterator(TimeseriesConfig(**{**kw, "seed": 4})).load_state_dict(state)


def test_service_fit_matches_reference(monkeypatch):
    """``AnomalyService.fit`` on the CPU from the reference's init params
    (carried over, as torch cannot draw JAX's bits): the same final metrics
    and the same fitted scores as the JAX service."""
    _, params = _reference_params()
    monkeypatch.setattr(service_mod, "init_lstm_ae", lambda gen, cfg, device: params_from_numpy(
        params, device))
    dc = dict(features=32, seq_len=T_LEN, batch=BATCH)
    ref = JaxAnomalyService(ARCH, schedule="wavefront")
    mine = AnomalyService(ARCH, schedule="fused", device="cpu")
    want = ref.fit(JaxTimeseriesConfig(**dc), steps=STEPS)
    got = mine.fit(TimeseriesConfig(**dc), steps=STEPS)
    assert set(got) == set(want) == {"loss", "mse", "grad_norm", "lr"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    series = make_batch(TimeseriesConfig(**{**dc, "anomaly_rate": 0.5, "seed": 3}), 0)[0]
    np.testing.assert_allclose(mine.score(series).numpy(),
                               np.asarray(ref.score(jnp.asarray(series.numpy()))),
                               rtol=1e-5, atol=1e-6)


def test_anomaly_service_lifecycle(capsys):
    """fit -> calibrate -> score/detect/stream on the CPU; streaming running
    errors equal batch scores, and open gateways serve the fitted params."""
    svc = AnomalyService(ARCH, schedule="wavefront", device="cpu")
    gw = svc.open_gateway(capacity=2, max_batch=2)
    dc = TimeseriesConfig(features=32, seq_len=12, batch=16, anomaly_rate=0.0)
    assert svc.fit(dc, steps=0) == {}
    before = svc.score(torch.ones(1, 12, 32))
    metrics = svc.fit(dc, steps=5, log_every=2)
    assert "mse" in metrics and all(isinstance(v, float) for v in metrics.values())
    assert [ln.split()[1] for ln in capsys.readouterr().out.splitlines()] == ["0", "2", "4"]
    assert float((svc.score(torch.ones(1, 12, 32)) - before).abs().max()) > 0
    thr = svc.calibrate(dc)
    assert svc.threshold == thr > 0
    series, labels = make_batch(
        TimeseriesConfig(features=32, seq_len=12, batch=8, anomaly_rate=0.5, seed=3), 0)
    report = svc.detect(series, labels)
    assert 0.0 <= report.anomaly_rate <= 1.0
    sess = svc.stream_start(8)
    for t in range(series.shape[1]):
        errors, sess = svc.stream_step(series[:, t], sess)
    torch.testing.assert_close(errors, svc.score(series), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(torch.tensor(gw.score([series[0].numpy()])[0]),
                               svc.score(series[:1])[0], rtol=1e-5, atol=1e-6)


def test_anomaly_service_seed_governs_fit():
    """Two services with different seeds fit different models; the same
    seed is deterministic."""
    dc = TimeseriesConfig(features=32, seq_len=8, batch=8, anomaly_rate=0.0)
    series = torch.ones((2, 8, 32))

    def fitted_scores(seed):
        svc = AnomalyService(ARCH, device="cpu", seed=seed)
        svc.fit(dc, steps=2)
        return svc.score(series).numpy()

    a, b, a2 = fitted_scores(0), fitted_scores(7), fitted_scores(0)
    np.testing.assert_array_equal(a, a2)
    assert np.abs(a - b).max() > 0
