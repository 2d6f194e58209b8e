"""Port parity of RWKV-6: repro_torch.layers.rwkv and repro_torch.models.rwkv6
against the JAX package's, from carried weights (the reference's init,
converted with np.asarray), on the reduced rwkv6-7b.

The exact scan is K3's function, so the port routes it through
``ops.wkv6_op`` (its plain step loop on these CPU tensors) and, under
autograd, through ``WKV6``, whose backward computes the recurrence's
adjoint chunk by chunk: the CPU runs the backward the card runs.  Bars: the WKV forms at
the reference's own (tests/test_layers.py:146-206, rtol 2e-4 / atol
2e-5), ``WKV6``'s grads against ``jax.grad`` of ``wkv_scan`` at 1e-4 /
1e-5, the layers at 1e-4 / 1e-5 in f32 and 2e-2 in bf16, the model's
prefill and decode at 1e-4 in f32 and 6e-2 in bf16 (the dense LM's bar),
``train_loss`` and every grad leaf at 1e-4 / 1e-5 in f32 and, in bf16, the
loss at 6e-2 and each grad leaf at 5e-2 by relative Frobenius error (the
reference jitted with ``xla_allow_excess_precision`` off, as in
tests/test_torch_moe.py), one train step as in
tests/test_torch_lm_training.py."""
import argparse
import contextlib
import dataclasses
import functools
import io
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.config import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.config import get_config as jax_get_config  # noqa: E402
from repro.config import reduced_config as jax_reduced_config  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.layers import rwkv as jrwkv  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.training import build_train_step as jax_build_train_step  # noqa: E402
from repro.training import init_train_state as jax_init_train_state  # noqa: E402
from repro_torch.config import TrainConfig, get_config, list_archs, reduced_config  # noqa: E402
from repro_torch.data import LMDataConfig, make_lm_batch  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6_plain  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.layers import rwkv as trwkv  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.api import UNPORTED_FAMILIES  # noqa: E402
from repro_torch.serving import GreedyDecoder, stitch_prefill_cache  # noqa: E402
from repro_torch.training import build_train_step, init_train_state  # noqa: E402
from repro_torch.utils import params_from_numpy, tree_leaves  # noqa: E402

ARCH = "rwkv6-7b"
WKV_TOL = dict(rtol=2e-4, atol=2e-5)        # tests/test_layers.py:146-206
F32_TOL = dict(rtol=1e-4, atol=1e-5)
LAYER_TOL = {"float32": F32_TOL, "bfloat16": dict(rtol=2e-2, atol=2e-2)}
MODEL_TOL = {"float32": 1e-4, "bfloat16": 6e-2}
BF16_GRAD_REL = 5e-2
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                        else np.asarray(a), tree)


def _carry(tree):
    return params_from_numpy(_np(tree), "cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(want, np.float32), **tol)


def _wkv_case(b, s, h, hd, seed):
    """numpy f32 r, k, v, w, u, s0 drawn as tests/test_layers.py draws them:
    decays above exp(-4), so the chunked form is exact too."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    r, k, v = (normal(b, s, h, hd) * np.float32(0.3) for _ in range(3))
    w = np.exp(-np.exp(rng.uniform(-6.0, 0.5, (b, s, h, hd)))).astype(np.float32)
    return r, k, v, w, normal(h, hd) * np.float32(0.1), normal(b, h, hd, hd) * np.float32(0.1)


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------- config and init ----------------

def test_config_matches_reference_and_builds():
    """rwkv6-7b and its reduced config field for field; registered, no
    longer unported, and built with the reference's param tree."""
    assert ARCH in list_archs() and "rwkv6" not in UNPORTED_FAMILIES
    for mine, ref in ((get_config(ARCH), jax_get_config(ARCH)),
                      (reduced_config(ARCH), jax_reduced_config(ARCH))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    ref = jax.eval_shape(lambda: jax_build_model(jax_reduced_config(ARCH)).init(
        jax.random.PRNGKey(0)))
    api = build_model(reduced_config(ARCH))
    mine = api.init(torch.Generator().manual_seed(0), device="cpu")
    ref_flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    mine_flat = jax.tree_util.tree_flatten_with_path(mine)[0]
    assert [jax.tree_util.keystr(p) for p, _ in mine_flat] == \
        [jax.tree_util.keystr(p) for p, _ in ref_flat]
    for (_, t), (_, s) in zip(mine_flat, ref_flat):
        assert tuple(t.shape) == s.shape and str(t.dtype).split(".")[1] == str(s.dtype)
    cache = api.init_cache(3, 99, device="cpu")
    jcache = jax_build_model(jax_reduced_config(ARCH)).init_cache(3, 99)
    for name in ("tm_x", "wkv", "cm_x"):
        assert tuple(cache[name].shape) == jcache[name].shape
        assert str(cache[name].dtype).split(".")[1] == str(jcache[name].dtype)
        assert not cache[name].any()


def test_init_draws_the_reference_distribution():
    """Each drawn leaf truncated-normal at the reference's fan_in; the
    constants as the reference sets them."""
    cfg = reduced_config(ARCH)
    p = build_model(cfg).init(torch.Generator().manual_seed(3), device="cpu")["layers"]
    d, r, hd = cfg.d_model, cfg.rwkv.decay_lora, cfg.rwkv.head_dim
    for w, fan_in in ((p["tm"]["r"]["w"], d), (p["tm"]["w1"], d), (p["tm"]["w2"], r),
                      (p["tm"]["u"], hd), (p["cm"]["down"]["w"], cfg.d_ff)):
        std = fan_in ** -0.5
        assert float(w.abs().max()) <= 2 * std + 1e-7
        assert abs(float(w.std()) / std - 0.88) < 0.1            # a normal cut at 2 std
    assert torch.equal(p["tm"]["wbase"], torch.full((cfg.num_layers, d), -6.0))
    assert torch.equal(p["tm"]["mix"], torch.full((cfg.num_layers, 5, d), 0.5))
    assert torch.equal(p["cm"]["mix"], torch.full((cfg.num_layers, 2, d), 0.5))


def test_the_default_device_is_the_gpu():
    """``device=None`` resolves to cuda and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device resolves")
    api = build_model(reduced_config(ARCH))
    for call in (lambda: api.init(torch.Generator().manual_seed(0)),
                 lambda: api.init_cache(2, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------- the WKV recurrence ----------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv_scan_matches_reference(dtype):
    """The exact scan at the reference's shape (S=50, uneven against its
    64-step chunks), r, k, v in the compute dtype, passed to the scan
    uncast; y and the state f32."""
    tdt, jdt = DTYPES[dtype]
    case = _wkv_case(2, 50, 3, 32, seed=21)
    t, j = _t(case), _j(case)
    t[:3] = [a.to(tdt) for a in t[:3]]
    j[:3] = [a.astype(jdt) for a in j[:3]]
    y, s = trwkv.wkv_scan(*t)
    jy, js = jrwkv.wkv_scan(*j)
    assert y.dtype == s.dtype == torch.float32 and y.shape == t[0].shape
    _close(y, jy, WKV_TOL)
    _close(s, js, WKV_TOL)


def test_wkv_scan_chunked_matches_reference_and_exact_scan():
    case = _wkv_case(2, 50, 3, 32, seed=22)
    y, s = trwkv.wkv_scan_chunked(*_t(case))
    jy, js = jrwkv.wkv_scan_chunked(*_j(case))
    _close(y, jy, WKV_TOL)
    _close(s, js, WKV_TOL)
    ye, se = trwkv.wkv_scan(*_t(case))
    _close(y, ye.numpy(), WKV_TOL)
    _close(s, se.numpy(), WKV_TOL)


def test_wkv_step_matches_reference():
    case = _wkv_case(2, 1, 3, 16, seed=23)
    step = [a[:, 0] for a in case[:4]] + list(case[4:])
    y, s = trwkv.wkv_step(*_t(step))
    jy, js = jrwkv.wkv_step(*_j(step))
    assert tuple(y.shape) == (2, 3, 16)
    _close(y, jy, WKV_TOL)
    _close(s, js, WKV_TOL)


def _wkv_grads_case(seq):
    """(inputs, dy, dS) for a scalar loss sum(y * dy) + sum(S_T * dS)."""
    case = _wkv_case(2, seq, 2, 16, seed=seq)
    rng = np.random.default_rng(seq + 1)
    return (case, rng.standard_normal((2, seq, 2, 16)).astype(np.float32),
            rng.standard_normal((2, 2, 16, 16)).astype(np.float32))


@pytest.mark.parametrize("seq", [150, 192])
def test_wkv6_grads_match_jax(seq):
    """``WKV6``'s grads of every input, s0 included, against ``jax.grad``
    of the reference's ``wkv_scan``, at an S that spans several 64-step
    chunks and leaves the last one short (150) and one that fills three
    (192)."""
    case, dy, ds = _wkv_grads_case(seq)

    def jloss(args):
        y, s = jrwkv.wkv_scan(*args)
        return jnp.sum(y * dy) + jnp.sum(s * ds)

    want = jax.grad(jloss)(tuple(_j(case)))
    leaves = [t.requires_grad_() for t in _t(case)]
    y, s = trwkv.wkv_scan(*leaves)
    got = torch.autograd.grad(torch.sum(y * torch.from_numpy(dy))
                              + torch.sum(s * torch.from_numpy(ds)), leaves)
    for g, w in zip(got, want):
        _close(g, w, F32_TOL)


def test_wkv6_backward_rebuilds_a_state_per_chunk(monkeypatch):
    """The backward calls ``wkv6_op`` once per chunk after the first
    (ceil(T / 64) - 1: the K3 launches the chip run predicts), on
    contiguous chunks chained from s0, and its grads equal autograd's
    through the plain step loop; s0, not needing grad, gets none."""
    calls = []
    real = trwkv.wkv6_op

    def recorded(*args):
        calls.append(tuple(args[0].shape))
        assert all(a.is_contiguous() for a in args)
        return real(*args)

    monkeypatch.setattr(trwkv, "wkv6_op", recorded)
    case, dy, _ = _wkv_grads_case(150)
    r, k, v, w, u, s0 = _t(case)
    leaves = [t.requires_grad_() for t in (r, k, v, w, u)]
    y, _ = trwkv.wkv_scan(*leaves, s0)
    assert calls == [(2, 150, 2, 16)]
    got = torch.autograd.grad(torch.sum(y * torch.from_numpy(dy)), leaves)
    assert calls[1:] == [(2, 64, 2, 16)] * (math.ceil(150 / 64) - 1)
    want = torch.autograd.grad(torch.sum(wkv6_plain(*leaves, s0)[0] * torch.from_numpy(dy)),
                               leaves)
    for g, wg in zip(got, want):
        torch.testing.assert_close(g, wg, rtol=1e-5, atol=1e-6)


# ---------------- the layers ----------------

@functools.lru_cache(maxsize=None)
def _layer_params(seed=0):
    jcfg = jax_reduced_config(ARCH)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    jtm, jcm = jrwkv.init_time_mix(k1, jcfg), jrwkv.init_channel_mix(k2, jcfg)
    return jcfg, reduced_config(ARCH), jtm, jcm, _carry(jtm), _carry(jcm)


def _x(cfg, dtype, *lead, seed=4):
    x = np.random.default_rng(seed).standard_normal(lead + (cfg.d_model,)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_mix_matches_reference(dtype):
    """The sequence form from a carried x_prev and state (S=70: past one
    64-step chunk), y in the compute dtype, the state in f32."""
    jcfg, cfg, jtm, _, tm, _ = _layer_params()
    xt, xj = _x(cfg, dtype, 2, 70)
    pt, pj = _x(cfg, dtype, 2, seed=5)
    st = _wkv_case(2, 1, 4, 16, seed=6)[5]
    y, (last, s) = trwkv.apply_time_mix(tm, xt, cfg, x_prev=pt, state=torch.from_numpy(st))
    jy, (jlast, js) = jrwkv.apply_time_mix(jtm, xj, jcfg, x_prev=pj, state=jnp.asarray(st))
    assert y.dtype == xt.dtype and s.dtype == torch.float32 and torch.equal(last, xt[:, -1])
    _close(y, jy.astype(jnp.float32), LAYER_TOL[dtype])
    _close(s, js, LAYER_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_mix_step_matches_reference(dtype):
    jcfg, cfg, jtm, _, tm, _ = _layer_params()
    xt, xj = _x(cfg, dtype, 3)
    pt, pj = _x(cfg, dtype, 3, seed=5)
    st = _wkv_case(3, 1, 4, 16, seed=7)[5]
    y, (x_out, s) = trwkv.apply_time_mix_step(tm, xt, cfg, pt, torch.from_numpy(st))
    jy, (_, js) = jrwkv.apply_time_mix_step(jtm, xj, jcfg, pj, jnp.asarray(st))
    assert y.dtype == xt.dtype and x_out is xt
    _close(y, jy.astype(jnp.float32), LAYER_TOL[dtype])
    _close(s, js, LAYER_TOL[dtype])


@pytest.mark.parametrize("scan_impl", ["steps", "chunked"])
def test_time_mix_scan_impls_match_reference(scan_impl):
    """Both ``scan_impl`` settings in f32: the chunked form stays plain ops."""
    jcfg, cfg, jtm, _, tm, _ = _layer_params()
    jcfg = jcfg.with_overrides(rwkv=dataclasses.replace(jcfg.rwkv, scan_impl=scan_impl))
    cfg = cfg.with_overrides(rwkv=dataclasses.replace(cfg.rwkv, scan_impl=scan_impl))
    xt, xj = _x(cfg, "float32", 2, 21, seed=8)
    y, (_, s) = trwkv.apply_time_mix(tm, xt, cfg)
    jy, (_, js) = jrwkv.apply_time_mix(jtm, xj, jcfg)
    _close(y, jy, F32_TOL)
    _close(s, js, F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_mix_matches_reference(dtype):
    jcfg, cfg, _, jcm, _, cm = _layer_params()
    xt, xj = _x(cfg, dtype, 2, 9)
    pt, pj = _x(cfg, dtype, 2, seed=5)
    y, last = trwkv.apply_channel_mix(cm, xt, cfg, x_prev=pt)
    jy, _ = jrwkv.apply_channel_mix(jcm, xj, jcfg, x_prev=pj)
    assert y.dtype == xt.dtype and torch.equal(last, xt[:, -1])
    _close(y, jy.astype(jnp.float32), LAYER_TOL[dtype])


def test_rwkv_sequence_equals_steps():
    """tests/test_layers.py::test_rwkv_sequence_equals_steps on the port."""
    _, cfg, _, _, tm, _ = _layer_params(13)
    b, s = 2, 6
    x = torch.randn(b, s, cfg.d_model, generator=torch.Generator().manual_seed(14))
    y_seq, (_, st_seq) = trwkv.apply_time_mix(tm, x, cfg)
    x_prev = torch.zeros(b, cfg.d_model)
    st = torch.zeros(b, 4, 16, 16)
    ys = []
    for t in range(s):
        y_t, (x_prev, st) = trwkv.apply_time_mix_step(tm, x[:, t], cfg, x_prev, st)
        ys.append(y_t)
    torch.testing.assert_close(torch.stack(ys, 1), y_seq, **WKV_TOL)
    torch.testing.assert_close(st, st_seq, **WKV_TOL)


# ---------------- the model ----------------

@functools.lru_cache(maxsize=None)
def _model(dtype):
    japi = jax_build_model(jax_reduced_config(ARCH).with_overrides(compute_dtype=dtype))
    jparams = japi.init(jax.random.PRNGKey(0))
    return japi, jparams, build_model(reduced_config(ARCH).with_overrides(compute_dtype=dtype)), \
        _carry(jparams)


def _tokens(cfg, b, s, seed=26):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _state_close(got, want, tol):
    """The token shifts at ``tol``; the f32 WKV state at ``tol`` relative
    plus ``tol`` times its rms absolute: it is an unnormalised sum over the
    prompt of products of k and v (entries past 10 here), so in bf16 each
    entry carries the bf16 rounding of its terms in proportion to the
    state's scale, not its own."""
    for name in ("tm_x", "wkv", "cm_x"):
        assert got[name].dtype == getattr(torch, str(want[name].dtype))
        w = np.asarray(want[name].astype(jnp.float32))
        scale = float(np.sqrt(np.mean(np.square(w)))) if name == "wkv" else 1.0
        _close(got[name], w, dict(rtol=tol, atol=tol * scale))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_reference(dtype):
    """Logits and the stacked state over S=67 (past one 64-step chunk)."""
    japi, jparams, api, params = _model(dtype)
    toks = _tokens(api.cfg, 2, 67)
    logits, state = api.prefill(params, {"tokens": torch.from_numpy(toks)})
    jlogits, jstate = jax.jit(lambda p, t: japi.prefill(p, {"tokens": t}))(jparams,
                                                                          jnp.asarray(toks))
    assert tuple(logits.shape) == (2, 1, api.cfg.vocab_size) and logits.dtype == DTYPES[dtype][0]
    _close(logits, jlogits.astype(jnp.float32), dict(rtol=MODEL_TOL[dtype], atol=MODEL_TOL[dtype]))
    _state_close(state, jstate, MODEL_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_after_prefill_matches_reference(dtype):
    """Two decode steps from the reference prefill's state, carried: the
    logits and the new state against the JAX package's decode from the
    same state."""
    japi, jparams, api, params = _model(dtype)
    toks = _tokens(api.cfg, 2, 9)
    _, jstate = japi.prefill(jparams, {"tokens": jnp.asarray(toks)})
    state = {k: _carry(v).to(getattr(torch, str(v.dtype))) for k, v in jstate.items()}
    tol = dict(rtol=MODEL_TOL[dtype], atol=MODEL_TOL[dtype])
    for i, token in enumerate(_tokens(api.cfg, 2, 2, seed=27).T):
        token = token[:, None]
        logits, state = api.decode(params, torch.from_numpy(token), state, torch.tensor(9 + i))
        jlogits, jstate = japi.decode(jparams, jnp.asarray(token), jstate, jnp.int32(9 + i))
        _close(logits, jlogits.astype(jnp.float32), tol)
        _state_close(state, jstate, MODEL_TOL[dtype])


def test_decode_consistent_with_prefill():
    """tests/test_layers.py::test_rwkv_model_prefill_then_decode_consistent
    on the port, at its bar (3e-2, the default bf16 compute)."""
    api = build_model(reduced_config(ARCH))
    params = api.init(torch.Generator().manual_seed(17), device="cpu")
    toks = torch.from_numpy(_tokens(api.cfg, 1, 9, seed=18))
    full, _ = api.prefill(params, {"tokens": toks})
    _, state = api.prefill(params, {"tokens": toks[:, :-1]})
    dec, _ = api.decode(params, toks[:, -1:], state, torch.tensor(8))
    torch.testing.assert_close(dec.float(), full.float(), rtol=3e-2, atol=3e-2)


def _rel_fro(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got.float().numpy() - want) / max(np.linalg.norm(want), 1e-30))


def _batch(cfg, b=2, s=70, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[:, -2:] = -1
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32), "labels": labels}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_loss_matches_reference(dtype):
    """The loss and every grad leaf against jax.value_and_grad of the
    reference's loss (S=70: the WKV backward walks two chunks, the
    second short), the reference jitted with ``xla_allow_excess_precision``
    off so that each bf16 op rounds as written, as the port's do."""
    japi, jparams, api, params = _model(dtype)
    batch = _batch(api.cfg)
    fn = jax.value_and_grad(lambda p, bt: japi.loss(p, bt, loss_chunk=32), has_aux=True)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    exact = jax.jit(fn).lower(jparams, jbatch).compile(
        compiler_options={"xla_allow_excess_precision": False})
    (jloss, jmetrics), jgrads = exact(jparams, jbatch)
    jgrads = jax.tree.leaves(jgrads)
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    it = iter(leaves)
    tracked = jax.tree.map(lambda _: next(it), params)      # tree_leaves order: sorted keys
    loss, metrics = api.loss(tracked, {k: torch.from_numpy(v).long() for k, v in batch.items()},
                             loss_chunk=32)
    grads = torch.autograd.grad(loss, leaves)
    assert set(metrics) == set(jmetrics) == {"xent"} and len(grads) == len(jgrads)
    if dtype == "float32":
        np.testing.assert_allclose(float(loss), float(jloss), **F32_TOL)
        for g, w in zip(grads, jgrads):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)
    else:
        np.testing.assert_allclose(float(loss), float(jloss), rtol=MODEL_TOL[dtype],
                                   atol=MODEL_TOL[dtype])
        errs = [_rel_fro(g, w) for g, w in zip(grads, jgrads)]
        assert max(errs) < BF16_GRAD_REL, errs


def test_remat_is_bit_equal_to_no_remat():
    """Per-layer recompute reruns the same ops (K3's plain version here):
    loss and grads bit-equal to no remat."""
    _, _, api, params = _model("bfloat16")
    batch = {k: torch.from_numpy(v).long() for k, v in _batch(api.cfg).items()}
    runs = []
    for remat in (True, False):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        it = iter(leaves)
        tracked = jax.tree.map(lambda _: next(it), params)
        loss, _ = api.loss(tracked, batch, remat=remat, loss_chunk=32)
        runs.append((loss, torch.autograd.grad(loss, leaves)))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


STEP_TC = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10, loss_chunk=8)
TINY_GRAD = 1e-6


@pytest.mark.parametrize("form", [{}, {"microbatch": 2}, {"grad_compression": "int8_ef"}])
def test_train_step_matches_reference(form):
    """One AdamW step of both packages from the same params and batch
    (plain, microbatched, int8 error feedback): metrics at rtol 1e-5, the
    first moment at the grads' bar, params at atol 1e-6 except where the
    reference's |g| is below TINY_GRAD (held to one update, 2 lr), and
    under int8_ef at most 0.1% of the elements an int8 level apart
    (tests/test_torch_lm_training.py).  A level is read off the
    reference's error buffer (its entries span half a level either side of
    0): RWKV's grads reach 0.06 here, so their f32 disagreement (1e-5
    relative) moves the buffers by more than the absolute 1e-7 that marks
    a flip for the dense LM's small grads."""
    japi, _, api, _ = _model("float32")
    jtc, tc = JaxTrainConfig(**STEP_TC, **form), TrainConfig(**STEP_TC, **form)
    jstate = jax_init_train_state(japi, jax.random.PRNGKey(0), jtc)
    state = init_train_state(params_from_numpy(_np(jstate.params), "cpu"), tc)
    batch = make_lm_batch(LMDataConfig(vocab_size=api.cfg.vocab_size, seq_len=16,
                                       global_batch=4), 0)
    jstate, jmetrics = jax.jit(jax_build_train_step(japi, jtc))(
        jstate, {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in batch.items()})
    state, metrics = build_train_step(api, tc)(state, batch)
    assert set(metrics) == set(jmetrics)
    for k in ("loss", "xent", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5)
    keep = [np.ones(p.shape, bool) for p in tree_leaves(state.params)]
    if state.ef is not None:
        flips = [np.abs(e.numpy() - np.asarray(je)) > np.abs(np.asarray(je)).max()
                 for e, je in zip(tree_leaves(state.ef), jax.tree.leaves(jstate.ef))]
        assert sum(int(f.sum()) for f in flips) <= 1e-3 * sum(f.size for f in flips)
        keep = [~f for f in flips]
    lr = float(jmetrics["lr"])
    for n, (p, jp, mu, jmu) in enumerate(zip(
            tree_leaves(state.params), jax.tree.leaves(jstate.params),
            tree_leaves(state.opt.mu), jax.tree.leaves(jstate.opt.mu))):
        mask = keep[n]
        np.testing.assert_allclose(mu.numpy()[mask], np.asarray(jmu)[mask], rtol=1e-4, atol=1e-6)
        tiny = np.abs(np.asarray(jmu)) / (1 - tc.beta1) < TINY_GRAD
        diff = np.abs(p.numpy() - np.asarray(jp))
        assert diff[mask & ~tiny].max(initial=0.0) <= 1e-6
        assert diff[mask & tiny].max(initial=0.0) <= 2 * lr


# ---------------- serving ----------------

def test_greedy_decoder_carries_the_state():
    """``GreedyDecoder`` (eager on the CPU) from the prefill's state, taken
    as the decode cache as it is: each token is the argmax of a
    teacher-forced re-prefill, and the caller's state ends as the state
    after the last token (written back in place)."""
    _, _, api, params = _model("float32")
    toks = torch.from_numpy(_tokens(api.cfg, 2, 6, seed=3))
    logits, pre = api.prefill(params, {"tokens": toks})
    first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    cache = stitch_prefill_cache(api, pre, 0)
    assert cache is pre and api.stitch(pre, 0) is pre
    out, back = GreedyDecoder(api)(params, cache, first, 6, 4)
    assert back is cache and out.shape == (2, 4)
    seq = torch.cat([toks, first, out[:, :-1]], dim=1)
    for j in range(4):
        full, state = api.prefill(params, {"tokens": seq[:, :7 + j]})
        assert torch.equal(full[:, -1].argmax(-1).to(torch.int32), out[:, j])
    for name in ("tm_x", "wkv", "cm_x"):
        torch.testing.assert_close(cache[name], state[name], rtol=1e-5, atol=1e-6)


def _teacher_forced(prefill, tokens, n):
    """The greedy continuation by re-prefilling the growing sequence."""
    out = []
    for _ in range(n):
        logits, _ = prefill(tokens)
        nxt = np.asarray(logits[:, -1], np.float32).argmax(-1)
        out.append(int(nxt[0]))
        tokens = np.concatenate([tokens, nxt[:, None].astype(np.int32)], axis=1)
    return out


def _continuation(serve_lm, cfg):
    args = argparse.Namespace(device="cpu", batch=2, seq_len=7, decode_tokens=5)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_lm(cfg, args)
    out = buf.getvalue()
    assert re.search(r"\[serve\] .*: prefill\(2x7\)=[\d.]+ms, 5 tokens decoded in", out)
    return [int(t) for t in re.search(r"sample continuation: \[(.*)\]", out).group(1).split(",")]


def test_serve_lm_decodes_from_the_prefill_state():
    """The port's ``serve_lm`` on the reduced config continues the prompt
    as a teacher-forced re-prefill does (after the prefill's own token)."""
    cfg = reduced_config(ARCH).with_overrides(compute_dtype="float32")
    cont = _continuation(serve_launcher.serve_lm, cfg)
    api = build_model(cfg)
    params = api.init(torch.Generator("cpu").manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 7), generator=torch.Generator("cpu").manual_seed(1),
                         dtype=torch.int32)[:1].numpy()

    def prefill(t):
        logits, state = api.prefill(params, {"tokens": torch.from_numpy(t)})
        return logits.numpy(), state

    assert cont == _teacher_forced(prefill, toks, 6)[1:]


def test_reference_serve_lm_decodes_from_a_zero_state():
    """Pins the reference's fault (ROADMAP.md, queue 3): its ``serve_lm``
    throws the prefill's state away and decodes from ``init_state``'s
    zeros, so its continuation is not the teacher-forced one of its own
    model, params and prompt."""
    jcfg = jax_reduced_config(ARCH).with_overrides(compute_dtype="float32")
    cont = _continuation(jax_serve.serve_lm, jcfg)
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 7), 0, jcfg.vocab_size))[:1]
    prefill = jax.jit(lambda t: japi.prefill(jparams, {"tokens": t}))
    assert cont != _teacher_forced(prefill, toks, 6)[1:]


def test_launchers_serve_and_train_resume(tmp_path, capsys):
    """``serve --arch rwkv6-7b --device cpu`` prefills and decodes at the
    reduced size; ``train`` checkpoints every 2 steps, and a second run
    resumes from step 4 onto the trajectory of one uninterrupted run."""
    from repro_torch.launch import train as train_launcher

    serve_launcher.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--seq-len", "8",
                         "--decode-tokens", "3"])
    out = capsys.readouterr().out
    assert f"[serve] {ARCH}-reduced: prefill(2x8)=" in out and "3 tokens decoded" in out

    def train(ckpt_dir, steps):
        train_launcher.main(["--arch", ARCH, "--device", "cpu", "--steps", str(steps),
                             "--ckpt-every", "2", "--ckpt-dir", str(ckpt_dir), "--batch", "2",
                             "--seq-len", "8"])
        text = capsys.readouterr().out
        return text, [ln for ln in text.splitlines() if ln.startswith("[train] step")][-1]

    first, _ = train(tmp_path / "a", 4)
    assert f"[train] {ARCH}-reduced:" in first and "resumed" not in first
    second, resumed_last = train(tmp_path / "a", 6)
    assert "[train] resumed from step 4" in second
    whole, whole_last = train(tmp_path / "b", 6)
    assert resumed_last == whole_last and "loss=nan" not in whole


def test_state_tree_is_what_the_decode_returns():
    """``init_cache`` gives the decode's state tree (bf16 token shifts, f32
    WKV), and a decode step writes the new state into it in place and
    returns that same tree, as the transformer's decode does with its KV
    cache: a captured decode's buffers then hold the state after each
    replay.  The state written equals a one-token prefill's from zeros."""
    _, _, api, params = _model("bfloat16")
    cache = api.init_cache(2, 0, device="cpu")
    leaves = {name: cache[name] for name in cache}
    token = torch.from_numpy(_tokens(api.cfg, 2, 1, seed=5))
    _, new = api.decode(params, token, cache, torch.tensor(0))
    assert new is cache and all(cache[name] is leaves[name] for name in leaves)
    assert cache["wkv"].dtype == torch.float32 and cache["tm_x"].dtype == torch.bfloat16
    _, want = api.prefill(params, {"tokens": token})
    for name in cache:
        assert cache[name].shape == want[name].shape and cache[name].dtype == want[name].dtype
        torch.testing.assert_close(cache[name], want[name], rtol=1e-5, atol=1e-6)
        assert cache[name].abs().max() > 0
