"""Port parity of Jamba: repro_torch.layers.mamba, attention without RoPE
and repro_torch.models.jamba against the JAX package's, from carried
weights (the reference's init, converted with np.asarray), on the reduced
jamba-v0.1-52b (one period of 8 layers: 7 Mamba, attention at position 4,
MoE of 4 experts top-2 at 1, 3, 5 and 7).

Bars: the Mamba forms in f32 at the reference's own (tests/test_layers.py:210-229,
rtol 2e-4 / atol 2e-5), the Mamba layer in bf16 at 6e-2; attention
without RoPE at 1e-4 in f32 and 6e-2 in bf16; the model's prefill (logits
and every state) and decode at 1e-4 in f32 and 6e-2 in bf16; decode
against prefill through ``ModelAPI.stitch`` at the reference's 5e-2
(tests/test_serving_consistency.py:80-107); ``train_loss`` and every grad
leaf at 1e-4 / 1e-5 in f32 and, in bf16, the loss at 6e-2 and each grad
leaf at 5e-2 by relative Frobenius error; one train step as in
tests/test_torch_lm_training.py.  Where the reference is jitted in bf16 it
is compiled with ``xla_allow_excess_precision`` off, so that each bf16 op
rounds as written, as the port's do (tests/test_torch_moe.py).

Routing is discrete, and in bf16 the two packages' router inputs lie an
ulp or so apart: XLA's CPU transcendentals are approximations (40% of
bf16 ``jax.nn.silu`` outputs and 10% of f32 ``exp`` outputs here differ
from PyTorch's by an ulp), and every Mamba layer runs two SiLUs, a
softplus and an exp.  Their router probabilities then differ by up to
~1e-2, which swaps a near-tied expert of a few tokens, and that moves the
token's row by O(1) in every later layer.  So every MoE layer of a model
test is held to the reference's routing, recorded from inside its
compiled scan by a debug callback: the port's own top-k must equal the
reference's at every token whose reference gap between the k-th and
(k+1)-th probability exceeds ``ROUTE_TIE`` (1e-5 in f32, as
tests/test_torch_moe.py; 2e-2 in bf16), the swaps at near-ties are
counted and must be few, and the port then combines the reference's
choices with its own weights, so that the rest of the model is held at
the bars above rather than a swap's O(1).  The router itself is held on
equal inputs without that (``test_moe_routing_matches_reference``)."""
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
from repro.layers import attention as jattn  # noqa: E402
from repro.layers import mamba as jmamba  # noqa: E402
from repro.layers import moe as jmoe  # noqa: E402
from repro.layers import norms as jnorms  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import jamba as jjamba  # noqa: E402
from repro.optim import adamw_update as jax_adamw_update  # noqa: E402
from repro.optim import compress_grads as jax_compress_grads  # noqa: E402
from repro.training import build_train_step as jax_build_train_step  # noqa: E402
from repro.training import init_train_state as jax_init_train_state  # noqa: E402
from repro_torch.config import TrainConfig, get_config, list_archs, reduced_config  # noqa: E402
from repro_torch.data import LMDataConfig, make_lm_batch  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.layers import mamba as tmamba  # noqa: E402
from repro_torch.layers import moe as tmoe  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import jamba as tjamba  # noqa: E402
from repro_torch.models.api import UNPORTED_FAMILIES  # noqa: E402
from repro_torch.serving import GreedyDecoder, stitch_prefill_cache  # noqa: E402
from repro_torch.training import build_train_step, init_train_state  # noqa: E402
from repro_torch.utils import params_from_numpy, tree_leaves, tree_map  # noqa: E402

ARCH = "jamba-v0.1-52b"
MAMBA_TOL = dict(rtol=2e-4, atol=2e-5)      # tests/test_layers.py:210-229
F32_TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = {"float32": 1e-4, "bfloat16": 6e-2}
CONSISTENCY_TOL = 5e-2                      # tests/test_serving_consistency.py:80-107
BF16_GRAD_REL = 5e-2
TIE = 1e-5
ROUTE_TIE = {"float32": TIE, "bfloat16": 2e-2}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
EXACT = {"xla_allow_excess_precision": False}


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                        else np.asarray(a), tree)


def _carry(tree):
    """A JAX tree -> tensors on the CPU in the same dtypes (bf16 via f32)."""
    dtypes = jax.tree.map(lambda a: getattr(torch, str(a.dtype)), tree)
    return tree_map(lambda t, dt: t.to(dt), params_from_numpy(_np(tree), "cpu"), dtypes)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(want, np.float32), **tol)


def _both(x, dtype):
    """x as a tensor and as a JAX array, sharing no memory: the port writes
    states in place, and ``jnp.asarray`` may alias a numpy buffer."""
    tdt, jdt = DTYPES[dtype]
    return torch.tensor(x).to(tdt), jnp.asarray(x).astype(jdt)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _exact_jit(fn, *args):
    """``fn`` jitted with each bf16 op rounded as written, traced anew (a
    cached trace would keep an earlier ``_reference_routes``' recorder)."""
    return jax.jit(lambda *a: fn(*a)).lower(*args).compile(compiler_options=EXACT)(*args)


@contextlib.contextmanager
def _reference_routes():
    """(indices, probs) of every call of the reference's ``_router`` while
    open, in call order, sent out of its compiled code by a debug callback."""
    real, rec = jmoe._router, []

    def recorded(p, x, top_k):
        out = real(p, x, top_k)
        jax.debug.callback(lambda i, pr: rec.append((np.asarray(i), np.asarray(pr))),
                           out[1], out[2])
        return out

    jmoe._router = recorded
    try:
        yield rec
    finally:
        jmoe._router = real


@contextlib.contextmanager
def _routed_as(rec, dtype):
    """The port's MoE layers routed as the reference's calls in ``rec``
    (taken in order, cycling: a recompute routes again).  Each layer's own
    top-k must equal the reference's wherever the reference's k-th and
    (k+1)-th probabilities lie more than ROUTE_TIE apart; the swaps at
    near-ties are counted in the yielded list (one entry a call), and the
    reference's choices are combined with the port's own weights."""
    real, swaps = tmoe._router, []

    def routed(p, x, top_k):
        _, idx, probs = real(p, x, top_k)
        jidx, jprobs = rec[len(swaps) % len(rec)]
        top = np.sort(jprobs, axis=-1)[:, ::-1]
        clear = top[:, top_k - 1] - top[:, top_k] > ROUTE_TIE[dtype]
        differ = (np.sort(idx.numpy(), -1) != np.sort(jidx, -1)).any(-1)
        assert not (differ & clear).any(), \
            f"routing differs at clear tokens {np.where(differ & clear)}"
        swaps.append(int(differ.sum()))
        want = torch.from_numpy(jidx.astype(np.int64))
        w = probs.gather(-1, want)
        return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), want, probs

    tmoe._router = routed
    try:
        yield swaps
    finally:
        tmoe._router = real


def _few(swaps, tokens):
    """At most 5% of the (token, MoE layer) routings swapped at a near-tie."""
    assert swaps and sum(swaps) <= 0.05 * tokens * len(swaps), swaps


# ---------------- config and init ----------------

def test_config_matches_reference_and_builds():
    """jamba-v0.1-52b and its reduced config field for field; registered, no
    longer unported, and built with the reference's param tree, leaf for
    leaf (path, shape, dtype); ``init_cache`` the reference's state tree."""
    assert ARCH in list_archs() and "jamba" not in UNPORTED_FAMILIES
    for mine, ref in ((get_config(ARCH), jax_get_config(ARCH)),
                      (reduced_config(ARCH), jax_reduced_config(ARCH))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    japi = jax_build_model(jax_reduced_config(ARCH))
    ref = jax.eval_shape(lambda: japi.init(jax.random.PRNGKey(0)))
    api = build_model(reduced_config(ARCH))
    mine = api.init(torch.Generator().manual_seed(0), device="cpu")
    for got, want in ((mine, ref), (api.init_cache(3, 11, device="cpu"),
                                    jax.eval_shape(lambda: japi.init_cache(3, 11)))):
        got_flat = jax.tree_util.tree_flatten_with_path(got)[0]
        want_flat = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [jax.tree_util.keystr(p) for p, _ in got_flat] == \
            [jax.tree_util.keystr(p) for p, _ in want_flat]
        for (_, t), (_, s) in zip(got_flat, want_flat):
            assert tuple(t.shape) == s.shape and str(t.dtype).split(".")[1] == str(s.dtype)
    assert not any(t.any() for t in tree_leaves(api.init_cache(3, 11, device="cpu")))


@pytest.mark.parametrize("arch_config", ["full", "reduced"])
def test_layer_kinds_and_dims_match_reference(arch_config):
    """Attention at position 4, MoE at 1, 3, 5, 7; dt_rank ceil(d_model/16)
    (256 at full width, 4 reduced); the period count, and a layer count off
    the period refused."""
    mine, ref = ((get_config(ARCH), jax_get_config(ARCH)) if arch_config == "full"
                 else (reduced_config(ARCH), jax_reduced_config(ARCH)))
    kinds = [tjamba._layer_kind(mine, j) for j in range(tjamba.PERIOD)]
    assert kinds == [jjamba._layer_kind(ref, j) for j in range(jjamba.PERIOD)]
    assert [k for k, _ in kinds].count("attn") == 1 and kinds[4][0] == "attn"
    assert [j for j, (_, f) in enumerate(kinds) if f == "moe"] == [1, 3, 5, 7]
    assert tmamba.mamba_dims(mine) == jmamba.mamba_dims(ref)
    assert tmamba.mamba_dims(mine)[2] == {"full": 256, "reduced": 4}[arch_config]
    assert tjamba._n_periods(mine) == jjamba._n_periods(ref)
    with pytest.raises(ValueError, match="multiple of 8"):
        tjamba._n_periods(mine.with_overrides(num_layers=12))


def test_init_draws_the_reference_distribution():
    """a_log exactly log(1..d_state) per channel and d_skip ones, as the
    reference sets them; conv_b zero; conv_w truncated-normal at fan_in
    d_conv, the projections at theirs; the attention and MLP leaves as the
    transformer's."""
    cfg = reduced_config(ARCH)
    p = build_model(cfg).init(torch.Generator().manual_seed(3), device="cpu")["positions"]
    jm = jmamba.init_mamba(jax.random.PRNGKey(0), jax_reduced_config(ARCH))
    m = p[0]["mixer"]
    assert np.array_equal(m["a_log"][0].numpy(), np.asarray(jm["a_log"]))
    assert torch.equal(m["d_skip"], torch.ones(1, 2 * cfg.d_model))
    assert not m["conv_b"].any() and not m["dt_proj"]["b"].any()
    d_inner, d_state, dt_rank = tmamba.mamba_dims(cfg)
    for w, fan_in in ((m["conv_w"], cfg.ssm.d_conv), (m["in_x"]["w"], cfg.d_model),
                      (m["x_proj"]["w"], d_inner), (m["dt_proj"]["w"], dt_rank),
                      (m["out"]["w"], d_inner)):
        std = fan_in ** -0.5
        assert float(w.abs().max()) <= 2 * std + 1e-7
        assert abs(float(w.std()) / std - 0.88) < 0.15           # a normal cut at 2 std
    assert set(p[4]["mixer"]) == {"q", "k", "v", "o"} and set(p[1]["ffn"]) == {
        "router", "gate", "up", "down"} and set(p[0]["ffn"]) == {"gate", "up", "down"}


def test_the_default_device_is_the_gpu():
    """``device=None`` resolves to cuda and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device resolves")
    api = build_model(reduced_config(ARCH))
    for call in (lambda: api.init(torch.Generator().manual_seed(0)),
                 lambda: api.init_cache(2, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------- the Mamba layer ----------------

@functools.lru_cache(maxsize=None)
def _mamba(seed=15):
    jcfg = jax_reduced_config(ARCH)
    jp = jmamba.init_mamba(jax.random.PRNGKey(seed), jcfg)
    return jcfg, reduced_config(ARCH), jp, _carry(jp)


def _scan_case(b, s, seed):
    """dt (softplus of a normal: the layer's range), B, C, x, A = -exp(a_log)
    and a state, numpy f32."""
    cfg = reduced_config(ARCH)
    d_inner, d_state, _ = tmamba.mamba_dims(cfg)
    dt = np.log1p(np.exp(_rand(seed, b, s, d_inner))).astype(np.float32)
    a = -np.tile(np.arange(1, d_state + 1, dtype=np.float32), (d_inner, 1))
    return (dt, _rand(seed + 1, b, s, d_state), _rand(seed + 2, b, s, d_state),
            _rand(seed + 3, b, s, d_inner), a, _rand(seed + 4, b, d_inner, d_state, scale=0.5))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state, dtype):
    """y and the new state (the last K-1 inputs); in bf16 bit-equal: the K
    shifted products summed in the reference's order, every add in bf16."""
    jcfg, cfg, jp, p = _mamba()
    xt, xj = _both(_rand(1, 2, 7, 2 * cfg.d_model), dtype)
    st = _rand(2, 2, cfg.ssm.d_conv - 1, 2 * cfg.d_model) if with_state else None
    sargs = ((_both(st, dtype)[0],), (_both(st, dtype)[1],)) if with_state else ((), ())
    y, new = tmamba._causal_conv(xt, p["conv_w"], p["conv_b"], *sargs[0])
    jy, jnew = jmamba._causal_conv(xj, jp["conv_w"], jp["conv_b"], *sargs[1])
    assert y.dtype == new.dtype == xt.dtype and torch.equal(new, xt[:, -3:])
    if dtype == "float32":
        _close(y, jy, MAMBA_TOL)
    else:
        np.testing.assert_array_equal(y.float().numpy(), np.asarray(jy, np.float32))


@pytest.mark.parametrize("seq", [6, 9])
def test_ssm_scan_matches_reference(seq):
    """At an S that is not a multiple of the chunk (4): the reference pads
    with dt = 0, the port walks the real steps."""
    case = _scan_case(2, seq, seed=seq)
    y, h = tmamba.ssm_scan(*map(torch.from_numpy, case), chunk=4)
    jy, jh = jmamba.ssm_scan(*map(jnp.asarray, case), chunk=4)
    assert y.dtype == h.dtype == torch.float32 and y.shape == (2, seq, case[0].shape[-1])
    _close(y, jy, MAMBA_TOL)
    _close(h, jh, MAMBA_TOL)
    y_whole, h_whole = tmamba.ssm_scan(*map(torch.from_numpy, case))
    _close(y_whole, y.numpy(), MAMBA_TOL)
    _close(h_whole, h.numpy(), MAMBA_TOL)


def test_ssm_step_matches_reference():
    case = _scan_case(3, 1, seed=30)
    case = [a[:, 0] for a in case[:4]] + list(case[4:])
    y, h = tmamba.ssm_step(*map(torch.from_numpy, case))
    jy, jh = jmamba.ssm_step(*map(jnp.asarray, case))
    _close(y, jy, MAMBA_TOL)
    _close(h, jh, MAMBA_TOL)


def _mamba_state(cfg, b, dtype, seed):
    d_inner, d_state, _ = tmamba.mamba_dims(cfg)
    ssm = _rand(seed, b, d_inner, d_state, scale=0.5)
    conv = _rand(seed + 1, b, cfg.ssm.d_conv - 1, d_inner)
    ssm_t, ssm_j = _both(ssm, "float32")
    conv_t, conv_j = _both(conv, dtype)
    return {"ssm": ssm_t, "conv": conv_t}, {"ssm": ssm_j, "conv": conv_j}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("from_state", [False, True])
def test_apply_mamba_matches_reference(from_state, dtype):
    """y, ``ssm`` and ``conv`` from zeros and from a carried state (S=9,
    chunk 4): f32 at the reference's Mamba bar, bf16 at 6e-2."""
    jcfg, cfg, jp, p = _mamba()
    xt, xj = _both(_rand(5, 2, 9, cfg.d_model), dtype)
    st, jst = _mamba_state(cfg, 2, dtype, seed=6) if from_state else (None, None)
    y, new = tmamba.apply_mamba(p, xt, cfg, st, chunk=4)
    jy, jnew = jmamba.apply_mamba(jp, xj, jcfg, jst, chunk=4)
    tol = MAMBA_TOL if dtype == "float32" else dict(rtol=6e-2, atol=6e-2)
    assert y.dtype == new["conv"].dtype == xt.dtype and new["ssm"].dtype == torch.float32
    _close(y, jy.astype(jnp.float32), tol)
    _close(new["ssm"], jnew["ssm"], tol)
    _close(new["conv"], jnew["conv"].astype(jnp.float32), tol)


def test_apply_mamba_steps_equal_sequence():
    """tests/test_layers.py::test_mamba_sequence_equals_steps on the port,
    and against the reference's sequence: S decode steps from
    ``init_mamba_state`` (each writing the state in place) give the
    sequence form's y and final ``ssm`` and ``conv``."""
    jcfg, cfg, jp, p = _mamba()
    x = _rand(16, 2, 6, cfg.d_model)
    y_seq, st_seq = tmamba.apply_mamba(p, torch.from_numpy(x), cfg, chunk=4)
    jy, jst = jmamba.apply_mamba(jp, jnp.asarray(x), jcfg, chunk=4)
    st = tmamba.init_mamba_state(cfg, 2, torch.float32)
    leaves = dict(st)
    ys = []
    for t in range(6):
        y_t, back = tmamba.apply_mamba_step(p, torch.from_numpy(x[:, t]), cfg, st)
        assert back is st and all(st[k] is leaves[k] for k in leaves)
        ys.append(y_t)
    y_step = torch.stack(ys, 1)
    for got, want in ((y_step, y_seq), (st["ssm"], st_seq["ssm"]), (st["conv"], st_seq["conv"])):
        torch.testing.assert_close(got, want, **MAMBA_TOL)
    _close(y_step, jy, MAMBA_TOL)
    _close(st["ssm"], jst["ssm"], MAMBA_TOL)
    _close(st["conv"], jst["conv"], MAMBA_TOL)


def test_apply_mamba_step_matches_reference_step():
    """One bf16 decode step from a carried state: y and the state written
    in place against the reference's returned state."""
    jcfg, cfg, jp, p = _mamba()
    xt, xj = _both(_rand(7, 3, cfg.d_model), "bfloat16")
    st, jst = _mamba_state(cfg, 3, "bfloat16", seed=8)
    y, st = tmamba.apply_mamba_step(p, xt, cfg, st)
    jy, jst = jmamba.apply_mamba_step(jp, xj, jcfg, jst)
    tol = dict(rtol=6e-2, atol=6e-2)
    _close(y, jy.astype(jnp.float32), tol)
    _close(st["ssm"], jst["ssm"], tol)
    _close(st["conv"], jst["conv"].astype(jnp.float32), tol)


# ---------------- attention without RoPE ----------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_without_rope_matches_reference(dtype):
    """``apply_attention`` and ``decode_attention`` with ``use_rope=False``
    (Jamba's attention): f32 at 1e-4, bf16 at 6e-2; the K/V they return or
    write are unrotated, and differ from the RoPE forms'."""
    jcfg = jax_reduced_config(ARCH)
    cfg = reduced_config(ARCH)
    jp = jattn.init_attention(jax.random.PRNGKey(9), jcfg)
    p = _carry(jp)
    tol = dict(rtol=MODEL_TOL[dtype], atol=MODEL_TOL[dtype])
    xt, xj = _both(_rand(10, 2, 7, cfg.d_model), dtype)
    y, (k, v) = tattn.apply_attention(p, xt, cfg=cfg, causal=True, use_rope=False, kv_chunk=4,
                                      return_kv=True)
    jy, (jk, jv) = jattn.apply_attention(jp, xj, cfg=jcfg, causal=True, use_rope=False,
                                         kv_chunk=4, return_kv=True)
    for got, want in ((y, jy), (k, jk), (v, jv)):
        _close(got, want.astype(jnp.float32), tol)
    _, (k_rope, _) = tattn.apply_attention(p, xt, cfg=cfg, causal=True, kv_chunk=4,
                                           return_kv=True)
    assert not torch.allclose(k_rope[:, 1:], k[:, 1:])

    cache = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
    cache = {n: torch.cat([c, torch.zeros_like(c[:, :2])], dim=1) for n, c in cache.items()}
    jcache = {n: jnp.asarray(c.float().numpy()).astype(jnp.bfloat16) for n, c in cache.items()}
    x1t, x1j = _both(_rand(11, 2, 1, cfg.d_model), dtype)
    y1, back = tattn.decode_attention(p, x1t, cache, torch.tensor(7), cfg=cfg, use_rope=False)
    jy1, jback = jattn.decode_attention(jp, x1j, jcache, jnp.int32(7), cfg=jcfg, use_rope=False)
    assert back is cache
    _close(y1, jy1.astype(jnp.float32), tol)
    for n in ("k", "v"):
        _close(cache[n], jback[n].astype(jnp.float32), tol)


# ---------------- the model ----------------

@functools.lru_cache(maxsize=None)
def _model(dtype, capacity_factor=None):
    jcfg, cfg = jax_reduced_config(ARCH), reduced_config(ARCH)
    if capacity_factor is not None:
        jcfg = jcfg.with_overrides(
            moe=dataclasses.replace(jcfg.moe, capacity_factor=capacity_factor))
        cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))
    japi = jax_build_model(jcfg.with_overrides(compute_dtype=dtype))
    jparams = japi.init(jax.random.PRNGKey(0))
    return japi, jparams, build_model(cfg.with_overrides(compute_dtype=dtype)), _carry(jparams)


def _tokens(cfg, b, s, seed=26):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _f32(a) -> np.ndarray:
    return a.float().detach().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a.astype(jnp.float32))


def _state_leaves(got, want, want32=None):
    """(name, port leaf, reference leaf[, reference f32 run's leaf]) over a
    state tuple, the port's dtypes the reference's."""
    assert len(got) == len(want) == tjamba.PERIOD
    for j, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for name in g:
            assert g[name].dtype == getattr(torch, str(w[name].dtype))
            yield (name, g[name], w[name]) + (() if want32 is None else (want32[j][name],))


def _states_close(got, want, tol):
    """Every leaf of the state tuple at ``tol``; the f32 SSM state also
    relative to its rms: a sum over the prompt's steps."""
    for name, g, w in _state_leaves(got, want):
        wf = _f32(w)
        scale = float(np.sqrt(np.mean(np.square(wf)))) if name == "ssm" else 1.0
        _close(g, wf, dict(rtol=tol, atol=tol * max(scale, 1.0)))


def _no_farther(got16, ref16, ref32, bar, what):
    """bf16 end to end: the port's result lies within ``bar`` of the
    reference's own bf16 distance from the reference's f32 result (max abs,
    over the rms for an SSM state): the port's bf16 approximates the
    function as the reference's bf16 does."""
    g, r16, r32 = _f32(got16), _f32(ref16), _f32(ref32)
    scale = max(1.0, float(np.sqrt(np.mean(np.square(r32))))) if what == "ssm" else 1.0
    mine, theirs = np.abs(g - r32).max() / scale, np.abs(r16 - r32).max() / scale
    assert mine <= theirs + bar, \
        f"{what}: the port's bf16 {mine:.4g} from f32, the reference's {theirs:.4g}"


@functools.lru_cache(maxsize=None)
def _prefill_both(dtype):
    """(port logits and states, reference's) for a prompt of B=2, S=11, the
    port routed as the reference routed."""
    japi, jparams, api, params = _model(dtype)
    toks = _tokens(api.cfg, 2, 11)
    with _reference_routes() as rec:
        jout = _exact_jit(lambda p, t: japi.prefill(p, {"tokens": t}), jparams, jnp.asarray(toks))
    with _routed_as(rec, dtype) as swaps:
        out = api.prefill(params, {"tokens": torch.from_numpy(toks)})
    _few(swaps, toks.size)
    return out, jout


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_reference(dtype):
    """Logits and every state (S=11) against the reference's jitted
    prefill, routed as the reference routed: in f32 at 1e-4; in bf16 no
    farther (+6e-2) from the reference's f32 prefill than the reference's
    own bf16 prefill is.  (The bf16 chains lie up to 0.18 apart in the
    logits and the reference's bf16 0.17 from its f32: eight layers
    amplify the two packages' ulp-level differences, see the module
    docstring; each bf16 layer on equal inputs is held at 6e-2 by
    ``test_prefill_layers_match_reference_in_bf16``.)"""
    (logits, states), (jlogits, jstates) = _prefill_both(dtype)
    assert tuple(logits.shape) == (2, 1, 512) and logits.dtype == DTYPES[dtype][0]
    if dtype == "float32":
        _close(logits, _f32(jlogits), dict(rtol=MODEL_TOL[dtype], atol=MODEL_TOL[dtype]))
        _states_close(states, jstates, MODEL_TOL[dtype])
        return
    _, (jlogits32, jstates32) = _prefill_both("float32")
    _no_farther(logits, jlogits, jlogits32, MODEL_TOL[dtype], "logits")
    for name, g, w, w32 in _state_leaves(states, jstates, jstates32):
        _no_farther(g, w, w32, MODEL_TOL[dtype], name)


def _reference_layer(jlp, h, jcfg, j):
    """Layer j of the reference's ``period_fn`` (``models/jamba.py:165-182``),
    built from its own layer functions: (h, state)."""
    hn = jnorms.apply_norm(jlp["ln1"], h, jcfg.norm)
    if jjamba._layer_kind(jcfg, j)[0] == "attn":
        y, (k, v) = jattn.apply_attention(jlp["mixer"], hn, cfg=jcfg, causal=True,
                                          use_rope=False, return_kv=True)
        st = {"k": k.astype(h.dtype), "v": v.astype(h.dtype)}
    else:
        y, st = jmamba.apply_mamba(jlp["mixer"], hn, jcfg)
    h = h + y
    f, _ = jjamba._ffn(jlp, jnorms.apply_norm(jlp["ln2"], h, jcfg.norm), jcfg, j)
    return h + f, st


def _reference_decode_layer(jlp, st, h, n, jcfg, j):
    """Layer j of the reference's decode ``period_fn`` (``models/jamba.py:217-236``):
    (h, new state)."""
    hn = jnorms.apply_norm(jlp["ln1"], h, jcfg.norm)
    if jjamba._layer_kind(jcfg, j)[0] == "attn":
        y3, st = jattn.decode_attention(jlp["mixer"], hn[:, None, :], st, n, cfg=jcfg,
                                        use_rope=False)
        y = y3[:, 0, :]
    else:
        y, st = jmamba.apply_mamba_step(jlp["mixer"], hn, jcfg, st)
    h = h + y
    f, _ = jjamba._ffn(jlp, jnorms.apply_norm(jlp["ln2"], h, jcfg.norm)[:, None, :], jcfg, j)
    return h + f[:, 0, :], st


def _position(tree, j):
    """Position j's params of the one period, unstacked."""
    return tree_map(lambda t: t[0], tree["positions"][j])


def test_prefill_layers_match_reference_in_bf16():
    """Each of the 8 bf16 layers of the prefill on equal inputs: the
    reference's chain (its layers jitted one by one) gives layer j its
    input, and the port's ``_layer_fn`` on that input, routed as the
    reference routed, holds the layer's output and state at 6e-2."""
    japi, jparams, api, params = _model("bfloat16")
    jcfg, cfg, tol = japi.cfg, api.cfg, MODEL_TOL["bfloat16"]
    toks = _tokens(cfg, 2, 11)
    jh = jparams["embed"]["table"][jnp.asarray(toks)].astype(jnp.bfloat16)
    for j in range(tjamba.PERIOD):
        jlp = jax.tree.map(lambda a: a[0], jparams["positions"][j])
        h = torch.from_numpy(np.array(_f32(jh))).to(torch.bfloat16)
        with _reference_routes() as rec:
            jh, jst = _exact_jit(lambda lp, x, j=j: _reference_layer(lp, x, jcfg, j), jlp, jh)
        with contextlib.ExitStack() as stack:
            swaps = stack.enter_context(_routed_as(rec, "bfloat16")) if rec else None
            h, aux, st = tjamba._layer_fn(_position(params, j), h, cfg, j, 1024, 1)
        if rec:
            _few(swaps, toks.size)
        assert h.dtype == torch.bfloat16 and (aux != 0.0) == bool(rec)
        _close(h, _f32(jh), dict(rtol=tol, atol=tol))
        _states_close((st,) * tjamba.PERIOD, (jst,) * tjamba.PERIOD, tol)


def _reference_stitched(japi, jstates, b, s, max_len):
    """The reference's prefill states in its decode layout, as
    tests/test_serving_consistency.py stitches them (KV into init_cache's
    bf16 zeros)."""
    out = []
    for j, st in enumerate(jstates):
        if "k" in st:
            tmpl = japi.init_cache(b, max_len)[j]
            out.append({n: tmpl[n].at[:, :, :s].set(st[n].astype(tmpl[n].dtype)) for n in st})
        else:
            out.append(st)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _decode_both(dtype):
    """Two decode steps of both packages after a prompt of B=2, S=9, from
    the reference's stitched prefill states (f32 prefill, so both dtypes
    start from the same states), the port routed as the reference routed:
    [(logits, states, reference logits, reference states)] a step."""
    toks, steps = _tokens(reduced_config(ARCH), 2, 9), 2
    japi, jparams, api, params = _model(dtype)
    j32, jp32, _, _ = _model("float32")
    _, jstates = j32.prefill(jp32, {"tokens": jnp.asarray(toks)})
    jstates = _reference_stitched(japi, jstates, *toks.shape, toks.shape[1] + steps)
    jstates = tuple({n: x if n == "ssm" else x.astype(jnp.dtype(dtype)) for n, x in st.items()}
                    for st in jstates)
    states = _carry(jstates)
    out = []
    for i, token in enumerate(_tokens(api.cfg, toks.shape[0], steps, seed=27).T):
        token, n = token[:, None], toks.shape[1] + i
        with _reference_routes() as rec:
            jlogits, jstates = _exact_jit(japi.decode, jparams, jnp.asarray(token), jstates,
                                          jnp.int32(n))
        with _routed_as(rec, dtype) as swaps:
            logits, back = api.decode(params, torch.from_numpy(token), states, torch.tensor(n))
        assert back is states and len(swaps) == 4 and sum(swaps) <= 1
        out.append((logits, tree_map(torch.clone, states), jlogits, jstates))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_reference(dtype):
    """Two decode steps from the reference's stitched prefill states,
    carried: the logits and every state written (in place) against the
    reference's decode from the same states, routed as it routed; f32 at
    1e-4, bf16 as the prefill's (each bf16 decode layer on equal inputs:
    ``test_decode_layers_match_reference_in_bf16``)."""
    runs = _decode_both(dtype)
    if dtype == "float32":
        for logits, states, jlogits, jstates in runs:
            _close(logits, _f32(jlogits), dict(rtol=1e-4, atol=1e-4))
            _states_close(states, jstates, 1e-4)
        return
    for (logits, states, jlogits, jstates), (_, _, jl32, js32) in zip(
            runs, _decode_both("float32")):
        _no_farther(logits, jlogits, jl32, MODEL_TOL[dtype], "logits")
        for name, g, w, w32 in _state_leaves(states, jstates, js32):
            _no_farther(g, w, w32, MODEL_TOL[dtype], name)


def test_decode_layers_match_reference_in_bf16():
    """Each of the 8 bf16 decode layers on equal inputs and states: the
    reference's decode chain gives layer j its input h and the stitched
    prefill's state, and the port's ``_decode_layer`` there, routed as the
    reference routed, holds h and the state it writes in place at 6e-2."""
    japi, jparams, api, params = _model("bfloat16")
    jcfg, cfg, tol = japi.cfg, api.cfg, MODEL_TOL["bfloat16"]
    toks = _tokens(cfg, 2, 9)
    _, jstates = japi.prefill(jparams, {"tokens": jnp.asarray(toks)})
    jstates = _reference_stitched(japi, jstates, 2, 9, 10)
    token = _tokens(cfg, 2, 1, seed=27)
    jh = jparams["embed"]["table"][jnp.asarray(token[:, 0])].astype(jnp.bfloat16)
    for j in range(tjamba.PERIOD):
        jlp = jax.tree.map(lambda a: a[0], jparams["positions"][j])
        jst = jax.tree.map(lambda a: a[0], jstates[j])
        h, st = torch.from_numpy(np.array(_f32(jh))).to(torch.bfloat16), _carry(jst)
        with _reference_routes() as rec:
            jh, jst = _exact_jit(lambda lp, s_, x, j=j: _reference_decode_layer(
                lp, s_, x, jnp.int32(9), jcfg, j), jlp, jst, jh)
        with contextlib.ExitStack() as stack:
            swaps = stack.enter_context(_routed_as(rec, "bfloat16")) if rec else [0]
            h = tjamba._decode_layer(_position(params, j), st, h, torch.tensor(9), cfg, j)
        assert sum(swaps) <= 1
        _close(h, _f32(jh), dict(rtol=tol, atol=tol))
        _states_close((st,) * tjamba.PERIOD, (jst,) * tjamba.PERIOD, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_consistent_with_prefill(dtype):
    """tests/test_serving_consistency.py::test_jamba_decode_consistent_with_prefill
    on the port, through ``ModelAPI.stitch``: the prefill's states of S
    tokens decode token S+1 to the last position of a prefill of S+1, at
    the reference's 5e-2 (capacity_factor 16: the prefill routes B*S tokens
    together, the decode B)."""
    _, _, api, params = _model(dtype, capacity_factor=16.0)
    toks = torch.from_numpy(_tokens(api.cfg, 2, 10, seed=4))
    full, _ = api.prefill(params, {"tokens": toks})
    _, pre = api.prefill(params, {"tokens": toks[:, :-1]})
    states = stitch_prefill_cache(api, pre, 10)
    assert states[4]["k"].shape[2] == 10 and all(states[j] is pre[j] for j in (0, 1, 2, 3, 5, 6, 7))
    dec, _ = api.decode(params, toks[:, -1:], states, torch.tensor(9))
    torch.testing.assert_close(dec.float(), full.float(), rtol=CONSISTENCY_TOL,
                               atol=CONSISTENCY_TOL)


def test_stitch_refuses_a_short_cache():
    _, _, api, params = _model("float32")
    _, pre = api.prefill(params, {"tokens": torch.from_numpy(_tokens(api.cfg, 1, 6))})
    with pytest.raises(ValueError, match="cannot hold the 6"):
        api.stitch(pre, 5)


@contextlib.contextmanager
def _recorded_router_inputs():
    """(x, indices) of every port ``_router`` call while open."""
    real, calls = tmoe._router, []

    def recorded(p, x, top_k):
        out = real(p, x, top_k)
        calls.append((x.detach().clone(), out[1].clone()))
        return out

    tmoe._router = recorded
    try:
        yield calls
    finally:
        tmoe._router = real


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_routing_matches_reference(dtype):
    """Every MoE layer of a prefill (positions 1, 3, 5, 7) routes each
    token as the reference's router does on the same inputs and weights:
    indices equal wherever the top k + 1 probabilities are more than TIE
    apart; the near-ties are counted and must be few."""
    japi, jparams, api, params = _model(dtype)
    with _recorded_router_inputs() as calls:
        api.prefill(params, {"tokens": torch.from_numpy(_tokens(api.cfg, 2, 11, seed=31))})
    assert len(calls) == 4
    for (x, idx), j in zip(calls, (1, 3, 5, 7)):
        jrouter = {"router": jparams["positions"][j]["ffn"]["router"][0]}
        _, jidx, jprobs = jmoe._router(jrouter, jnp.asarray(x.float().numpy()).astype(
            DTYPES[dtype][1]), api.cfg.moe.top_k)
        top = np.sort(np.asarray(jprobs), axis=-1)[:, ::-1][:, :api.cfg.moe.top_k + 1]
        clear = np.min(-np.diff(top, axis=-1), axis=-1) > TIE
        assert clear.sum() >= 0.9 * len(clear), f"{(~clear).sum()} near-ties of {len(clear)}"
        np.testing.assert_array_equal(idx.numpy()[clear], np.asarray(jidx)[clear])


def _rel_fro(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got.float().numpy() - want) / max(np.linalg.norm(want), 1e-30))


def _batch(cfg, b=2, s=12, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[:, -2:] = -1
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32), "labels": labels}


def _tracked(params):
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    it = iter(leaves)
    return leaves, jax.tree.map(lambda _: next(it), params)   # tree_leaves order: sorted keys


@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads(dtype):
    """The reference's jitted value_and_grad on ``_batch``: ((loss,
    metrics), grad leaves, its routing records)."""
    japi, jparams, _, _ = _model(dtype)
    fn = jax.value_and_grad(lambda p, bt: japi.loss(p, bt, loss_chunk=5), has_aux=True)
    with _reference_routes() as rec:
        out, jgrads = _exact_jit(fn, jparams, {k: jnp.asarray(v)
                                               for k, v in _batch(japi.cfg).items()})
    return out, jax.tree.leaves(jgrads), list(rec)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_loss_matches_reference(dtype):
    """The total, xent and aux, and every grad leaf, against
    jax.value_and_grad of the reference's loss (aux_weight 0.01; the Mamba
    scan's backward step by step), routed as the reference routed.  In bf16
    the loss at 6e-2, and each grad leaf within 5e-2 of the reference's
    own bf16 distance from its f32 grads (relative Frobenius): the bf16
    chains drift apart as the prefill's do (module docstring)."""
    _, _, api, params = _model(dtype)
    batch = _batch(api.cfg)
    (jloss, jmetrics), jgrads, rec = _reference_loss_and_grads(dtype)
    leaves, tracked = _tracked(params)
    with _routed_as(rec[:4], dtype) as swaps:
        loss, metrics = api.loss(tracked, {k: torch.from_numpy(v).long() for k, v in batch.items()},
                                 loss_chunk=5)
        grads = torch.autograd.grad(loss, leaves)
    assert len(swaps) == 8              # the forward's 4 MoE layers, then the recompute's
    _few(swaps, batch["tokens"].size)
    assert set(metrics) == set(jmetrics) == {"xent", "aux"} and float(metrics["aux"]) > 0
    assert len(grads) == len(jgrads)
    if dtype == "float32":
        for got, want in ((loss, jloss), (metrics["xent"], jmetrics["xent"]),
                          (metrics["aux"], jmetrics["aux"])):
            np.testing.assert_allclose(float(got), float(want), **F32_TOL)
        for g, w in zip(grads, jgrads):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)
        return
    for got, want in ((loss, jloss), (metrics["xent"], jmetrics["xent"]),
                      (metrics["aux"], jmetrics["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=MODEL_TOL[dtype],
                                   atol=MODEL_TOL[dtype])
    _, jgrads32, _ = _reference_loss_and_grads("float32")
    mine = [_rel_fro(g, w32) for g, w32 in zip(grads, jgrads32)]
    theirs = [_rel_fro(torch.from_numpy(np.array(_f32(w))), w32)
              for w, w32 in zip(jgrads, jgrads32)]
    assert all(m <= t + BF16_GRAD_REL for m, t in zip(mine, theirs)), list(zip(mine, theirs))


def test_remat_is_bit_equal_to_no_remat():
    """Per-period recompute reruns the same ops (routing included): loss
    and grads bit-equal to no remat."""
    _, _, api, params = _model("bfloat16")
    batch = {k: torch.from_numpy(v).long() for k, v in _batch(api.cfg).items()}
    runs = []
    for remat in (True, False):
        leaves, tracked = _tracked(params)
        loss, _ = api.loss(tracked, batch, remat=remat, loss_chunk=5)
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
    under int8_ef at most 0.1% of the elements an int8 level apart, a
    level read off the reference's error buffer (tests/test_torch_rwkv.py).
    The reference's own int8_ef step raises on Jamba's tuple of positions
    (``test_reference_int8_ef_raises_on_the_positions_tuple``), so under
    int8_ef it is its step with ``compress_grads`` applied per leaf."""
    japi, _, api, _ = _model("float32")
    jtc, tc = JaxTrainConfig(**STEP_TC, **form), TrainConfig(**STEP_TC, **form)
    jstate = jax_init_train_state(japi, jax.random.PRNGKey(0), jtc)
    state = init_train_state(params_from_numpy(_np(jstate.params), "cpu"), tc)
    batch = make_lm_batch(LMDataConfig(vocab_size=api.cfg.vocab_size, seq_len=16,
                                       global_batch=4), 0)
    jstep = (_reference_int8_step(japi, jtc) if tc.grad_compression == "int8_ef"
             else jax_build_train_step(japi, jtc))
    jstate, jmetrics = jax.jit(jstep)(
        jstate, {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in batch.items()})
    state, metrics = build_train_step(api, tc)(state, batch)
    assert set(metrics) == set(jmetrics)
    for k in ("loss", "xent", "aux", "grad_norm", "lr"):
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


def _reference_int8_step(japi, tc):
    """The reference's int8_ef train step (``training/step.py:72-114``,
    microbatch 1) with its ``compress_grads`` applied one leaf at a time
    (tests/test_torch_training.py)."""
    def train_step(state, batch):
        def loss_fn(p):
            return japi.loss(p, batch, remat=tc.remat != "none", loss_chunk=tc.loss_chunk)

        (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        metrics = dict(metrics, loss=loss)
        leaves, treedef = jax.tree.flatten(grads)
        out = [jax_compress_grads({"g": g}, {"g": e})
               for g, e in zip(leaves, treedef.flatten_up_to(state.ef))]
        grads = treedef.unflatten([d["g"] for d, _ in out])
        ef = treedef.unflatten([e["g"] for _, e in out])
        params, opt, opt_metrics = jax_adamw_update(state.params, grads, state.opt, tc)
        metrics.update(opt_metrics)
        return state.__class__(params=params, opt=opt, ef=ef), metrics

    return train_step


def test_reference_int8_ef_raises_on_the_positions_tuple():
    """Pins the reference's ``compress_grads`` fault (ROADMAP.md, queue 3)
    on Jamba: its ``is_leaf`` on tuples takes the params' own tuple of
    period positions for a (deq, err) pair, so its int8_ef step raises;
    the port's compresses per leaf (tests/test_torch_training.py)."""
    japi, _, _, _ = _model("float32")
    jtc = JaxTrainConfig(**STEP_TC, grad_compression="int8_ef")
    jstate = jax_init_train_state(japi, jax.random.PRNGKey(0), jtc)
    batch = make_lm_batch(LMDataConfig(vocab_size=japi.cfg.vocab_size, seq_len=8,
                                       global_batch=2), 0)
    with pytest.raises(ValueError, match="Expected tuple"):
        jax.eval_shape(jax_build_train_step(japi, jtc), jstate,
                       {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in batch.items()})


def test_ep_a2a_goes_through_apply_moe_ep(monkeypatch):
    """``impl="ep_a2a"`` routes each MoE position through ``apply_moe_ep``
    (without a mesh: ``apply_moe``), which reads the mesh from the context
    and takes none as an argument."""
    cfg = reduced_config(ARCH)
    cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, impl="ep_a2a"))
    api = build_model(cfg)
    params = api.init(torch.Generator().manual_seed(1), device="cpu")
    seen = []
    real = tjamba.apply_moe_ep
    monkeypatch.setattr(tjamba, "apply_moe_ep", lambda *a: seen.append(1) or real(*a))
    logits, _ = api.prefill(params, {"tokens": torch.from_numpy(_tokens(cfg, 1, 5))})
    assert len(seen) == 4 and torch.isfinite(logits).all()
    with pytest.raises(TypeError, match="mesh"):
        real(params["positions"][1]["ffn"], torch.zeros(1, 2, cfg.d_model), cfg, mesh=object())


# ---------------- serving ----------------

def test_state_tree_is_what_the_decode_returns():
    """``init_cache`` gives the decode's state tree (bf16 KV and conv, f32
    SSM), and a decode step writes every state into it in place and returns
    that same tree: the captured decode's buffers then hold the states
    after each replay.  From zeros at position 0, the states written equal
    a one-token prefill's."""
    _, _, api, params = _model("bfloat16")
    cache = api.init_cache(2, 3, device="cpu")
    leaves = [t for t in tree_leaves(cache)]
    token = torch.from_numpy(_tokens(api.cfg, 2, 1, seed=5))
    _, new = api.decode(params, token, cache, torch.tensor(0))
    assert new is cache and all(a is b for a, b in zip(tree_leaves(cache), leaves))
    assert cache[0]["ssm"].dtype == torch.float32 and cache[0]["conv"].dtype == torch.bfloat16
    _, want = api.prefill(params, {"tokens": token})
    for j, (got, w) in enumerate(zip(cache, want)):
        for name in got:
            g = got[name][:, :, :1] if name in ("k", "v") else got[name]
            assert g.shape == w[name].shape
            torch.testing.assert_close(g.float(), w[name].float(), rtol=1e-5, atol=1e-6)
            assert g.abs().max() > 0
        if "k" in got:
            assert not got["k"][:, :, 1:].any()


def test_greedy_decoder_carries_the_states():
    """``GreedyDecoder`` (eager on the CPU) from the stitched prefill
    states: each token is the argmax of a teacher-forced re-prefill, and
    the caller's states end as the states after the last token."""
    _, _, api, params = _model("float32", capacity_factor=16.0)
    toks = torch.from_numpy(_tokens(api.cfg, 2, 6, seed=3))
    logits, pre = api.prefill(params, {"tokens": toks})
    first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    cache = stitch_prefill_cache(api, pre, 10)
    out, back = GreedyDecoder(api)(params, cache, first, 6, 4)
    assert back is cache and out.shape == (2, 4)
    seq = torch.cat([toks, first, out[:, :-1]], dim=1)
    for j in range(4):
        full, state = api.prefill(params, {"tokens": seq[:, :7 + j]})
        assert torch.equal(full[:, -1].argmax(-1).to(torch.int32), out[:, j])
    for j, (got, want) in enumerate(zip(cache, state)):
        for name in got:
            g = got[name][:, :, :10] if name in ("k", "v") else got[name]
            torch.testing.assert_close(g, want[name], rtol=1e-4, atol=1e-5)


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


def _serving_cfg(cfg):
    """f32 compute and capacity_factor 16: the prefill routes B*S tokens
    together and the decode B, so without drops both route alike."""
    return cfg.with_overrides(compute_dtype="float32",
                              moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))


def test_serve_lm_decodes_from_the_prefill_states():
    """The port's ``serve_lm`` on the reduced config continues the prompt
    as a teacher-forced re-prefill does (after the prefill's own token)."""
    cfg = _serving_cfg(reduced_config(ARCH))
    cont = _continuation(serve_launcher.serve_lm, cfg)
    api = build_model(cfg)
    params = api.init(torch.Generator("cpu").manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 7), generator=torch.Generator("cpu").manual_seed(1),
                         dtype=torch.int32)[:1].numpy()

    def prefill(t):
        logits, states = api.prefill(params, {"tokens": torch.from_numpy(t)})
        return logits.numpy(), states

    assert cont == _teacher_forced(prefill, toks, 6)[1:]


def test_reference_serve_lm_decodes_jamba_from_zero_states():
    """Pins the reference's fault (ROADMAP.md, queue 3): its ``serve_lm``
    throws the prefill's states away and decodes from ``init_states``'
    zeros (no KV at the prompt's positions, zero SSM and conv states), so
    its continuation is not the teacher-forced one of its own model,
    params and prompt (bf16, its default compute).  In f32 it does not
    decode at all: ``init_states``' conv state is bf16 and the f32 decode
    returns it in f32, which its greedy loop's ``lax.scan`` refuses."""
    with pytest.raises(TypeError, match="carry input and carry output must have equal types"):
        _continuation(jax_serve.serve_lm, _serving_cfg(jax_reduced_config(ARCH)))
    jcfg = _serving_cfg(jax_reduced_config(ARCH)).with_overrides(compute_dtype="bfloat16")
    cont = _continuation(jax_serve.serve_lm, jcfg)
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 7), 0, jcfg.vocab_size))[:1]
    prefill = jax.jit(lambda t: japi.prefill(jparams, {"tokens": t}))
    assert _first_difference(prefill, toks, cont) is not None


def _first_difference(prefill, tokens, cont):
    """The first step at which ``cont`` (the continuation after the
    prefill's own token) leaves the teacher-forced greedy one, or None."""
    for i in range(len(cont) + 1):
        logits, _ = prefill(tokens)
        nxt = np.asarray(logits[:, -1], np.float32).argmax(-1)
        if i and int(nxt[0]) != cont[i - 1]:
            return i
        tokens = np.concatenate([tokens, nxt[:, None].astype(np.int32)], axis=1)
    return None


def test_launchers_serve_and_train_resume(tmp_path, capsys):
    """``serve --arch jamba-v0.1-52b --reduced --device cpu`` prefills and
    decodes; ``train`` checkpoints every 2 steps, and a second run resumes
    from step 4 onto the trajectory of one uninterrupted run."""
    from repro_torch.launch import train as train_launcher

    serve_launcher.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
                         "--seq-len", "8", "--decode-tokens", "3"])
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
    assert resumed_last == whole_last and "loss=nan" not in whole and math.isfinite(
        float(re.search(r"loss=([\d.]+)", whole_last).group(1)))
