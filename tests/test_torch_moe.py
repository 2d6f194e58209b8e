"""Port parity of the MoE transformer: repro_torch.layers.moe and the MoE
configs of repro_torch.models against the JAX package's, from carried
weights (the reference's init, converted with np.asarray), on the reduced
moonshot-v1-16b-a3b and dbrx-132b.

Routing is discrete: one ulp in a router probability can swap an expert,
which moves that token's output by O(1) and the capacity slot of every
later token routed there.  So the layer is held in three parts: the
router's weights and probs at 1e-6 and its indices equal wherever the gap
between consecutive probabilities of the top k + 1 exceeds ``TIE`` (the
near-ties counted); both combines on the reference's own (weights,
indices), so that a flip cannot hide a combine error; and the whole
``apply_moe`` at 1e-5 in f32 and 2e-2 in bf16.  The model's prefill is
held at 1e-4 in f32 and by greedy token in bf16, its decode to its prefill
by greedy token at ``capacity_factor=16`` (the reference's invariant,
tests/test_serving_consistency.py:20-47), ``train_loss`` and its grads at
the dense LM's bars (tests/test_torch_lm_training.py)."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.config import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.config import get_config as jax_get_config  # noqa: E402
from repro.config import reduced_config as jax_reduced_config  # noqa: E402
from repro.layers import moe as jmoe  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.training import build_train_step as jax_build_train_step  # noqa: E402
from repro.training import init_train_state as jax_init_train_state  # noqa: E402
from repro_torch.config import (  # noqa: E402
    ModelConfig,
    MoEConfig,
    TrainConfig,
    get_config,
    list_archs,
    reduced_config,
)
from repro_torch.data import LMDataConfig, make_lm_batch  # noqa: E402
from repro_torch.layers import moe as tmoe  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import stitch_prefill_cache  # noqa: E402
from repro_torch.training import build_train_step, init_train_state  # noqa: E402
from repro_torch.utils import params_from_numpy, tree_leaves  # noqa: E402

MOE = ["moonshot-v1-16b-a3b", "dbrx-132b"]
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}
PROB_TOL = 1e-6
TIE = 1e-5
MODEL_TOL = 1e-4
BF16_ULP = 2.0 ** -7
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_LOSS_TOL = 6e-2
BF16_GRAD_REL = 5e-2
B, S, CHUNK = 2, 12, 5


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                        else np.asarray(a), tree)


def _carry(tree):
    return params_from_numpy(_np(tree), "cpu")


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(x, dtype):
    tdt, jdt, _ = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _cfgs(arch, **moe_kw):
    """(reference config, port config) of ``arch``'s reduced size, with
    ``moe_kw`` replaced in both MoE configs."""
    jcfg, cfg = jax_reduced_config(arch), reduced_config(arch)
    return (jcfg.with_overrides(moe=dataclasses.replace(jcfg.moe, **moe_kw)),
            cfg.with_overrides(moe=dataclasses.replace(cfg.moe, **moe_kw)))


@functools.lru_cache(maxsize=None)
def _layer(arch, seed=0):
    jcfg, cfg = _cfgs(arch)
    p = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, p, _carry(p)


# ---------------- configs and init ----------------
# (each config's fields and the param tree against the reference:
# tests/test_torch_transformer.py, parametrized over these archs too)

@pytest.mark.parametrize("arch", MOE)
def test_configs_and_init_distribution(arch):
    """Both archs registered with their published expert counts; each MoE
    leaf drawn truncated-normal at the reference's fan_in (D for router,
    gate and up, d_ff for down), stacked (L, ...)."""
    full = get_config(arch)
    assert arch in list_archs()
    assert dataclasses.asdict(full.moe) == dataclasses.asdict(jax_get_config(arch).moe)
    assert (full.moe.num_experts, full.moe.top_k) == {"moonshot-v1-16b-a3b": (64, 6),
                                                      "dbrx-132b": (16, 4)}[arch]
    cfg = reduced_config(arch)
    moe = build_model(cfg).init(torch.Generator().manual_seed(3), device="cpu")["layers"]["moe"]
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    shapes = {"router": (d, e), "gate": (e, d, f), "up": (e, d, f), "down": (e, f, d)}
    for name, fan_in in (("router", d), ("gate", d), ("up", d), ("down", f)):
        w, std = moe[name], fan_in ** -0.5
        assert tuple(w.shape) == (cfg.num_layers,) + shapes[name]
        assert float(w.abs().max()) <= 2 * std + 1e-7
        assert abs(float(w.std()) / std - 0.88) < 0.1            # a normal cut at 2 std


# ---------------- the layer, in parts ----------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", MOE)
def test_router_matches_reference(arch, dtype):
    """Weights and probs at 1e-6; indices (sorted by descending prob, as
    lax.top_k) equal wherever the top k + 1 probabilities are more than
    TIE apart; the near-ties are counted and must be few."""
    jcfg, cfg, jp, p = _layer(arch)
    xt, xj = _both(_rand(1, 64, cfg.d_model), dtype)
    w, idx, probs = tmoe._router(p, xt, cfg.moe.top_k)
    jw, jidx, jprobs = jmoe._router(jp, xj, jcfg.moe.top_k)
    assert w.dtype == probs.dtype == torch.float32
    _close(probs, jprobs, PROB_TOL)
    _close(w, jw, PROB_TOL)
    top = np.sort(np.asarray(jprobs), axis=-1)[:, ::-1][:, :cfg.moe.top_k + 1]
    clear = np.min(-np.diff(top, axis=-1), axis=-1) > TIE
    assert clear.sum() >= 0.9 * len(clear), f"{(~clear).sum()} near-ties of {len(clear)}"
    np.testing.assert_array_equal(idx.numpy()[clear], np.asarray(jidx)[clear])


@pytest.mark.parametrize("arch", MOE)
def test_aux_loss_and_capacity_match_reference(arch):
    jcfg, cfg, jp, _ = _layer(arch)
    _, jidx, jprobs = jmoe._router(jp, jnp.asarray(_rand(2, 64, cfg.d_model)), jcfg.moe.top_k)
    aux = tmoe._aux_loss(torch.from_numpy(np.asarray(jprobs)),
                         torch.from_numpy(np.asarray(jidx)), cfg.moe.num_experts)
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(jmoe._aux_loss(jprobs, jidx, jcfg.moe.num_experts)),
                               rtol=1e-6)
    for cf in (1e-9, 0.5, 1.25, 16.0):
        jc, c = _cfgs(arch, capacity_factor=cf)
        for n in (1, 2, 7, 8, 24, 100, 16384):
            assert tmoe.capacity(n, c) == jmoe.capacity(n, jc)


def _routing(jp, jcfg, x):
    """The reference's (weights, indices) of x (N, D), as tensors."""
    jw, jidx, _ = jmoe._router(jp, x.astype(jnp.float32), jcfg.moe.top_k)
    return torch.from_numpy(np.asarray(jw)), torch.from_numpy(np.asarray(jidx))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("combine", ["_scatter_combine", "_dense_combine"])
@pytest.mark.parametrize("arch", MOE)
def test_combine_on_reference_routing(arch, combine, dtype, capacity_factor):
    """Each combine given the reference's own weights and indices: the
    scatter path's slot order and drops (capacity_factor 0.25 drops) and
    the dense oracle's gates, at the layer bars."""
    jcfg, cfg = _cfgs(arch, capacity_factor=capacity_factor)
    _, _, jp, p = _layer(arch)
    xt, xj = _both(_rand(3, 40, cfg.d_model), dtype)
    w, idx = _routing(jp, jcfg, xj)
    got = getattr(tmoe, combine)(p, xt, w, idx, cfg)
    want = getattr(jmoe, combine)(jp, xj, jnp.asarray(w.numpy()), jnp.asarray(idx.numpy()), jcfg)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    _close(got, want.astype(jnp.float32), DTYPES[dtype][2])
    if combine == "_scatter_combine" and capacity_factor < 1:
        assert int((got == 0).all(-1).sum()) > 0          # some tokens dropped entirely


@pytest.mark.parametrize("impl", ["scatter", "dense"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", MOE)
def test_apply_moe_matches_reference(arch, dtype, impl):
    jcfg, cfg = _cfgs(arch, impl=impl)
    _, _, jp, p = _layer(arch)
    xt, xj = _both(_rand(4, 2, 16, cfg.d_model), dtype)
    y, aux = tmoe.apply_moe(p, xt, cfg)
    yj, auxj = jmoe.apply_moe(jp, xj, jcfg)
    assert y.dtype == xt.dtype and y.shape == xt.shape and aux.dtype == torch.float32
    _close(y, yj.astype(jnp.float32), DTYPES[dtype][2])
    np.testing.assert_allclose(float(aux), float(auxj), rtol=1e-5)


# ---------------- the reference's layer cases (tests/test_layers.py:89-140) -------------

def _tiny_moe_cfg(impl: str, capacity_factor: float = 8.0) -> ModelConfig:
    return ModelConfig(
        name="t", family="transformer", num_layers=1, d_model=32, num_heads=4,
        num_kv_heads=4, d_ff=64, vocab_size=64,
        moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=capacity_factor, impl=impl),
    )


def _tiny_params(seed):
    return tmoe.init_moe(torch.Generator().manual_seed(seed), _tiny_moe_cfg("scatter"), "cpu")


def test_moe_scatter_matches_dense_oracle():
    """With ample capacity (nothing dropped) the scatter path equals the
    dense oracle."""
    params = _tiny_params(7)
    x = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(8))
    y_s, aux_s = tmoe.apply_moe(params, x, _tiny_moe_cfg("scatter"))
    y_d, aux_d = tmoe.apply_moe(params, x, _tiny_moe_cfg("dense"))
    np.testing.assert_allclose(y_s.numpy(), y_d.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(aux_s), float(aux_d), rtol=1e-5)


def test_moe_capacity_dropping_zeroes_tokens():
    """With capacity ~0 (8 slots an expert) 32 (token, choice) pairs must
    drop: tokens whose every choice dropped come out exactly zero."""
    params = _tiny_params(9)
    x = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(10))
    y, _ = tmoe.apply_moe(params, x, _tiny_moe_cfg("scatter", capacity_factor=1e-9))
    assert int((y == 0.0).all(-1).sum()) >= 8


def test_moe_aux_loss_uniform_is_one_and_skew_is_larger():
    """Balanced dispatch with uniform probs gives 1; all mass and dispatch
    on one expert gives E."""
    n, e, k = 64, 4, 2
    uniform = torch.full((n, e), 1.0 / e)
    balanced = torch.stack([torch.arange(n) % e, (torch.arange(n) + 1) % e], dim=1)
    aux_bal = tmoe._aux_loss(uniform, balanced, e)
    assert float(aux_bal) == pytest.approx(1.0, rel=1e-5)
    skewed = torch.zeros(n, e)
    skewed[:, 0] = 1.0
    aux_skew = tmoe._aux_loss(skewed, torch.zeros(n, k, dtype=torch.int64), e)
    assert float(aux_skew) == pytest.approx(float(e), rel=1e-5)
    assert float(aux_skew) > float(aux_bal)


def test_ep_a2a_without_mesh_is_scatter_and_a_mesh_raises(tmp_path):
    """Without a mesh ``apply_moe_ep`` is the scatter path; on a (1, 1)
    mesh of one gloo rank its all_to_all body gives the same values (the
    (2, 2) and (2, 1, 2) meshes: tests/test_torch_sharded_step.py)."""
    from test_torch_sharded_step import one_rank_mesh

    from repro_torch.distributed import sharding

    params = _tiny_params(11)
    x = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(12))
    y_ep, aux_ep = tmoe.apply_moe_ep(params, x, _tiny_moe_cfg("ep_a2a"))
    y_s, aux_s = tmoe.apply_moe(params, x, _tiny_moe_cfg("scatter"))
    assert torch.equal(y_ep, y_s) and torch.equal(aux_ep, aux_s)
    with one_rank_mesh(tmp_path) as mesh, sharding.mesh_context(mesh):
        y_m, aux_m = tmoe.apply_moe_ep(params, x, _tiny_moe_cfg("ep_a2a"))
        y_m, aux_m = y_m.full_tensor(), aux_m.full_tensor()
    np.testing.assert_allclose(y_m.numpy(), y_s.numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(aux_m), float(aux_s), rtol=1e-4)


def test_decode_shapes_never_drop():
    """At decode (B <= 8 tokens) each token picks an expert at most once
    and the capacity is at least 8: nothing can drop, whatever the
    routing.  All tokens routed to the same experts still come out as the
    dense oracle's."""
    cfg = _tiny_moe_cfg("scatter", capacity_factor=1e-9)
    params = _tiny_params(13)
    params["router"] = torch.zeros_like(params["router"])         # every token ties
    x = torch.randn(8, 1, 32, generator=torch.Generator().manual_seed(14))
    assert tmoe.capacity(8, cfg) == 8
    y_s, _ = tmoe.apply_moe(params, x, cfg)
    y_d, _ = tmoe.apply_moe(params, x, _tiny_moe_cfg("dense"))
    np.testing.assert_allclose(y_s.numpy(), y_d.numpy(), rtol=1e-5, atol=1e-6)


# ---------------- the model ----------------

@functools.lru_cache(maxsize=None)
def _model(arch, dtype, capacity_factor=None):
    moe_kw = {} if capacity_factor is None else {"capacity_factor": capacity_factor}
    jcfg, cfg = _cfgs(arch, **moe_kw)
    japi = jax_build_model(jcfg.with_overrides(compute_dtype=dtype))
    jparams = japi.init(jax.random.PRNGKey(0))
    return japi, jparams, build_model(cfg.with_overrides(compute_dtype=dtype)), _carry(jparams)


def _tokens(cfg, b, s, seed=26):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_prefill_matches_reference(arch, dtype):
    """Logits and cache at 1e-4 in f32; in bf16 the greedy token."""
    japi, jparams, api, params = _model(arch, dtype)
    toks = _tokens(api.cfg, 2, 10)
    logits, cache = api.prefill(params, {"tokens": torch.from_numpy(toks)}, kv_chunk=4)
    jlogits, jcache = jax.jit(lambda p, t: japi.prefill(p, {"tokens": t}, kv_chunk=4))(
        jparams, jnp.asarray(toks))
    assert tuple(logits.shape) == (2, 1, api.cfg.vocab_size)
    assert logits.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close(logits, jlogits, MODEL_TOL)
        for name in ("k", "v"):
            _close(cache[name], jcache[name], MODEL_TOL)
    else:
        np.testing.assert_array_equal(logits[:, -1].float().argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(jlogits[:, -1], -1)))


@pytest.mark.parametrize("arch", MOE)
def test_decode_step_matches_reference(arch):
    """One decode step (f32 compute) from the reference prefill's cache,
    stitched and carried: logits at 1e-4, the updated bf16 cache within
    one bf16 ulp (a new K/V row rounds from f32 values 1e-7 apart)."""
    japi, jparams, api, params = _model(arch, "float32")
    toks = _tokens(api.cfg, 2, 9)
    _, jcache = japi.prefill(jparams, {"tokens": jnp.asarray(toks)})
    jdec = japi.init_cache(2, 12)
    jdec = {n: jdec[n].at[:, :, :9].set(jcache[n].astype(jdec[n].dtype)) for n in ("k", "v")}
    cache = {n: torch.from_numpy(np.asarray(jdec[n], np.float32)).to(torch.bfloat16)
             for n in ("k", "v")}
    token = _tokens(api.cfg, 2, 1, seed=27)
    logits, out = api.decode(params, torch.from_numpy(token), cache, torch.tensor(9))
    jlogits, jout = japi.decode(jparams, jnp.asarray(token), jdec, jnp.int32(9))
    _close(logits, jlogits, MODEL_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(out[name].float().numpy(),
                                   np.asarray(jout[name].astype(jnp.float32)),
                                   rtol=BF16_ULP, atol=MODEL_TOL)


def _ulp(x: np.ndarray, dtype: str) -> np.ndarray:
    """The spacing of ``dtype`` at |x|: 2^(exponent - mantissa bits)."""
    bits = {"float32": 23, "bfloat16": 7}[dtype]
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - bits)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_decode_consistent_with_prefill(arch, dtype):
    """tests/test_serving_consistency.py's MoE invariant on the port, at
    capacity_factor 16 (prefill routes B*S tokens together, decode B):
    the prefix's cache stitched, the last token decoded, the greedy token
    equals the teacher-forced one.  A row whose teacher-forced top two
    logits lie within two ulps of the compute dtype is a tie no order of
    arithmetic decides: it is counted, not held.  (In bf16 the second
    row of moonshot's prompt is an exact tie, 0.0 apart, in the port and
    in the reference's jitted prefill alike, and both decodes pick the
    other token.)"""
    _, _, api, params = _model(arch, dtype, capacity_factor=16.0)
    toks = torch.from_numpy(_tokens(api.cfg, 2, 11, seed=1))
    full, _ = api.prefill(params, {"tokens": toks})
    _, pre = api.prefill(params, {"tokens": toks[:, :-1]})
    cache = stitch_prefill_cache(api, pre, 11)
    dec, _ = api.decode(params, toks[:, -1:], cache, torch.tensor(10))
    want = full[:, -1].float().numpy()
    top2 = np.sort(want, axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * _ulp(top2[:, 1], dtype)
    if dtype == "float32":
        assert decided.all()
    assert decided.any()
    np.testing.assert_array_equal(dec[:, -1].float().argmax(-1).numpy()[decided],
                                  want.argmax(-1)[decided])


# ---------------- train_loss and the train step ----------------

def _batch(cfg, b=B, s=S, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[:, -2:] = -1
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": labels}


def _rel_fro(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got.float().numpy() - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_train_loss_matches_reference(arch, dtype):
    """The total, xent and aux, and every grad leaf, against
    jax.value_and_grad of the reference's loss (aux_weight 0.01), jitted
    with XLA's ``xla_allow_excess_precision`` off, so that each bf16 op
    rounds to bf16 as written, as the port's do.  With it on (XLA's
    default) the fused bf16 ops skip roundings, and on moonshot's batch
    here that flips a routing: the reference's loss is 6.5658 against
    6.5416 op by op, its grads 0.12-0.54 apart by relative Frobenius
    error; off, it gives the op-by-op loss, and the port's grads are
    0.004-0.012 from those."""
    japi, jparams, api, params = _model(arch, dtype)
    batch = _batch(api.cfg)
    fn = jax.value_and_grad(lambda p, bt: japi.loss(p, bt, loss_chunk=CHUNK), has_aux=True)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    exact = jax.jit(fn).lower(jparams, jbatch).compile(
        compiler_options={"xla_allow_excess_precision": False})
    (jloss, jmetrics), jgrads = exact(jparams, jbatch)
    jgrads = jax.tree.leaves(jgrads)
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    it = iter(leaves)
    tracked = jax.tree.map(lambda _: next(it), params)      # tree_leaves order: sorted keys
    loss, metrics = api.loss(tracked, {k: torch.from_numpy(v).long() for k, v in batch.items()},
                             loss_chunk=CHUNK)
    grads = torch.autograd.grad(loss, leaves)
    assert set(metrics) == set(jmetrics) == {"xent", "aux"} and float(metrics["aux"]) > 0
    assert len(grads) == len(jgrads)
    if dtype == "float32":
        for got, want in ((loss, jloss), (metrics["xent"], jmetrics["xent"]),
                          (metrics["aux"], jmetrics["aux"])):
            np.testing.assert_allclose(float(got), float(want), **F32_TOL)
        for g, w in zip(grads, jgrads):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)
    else:
        np.testing.assert_allclose(float(loss), float(jloss), rtol=BF16_LOSS_TOL,
                                   atol=BF16_LOSS_TOL)
        errs = [_rel_fro(g, w) for g, w in zip(grads, jgrads)]
        assert max(errs) < BF16_GRAD_REL, errs


@pytest.mark.parametrize("arch", MOE)
def test_remat_recompute_routes_as_the_forward(arch, monkeypatch):
    """Under per-layer recompute the backward calls each layer's router a
    second time; it must route as the forward did (the same ops, no TF32,
    no random draws), so loss and grads are bit-equal to no remat."""
    _, _, api, params = _model(arch, "bfloat16")
    batch = {k: torch.from_numpy(v).long() for k, v in _batch(api.cfg).items()}
    real, calls = tmoe._router, []

    def recorded(p, x, top_k):
        out = real(p, x, top_k)
        calls.append(out[1].clone())
        return out

    monkeypatch.setattr(tmoe, "_router", recorded)
    runs = {}
    for remat in (True, False):
        calls.clear()
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        it = iter(leaves)
        tracked = jax.tree.map(lambda _: next(it), params)
        loss, _ = api.loss(tracked, batch, remat=remat, loss_chunk=CHUNK)
        runs[remat] = (loss, torch.autograd.grad(loss, leaves), list(calls))
    layers = api.cfg.num_layers
    forward, recompute = runs[True][2][:layers], runs[True][2][layers:]
    assert len(recompute) == layers and len(runs[False][2]) == layers
    assert all(torch.equal(a, b) for a, b in zip(forward, recompute[::-1]))
    assert torch.equal(runs[True][0], runs[False][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[True][1], runs[False][1]))


STEP_TC = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10, loss_chunk=8)
TINY_GRAD = 1e-6


@pytest.mark.parametrize("arch", MOE)
def test_train_step_matches_reference(arch):
    """One AdamW step of both packages from the same params and batch:
    metrics at rtol 1e-5, the first moment at the grads' bar, params at
    atol 1e-6 except where the reference's |g| is below TINY_GRAD (AdamW's
    first update g/(|g|+eps) turns on the grads' last bits there), held
    to one update (2 lr) instead (tests/test_torch_lm_training.py)."""
    japi, _, api, _ = _model(arch, "float32")
    jtc, tc = JaxTrainConfig(**STEP_TC), TrainConfig(**STEP_TC)
    jstate = jax_init_train_state(japi, jax.random.PRNGKey(0), jtc)
    state = init_train_state(params_from_numpy(_np(jstate.params), "cpu"), tc)
    batch = make_lm_batch(LMDataConfig(vocab_size=api.cfg.vocab_size, seq_len=16,
                                       global_batch=4), 0)
    jstate, jmetrics = jax.jit(jax_build_train_step(japi, jtc))(
        jstate, {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in batch.items()})
    state, metrics = build_train_step(api, tc)(state, batch)
    assert set(metrics) == set(jmetrics)
    for k in ("loss", "xent", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5)
    lr = float(jmetrics["lr"])
    for p, jp, mu, jmu in zip(tree_leaves(state.params), jax.tree.leaves(jstate.params),
                              tree_leaves(state.opt.mu), jax.tree.leaves(jstate.opt.mu)):
        np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-4, atol=1e-6)
        tiny = np.abs(np.asarray(jmu)) / (1 - tc.beta1) < TINY_GRAD
        diff = np.abs(p.numpy() - np.asarray(jp))
        assert diff[~tiny].max(initial=0.0) <= 1e-6
        assert diff[tiny].max(initial=0.0) <= 2 * lr


# ---------------- the launchers ----------------

@pytest.mark.parametrize("arch", MOE)
def test_launchers_serve_and_train_resume(arch, tmp_path, capsys):
    """``serve --arch <MoE> --device cpu`` prefills and decodes at the
    reduced size; ``train`` checkpoints every 2 steps, and a second run
    resumes from step 4 onto the trajectory of one uninterrupted run."""
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher

    serve_launcher.main(["--arch", arch, "--device", "cpu", "--batch", "2", "--seq-len", "8",
                         "--decode-tokens", "3"])
    out = capsys.readouterr().out
    assert f"[serve] {arch}-reduced: prefill(2x8)=" in out and "3 tokens decoded" in out

    def train(ckpt_dir, steps):
        train_launcher.main(["--arch", arch, "--device", "cpu", "--steps", str(steps),
                             "--ckpt-every", "2", "--ckpt-dir", str(ckpt_dir), "--batch", "2",
                             "--seq-len", "8"])
        text = capsys.readouterr().out
        return text, [ln for ln in text.splitlines() if ln.startswith("[train] step")][-1]

    first, _ = train(tmp_path / "a", 4)
    assert f"[train] {arch}-reduced:" in first and "resumed" not in first
    second, resumed_last = train(tmp_path / "a", 6)
    assert "[train] resumed from step 4" in second
    whole, whole_last = train(tmp_path / "b", 6)
    assert resumed_last == whole_last and "loss=nan" not in whole
