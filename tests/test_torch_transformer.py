"""Port parity of the dense transformer LM: repro_torch.layers and
repro_torch.models.transformer against the JAX package's, from carried
weights (the reference's init, converted with np.asarray), on the reduced
configs.

Tolerances: layers in f32 at rtol = atol = 1e-5 (attention 1e-4) and in
bf16 at 2e-2; the model's prefill and decode in f32 compute at 1e-4 and in
bf16 at 6e-2 (the reference's bf16 bar, tests/test_serving_consistency.py);
greedy decoding in f32 compute by token identity."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.config import get_config as jax_get_config  # noqa: E402
from repro.config import reduced_config as jax_reduced_config  # noqa: E402
from repro.layers import attention as ja  # noqa: E402
from repro.layers import embeddings as je  # noqa: E402
from repro.layers import linear as jl  # noqa: E402
from repro.layers import mlp as jm  # noqa: E402
from repro.layers import norms as jn  # noqa: E402
from repro.layers import rotary as jr  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import greedy_decode_loop as jax_greedy  # noqa: E402
from repro_torch.config import ModelConfig, MoEConfig, get_config, reduced_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.layers import attention as ta  # noqa: E402
from repro_torch.layers import embeddings as te  # noqa: E402
from repro_torch.layers import linear as tl  # noqa: E402
from repro_torch.layers import mlp as tm  # noqa: E402
from repro_torch.layers import norms as tn  # noqa: E402
from repro_torch.layers import rotary as tr  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import GreedyDecoder, stitch_prefill_cache  # noqa: E402
from repro_torch.utils import params_from_numpy  # noqa: E402

DENSE = ["tinyllama-1.1b", "olmo-1b", "phi4-mini-3.8b", "internlm2-20b", "phi-3-vision-4.2b"]
MOE = ["moonshot-v1-16b-a3b", "dbrx-132b"]          # their parity: tests/test_torch_moe.py
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5), "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}
ATTN_F32_TOL = 1e-4
MODEL_TOL = {"float32": 1e-4, "bfloat16": 6e-2}


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                        else np.asarray(a), tree)


def _carry(tree):
    return params_from_numpy(_np(tree), "cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _both(x, dtype):
    tdt, jdt, _ = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


# ---------------- layers ----------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bias", [False, True])
def test_linear(dtype, bias):
    p = jl.init_linear(jax.random.PRNGKey(0), 48, 24, bias=bias)
    if bias:
        p["b"] = jnp.asarray(_rand(1, 24))
    xt, xj = _both(_rand(2, 3, 5, 48), dtype)
    _close(tl.apply_linear(_carry(p), xt), jl.apply_linear(p, xj).astype(jnp.float32),
           DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparametric_ln"])
def test_norms_match_reference(kind, dtype):
    p = jn.init_norm(kind, 64)
    if kind == "layernorm":
        p = {"scale": jnp.asarray(_rand(3, 64)), "bias": jnp.asarray(_rand(4, 64))}
    xt, xj = _both(_rand(5, 4, 64) * 5 + 3, dtype)
    got = tn.apply_norm(_carry(p), xt, kind)
    assert got.dtype == xt.dtype
    _close(got, jn.apply_norm(p, xj, kind).astype(jnp.float32), DTYPES[dtype][2])


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparametric_ln"])
def test_norms_normalize(kind):
    """The properties tests/test_layers.py::test_norms_normalize checks of the reference."""
    y = tn.apply_norm(tn.init_norm(kind, 64, "cpu"), torch.from_numpy(_rand(19, 4, 64) * 5 + 3), kind)
    if kind in ("layernorm", "nonparametric_ln"):
        np.testing.assert_allclose(y.mean(-1).numpy(), 0.0, atol=1e-5)
        np.testing.assert_allclose(y.var(-1, unbiased=False).numpy(), 1.0, rtol=1e-3)
    else:
        np.testing.assert_allclose(torch.square(y).mean(-1).numpy(), 1.0, rtol=1e-3)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batched_positions", [False, True])
def test_rope(dtype, batched_positions):
    xt, xj = _both(_rand(6, 2, 7, 3, 16), dtype)
    pos = np.arange(7) + 5
    if batched_positions:
        pos = np.stack([pos, pos * 2])
    got = tr.apply_rope(xt, torch.from_numpy(pos), 10000.0)
    _close(got, jr.apply_rope(xj, jnp.asarray(pos), 10000.0).astype(jnp.float32), DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_and_unembed(dtype):
    tdt, jdt, tol = DTYPES[dtype]
    p = je.init_embedding(jax.random.PRNGKey(7), 100, 32)
    w = je.init_unembed(jax.random.PRNGKey(8), 32, 100)["w"]
    toks = np.random.default_rng(9).integers(0, 100, (3, 6)).astype(np.int32)
    h = te.embed_tokens(_carry(p), torch.from_numpy(toks), tdt)
    assert h.dtype == tdt
    _close(h, je.embed_tokens(p, jnp.asarray(toks), jdt).astype(jnp.float32), tol)
    _close(te.unembed_logits(_carry(w), h),
           je.unembed_logits(w, je.embed_tokens(p, jnp.asarray(toks), jdt)).astype(jnp.float32),
           tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_mlp(activation, dtype):
    cfg = jax_reduced_config("tinyllama-1.1b").with_overrides(activation=activation, qkv_bias=True)
    mine = reduced_config("tinyllama-1.1b").with_overrides(activation=activation, qkv_bias=True)
    p = jm.init_mlp(jax.random.PRNGKey(10), cfg)
    xt, xj = _both(_rand(11, 2, 5, cfg.d_model), dtype)
    _close(tm.apply_mlp(_carry(p), xt, mine), jm.apply_mlp(p, xj, cfg).astype(jnp.float32),
           DTYPES[dtype][2])


def _attn_setup(arch="tinyllama-1.1b", seed=12):
    cfg = jax_reduced_config(arch)
    return cfg, reduced_config(arch), ja.init_attention(jax.random.PRNGKey(seed), cfg)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,q_chunks,kv_chunk", [(True, 1, 4), (True, 4, 4), (False, 1, 5)])
def test_apply_attention(dtype, causal, q_chunks, kv_chunk):
    jcfg, cfg, p = _attn_setup()
    xt, xj = _both(_rand(13, 2, 12, cfg.d_model), dtype)
    y, (k, v) = ta.apply_attention(_carry(p), xt, cfg=cfg, causal=causal, return_kv=True,
                                   kv_chunk=kv_chunk, q_chunks=q_chunks)
    yj, (kj, vj) = ja.apply_attention(p, xj, cfg=jcfg, causal=causal, return_kv=True,
                                      kv_chunk=kv_chunk, q_chunks=q_chunks)
    tol = ATTN_F32_TOL if dtype == "float32" else DTYPES[dtype][2]
    for got, want in ((y, yj), (k, kj), (v, vj)):
        _close(got, want.astype(jnp.float32), tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_matches_reference(dtype):
    jcfg, cfg, p = _attn_setup()
    tdt, jdt, tol = DTYPES[dtype]
    tol = ATTN_F32_TOL if dtype == "float32" else tol
    b, s_max, n = 2, 9, 5
    hd = cfg.resolved_head_dim()
    k0 = _rand(14, b, s_max, cfg.num_kv_heads, hd)
    v0 = _rand(15, b, s_max, cfg.num_kv_heads, hd)
    xt, xj = _both(_rand(16, b, 1, cfg.d_model), dtype)
    cache = {"k": torch.from_numpy(k0).to(tdt), "v": torch.from_numpy(v0).to(tdt)}
    y, out = ta.decode_attention(_carry(p), xt, cache, torch.tensor(n, dtype=torch.int32), cfg=cfg)
    assert out["k"] is cache["k"] and out["v"] is cache["v"]    # written in place
    yj, cj = ja.decode_attention(p, xj, {"k": jnp.asarray(k0).astype(jdt),
                                         "v": jnp.asarray(v0).astype(jdt)}, jnp.int32(n), cfg=jcfg)
    _close(y, yj.astype(jnp.float32), tol)
    for name in ("k", "v"):
        _close(out[name], cj[name].astype(jnp.float32), tol)


@pytest.mark.parametrize("s", [16, 64, 100])
@pytest.mark.parametrize("kv_chunk", [8, 16, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_blocked_attention_matches_exact(s, kv_chunk, causal):
    """tests/test_layers.py::test_blocked_attention_matches_exact's sizes,
    against the port's exact softmax (K4's plain version; S == Sk, where
    its top-left causal mask is the reference's)."""
    b, h, d = 2, 3, 16
    q, k, v = (torch.from_numpy(_rand(seed, b, s, h, d)) for seed in (17, 18, 19))
    out = ta.blocked_attention(q, k, v, causal=causal, kv_chunk=kv_chunk)
    ref = flash_attention_plain(*(t.transpose(1, 2) for t in (q, k, v)), causal=causal)
    np.testing.assert_allclose(out.numpy(), ref.transpose(1, 2).numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("q_offset", [0, 20])
def test_blocked_attention_padding_matches_reference(q_offset):
    """Zero padding of the last kv chunk masked, and ``q_offset``, as the reference."""
    b, s, h, d = 2, 100, 3, 16
    q, k, v = (_rand(seed, b, s, h, d) for seed in (20, 21, 22))
    out = ta.blocked_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                               kv_chunk=16, q_offset=q_offset)
    ref = ja.blocked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                               kv_chunk=16, q_offset=q_offset)
    _close(out, ref, ATTN_F32_TOL)


def test_wedge_qchunks_equivalence():
    """The causal wedge (q_chunks > 1) equals q_chunks=1 (tests/test_layers.py:47)."""
    b, s, h, d = 2, 128, 2, 32
    q, k, v = (torch.from_numpy(_rand(seed, b, s, h, d)) for seed in (23, 24, 25))
    base = ta.blocked_attention(q, k, v, causal=True, kv_chunk=32, q_chunks=1)
    wedge = ta.blocked_attention(q, k, v, causal=True, kv_chunk=32, q_chunks=4)
    np.testing.assert_allclose(wedge.numpy(), base.numpy(), rtol=1e-5, atol=1e-6)


def test_decode_matches_prefill_attention():
    """Decoding the last token against the prefix's cache equals attending
    it in a full causal pass (tests/test_layers.py:60; GQA + RoPE)."""
    _, cfg, p = _attn_setup(seed=5)
    params = _carry(p)
    b, s = 2, 12
    x = torch.from_numpy(_rand(6, b, s, cfg.d_model))
    full, (k_all, v_all) = ta.apply_attention(params, x, cfg=cfg, causal=True, return_kv=True,
                                              kv_chunk=4)
    cache = ta.init_kv_cache(cfg, b, s, torch.float32, "cpu")
    cache["k"][:, :s - 1] = k_all[:, :s - 1]
    cache["v"][:, :s - 1] = v_all[:, :s - 1]
    y, _ = ta.decode_attention(params, x[:, -1:], cache, torch.tensor(s - 1), cfg=cfg)
    np.testing.assert_allclose(y.numpy(), full[:, -1:].numpy(), rtol=1e-4, atol=1e-4)


# ---------------- configs and params ----------------

def _dims(c):
    return (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads, c.d_ff, c.vocab_size)


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", DENSE + MOE)
def test_config_copy_matches_reference(arch, size):
    get, ref_get = ((get_config, jax_get_config) if size == "full"
                    else (reduced_config, jax_reduced_config))
    mine, ref = get(arch), ref_get(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert [f.name for f in dataclasses.fields(mine)] == [f.name for f in dataclasses.fields(ref)]
    assert mine.resolved_head_dim() == ref.resolved_head_dim()
    assert all(mine.is_attn_layer(i) == ref.is_attn_layer(i) and
               mine.is_moe_layer(i) == ref.is_moe_layer(i) for i in range(mine.num_layers))
    exact = {  # tests/test_arch_smoke.py::test_exact_assigned_dims
        "olmo-1b": (16, 2048, 16, 16, 8192, 50304),
        "phi4-mini-3.8b": (32, 3072, 24, 8, 8192, 200064),
        "tinyllama-1.1b": (22, 2048, 32, 4, 5632, 32000),
        "internlm2-20b": (48, 6144, 48, 8, 16384, 92544),
        "phi-3-vision-4.2b": (32, 3072, 32, 32, 8192, 32064),
        "moonshot-v1-16b-a3b": (48, 2048, 16, 16, 1408, 163840),
        "dbrx-132b": (40, 6144, 48, 8, 10752, 100352),
    }
    if size == "full":
        assert _dims(mine) == exact[arch]


def test_moe_config_data_matches_reference():
    from repro.config import MoEConfig as JaxMoE
    from repro.config import RWKVConfig as JaxRWKV
    from repro.config import SSMConfig as JaxSSM
    from repro_torch.config import RWKVConfig, SSMConfig

    for mine, ref in ((MoEConfig(8, 2), JaxMoE(8, 2)), (SSMConfig(), JaxSSM()),
                      (RWKVConfig(), JaxRWKV())):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    cfg = ModelConfig("m", "transformer", num_layers=4, moe=MoEConfig(8, 2, every=2))
    assert [cfg.is_moe_layer(i) for i in range(4)] == [False, True, False, True]


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_param_tree_matches_reference(arch):
    ref = jax.eval_shape(lambda: jax_build_model(jax_reduced_config(arch)).init(
        jax.random.PRNGKey(0)))
    mine = build_model(reduced_config(arch)).init(torch.Generator().manual_seed(0), device="cpu")
    ref_flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    mine_flat = jax.tree_util.tree_flatten_with_path(mine)[0]
    assert [jax.tree_util.keystr(p) for p, _ in mine_flat] == \
        [jax.tree_util.keystr(p) for p, _ in ref_flat]
    for (_, t), (_, s) in zip(mine_flat, ref_flat):
        assert tuple(t.shape) == s.shape and str(t.dtype).split(".")[1] == str(s.dtype)


def test_init_draws_the_reference_distribution():
    cfg = reduced_config("tinyllama-1.1b")
    p = build_model(cfg).init(torch.Generator().manual_seed(3), device="cpu")
    w = p["layers"]["mlp"]["down"]["w"]                       # (L, d_ff, D), fan_in d_ff
    std = cfg.d_ff ** -0.5
    assert float(w.abs().max()) <= 2 * std + 1e-7
    assert abs(float(w.std()) / std - 0.88) < 0.05           # a normal cut at 2 std


def _reference_families():
    from repro.config import list_archs as jax_list_archs

    return sorted({jax_reduced_config(a).family for a in jax_list_archs()})


@pytest.mark.parametrize("family", _reference_families())
def test_build_model_builds_every_reference_family(family):
    """Every family the reference's ``build_model`` knows builds in the port
    (rwkv6 since item 11d, jamba since 11e, whisper since 11f): none is
    left in ``UNPORTED_FAMILIES``, and an unknown family raises."""
    from repro.config import list_archs as jax_list_archs
    from repro_torch.models.api import UNPORTED_FAMILIES

    arch = next(a for a in jax_list_archs() if jax_reduced_config(a).family == family)
    api = build_model(reduced_config(arch))
    assert api.cfg.family == family and callable(api.loss) and callable(api.prefill)
    assert family not in UNPORTED_FAMILIES
    with pytest.raises(ValueError, match="unknown family"):
        build_model(ModelConfig("x", "nope"))


def test_build_model_refuses_unported_families(monkeypatch):
    """A family listed in ``UNPORTED_FAMILIES`` (none since item 11f; the
    mechanism stays for item 11g) raises ``NotImplementedError`` naming the
    ROADMAP item that ports it."""
    from repro_torch.models import api as api_m

    monkeypatch.setitem(api_m.UNPORTED_FAMILIES, "later", "ROADMAP.md, queue 1, item 11g")
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue 1, item 11g"):
        build_model(ModelConfig("x", "later"))


def test_moe_and_lm_loss_raise():
    """A MoE config builds (item 11c, tests/test_torch_moe.py): its layers
    hold "moe" in place of "mlp", and its loss comes back finite with a
    positive aux; the dense LM's loss is ported
    (tests/test_torch_lm_training.py) and comes back finite."""
    cfg = reduced_config("tinyllama-1.1b")
    toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(1))
    moe = build_model(cfg.with_overrides(moe=MoEConfig(4, 2)))
    params = moe.init(torch.Generator().manual_seed(0), device="cpu")
    assert "moe" in params["layers"] and "mlp" not in params["layers"]
    loss, metrics = moe.loss(params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert torch.isfinite(loss) and float(metrics["aux"]) > 0
    api = build_model(cfg)
    loss, metrics = api.loss(api.init(torch.Generator().manual_seed(0), device="cpu"),
                             {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert loss.shape == () and torch.isfinite(loss) and set(metrics) == {"xent", "aux"}


# ---------------- the model ----------------

@functools.lru_cache(maxsize=None)
def _model(arch, dtype, decode_loop="scan"):
    jcfg = jax_reduced_config(arch).with_overrides(compute_dtype=dtype, decode_loop=decode_loop)
    cfg = reduced_config(arch).with_overrides(compute_dtype=dtype, decode_loop=decode_loop)
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    return japi, jparams, build_model(cfg), _carry(jparams)


def _batch(cfg, b, s, seed=26):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.frontend == "vision_stub":
        batch["image_embeds"] = _rand(seed + 1, b, cfg.vision_patches, cfg.d_model)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_reference(arch, dtype):
    japi, jparams, api, params = _model(arch, dtype)
    batch = _batch(api.cfg, 2, 10)
    logits, cache = api.prefill(params, _torch_batch(batch), kv_chunk=4, q_chunks=1)
    jlogits, jcache = japi.prefill(jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                                   kv_chunk=4)
    covered = 10 + (api.cfg.vision_patches if api.cfg.frontend == "vision_stub" else 0)
    assert tuple(logits.shape) == (2, 1, api.cfg.vocab_size)
    assert tuple(cache["k"].shape) == (api.cfg.num_layers, 2, covered, api.cfg.num_kv_heads,
                                       api.cfg.resolved_head_dim())
    assert logits.dtype == getattr(torch, dtype)
    tol = MODEL_TOL[dtype]
    _close(logits, jlogits.astype(jnp.float32), tol)
    for name in ("k", "v"):
        _close(cache[name], jcache[name].astype(jnp.float32), tol)


def _jax_stitched(japi, jcache, max_len):
    cache = japi.init_cache(jcache["k"].shape[1], max_len)
    s = jcache["k"].shape[2]
    if japi.cfg.decode_loop == "unroll":
        return tuple({n: c[n].at[:, :s].set(jcache[n][i].astype(c[n].dtype)) for n in ("k", "v")}
                     for i, c in enumerate(cache))
    return {n: cache[n].at[:, :, :s].set(jcache[n].astype(cache[n].dtype)) for n in ("k", "v")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decode_loop", ["scan", "unroll"])
@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_matches_reference(arch, decode_loop, dtype):
    """One decode step from the same stitched cache (the JAX prefill's,
    carried), in both cache layouts: logits and the updated cache."""
    japi, jparams, api, params = _model(arch, dtype, decode_loop)
    batch = _batch(api.cfg, 2, 9)
    _, jcache = japi.prefill(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    s = jcache["k"].shape[2]
    jdec = _jax_stitched(japi, jcache, s + 3)
    cache = params_from_numpy(_np(jdec), "cpu")
    cache = jax.tree.map(lambda t: t.to(torch.bfloat16), cache)
    token = np.random.default_rng(27).integers(0, api.cfg.vocab_size, (2, 1)).astype(np.int32)
    logits, out = api.decode(params, torch.from_numpy(token), cache, torch.tensor(s))
    assert out is cache
    jlogits, jout = japi.decode(jparams, jnp.asarray(token), jdec, jnp.int32(s))
    tol = MODEL_TOL[dtype]
    _close(logits, jlogits.astype(jnp.float32), tol)
    for got, want in zip(jax.tree.leaves(out), jax.tree.leaves(jout)):
        _close(got, want.astype(jnp.float32), tol)


@pytest.mark.parametrize("arch", DENSE)
def test_stitched_cache_and_decode_consistent_with_prefill(arch):
    """tests/test_serving_consistency.py's invariant on the port: the
    prefix's cache stitched into a decode cache, then decoding the last
    token, reproduces the teacher-forced logits (bf16, 6e-2)."""
    _, _, api, params = _model(arch, "bfloat16")
    batch = _torch_batch(_batch(api.cfg, 2, 11))
    full, _ = api.prefill(params, batch)
    prefix = dict(batch, tokens=batch["tokens"][:, :-1])
    _, pre = api.prefill(params, prefix)
    s = pre["k"].shape[2]
    cache = stitch_prefill_cache(api, pre, s + 1)
    dec, _ = api.decode(params, batch["tokens"][:, -1:], cache, torch.tensor(s))
    np.testing.assert_allclose(dec.float().numpy(), full.float().numpy(), rtol=6e-2, atol=6e-2)


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_tokens_match_reference(arch):
    """From the same stitched cache (f32 compute) the port's greedy tokens
    equal the JAX greedy_decode_loop's."""
    japi, jparams, api, params = _model(arch, "float32")
    batch = _batch(api.cfg, 2, 8)
    jlogits, jcache = japi.prefill(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    s = jcache["k"].shape[2]
    jdec = _jax_stitched(japi, jcache, s + 6)
    first = jnp.argmax(jlogits[:, -1], -1).astype(jnp.int32)[:, None]
    jtoks, _ = jax.jit(lambda p, c, f: jax_greedy(japi, p, c, f, jnp.int32(s), 6))(
        jparams, jdec, first)
    cache = jax.tree.map(lambda t: t.to(torch.bfloat16), params_from_numpy(_np(jdec), "cpu"))
    toks, out = GreedyDecoder(api)(params, cache, torch.from_numpy(np.array(first)), s, 6)
    assert out is cache and toks.dtype == torch.int32
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
