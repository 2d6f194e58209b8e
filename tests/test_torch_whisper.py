"""Port parity of Whisper: the sinusoidal table, cross-attention,
``decode_attention(update_cache=False)`` and repro_torch.models.whisper
against the JAX package's, from carried weights (the reference's init,
converted with np.asarray), on the reduced whisper-large-v3 (2 encoder and
2 decoder layers, d_model 64 in 4 heads, 12 frames).

Bars: the sinusoidal table to f32 rounding; attention in f32 at 1e-4 and
in bf16 at 6e-2; the model's logits in f32 at 1e-4 and its caches and
encoder memory at 1e-5 (tests/test_torch_transformer.py); each bf16 layer
kind on equal inputs at 6e-2, and the bf16 model no farther (+6e-2) from
the reference's f32 than the reference's own bf16 (tests/test_torch_jamba.py:
two bf16 chains drift apart through the layers); ``train_loss`` and every
grad leaf at 1e-4 / 1e-5 in f32 and, in bf16, the loss at 6e-2 and each
grad leaf within 5e-2 of the reference's own bf16 distance from its f32
grads by relative Frobenius error (tests/test_torch_lm_training.py); decode
against prefill at the reference's 5e-2
(tests/test_serving_consistency.py:110-131).  The reference's bf16 is
compiled with ``xla_allow_excess_precision`` off, so that each bf16 op
rounds as written, as the port's do.

Two reference faults are pinned: its ``serve_lm`` decodes Whisper against
a zeroed cross-KV (``init_cache``), so no frame reaches its continuation,
and its ``launch.train`` raises ``KeyError: 'frames'`` on Whisper."""
import argparse
import contextlib
import dataclasses
import functools
import io
import math
import re
import sys

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
from repro.layers import mlp as jmlp  # noqa: E402
from repro.layers import norms as jnorms  # noqa: E402
from repro.layers import rotary as jrot  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
from repro.serving import greedy_decode_loop as jax_greedy  # noqa: E402
from repro.training import build_train_step as jax_build_train_step  # noqa: E402
from repro.training import init_train_state as jax_init_train_state  # noqa: E402
from repro_torch.config import TrainConfig, get_config, list_archs, reduced_config  # noqa: E402
from repro_torch.data import LMDataConfig, make_lm_batch  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.layers import rotary as trot  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import whisper as twhisper  # noqa: E402
from repro_torch.models.api import UNPORTED_FAMILIES  # noqa: E402
from repro_torch.serving import GreedyDecoder, stitch_prefill_cache  # noqa: E402
from repro_torch.training import build_train_step, init_train_state  # noqa: E402
from repro_torch.utils import params_from_numpy, tree_leaves, tree_map  # noqa: E402

ARCH = "whisper-large-v3"
F32_TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = {"float32": 1e-4, "bfloat16": 6e-2}
STATE_TOL = {"float32": 1e-5, "bfloat16": 6e-2}
CONSISTENCY_TOL = 5e-2                      # tests/test_serving_consistency.py:110-131
BF16_GRAD_REL = 5e-2
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
EXACT = {"xla_allow_excess_precision": False}


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                        else np.asarray(a), tree)


def _carry(tree):
    """A JAX tree -> tensors on the CPU in the same dtypes (bf16 via f32)."""
    dtypes = jax.tree.map(lambda a: getattr(torch, str(a.dtype)), tree)
    return tree_map(lambda t, dt: t.to(dt), params_from_numpy(_np(tree), "cpu"), dtypes)


def _f32(a) -> np.ndarray:
    return a.float().detach().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a.astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def _both(x, dtype):
    """x as a tensor and as a JAX array, sharing no memory: the port writes
    caches in place, and ``jnp.asarray`` may alias a numpy buffer."""
    tdt, jdt = DTYPES[dtype]
    return torch.tensor(x).to(tdt), jnp.asarray(x).astype(jdt)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _exact_jit(fn, *args):
    """``fn`` jitted with each bf16 op rounded as written."""
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT)(*args)


def _no_farther(got16, ref16, ref32, bar, what):
    """bf16 end to end: the port's result lies within ``bar`` of the
    reference's own bf16 distance (max abs) from the reference's f32."""
    g, r16, r32 = _f32(got16), _f32(ref16), _f32(ref32)
    mine, theirs = np.abs(g - r32).max(), np.abs(r16 - r32).max()
    assert mine <= theirs + bar, \
        f"{what}: the port's bf16 {mine:.4g} from f32, the reference's {theirs:.4g}"


# ---------------- config and init ----------------

def test_config_matches_reference_and_builds():
    """whisper-large-v3 and its reduced config field for field; registered,
    no longer unported, and built with the reference's param tree, leaf for
    leaf (path, shape, dtype, ``self_attn``, ``ln_x`` and ``cross_attn``
    included); ``init_cache`` the reference's cache tree, zeroed."""
    assert ARCH in list_archs() and "whisper" not in UNPORTED_FAMILIES
    for mine, ref in ((get_config(ARCH), jax_get_config(ARCH)),
                      (reduced_config(ARCH), jax_reduced_config(ARCH))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    japi = jax_build_model(jax_reduced_config(ARCH))
    api = build_model(reduced_config(ARCH))
    mine = api.init(torch.Generator().manual_seed(0), device="cpu")
    cache = api.init_cache(3, 11, device="cpu")
    for got, want in ((mine, jax.eval_shape(lambda: japi.init(jax.random.PRNGKey(0)))),
                      (cache, jax.eval_shape(lambda: japi.init_cache(3, 11)))):
        got_flat = jax.tree_util.tree_flatten_with_path(got)[0]
        want_flat = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [jax.tree_util.keystr(p) for p, _ in got_flat] == \
            [jax.tree_util.keystr(p) for p, _ in want_flat]
        for (_, t), (_, s) in zip(got_flat, want_flat):
            assert tuple(t.shape) == s.shape and str(t.dtype).split(".")[1] == str(s.dtype)
    assert set(mine["dec_layers"]) == {"ln1", "self_attn", "ln_x", "cross_attn", "ln2", "mlp"}
    assert not any(t.any() for t in tree_leaves(cache))


def test_init_draws_the_reference_distribution():
    """``dec_pos`` is (MAX_DECODER_LEN, d_model) truncated normal at fan_in
    d_model; LayerNorm scales one and biases zero; the biased projections
    start at zero, as the reference's."""
    cfg = reduced_config(ARCH)
    p = build_model(cfg).init(torch.Generator().manual_seed(3), device="cpu")
    assert twhisper.MAX_DECODER_LEN == jwhisper.MAX_DECODER_LEN == 32_768
    std = cfg.d_model ** -0.5
    for w in (p["dec_pos"], p["enc_layers"]["attn"]["q"]["w"], p["dec_layers"]["cross_attn"]["v"]["w"]):
        assert float(w.abs().max()) <= 2 * std + 1e-7
        assert abs(float(w.std()) / std - 0.88) < 0.05           # a normal cut at 2 std
    assert tuple(p["dec_pos"].shape) == (32_768, cfg.d_model)
    assert torch.equal(p["ln_enc"]["scale"], torch.ones(cfg.d_model))
    assert not p["dec_layers"]["ln_x"]["bias"].any() and not p["enc_layers"]["mlp"]["up"]["b"].any()


def test_the_default_device_is_the_gpu():
    """``device=None`` resolves to cuda and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device resolves")
    api = build_model(reduced_config(ARCH))
    for call in (lambda: api.init(torch.Generator().manual_seed(0)),
                 lambda: api.init_cache(2, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------- layers ----------------

@pytest.mark.parametrize("seq_len,dim", [(12, 64), (1500, 1280), (5, 2), (3, 7)])
def test_sinusoidal_embedding_matches_reference(seq_len, dim):
    """The table to f32 rounding, at the reduced and the full encoder's
    shapes and at the degenerate widths where the reference's denominator
    ``max(1, half - 1)`` departs from ``half - 1``: the arguments reach
    seq_len - 1, so an f32 argument is off by up to seq_len · eps, and each
    table lies within that of the f64 table, the two within twice that."""
    got = trot.sinusoidal_embedding(seq_len, dim)
    want = np.asarray(jrot.sinusoidal_embedding(seq_len, dim))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    half = dim // 2
    args = np.arange(seq_len)[:, None] / 1e4 ** (np.arange(half) / max(1, half - 1))
    exact = np.concatenate([np.sin(args), np.cos(args)], axis=-1)
    ulp = seq_len * float(np.finfo(np.float32).eps)
    np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=ulp)
    np.testing.assert_allclose(want, exact, rtol=0, atol=ulp)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2 * ulp)


@functools.lru_cache(maxsize=None)
def _attn(seed=9):
    jcfg = jax_reduced_config(ARCH)
    jp = jattn.init_attention(jax.random.PRNGKey(seed), jcfg)
    return jcfg, reduced_config(ARCH), jp, _carry(jp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_reference(dtype):
    """``apply_attention(x_kv=)``: queries from 7 decoder rows, K/V
    projected from 12 frames (non-causal), and the un-expanded K/V it
    returns; f32 at 1e-4, bf16 at 6e-2; the result differs from
    self-attention's."""
    jcfg, cfg, jp, p = _attn()
    tol = MODEL_TOL[dtype]
    xt, xj = _both(_rand(10, 2, 7, cfg.d_model), dtype)
    mt, mj = _both(_rand(11, 2, 12, cfg.d_model), dtype)
    y, (k, v) = tattn.apply_attention(p, xt, cfg=cfg, causal=False, use_rope=False, x_kv=mt,
                                      kv_chunk=5, return_kv=True)
    jy, (jk, jv) = jattn.apply_attention(jp, xj, cfg=jcfg, causal=False, use_rope=False, x_kv=mj,
                                         kv_chunk=5, return_kv=True)
    assert tuple(y.shape) == (2, 7, cfg.d_model) and tuple(k.shape) == (2, 12, 4, 16)
    for got, want in ((y, jy), (k, jk), (v, jv)):
        _close(got, want, tol)
    self_y = tattn.apply_attention(p, xt, cfg=cfg, causal=False, use_rope=False)
    assert not torch.allclose(self_y.float(), y.float())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_without_update_leaves_the_cache(dtype):
    """``update_cache=False`` (Whisper's cross step, ``cache_len`` =
    T_enc - 1): the cache stays bit-unchanged, at the position too, y
    matches the reference's, and a Python int and a tensor ``cache_len``
    give the same y; with the update the port writes the row the reference
    does."""
    jcfg, cfg, jp, p = _attn()
    tol = MODEL_TOL[dtype]
    kv = _rand(12, 2, 2, 12, 4, 16)
    cache = {"k": torch.tensor(kv[0]).to(torch.bfloat16), "v": torch.tensor(kv[1]).to(torch.bfloat16)}
    jcache = {"k": jnp.asarray(kv[0]).astype(jnp.bfloat16), "v": jnp.asarray(kv[1]).astype(jnp.bfloat16)}
    before = tree_map(torch.clone, cache)
    xt, xj = _both(_rand(13, 2, 1, cfg.d_model), dtype)
    y, back = tattn.decode_attention(p, xt, cache, 11, cfg=cfg, use_rope=False, update_cache=False)
    jy, jback = jattn.decode_attention(jp, xj, jcache, jnp.int32(11), cfg=jcfg, use_rope=False,
                                       update_cache=False)
    assert back is cache and all(torch.equal(cache[n], before[n]) for n in cache)
    _close(y, jy, tol)
    y_t, _ = tattn.decode_attention(p, xt, cache, torch.tensor(11), cfg=cfg, use_rope=False,
                                    update_cache=False)
    assert torch.equal(y_t, y) and all(torch.equal(cache[n], before[n]) for n in cache)
    _, jwritten = jattn.decode_attention(jp, xj, jcache, jnp.int32(11), cfg=jcfg, use_rope=False)
    tattn.decode_attention(p, xt, cache, torch.tensor(11), cfg=cfg, use_rope=False)
    for n in cache:
        assert not torch.equal(cache[n][:, 11], before[n][:, 11])
        _close(cache[n], jwritten[n], tol)


# ---------------- the model ----------------

@functools.lru_cache(maxsize=None)
def _model(dtype):
    jcfg, cfg = jax_reduced_config(ARCH), reduced_config(ARCH)
    japi = jax_build_model(jcfg.with_overrides(compute_dtype=dtype))
    jparams = japi.init(jax.random.PRNGKey(0))
    return japi, jparams, build_model(cfg.with_overrides(compute_dtype=dtype)), _carry(jparams)


def _tokens(cfg, b, s, seed=26):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _frames(cfg, b, seed=27):
    return _rand(seed, b, cfg.encoder_seq_len, cfg.d_model)


def _batch_both(cfg, toks, frames):
    return ({"tokens": torch.from_numpy(toks).long(), "frames": torch.from_numpy(frames)},
            {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})


@functools.lru_cache(maxsize=None)
def _prefill_both(dtype):
    """(port memory, logits and cache; the reference's) for a prompt of
    B=2, S=9 over 12 frames."""
    japi, jparams, api, params = _model(dtype)
    toks, frames = _tokens(api.cfg, 2, 9), _frames(api.cfg, 2)
    batch, jbatch = _batch_both(api.cfg, toks, frames)
    cdt = DTYPES[dtype][1]
    jmem = _exact_jit(lambda p, f: jwhisper.encode(p, f.astype(cdt), japi.cfg, remat=False),
                      jparams, jbatch["frames"])
    jout = _exact_jit(lambda p, b: japi.prefill(p, b), jparams, jbatch)
    mem = twhisper.encode(params, batch["frames"].to(DTYPES[dtype][0]), api.cfg, remat=False)
    return (mem,) + api.prefill(params, batch), (jmem,) + jout


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_prefill_match_reference(dtype):
    """The encoder's memory, the prefill's logits and its cache ``k``,
    ``v``, ``ck``, ``cv`` (L, B, ·, Hkv, hd) in compute dtype: f32 at 1e-4
    (logits) and 1e-5; bf16 no farther (+6e-2) from the reference's f32
    than the reference's own bf16."""
    (mem, logits, cache), (jmem, jlogits, jcache) = _prefill_both(dtype)
    tdt = DTYPES[dtype][0]
    assert tuple(logits.shape) == (2, 1, 512) and logits.dtype == tdt
    assert tuple(cache["k"].shape) == (2, 2, 9, 4, 16) and tuple(cache["ck"].shape) == (2, 2, 12, 4, 16)
    assert set(cache) == set(jcache) and all(t.dtype == tdt for t in cache.values())
    if dtype == "float32":
        _close(logits, jlogits, MODEL_TOL[dtype])
        _close(mem, jmem, STATE_TOL[dtype])
        for name in cache:
            _close(cache[name], jcache[name], STATE_TOL[dtype])
        return
    (_, _, _), (jmem32, jlogits32, jcache32) = _prefill_both("float32")
    _no_farther(logits, jlogits, jlogits32, MODEL_TOL[dtype], "logits")
    _no_farther(mem, jmem, jmem32, MODEL_TOL[dtype], "memory")
    for name in cache:
        _no_farther(cache[name], jcache[name], jcache32[name], MODEL_TOL[dtype], name)


def test_prefill_cross_kv_is_cross_kv_bit_for_bit():
    """The prefill takes ``ck``/``cv`` from the cross-attention's own
    projection of the memory: bit-equal to ``_cross_kv`` of that memory,
    layer by layer."""
    (mem, _, cache), _ = _prefill_both("bfloat16")
    _, _, api, params = _model("bfloat16")
    for i in range(api.cfg.num_layers):
        lp = tree_map(lambda t: t[i], params["dec_layers"])
        ck, cv = twhisper._cross_kv(lp, mem, api.cfg)
        assert torch.equal(cache["ck"][i], ck) and torch.equal(cache["cv"][i], cv)


def _reference_enc_layer(jlp, h, jcfg):
    """One layer of the reference's ``encode`` (``models/whisper.py:108-123``)."""
    hn = jnorms.apply_norm(jlp["ln1"], h, "layernorm")
    h = h + jattn.apply_attention(jlp["attn"], hn, cfg=jcfg, causal=False, use_rope=False)
    return h + jmlp.apply_mlp(jlp["mlp"], jnorms.apply_norm(jlp["ln2"], h, "layernorm"), jcfg)


def _reference_dec_layer(jlp, h, memory, jcfg):
    """One layer of the reference's ``prefill`` (``models/whisper.py:180-200``)."""
    hn = jnorms.apply_norm(jlp["ln1"], h, "layernorm")
    y, kv = jattn.apply_attention(jlp["self_attn"], hn, cfg=jcfg, causal=True, use_rope=False,
                                  return_kv=True)
    h = h + y
    hn = jnorms.apply_norm(jlp["ln_x"], h, "layernorm")
    h = h + jattn.apply_attention(jlp["cross_attn"], hn, cfg=jcfg, causal=False, use_rope=False,
                                  x_kv=memory)
    h = h + jmlp.apply_mlp(jlp["mlp"], jnorms.apply_norm(jlp["ln2"], h, "layernorm"), jcfg)
    return h, kv, jwhisper._cross_kv(jlp, memory, jcfg)


def _reference_decode_layer(jlp, cache_l, h, n, jcfg):
    """One layer of the reference's ``decode_step`` (``models/whisper.py:237-258``)."""
    hn = jnorms.apply_norm(jlp["ln1"], h, "layernorm")
    y, new_self = jattn.decode_attention(jlp["self_attn"], hn, {"k": cache_l["k"], "v": cache_l["v"]},
                                         n, cfg=jcfg, use_rope=False)
    h = h + y
    hn = jnorms.apply_norm(jlp["ln_x"], h, "layernorm")
    y, _ = jattn.decode_attention(jlp["cross_attn"], hn, {"k": cache_l["ck"], "v": cache_l["cv"]},
                                  jnp.int32(jcfg.encoder_seq_len - 1), cfg=jcfg, use_rope=False,
                                  update_cache=False)
    h = h + y
    h = h + jmlp.apply_mlp(jlp["mlp"], jnorms.apply_norm(jlp["ln2"], h, "layernorm"), jcfg)
    return h, new_self


def _layer(tree, i):
    return tree_map(lambda t: t[i], tree)


def test_layer_kinds_match_reference_in_bf16():
    """Each bf16 layer kind on equal inputs, at 6e-2: every encoder layer
    (the reference's chain gives layer i its input), every decoder layer
    over the prompt (its output, self K/V and cross K/V), and every
    decoder layer's decode step against its stitched caches (its output
    and the row it writes; ``ck``/``cv`` bit-unchanged)."""
    japi, jparams, api, params = _model("bfloat16")
    jcfg, cfg, tol = japi.cfg, api.cfg, MODEL_TOL["bfloat16"]
    toks, frames = _tokens(cfg, 2, 9), _frames(cfg, 2)
    jh = jnp.asarray(frames).astype(jnp.bfloat16) + \
        jrot.sinusoidal_embedding(12, cfg.d_model).astype(jnp.bfloat16)
    for i in range(cfg.encoder_layers):
        h = torch.tensor(_f32(jh)).to(torch.bfloat16)
        jh = _exact_jit(lambda lp, x: _reference_enc_layer(lp, x, jcfg),
                        jax.tree.map(lambda a: a[i], jparams["enc_layers"]), jh)
        _close(twhisper._enc_layer(_layer(params["enc_layers"], i), h, cfg), jh, tol)
    jmem = jnorms.apply_norm(jparams["ln_enc"], jh, "layernorm")
    mem = torch.tensor(_f32(jmem)).to(torch.bfloat16)
    jh = jparams["embed"]["table"][jnp.asarray(toks)].astype(jnp.bfloat16) + \
        jparams["dec_pos"][:9].astype(jnp.bfloat16)[None]
    jcache = japi.init_cache(2, 10)
    for i in range(cfg.num_layers):
        h = torch.tensor(_f32(jh)).to(torch.bfloat16)
        jlp = jax.tree.map(lambda a: a[i], jparams["dec_layers"])
        jh, (jk, jv), (jck, jcv) = _exact_jit(lambda lp, x, m: _reference_dec_layer(lp, x, m, jcfg),
                                              jlp, jh, jmem)
        got, (k, v), (ck, cv) = twhisper._dec_layer(_layer(params["dec_layers"], i), h, mem, cfg,
                                                    1024, 1)
        for g, w in ((got, jh), (k, jk), (v, jv), (ck, jck), (cv, jcv)):
            _close(g, w, tol)
        jcache = {"k": jcache["k"].at[i, :, :9].set(jk.astype(jnp.bfloat16)),
                  "v": jcache["v"].at[i, :, :9].set(jv.astype(jnp.bfloat16)),
                  "ck": jcache["ck"].at[i].set(jck), "cv": jcache["cv"].at[i].set(jcv)}
    token = _tokens(cfg, 2, 1, seed=28)
    jh = jparams["embed"]["table"][jnp.asarray(token)].astype(jnp.bfloat16) + \
        jparams["dec_pos"][9:10].astype(jnp.bfloat16)[None]
    for i in range(cfg.num_layers):
        h = torch.tensor(_f32(jh)).to(torch.bfloat16)
        jcache_l = jax.tree.map(lambda a: a[i], jcache)
        cache_l = _carry(jcache_l)
        kept = {n: cache_l[n].clone() for n in ("ck", "cv")}
        jh, jnew = _exact_jit(lambda lp, c, x: _reference_decode_layer(lp, c, x, jnp.int32(9), jcfg),
                              jax.tree.map(lambda a: a[i], jparams["dec_layers"]), jcache_l, jh)
        got = twhisper._decode_layer(_layer(params["dec_layers"], i), cache_l, h, torch.tensor(9),
                                     cfg)
        _close(got, jh, tol)
        for n in ("k", "v"):
            _close(cache_l[n], jnew[n], tol)
        assert all(torch.equal(cache_l[n], kept[n]) for n in kept)


def _reference_stitched(japi, jcache, s, max_len):
    """The reference's prefill cache in its decode layout, as
    tests/test_serving_consistency.py:110-131 stitches it (self-KV into
    init_cache's bf16 zeros, ck/cv cast to its dtype)."""
    tmpl = japi.init_cache(jcache["k"].shape[1], max_len)
    return {"k": tmpl["k"].at[:, :, :s].set(jcache["k"].astype(tmpl["k"].dtype)),
            "v": tmpl["v"].at[:, :, :s].set(jcache["v"].astype(tmpl["v"].dtype)),
            "ck": jcache["ck"].astype(tmpl["ck"].dtype), "cv": jcache["cv"].astype(tmpl["cv"].dtype)}


@functools.lru_cache(maxsize=None)
def _decode_both(dtype):
    """Three decode steps of both packages from the reference's stitched
    prefill cache of a B=2, S=9 prompt (the f32 prefill, so both dtypes
    start from the same cache): [(logits, cache, reference logits,
    reference cache)] a step."""
    japi, jparams, api, params = _model(dtype)
    _, (_, _, jcache) = _prefill_both("float32")
    jcache = _reference_stitched(japi, jcache, 9, 12)
    cache = _carry(jcache)
    out = []
    for i, token in enumerate(_tokens(api.cfg, 2, 3, seed=29).T):
        token, n = token[:, None], 9 + i
        jlogits, jcache = _exact_jit(japi.decode, jparams, jnp.asarray(token), jcache, jnp.int32(n))
        logits, back = api.decode(params, torch.from_numpy(token).long(), cache, torch.tensor(n))
        assert back is cache
        out.append((logits, tree_map(torch.clone, cache), jlogits, jcache))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_reference(dtype):
    """Three decode steps from the reference's stitched cache, carried: the
    logits and the cache written in place against the reference's decode
    from the same cache; f32 at 1e-4 / 1e-5, bf16 no farther (+6e-2) from
    the reference's f32 than its own bf16."""
    runs = _decode_both(dtype)
    if dtype == "float32":
        for logits, cache, jlogits, jcache in runs:
            _close(logits, jlogits, MODEL_TOL[dtype])
            for name in cache:
                _close(cache[name], jcache[name], STATE_TOL[dtype])
        return
    for (logits, cache, jlogits, jcache), (_, _, jl32, jc32) in zip(runs, _decode_both("float32")):
        _no_farther(logits, jlogits, jl32, MODEL_TOL[dtype], "logits")
        for name in cache:
            _no_farther(cache[name], jcache[name], jc32[name], MODEL_TOL[dtype], name)


def test_decode_writes_only_the_self_kv_in_place():
    """A decode step writes the token's self K/V at ``cache_len`` into the
    caller's cache and returns that same tree; every other position and
    ``ck``/``cv`` stay bit-unchanged (an unguarded cross write would put
    the token's K/V at frame T_enc - 1)."""
    _, _, api, params = _model("bfloat16")
    (_, _, pre), _ = _prefill_both("bfloat16")
    cache = api.stitch(tree_map(torch.clone, pre), 12)
    before = tree_map(torch.clone, cache)
    leaves = tree_leaves(cache)
    _, back = api.decode(params, torch.from_numpy(_tokens(api.cfg, 2, 1, seed=5)).long(), cache,
                         torch.tensor(9))
    assert back is cache and all(a is b for a, b in zip(tree_leaves(cache), leaves))
    for name in ("ck", "cv"):
        assert torch.equal(cache[name], before[name])
    for name in ("k", "v"):
        assert not torch.equal(cache[name][:, :, 9], before[name][:, :, 9])
        rest = [j for j in range(12) if j != 9]
        assert torch.equal(cache[name][:, :, rest], before[name][:, :, rest])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_consistent_with_prefill(dtype):
    """tests/test_serving_consistency.py::test_whisper_decode_consistent_with_prefill
    on the port, through ``ModelAPI.stitch``: the prefill's cache of S
    tokens decodes token S+1 to the last position of a prefill of S+1, at
    the reference's 5e-2, with the greedy tokens equal."""
    _, _, api, params = _model(dtype)
    toks = torch.from_numpy(_tokens(api.cfg, 2, 9, seed=6)).long()
    frames = torch.from_numpy(_frames(api.cfg, 2, seed=7))
    full, _ = api.prefill(params, {"tokens": toks, "frames": frames})
    _, pre = api.prefill(params, {"tokens": toks[:, :-1], "frames": frames})
    cache = stitch_prefill_cache(api, pre, 9)
    assert cache["ck"] is pre["ck"] and cache["cv"] is pre["cv"] and cache["k"].shape[2] == 9
    dec, _ = api.decode(params, toks[:, -1:], cache, torch.tensor(8))
    torch.testing.assert_close(dec.float(), full.float(), rtol=CONSISTENCY_TOL,
                               atol=CONSISTENCY_TOL)
    assert torch.equal(dec[:, -1].argmax(-1), full[:, -1].argmax(-1))


def test_stitch_refuses_a_short_cache():
    _, _, api, params = _model("float32")
    batch, _ = _batch_both(api.cfg, _tokens(api.cfg, 1, 6), _frames(api.cfg, 1))
    _, pre = api.prefill(params, batch)
    with pytest.raises(ValueError, match="cannot hold the 6"):
        api.stitch(pre, 5)


# ---------------- training ----------------

def _rel_fro(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got.float().numpy() - want) / max(np.linalg.norm(want), 1e-30))


def _train_batch(cfg, b=2, s=12, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[:, -2:] = -1
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32), "labels": labels,
            "frames": _frames(cfg, b, seed=seed + 1)}


def _tracked(params):
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    it = iter(leaves)
    return leaves, jax.tree.map(lambda _: next(it), params)   # tree_leaves order: sorted keys


@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads(dtype):
    japi, jparams, _, _ = _model(dtype)
    fn = jax.value_and_grad(lambda p, bt: japi.loss(p, bt, loss_chunk=5), has_aux=True)
    out, jgrads = _exact_jit(fn, jparams, {k: jnp.asarray(v) for k, v in
                                           _train_batch(japi.cfg).items()})
    return out, jax.tree.leaves(jgrads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_loss_matches_reference(dtype):
    """The loss and every grad leaf (``dec_pos``, both stacks, the tied
    table) against jax.value_and_grad of the reference's loss; f32 at
    1e-4 / 1e-5, bf16 the loss at 6e-2 and each grad leaf within 5e-2 of
    the reference's own bf16 distance from its f32 grads (relative
    Frobenius)."""
    _, _, api, params = _model(dtype)
    batch = _train_batch(api.cfg)
    (jloss, jmetrics), jgrads = _reference_loss_and_grads(dtype)
    leaves, tracked = _tracked(params)
    loss, metrics = api.loss(tracked, {k: torch.from_numpy(v) for k, v in batch.items()},
                             loss_chunk=5)
    grads = torch.autograd.grad(loss, leaves)
    assert set(metrics) == set(jmetrics) == {"xent"} and len(grads) == len(jgrads)
    if dtype == "float32":
        np.testing.assert_allclose(float(loss.detach()), float(jloss), **F32_TOL)
        for g, w in zip(grads, jgrads):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)
        return
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=MODEL_TOL[dtype],
                               atol=MODEL_TOL[dtype])
    _, jgrads32 = _reference_loss_and_grads("float32")
    mine = [_rel_fro(g, w32) for g, w32 in zip(grads, jgrads32)]
    theirs = [_rel_fro(torch.tensor(_f32(w)), w32) for w, w32 in zip(jgrads, jgrads32)]
    assert all(m <= t + BF16_GRAD_REL for m, t in zip(mine, theirs)), list(zip(mine, theirs))


def test_remat_is_bit_equal_to_no_remat():
    """Per-layer recompute of both stacks reruns the same ops: loss and
    grads bit-equal to no remat."""
    _, _, api, params = _model("bfloat16")
    batch = {k: torch.from_numpy(v) for k, v in _train_batch(api.cfg).items()}
    runs = []
    for remat in (True, False):
        leaves, tracked = _tracked(params)
        loss, _ = api.loss(tracked, batch, remat=remat, loss_chunk=5)
        runs.append((loss, torch.autograd.grad(loss, leaves)))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


STEP_TC = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10, loss_chunk=8)
TINY_GRAD = 1e-6


@pytest.mark.parametrize("form", [{}, {"microbatch": 2}])
def test_train_step_matches_reference(form):
    """One AdamW step of both packages from the same params and a batch with
    frames (plain, microbatched: ``frames`` split along the batch as the
    tokens are): metrics at rtol 1e-5, the first moment at the grads' bar,
    params at atol 1e-6 except where the reference's |g| is below
    TINY_GRAD (held to one update, 2 lr)."""
    japi, _, api, _ = _model("float32")
    jtc, tc = JaxTrainConfig(**STEP_TC, **form), TrainConfig(**STEP_TC, **form)
    jstate = jax_init_train_state(japi, jax.random.PRNGKey(0), jtc)
    state = init_train_state(params_from_numpy(_np(jstate.params), "cpu"), tc)
    batch = make_lm_batch(LMDataConfig(vocab_size=api.cfg.vocab_size, seq_len=16,
                                       global_batch=4), 0)
    batch["frames"] = torch.from_numpy(_frames(api.cfg, 4, seed=8))
    jstate, jmetrics = jax.jit(jax_build_train_step(japi, jtc))(
        jstate, {k: jnp.asarray(v.numpy(), jnp.float32 if k == "frames" else jnp.int32)
                 for k, v in batch.items()})
    state, metrics = build_train_step(api, tc)(state, batch)
    assert set(metrics) == set(jmetrics)
    for k in ("loss", "xent", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5)
    lr = float(jmetrics["lr"])
    for p, jp, mu, jmu in zip(tree_leaves(state.params), jax.tree.leaves(jstate.params),
                              tree_leaves(state.opt.mu), jax.tree.leaves(jstate.opt.mu)):
        np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-4, atol=1e-6)
        tiny = np.abs(np.asarray(jmu)) / (1 - tc.beta1) < TINY_GRAD
        diff = np.abs(p.numpy() - np.asarray(jp))
        assert diff[~tiny].max(initial=0.0) <= 1e-6
        assert diff[tiny].max(initial=0.0) <= 2 * lr


# ---------------- serving ----------------

def test_greedy_decoder_continues_the_prefill():
    """``GreedyDecoder`` (eager on the CPU) from the stitched prefill cache:
    each token is the argmax of a teacher-forced re-prefill over the same
    frames, and the caller's cache ends holding the self-KV of every token
    and the cross-KV unchanged."""
    _, _, api, params = _model("float32")
    toks = torch.from_numpy(_tokens(api.cfg, 2, 6, seed=3)).long()
    frames = torch.from_numpy(_frames(api.cfg, 2, seed=4))
    logits, pre = api.prefill(params, {"tokens": toks, "frames": frames})
    first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    cache = stitch_prefill_cache(api, pre, 10)
    ck = cache["ck"].clone()
    out, back = GreedyDecoder(api)(params, cache, first, 6, 4)
    assert back is cache and out.shape == (2, 4) and torch.equal(cache["ck"], ck)
    seq = torch.cat([toks, first.long(), out[:, :-1].long()], dim=1)
    for j in range(4):
        full, state = api.prefill(params, {"tokens": seq[:, :7 + j], "frames": frames})
        assert torch.equal(full[:, -1].argmax(-1).to(torch.int32), out[:, j])
    for name in ("k", "v"):
        torch.testing.assert_close(cache[name], state[name], rtol=1e-4, atol=1e-5)


def _continuation(serve_lm, cfg, n=5):
    args = argparse.Namespace(device="cpu", batch=2, seq_len=7, decode_tokens=n)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_lm(cfg, args)
    out = buf.getvalue()
    assert re.search(rf"\[serve\] .*: prefill\(2x7\)=[\d.]+ms, {n} tokens decoded in", out)
    return [int(t) for t in re.search(r"sample continuation: \[(.*)\]", out).group(1).split(",")]


def _teacher_forced(prefill, tokens, n):
    """The greedy continuation by re-prefilling the growing sequence."""
    out = []
    for _ in range(n):
        logits = prefill(tokens)
        nxt = np.asarray(logits[:, -1], np.float32).argmax(-1)
        out.append(int(nxt[0]))
        tokens = np.concatenate([tokens, nxt[:, None].astype(np.int32)], axis=1)
    return out


def test_serve_lm_decodes_from_the_frames(monkeypatch):
    """The port's ``serve_lm`` on the reduced config (f32 compute): its
    continuation is a teacher-forced re-prefill's over the frames it drew
    (after the prefill's own token), and it changes when only the frames
    change (another seed for them, the same params and prompt)."""
    cfg = reduced_config(ARCH).with_overrides(compute_dtype="float32")
    api = build_model(cfg)
    params = api.init(torch.Generator("cpu").manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 7), generator=torch.Generator("cpu").manual_seed(1),
                         dtype=torch.int32)[:1].numpy()
    conts = []
    for seed in (serve_launcher.FRAMES_SEED, serve_launcher.FRAMES_SEED + 1):
        monkeypatch.setattr(serve_launcher, "FRAMES_SEED", seed)
        cont = _continuation(serve_launcher.serve_lm, cfg)
        frames = torch.randn((2, cfg.encoder_seq_len, cfg.d_model),
                             generator=torch.Generator("cpu").manual_seed(seed)).to(torch.bfloat16)

        def prefill(t, frames=frames[:1]):
            return api.prefill(params, {"tokens": torch.from_numpy(t).long(), "frames": frames})[0]

        assert cont == _teacher_forced(prefill, toks, 6)[1:]
        conts.append(cont)
    assert conts[0] != conts[1]


def test_reference_serve_lm_decodes_whisper_without_the_frames():
    """Pins the reference's fault (ROADMAP.md, queue 3): its ``serve_lm``
    throws the prefill's cache away and decodes from ``init_cache``, whose
    cross-KV ``ck``/``cv`` are zeros, so no frame reaches its continuation:
    after the prefill's first token it is the greedy loop from that zeroed
    cache, and not the one the same loop gives from the stitched prefill
    cache (its prompt's self-KV and its frames' cross-KV), whose first
    token is the argmax of a prefill of the prompt and that token."""
    jcfg = jax_reduced_config(ARCH).with_overrides(compute_dtype="float32")
    cont = _continuation(jax_serve.serve_lm, jcfg, n=8)
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 7), 0, jcfg.vocab_size)
    frames = jax.random.normal(jax.random.PRNGKey(2), (2, jcfg.encoder_seq_len, jcfg.d_model),
                               jnp.bfloat16)
    prefill = jax.jit(japi.prefill)
    logits, pre = prefill(jparams, {"tokens": toks, "frames": frames})
    first = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    zeroed = japi.init_cache(2, 7 + 8)
    assert not np.asarray(zeroed["ck"]).any() and not np.asarray(zeroed["cv"]).any()
    greedy = jax.jit(lambda c: jax_greedy(japi, jparams, c, first, jnp.int32(7), 8)[0])
    from_zeros, from_prefill = greedy(zeroed), greedy(_reference_stitched(japi, pre, 7, 7 + 8))
    assert cont == np.asarray(from_zeros)[0].tolist()
    longer, _ = prefill(jparams, {"tokens": jnp.concatenate([toks, first], axis=1),
                                  "frames": frames})
    assert np.array_equal(np.asarray(from_prefill)[:, 0], np.asarray(longer[:, -1]).argmax(-1))
    assert cont != np.asarray(from_prefill)[0].tolist()


def test_reference_train_launcher_raises_on_whisper(tmp_path, monkeypatch):
    """Pins the reference's fault (ROADMAP.md, queue 3): ``python -m
    repro.launch.train --arch whisper-large-v3`` gives ``train_loss`` token
    batches from ``LMIterator`` and raises ``KeyError: 'frames'``; the
    port's trainer draws seeded frames (``test_launchers_serve_and_train_resume``)."""
    from repro.launch import train as jax_train

    monkeypatch.setattr(sys, "argv", ["train", "--arch", ARCH, "--steps", "1", "--batch", "2",
                                      "--seq-len", "8", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(KeyError, match="frames"):
        jax_train.main()


def test_train_frames_are_seeded_by_batch_index():
    """The launcher's Whisper batches carry f32 ``frames`` (B, T_enc, D)
    drawn from (seed, batch index): a second iterator reloaded at index 1
    gives batch 1's frames again, and two batches' frames differ."""
    cfg = reduced_config(ARCH)
    args = argparse.Namespace(batch=2, seq_len=8)
    it, to_batch = train_launcher.make_iterator(cfg, args)
    b0, b1 = to_batch(next(it)), to_batch(next(it))
    assert set(b0) == {"tokens", "labels", "frames"}
    assert tuple(b0["frames"].shape) == (2, cfg.encoder_seq_len, cfg.d_model)
    assert b0["frames"].dtype == torch.float32 and not torch.equal(b0["frames"], b1["frames"])
    it2, to_batch2 = train_launcher.make_iterator(cfg, args)
    it2.load_state_dict({"index": 1, "seed": 0})
    again = to_batch2(next(it2))
    assert all(torch.equal(again[k], b1[k]) for k in b1)


def test_launchers_serve_and_train_resume(tmp_path, capsys):
    """``serve --arch whisper-large-v3 --device cpu`` prefills and decodes
    at the reduced default; ``train`` checkpoints every 2 steps, and a
    second run resumes from step 4 onto the trajectory of one
    uninterrupted run (the frames drawn per batch index)."""
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
    assert resumed_last == whole_last and "loss=nan" not in whole and math.isfinite(
        float(re.search(r"loss=([\d.]+)", whole_last).group(1)))
