"""Port parity of the serving steps: the Engine's per-call params
(``*_with``) and ``build_score_step`` against the JAX package's, and the LM
steps and ``serve_lm`` on the CPU.

The reference's ``serve_lm`` decodes against a zeroed cache: it throws the
prefill's cache away (``repro/launch/serve.py:347``), makes a new one
(``:351``) and decodes from position S against it (``:355``), so every
decoded token attends to zero keys and values where the prompt should be.
Its own invariant (``tests/test_serving_consistency.py``) stitches the
prefix cache in first; the port's ``serve_lm`` does, and
``test_serve_lm_decodes_against_the_prefill_cache`` pins it.
"""
import argparse
import contextlib
import functools
import io
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

from repro.config import get_config as jax_get_config  # noqa: E402
from repro.core import init_lstm_ae as jax_init_lstm_ae  # noqa: E402
from repro.engine import build_engine as jax_build_engine  # noqa: E402
from repro.serving import build_score_step as jax_build_score_step  # noqa: E402
from repro_torch.config import get_config, reduced_config  # noqa: E402
from repro_torch.core.lstm import init_lstm_ae  # noqa: E402
from repro_torch.engine import EngineConfig, Placement, build_engine  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    GreedyDecoder,
    build_decode_step,
    build_prefill_step,
    build_score_step,
    greedy_decode_loop,
    stitch_prefill_cache,
)

ARCH = "lstm-ae-f32-d2"
FORMS = ["reconstruct", "score", "score_masked", "stream", "stream_masked"]
PROGRAM = {"reconstruct": "reconstruct", "score": "score", "score_masked": "score_masked",
           "stream": "step", "stream_masked": "mstep"}


@functools.lru_cache(maxsize=None)
def _setup(t=6, b=4):
    cfg = get_config(ARCH)
    p1 = init_lstm_ae(torch.Generator().manual_seed(0), cfg, "cpu")
    p2 = init_lstm_ae(torch.Generator().manual_seed(1), cfg, "cpu")
    rng = np.random.default_rng(2)
    series = torch.from_numpy(rng.standard_normal((b, t, 32)).astype(np.float32))
    return cfg, p1, p2, series


def _call(engine, form, params, series):
    """``engine.<form>`` (params None) or ``engine.<form>_with(params, ...)``."""
    b = series.shape[0]
    if form in ("stream", "stream_masked"):
        args = (series[:, 0], engine.init_stream_state(b))
        if form == "stream_masked":
            args += (torch.tensor([True, False] * (b // 2)),)
    else:
        batch = {"series": series}
        if form == "score_masked":
            batch["lengths"] = torch.tensor([6, 3, 0, 5][:b], dtype=torch.int32)
        args = (batch,)
    if params is None:
        return getattr(engine, form)(*args)
    return getattr(engine, f"{form}_with")(params, *args)


def _equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("schedule", ["wavefront", "fused", "pipelined"])
@pytest.mark.parametrize("form", FORMS)
def test_with_form_bit_equal_to_bound(form, schedule):
    cfg, p1, p2, series = _setup()
    engine = build_engine(cfg, schedule, params=p1, device="cpu")
    assert _equal(_call(engine, f"{form}", p2, series),
                  _call(build_engine(cfg, schedule, params=p2, device="cpu"), form, None, series))
    # numpy params are taken too
    np_p2 = jax.tree.map(lambda t: t.numpy(), p2)
    assert _equal(_call(engine, form, np_p2, series), _call(engine, form, p2, series))


@pytest.mark.parametrize("form", FORMS)
def test_with_form_leaves_bound_calls_unchanged(form):
    cfg, p1, p2, series = _setup()
    engine = build_engine(cfg, "fused", params=p1, device="cpu")
    before = _call(engine, form, None, series)
    weights = engine._require_params()
    _call(engine, form, p2, series)
    assert engine._require_params() is weights and engine.params is not p2
    assert _equal(_call(engine, form, None, series), before)
    assert f"{PROGRAM[form]}_with" in engine.profile_info()["per_program"]


@pytest.mark.parametrize("form", FORMS)
def test_with_form_sharded_equals_unsharded(form):
    """Under Placement.data(2) (two emulated CPU devices) each ``*_with``
    runs on the shards and equals the unsharded engine bit for bit."""
    cfg, p1, p2, series = _setup()
    sharded = build_engine(cfg, EngineConfig("fused", placement=Placement.data(2)),
                           params=p1, device="cpu")
    single = build_engine(cfg, "fused", params=p1, device="cpu")
    assert _equal(_call(sharded, form, p2, series), _call(single, form, p2, series))
    assert f"{PROGRAM[form]}_with@shard1" in sharded.profile_info()["per_program"]


def test_build_score_step_matches_reference():
    """The port's build_score_step against the JAX one from carried params,
    at rtol 1e-6 (tests/test_engine.py::test_build_score_step_matches_engine)."""
    jparams = jax.tree.map(np.asarray, jax_init_lstm_ae(jax.random.PRNGKey(0),
                                                        jax_get_config(ARCH)))
    series = np.random.default_rng(3).standard_normal((3, 7, 32)).astype(np.float32)
    want = jax_build_score_step(jax_build_engine(jax_get_config(ARCH), "wavefront"))(
        jparams, {"series": series})
    engine = build_engine(get_config(ARCH), "wavefront", device="cpu")
    got = build_score_step(engine)(jparams, {"series": series})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert torch.equal(got, engine.bind(jparams).score({"series": series}))


def test_steps_refuse_a_mesh(tmp_path):
    """The score, prefill and decode steps on a (1, 1) mesh of one gloo
    rank (the LM's params placed by their specs) equal the plain steps
    (the (2, 2) mesh: tests/test_torch_sharded_step.py)."""
    from test_torch_sharded_step import one_rank_mesh

    from repro_torch.distributed import sharding

    _, jparams, _, series = _setup()
    engine = build_engine(get_config(ARCH), "wavefront", device="cpu")
    api, params = _lm()
    toks = torch.randint(0, api.cfg.vocab_size, (2, 7), generator=torch.Generator().manual_seed(4))
    logits, cache = build_prefill_step(api)(params, {"tokens": toks})
    dec = api.stitch(cache, 9)
    token = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    d_logits, _ = build_decode_step(api)(params, token, dec, torch.tensor(7, dtype=torch.int32))
    with one_rank_mesh(tmp_path) as mesh:
        rules = sharding.rules_for_mesh(mesh)
        placed = sharding.device_put(params, mesh, sharding.spec_tree_to_shardings(
            mesh, rules, api.param_specs()))
        score = build_score_step(engine, mesh)(jparams, {"series": series})
        m_logits, m_cache = build_prefill_step(api, mesh, rules)(placed, {"tokens": toks})
        m_dec = sharding.device_put(api.stitch(cache, 9), mesh, sharding.spec_tree_to_shardings(
            mesh, rules, api.cache_specs()))
        m_d_logits, _ = build_decode_step(api, mesh)(placed, token, m_dec,
                                                     torch.tensor(7, dtype=torch.int32))
        got = [t.full_tensor() for t in (m_logits, m_cache["k"], m_d_logits, m_dec["k"])]
    assert torch.equal(score, engine.bind(jparams).score({"series": series}))
    for a, b in zip(got, (logits, cache["k"], d_logits, dec["k"])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=1e-5, atol=1e-6)


def _lm(arch="tinyllama-1.1b", **over):
    api = build_model(reduced_config(arch).with_overrides(compute_dtype="float32", **over))
    return api, api.init(torch.Generator().manual_seed(0), device="cpu")


def test_prefill_and_decode_steps_are_the_api_calls():
    api, params = _lm()
    toks = torch.randint(0, api.cfg.vocab_size, (2, 7), generator=torch.Generator().manual_seed(4))
    logits, cache = build_prefill_step(api, kv_chunk=4)(params, {"tokens": toks})
    want, want_cache = api.prefill(params, {"tokens": toks}, kv_chunk=4)
    assert torch.equal(logits, want) and _equal(cache, want_cache)
    dec = stitch_prefill_cache(api, cache, 9)
    assert dec["k"].shape[2] == 9 and torch.equal(dec["k"][:, :, :7], cache["k"].bfloat16())
    assert not dec["k"][:, :, 7:].any()
    step = build_decode_step(api)
    got, out = step(params, toks[:, :1], dec, torch.tensor(7))
    assert out is dec and dec["k"][:, :, 7].any()
    with pytest.raises(ValueError, match="cannot hold"):
        stitch_prefill_cache(api, cache, 6)


@pytest.mark.parametrize("decode_loop", ["scan", "unroll"])
def test_greedy_loop_equals_teacher_forcing(decode_loop):
    """Greedy tokens from the stitched cache equal argmax of a teacher-forced
    prefill of the growing sequence (f32 compute), in both cache layouts."""
    api, params = _lm(decode_loop=decode_loop)
    toks = torch.randint(0, api.cfg.vocab_size, (2, 6), generator=torch.Generator().manual_seed(5))
    logits, pre = api.prefill(params, {"tokens": toks})
    first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    cache = stitch_prefill_cache(api, pre, 6 + 5)
    out, back = greedy_decode_loop(api, params, cache, first, 6, 5)
    assert back is cache and out.shape == (2, 5)
    seq = torch.cat([toks, first, out[:, :-1]], dim=1)
    for j in range(5):
        full, _ = api.prefill(params, {"tokens": seq[:, :7 + j]})
        assert torch.equal(full[:, -1].argmax(-1).to(torch.int32), out[:, j])
    decoder = GreedyDecoder(api, jit=False)
    again, _ = decoder(params, stitch_prefill_cache(api, pre, 11), first, torch.tensor(6), 5)
    assert torch.equal(again, out) and decoder.logits.shape == (2, api.cfg.vocab_size)
    assert decoder.captures == 0


def _serve_lm(arch, decode_tokens=5, batch=2, seq_len=7):
    cfg = reduced_config(arch).with_overrides(compute_dtype="float32")
    args = argparse.Namespace(device="cpu", batch=batch, seq_len=seq_len,
                              decode_tokens=decode_tokens)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.serve_lm(cfg, args)
    out = buf.getvalue()
    cont = [int(t) for t in re.search(r"sample continuation: \[(.*)\]", out).group(1).split(",")]
    return cfg, out, cont


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "phi-3-vision-4.2b"])
def test_serve_lm_decodes_against_the_prefill_cache(arch):
    """serve_lm's continuation equals argmax of a teacher-forced re-prefill
    of the growing sequence: the decode cache holds the prompt's K/V (and,
    under the vision stub, the patches'), not zeros."""
    cfg, out, cont = _serve_lm(arch)
    assert re.search(r"\[serve\] .*: prefill\(2x7\)=[\d.]+ms, 5 tokens decoded in [\d.]+ms "
                     r"\([\d,]+ tok/s\)", out)
    api = build_model(cfg)
    params = api.init(torch.Generator("cpu").manual_seed(0), device="cpu")
    gen = torch.Generator("cpu").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 7), generator=gen, dtype=torch.int32)}
    if cfg.frontend == "vision_stub":
        batch["image_embeds"] = torch.randn((2, cfg.vision_patches, cfg.d_model),
                                            generator=gen).to(torch.bfloat16)
    one = {k: v[:1] for k, v in batch.items()}
    logits, _ = api.prefill(params, one)
    seq = torch.cat([one["tokens"], logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)], 1)
    for tok in cont:          # the tokens decoded after the prefill's own
        logits, _ = api.prefill(params, dict(one, tokens=seq))
        assert int(logits[0, -1].argmax()) == tok
        seq = torch.cat([seq, torch.tensor([[tok]], dtype=torch.int32)], dim=1)


def test_serve_refuses_lstm_ae_modes_for_an_lm():
    for flag in (["--gateway"], ["--http"], ["--workers", "2"], ["--mesh", "data=2"]):
        with pytest.raises(SystemExit, match="LSTM-AE serving only"):
            serve.main(["--arch", "tinyllama-1.1b", "--device", "cpu"] + flag)


def test_serve_lm_defaults_to_the_gpu():
    """An LM arch without --device runs on cuda and never falls back to
    the CPU: without a GPU it raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "tinyllama-1.1b", "--decode-tokens", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(reduced_config("tinyllama-1.1b")).init(torch.Generator().manual_seed(0))
