"""moonlight-16b-a3b (the DeepSeek-V3 family, a port-only arch) on the CPU at
its reduced size, against the plain reference of the benchmark
(``portbench/reference/deepseek_v3_plain.py``: float32, the expanded latent
attention, an explicit loop over the experts) on seeded random weights.

Tolerances.  With the port's weights and compute in f32 the two differ only
in the order of their sums (SDPA against an explicit softmax, the absorbed
against the expanded attention, index_add against a loop), a few f32 ulps
through twelve layers: ``F32_TOL`` (1e-4 of the logits' norm) is ~100x what
they read and far below any wrong term (a left-out expert moves them by
O(1)).  The routing is then the reference's: its scores agree to ~1e-7,
and a near-tie under that is not met at these seeds.  In the configuration's
bf16 a row no routing swap reached reads ~1-3% from the reference, but a
bf16 near-tie that swaps one of a token's experts moves its row by ~0.05-0.3
and, through the MoE layers after it, swaps more (0.10 the median row, 0.29
the largest, here).  So the bf16 case holds the least row to
``BF16_LEAST_TOL`` (2-5x over a row no swap reached) and the median row to
``BF16_MEDIAN_TOL`` (2.5x the reading; a left-out term moves every row
past it).  The benchmark's judge (``portbench/families/deepseek_v3.py``)
reads the cascade-free latents besides.
"""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.families.deepseek_v3 import spec_of  # noqa: E402
from portbench.reference import deepseek_v3_plain as plain  # noqa: E402
from repro_torch.config import (  # noqa: E402
    PORT_ONLY,
    get_config,
    list_archs,
    reduced_config,
    reference_archs,
)
from repro_torch.layers import mla, moe  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.api import cache_struct, param_struct  # noqa: E402
from repro_torch.serving import GreedyDecoder, stitch_prefill_cache  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

ARCH = "moonlight-16b-a3b"
F32_TOL = 1e-4
BF16_LEAST_TOL = 0.05
BF16_MEDIAN_TOL = 0.25
SEED = 2**32 + 35


def _cfg(dtype="float32"):
    return reduced_config(ARCH).with_overrides(param_dtype=dtype, compute_dtype=dtype)


def _model(dtype="float32", seed=SEED):
    cfg = _cfg(dtype)
    api = build_model(cfg)
    return cfg, api, api.init(torch.Generator().manual_seed(seed), device="cpu")


def _rel_rows(got, want):
    return (got.float() - want).norm(dim=-1) / want.norm(dim=-1)


def test_registry_is_the_references_plus_moonlight():
    from repro.config import list_archs as jax_list_archs

    assert PORT_ONLY == (ARCH,)
    assert list_archs() == sorted(jax_list_archs() + [ARCH])
    assert reference_archs() == jax_list_archs()


def test_published_widths_and_param_count():
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.vocab_size) == (27, 2048, 16, 163_840)
    assert (cfg.qk_head_dim, cfg.latent_dim, cfg.v_head_dim) == (192, 576, 128)
    assert (cfg.n_routed_experts, cfg.num_experts_per_tok, cfg.n_shared_experts) == (64, 6, 2)
    assert (cfg.d_ff, cfg.moe_intermediate_size, cfg.routed_scaling_factor) == (11_264, 1408, 2.446)
    assert cfg.param_dtype == "bfloat16" and cfg.rope_theta == 50_000.0
    api = build_model(cfg)
    params = param_struct(api)
    assert sum(t.numel() for t in tree_leaves(params)) == 15_960_110_208
    # every weight bf16; f32 only the RMSNorm scales and the correction biases
    f32 = sum(t.numel() for t in tree_leaves(params) if t.dtype == torch.float32)
    assert {t.dtype for t in tree_leaves(params)} == {torch.bfloat16, torch.float32}
    assert f32 == 27 * (2 * 2048 + 512) + 2048 + 26 * 64
    cache = cache_struct(api, 32, 7688)["latent"]
    assert cache.shape == (27, 32, 7688, 576)
    assert cache.numel() * cache.element_size() == 7_652_081_664
    red = reduced_config(ARCH)
    for a, b in ((red.d_model, cfg.d_model), (red.kv_lora_rank, cfg.kv_lora_rank),
                 (red.qk_nope_head_dim, cfg.qk_nope_head_dim), (red.d_ff, cfg.d_ff),
                 (red.moe_intermediate_size, cfg.moe_intermediate_size),
                 (red.vocab_size, cfg.vocab_size)):
        assert a * 16 == b
    assert red.n_routed_experts >= 8 and red.n_shared_experts == 2
    assert red.first_k_dense_replace == 1 and red.num_layers - 1 >= 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_greedy_decode_matches_the_reference(dtype):
    """Prompts prefilled, stitched, then ``GreedyDecoder`` through the latent
    cache: every step's last logits against the reference's one forward over
    the prompt and the tokens fed so far."""
    cfg, api, params = _model(dtype)
    spec = spec_of(cfg)
    gen = torch.Generator().manual_seed(SEED + 1)
    b, s, steps = 4, 20, 4
    prompts = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    logits, pc = api.prefill(params, {"tokens": prompts})
    want, _ = plain.forward(params, prompts, spec)
    errs = [_rel_rows(logits[:, -1], want)]
    cache = stitch_prefill_cache(api, pc, s + steps)
    fed = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen, dtype=torch.int32)
    decoder = GreedyDecoder(api)
    for n in range(steps):   # one step a call, so that each step's logits are compared
        nxt, _ = decoder(params, cache, fed[:, -1:], s + n, 1)
        want, _ = plain.forward(params, torch.cat([prompts, fed.long()], dim=1), spec)
        errs.append(_rel_rows(decoder.logits, want))
        fed = torch.cat([fed, nxt], dim=1)
    errs = torch.cat(errs)
    if dtype == "float32":
        assert float(errs.max()) < F32_TOL, errs
    else:
        assert float(errs.min()) < BF16_LEAST_TOL, errs
        assert float(errs.median()) < BF16_MEDIAN_TOL, errs


def test_absorbed_decode_equals_expanded_attention():
    """The absorbed form on a latent cache gives the expanded form's output
    at the same position, for the same latents."""
    cfg, api, params = _model()
    lp = {k: v[0] for k, v in params["moe"]["attn"].items() if k != "kv_norm"}
    lp["kv_norm"] = {"scale": params["moe"]["attn"]["kv_norm"]["scale"][0]}
    gen = torch.Generator().manual_seed(SEED + 2)
    b, s = 3, 9
    x = torch.randn(b, s + 1, cfg.d_model, generator=gen)
    full, latents = mla.mla_prefill(lp, x, cfg, mla.rope_table(torch.arange(s + 1), cfg))
    cache = torch.zeros(b, s + 5, cfg.latent_dim)
    cache[:, :s] = latents[:, :s]
    n = torch.tensor(s)
    got = mla.mla_decode(lp, x[:, s:], cache, n, mla.decode_step_tables(n, s + 5, cfg), cfg)
    assert torch.allclose(cache[:, s], latents[:, s], rtol=1e-5, atol=1e-6)
    assert float((got[:, 0] - full[:, s]).norm() / full[:, s].norm()) < 1e-5
    assert not cache[:, s + 1:].any()


def _moe_params(cfg, seed=SEED + 3):
    _, _, params = _model(seed=seed)
    return {k: (v[0] if not isinstance(v, dict) else {kk: vv[0] for kk, vv in v.items()})
            for k, v in params["moe"]["moe"].items()}


def test_router_bias_chooses_and_never_weighs():
    cfg = _cfg()
    p = _moe_params(cfg)
    x = torch.randn(16, cfg.d_model, generator=torch.Generator().manual_seed(SEED + 4))
    scores = torch.sigmoid(x @ p["router"])
    k = cfg.num_experts_per_tok
    forced = torch.arange(cfg.n_routed_experts) >= cfg.n_routed_experts - k
    p["bias"] = torch.where(forced, 10.0, -10.0)        # the last k experts, whatever the scores
    weights, indices = moe.route_sigmoid(p, x, cfg)
    assert (indices.sort(dim=-1).values == torch.nonzero(forced)[:, 0]).all()
    chosen = scores.gather(1, indices)
    want = chosen / chosen.sum(-1, keepdim=True) * cfg.routed_scaling_factor
    assert torch.allclose(weights, want, rtol=1e-6)
    assert torch.allclose(weights.sum(-1), torch.full((16,), cfg.routed_scaling_factor))
    p["bias"] = torch.zeros(cfg.n_routed_experts)
    unbiased = moe.route_sigmoid(p, x, cfg)[1]
    assert (unbiased == scores.topk(k, dim=-1).indices).all()


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "padded"])
def test_dropless_and_the_shared_experts_always_added(grouped):
    """Every token routed to the same k experts (a bias that forces them):
    each still gets all k experts' full output, plus the shared experts'.
    Held against a per-token loop."""
    cfg = _cfg()
    p = _moe_params(cfg)
    k, e = cfg.num_experts_per_tok, cfg.n_routed_experts
    p["bias"] = torch.where(torch.arange(e) < k, 10.0, -10.0)
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator().manual_seed(SEED + 5))
    got = moe.apply_deepseek_moe(p, x, cfg, grouped=grouped)
    xf = x.reshape(-1, cfg.d_model)
    weights, indices = moe.route_sigmoid(p, xf, cfg)
    assert (indices.sort(dim=-1).values == torch.arange(k)).all()
    want = torch.stack([
        sum(weights[t, j] * moe.swiglu_ffn(
            xf[t:t + 1], {n: p[n][indices[t, j]] for n in ("gate", "up", "down")})[0]
            for j in range(k)) + moe.shared_experts(p, xf[t:t + 1])[0]
        for t in range(xf.shape[0])])
    assert torch.allclose(got.reshape(-1, cfg.d_model), want, rtol=1e-5, atol=1e-5)
    shared = moe.shared_experts(p, xf)
    assert shared.abs().mean() > 0.1 * want.abs().mean()


def test_stitch_and_decode_over_it():
    """The stitched cache holds the prefill's latents at [0, S) and zeros
    after; a decode step writes its latent at S and leaves the rest."""
    cfg, api, params = _model()
    prompts = torch.randint(0, cfg.vocab_size, (2, 7), generator=torch.Generator().manual_seed(3))
    _, pc = api.prefill(params, {"tokens": prompts})
    assert pc["latent"].shape == (cfg.num_layers, 2, 7, cfg.latent_dim)
    cache = stitch_prefill_cache(api, pc, 10)
    assert torch.equal(cache["latent"][:, :, :7], pc["latent"])
    assert not cache["latent"][:, :, 7:].any()
    before = cache["latent"].clone()
    api.decode(params, torch.zeros(2, 1, dtype=torch.int32), cache, torch.tensor(7))
    assert cache["latent"][:, :, 7].abs().sum() > 0
    assert torch.equal(cache["latent"][:, :, :7], before[:, :, :7])
    assert not cache["latent"][:, :, 8:].any()
    with pytest.raises(ValueError):
        stitch_prefill_cache(api, pc, 6)


def test_the_benchmark_draws_the_weights_the_port_takes():
    """The benchmark's family draws every tensor from the seed, and the
    program only receives them: exactly the port's params in layout, shape
    and dtype, at the configuration file's assumed distributions, the same
    for the same seed; a layout the port does not take is refused."""
    import json

    from portbench.families.deepseek_v3 import draw_weights, load

    cfg_file = json.loads((ROOT / "portbench" / "configs" / f"{ARCH}.json").read_text())
    cfg = reduced_config(ARCH)
    api, spec = build_model(cfg), spec_of(cfg)

    def draw():
        return draw_weights(cfg_file, spec, torch.Generator().manual_seed(SEED), torch.device("cpu"))

    w = load(api, draw())
    trunc = 0.8796      # the std of N(0, 1) cut at 2 std
    for t, fan_in in ((w["moe"]["moe"]["gate"], cfg.d_model),
                      (w["moe"]["moe"]["down"], cfg.moe_intermediate_size),
                      (w["dense"]["attn"]["wkv_b"], cfg.kv_lora_rank),
                      (w["embed"]["table"], cfg.d_model)):
        assert t.dtype == torch.bfloat16
        assert abs(float(t.float().std()) * fan_in ** 0.5 / trunc - 1) < 0.03
        assert float(t.float().abs().max()) <= 2 / fan_in ** 0.5 * (1 + 2**-8)
    bias = w["moe"]["moe"]["bias"]
    assert bias.dtype == torch.float32
    assert abs(float(bias.std()) / cfg_file["correction_bias_std"] - 1) < 0.25
    for norm in (w["ln_f"]["scale"], w["moe"]["ln1"]["scale"], w["dense"]["attn"]["kv_norm"]["scale"]):
        assert norm.dtype == torch.float32 and bool((norm == 1).all())
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(w), tree_leaves(draw())))
    w["moe"]["attn"]["wkv_b"] = w["moe"]["attn"]["wkv_b"].transpose(1, 2)
    with pytest.raises(ValueError, match="wkv_b"):
        load(api, w)
