"""The DeepSeek-V3 family (Moonlight-16B-A3B): the weights drawn from the
seed, the port's model on its serving path over them, its control, the
judgement of a decode run against the plain reference, the checks of its
configuration files and the faults its cells can have.

The weights are data, as the prompts are: :func:`draw_weights` draws every
tensor from the seed as the configuration file's ``assumed`` states, in the
layout the reference documents (``x @ W``, the layers stacked), and the
program receives them as its params after :func:`load` has held them to the
shapes and dtypes the port's model takes.  The reference reads the same
tensors (at 31.9 GB a second copy would not fit beside the program on one
card); nothing of the program draws or writes them.

The system is the port's normal path: ``build_model(get_config(<config>))``,
``api.prefill`` and ``stitch_prefill_cache`` for the prompts, and one
``serving.GreedyDecoder``, which captures the decode step into a CUDA graph
over the session cache itself (``in_place``, as ``launch/serve.py`` decodes),
for every request.  On a machine without a card it runs the configuration
file's ``cpu_port_config``, the port's reduced model, so that the harness's
tests run the cell on the CPU.

The judgement, against the reference in float32 on the same bf16 weights,
teacher-forced on the program's tokens from the same prompts, its prefix
computed once over the prompts ``reference_block`` sessions at a time.  A
row's error is |program - reference|_2 / |reference|_2.  Two quantities:

- the latents the program wrote into its cache at the last request's
  positions (``traffic/decode.py`` keeps them before the cache is dropped),
  each session's and position's a row, at the first ``first_k_dense_replace
  + 2`` layers.  Up to layer ``first_k_dense_replace`` a latent depends on no
  routing, so every row reads bf16's own error: ``latent_rel_err``, the
  largest of them, sees a latent written wrong, stale or not at all, in any
  session.  The next layer's latent depends on one MoE layer's routing, the
  token's own: a bf16 near-tie swaps an expert there for a few rows only,
  so ``moe_latent_rel_err_q3``, the upper quartile of its rows, reads bf16's
  error plus what one MoE layer adds, and sees a fault in the routed or
  shared experts that moves a quarter of the rows or more;
- the last decode step's logits of every session of the requests the kind
  kept (the first seven answered and the last): ``logits_rel_err_median``,
  the median row.  Routing is discrete, and with random weights a bf16
  near-tie that swaps one of a token's experts moves its state by some 5%,
  so that the routers of the layers after it swap more: over 26 MoE layers
  the swaps cascade, and a sound run's median row reads 0.25-0.35 at the
  cell's size, its largest as high as the control's.  The median is held
  under the control's, as the check on what the user is sent.

The reference routes on its own scores.  The limits and the readings they
come from are in the workload file and ``PERF.md``.  None of these sees a
fault that moves attention by one position of 7,681 (``one_short`` at the
cell's size reads as a sound run: with random weights the attention is
near uniform), which the small size's 24-token context shows.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from portbench.harness import log
from portbench.reference import deepseek_v3_plain as plain

SPEC_KEYS = ("hidden_size", "num_attention_heads", "qk_nope_head_dim", "qk_rope_head_dim",
             "v_head_dim", "kv_lora_rank", "first_k_dense_replace", "num_hidden_layers",
             "n_routed_experts", "num_experts_per_tok", "n_shared_experts",
             "moe_intermediate_size", "intermediate_size", "routed_scaling_factor",
             "norm_topk_prob", "rms_norm_eps", "rope_theta", "vocab_size")
DRAW_BLOCK = 1 << 26    # f32 values drawn at a time


def port_config(cfg: dict, device: torch.device):
    """The port's configuration the cell runs on ``device``: the published
    one on a card, the reduced one on the CPU.  Resolved before anything is
    drawn, so that a port without it fails at once."""
    from repro_torch.config import get_config, reduced_config

    if device.type == "cuda":
        return get_config(cfg["port_config"])
    return reduced_config(cfg["port_config"])


def spec_of(port_cfg) -> dict:
    """The reference's settings, under the published names, from the port's
    configuration the run built."""
    c = port_cfg
    return {"hidden_size": c.d_model, "num_attention_heads": c.num_heads,
            "qk_nope_head_dim": c.qk_nope_head_dim, "qk_rope_head_dim": c.qk_rope_head_dim,
            "v_head_dim": c.v_head_dim, "kv_lora_rank": c.kv_lora_rank,
            "first_k_dense_replace": c.first_k_dense_replace, "num_hidden_layers": c.num_layers,
            "n_routed_experts": c.n_routed_experts, "num_experts_per_tok": c.num_experts_per_tok,
            "n_shared_experts": c.n_shared_experts,
            "moe_intermediate_size": c.moe_intermediate_size, "intermediate_size": c.d_ff,
            "routed_scaling_factor": c.routed_scaling_factor, "norm_topk_prob": c.norm_topk_prob,
            "rms_norm_eps": c.rms_norm_eps, "rope_theta": c.rope_theta,
            "vocab_size": c.vocab_size}


def draw_weights(cfg: dict, spec: dict, gen: torch.Generator, device: torch.device) -> dict:
    """Every tensor of the model at ``spec``'s widths, drawn from ``gen`` as
    the configuration file's ``assumed`` states: each matrix truncated normal
    at std 1/sqrt(fan_in), cut at 2 std (the embedding table's fan in is
    ``hidden_size``), drawn in f32 a block of rows at a time and rounded to
    the file's ``dtype``; the RMSNorm scales 1; each MoE
    layer's correction bias f32, N(0, ``correction_bias_std``^2).  The layout
    is the reference's: ``x @ W`` (fan in first), the dense and the MoE
    layers each stacked along a leading layer dim."""
    dtype = getattr(torch, cfg["dtype"])
    d, h, v = spec["hidden_size"], spec["num_attention_heads"], spec["vocab_size"]
    nope, rd, vd, c = (spec["qk_nope_head_dim"], spec["qk_rope_head_dim"], spec["v_head_dim"],
                       spec["kv_lora_rank"])
    e, fe = spec["n_routed_experts"], spec["moe_intermediate_size"]
    fs = fe * spec["n_shared_experts"]
    k = spec["first_k_dense_replace"]

    def matrix(shape: tuple, fan_in: Optional[int] = None) -> torch.Tensor:
        std = 1.0 / math.sqrt(fan_in or shape[-2])
        out = torch.empty(shape, dtype=dtype, device=device)
        rows = out.view(-1, shape[-1])
        for block in rows.split(max(1, DRAW_BLOCK // shape[-1])):
            t = torch.empty(block.shape, dtype=torch.float32, device=device)
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
            block.copy_(t.mul_(std))
        return out

    def ones(shape: tuple) -> torch.Tensor:
        return torch.ones(shape, dtype=torch.float32, device=device)

    def layers(n: int, moe: bool) -> dict:
        p = {"ln1": {"scale": ones((n, d))},
             "attn": {"wq": matrix((n, d, h * (nope + rd))), "wkv_a": matrix((n, d, c + rd)),
                      "wkv_b": matrix((n, c, h * (nope + vd))), "wo": matrix((n, h * vd, d)),
                      "kv_norm": {"scale": ones((n, c))}},
             "ln2": {"scale": ones((n, d))}}
        if not moe:
            f = spec["intermediate_size"]
            p["mlp"] = {"gate": matrix((n, d, f)), "up": matrix((n, d, f)),
                        "down": matrix((n, f, d))}
            return p
        bias = torch.empty((n, e), dtype=torch.float32, device=device)
        bias.normal_(0.0, float(cfg["correction_bias_std"]), generator=gen)
        p["moe"] = {"router": matrix((n, d, e)), "bias": bias,
                    "gate": matrix((n, e, d, fe)), "up": matrix((n, e, d, fe)),
                    "down": matrix((n, e, fe, d)),
                    "shared": {"gate": matrix((n, d, fs)), "up": matrix((n, d, fs)),
                               "down": matrix((n, fs, d))}}
        return p

    return {"embed": {"table": matrix((v, d), fan_in=d)},
            "dense": layers(k, moe=False),
            "moe": layers(spec["num_hidden_layers"] - k, moe=True),
            "ln_f": {"scale": ones((d,))},
            "unembed": {"w": matrix((d, v))}}


def _layout(tree, path: str = "") -> dict:
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items() for k, v in _layout(sub, f"{path}/{name}").items()}
    return {path: (tuple(tree.shape), tree.dtype)}


def load(api, weights: dict) -> dict:
    """``weights`` as the program's params: refused unless they are exactly
    the tensors, shapes and dtypes the port's model takes (its ``init`` on
    the meta device, which draws nothing)."""
    want = _layout(api.init(torch.Generator(), device=torch.device("meta")))
    got = _layout(weights)
    if got != want:
        diff = sorted(p for p in want.keys() | got.keys() if want.get(p) != got.get(p))
        raise ValueError(f"the drawn weights differ from the port's params at {diff[:8]}: "
                         f"{[(want.get(p), got.get(p)) for p in diff[:8]]}")
    return weights


@dataclass
class System:
    """The port's model and its decoder over the drawn ``weights``."""
    api: object
    weights: dict
    spec: dict
    decoder: Optional[object] = None

    def prefill(self, prompts: torch.Tensor, max_len: int, chunk: int):
        """The decode cache of ``max_len`` positions holding every session's
        prompt: ``api.prefill`` ``chunk`` sessions at a time, each chunk's
        cache stitched to ``max_len`` and copied into its sessions' rows."""
        from repro_torch.serving import build_prefill_step, stitch_prefill_cache

        step = build_prefill_step(self.api)
        b = prompts.shape[0]
        cache = self.api.init_cache(b, max_len, device=prompts.device)
        for at in range(0, b, chunk):
            _, part = step(self.weights, {"tokens": prompts[at:at + chunk]})
            part = stitch_prefill_cache(self.api, part, max_len)
            for name, t in part.items():
                cache[name][:, at:at + chunk].copy_(t)
            del part
        return cache

    def decode(self, cache, first: torch.Tensor, start: int, steps: int):
        """One request: ``steps`` greedy tokens of every session from position
        ``start`` -> (tokens (B, steps) on the host, the last step's logits
        (B, V) on the device)."""
        tokens, _ = self.decoder(self.weights, cache, first, start, steps)
        return tokens.cpu(), self.decoder.logits

    def written(self, cache, start: int, steps: int) -> list:
        """The latents the last request wrote at positions [start, start +
        steps), f32 (B, steps, C + rope), at the layers the judge reads."""
        return [cache["latent"][i, :, start:start + steps].to(torch.float32, copy=True)
                for i in range(latent_layers(self.spec))]

    def counters(self) -> dict:
        d = self.decoder
        return {"captures": d.captures, "replays": d.replays} if d is not None else {}

    def close(self) -> None:
        self.decoder = None


def build(cfg: dict, gen: torch.Generator, device: torch.device) -> System:
    """The port's model for ``cfg`` on ``device`` over weights drawn from
    ``gen``; refuses a port whose widths differ from the configuration file's."""
    from repro_torch.models import build_model
    from repro_torch.serving import GreedyDecoder

    port_cfg = port_config(cfg, device)
    if device.type == "cpu":
        # one thread, as the harness's own runs on a card: the tests run cells
        # side by side in worker processes, where the reduced model's small
        # products on every core's threads stall one another
        torch.set_num_threads(1)
    spec = spec_of(port_cfg)
    if device.type == "cuda":
        got = {k: v for k, v in spec.items() if k in cfg}
        want = {k: cfg[k] for k in got}
        if got != want:
            raise ValueError(f"{cfg['port_config']} differs from the configuration file: "
                             f"{ {k: (got[k], want[k]) for k in got if got[k] != want[k]} }")
    api = build_model(port_cfg)
    weights = load(api, draw_weights(cfg, spec, gen, device))
    return System(api=api, weights=weights, spec=spec,
                  decoder=GreedyDecoder(api, in_place=True))


@dataclass
class Control:
    """The plain reference with every product's operands in float8 e4m3,
    one precision below the configuration's bf16, in the program's place:
    a sound limit fails it.  Its cache is each layer's f32 latents of the
    prompts; a request decodes from them, a reference forward over the
    request's tokens so far a token."""
    weights: dict
    spec: dict
    block: int = 1024
    last_latents: Optional[list] = None

    def prefill(self, prompts: torch.Tensor, max_len: int, chunk: int):
        return prefix(self.weights, prompts, self.spec, chunk, fp8=True, block=self.block)

    def decode(self, cache, first: torch.Tensor, start: int, steps: int):
        if start != cache[0].shape[1]:
            raise ValueError(f"the control decodes from its prompts' end {cache[0].shape[1]}, "
                             f"not {start}")
        ids = first
        for _ in range(steps):      # the request's tokens so far over the prompts' latents
            logits, latents = plain.forward(self.weights, ids.long(), self.spec, past=cache,
                                            fp8=True, block=self.block)
            ids = torch.cat([ids, logits.argmax(-1, keepdim=True).to(ids.dtype)], dim=1)
        self.last_latents = latents[:latent_layers(self.spec)]
        return ids[:, 1:].cpu(), logits

    def written(self, cache, start: int, steps: int) -> list:
        """The latents of the last request's positions, as its last forward
        computed them."""
        return self.last_latents

    def counters(self) -> dict:
        return {}

    def close(self) -> None:
        pass


def control(cfg: dict, gen: torch.Generator, device: torch.device) -> Control:
    """The control, over the weights ``build`` draws from the same seed."""
    spec = spec_of(port_config(cfg, device))
    return Control(weights=draw_weights(cfg, spec, gen, device), spec=spec)


def latent_layers(spec: dict) -> int:
    """The layers whose written latents the judge reads: those before the
    first MoE layer's output reaches a latent, and the one after it."""
    return spec["first_k_dense_replace"] + 2


def prefix(weights: dict, prompts: torch.Tensor, spec: dict, chunk: int, *, fp8: bool = False,
           block: int = 1024) -> list:
    """Each layer's reference latents of every prompt (B, S, C + rope), f32,
    ``chunk`` sessions a forward."""
    b, s = prompts.shape
    out = None
    for at in range(0, b, chunk):
        _, latents = plain.forward(weights, prompts[at:at + chunk].long(), spec, fp8=fp8,
                                   block=block, logits=False)
        if out is None:
            out = [torch.empty((b, s, t.shape[-1]), dtype=t.dtype, device=t.device)
                   for t in latents]
        for dst, t in zip(out, latents):
            dst[at:at + chunk] = t
        del latents
    return out


def rel_err_rows(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want|_2 / |want|_2 of each row (the last dim); infinite where
    ``got`` is missing or not finite, or the shapes differ."""
    rows = want[..., 0].numel()
    if got is None or got.shape != want.shape or not bool(torch.isfinite(got).all()):
        return torch.full((rows,), math.inf)
    got, want = got.float().to(want.device), want.float()
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).reshape(-1).cpu()


def _quantile(errs: torch.Tensor, q: float) -> float:
    """The order statistic at ``q`` of the sorted ``errs`` (the lower one
    between two)."""
    return float(errs[int(q * (len(errs) - 1))])


def judge(system, traffic, answers: dict, limits: dict) -> dict:
    """Each compared number beside its limit: the kept requests' last-step
    logits of every session, and the last request's written latents,
    against the reference's, teacher-forced on the program's tokens (the
    request's first token, then its first ``tokens - 1`` greedy tokens)
    over the reference's own prefix."""
    kept = {i: a for i, a in answers.items() if a["logits"] is not None}
    last, written = getattr(traffic, "written", None) or (None, None)
    inf = torch.full((1,), math.inf)
    logit_errs, pre_moe, after_moe = [], [inf], [inf]
    if kept:
        past = prefix(system.weights, traffic.prompts, system.spec, traffic.block)
        n = latent_layers(system.spec)
        if last in kept and written is not None:
            pre_moe, after_moe = [], []
        for i, a in sorted(kept.items()):
            ids = torch.cat([traffic.first(i).cpu(), a["tokens"][:, :-1]], dim=1)
            ids = ids.to(traffic.prompts.device)
            for at in range(0, ids.shape[0], traffic.block):
                rows = slice(at, at + traffic.block)
                logits, latents = plain.forward(system.weights, ids[rows].long(), system.spec,
                                                past=[p[rows] for p in past])
                logit_errs.append(rel_err_rows(a["logits"][rows], logits))
                if i == last and written is not None:
                    errs = [rel_err_rows(w[rows] if w is not None else None, r)
                            for w, r in zip(written, latents[:n])]
                    pre_moe += errs[:-1]
                    after_moe.append(errs[-1])
    logit_errs = torch.cat(logit_errs or [inf]).sort().values
    pre_moe, after_moe = torch.cat(pre_moe).sort().values, torch.cat(after_moe).sort().values
    for name, errs in (("logits_rel_err", logit_errs), ("latent_rel_err, routing-free layers",
                                                        pre_moe),
                       ("latent_rel_err, after one MoE layer", after_moe)):
        log(f"[judge] {name} over {len(errs)} rows: least {float(errs[0]):.5g}, quartiles "
            f"{_quantile(errs, 0.25):.5g} / {_quantile(errs, 0.5):.5g} / "
            f"{_quantile(errs, 0.75):.5g}, largest {float(errs[-1]):.5g}")
    return {name: {"value": value, "limit": float(limits[name])} for name, value in
            (("latent_rel_err", float(pre_moe[-1])),
             ("moe_latent_rel_err_q3", _quantile(after_moe, 0.75)),
             ("logits_rel_err_median", _quantile(logit_errs, 0.5)))}


def check_config(cfg: dict) -> None:
    """Refuses a configuration file that describes no DeepSeek-V3 the port
    runs: sigmoid scores with a correction bias in one group, no low-rank
    query, more experts than a token takes, a dense layer first."""
    if cfg.get("model_type") != "deepseek_v3":
        raise ValueError(f"{cfg['name']}: model_type {cfg.get('model_type')!r}")
    if (cfg["scoring_func"], cfg["topk_method"], cfg["n_group"], cfg["topk_group"]) != \
            ("sigmoid", "noaux_tc", 1, 1):
        raise ValueError(f"{cfg['name']}: routing other than sigmoid/noaux_tc in one group")
    if cfg["q_lora_rank"] is not None:
        raise ValueError(f"{cfg['name']}: a low-rank query is not ported")
    if not cfg["num_experts_per_tok"] < cfg["n_routed_experts"]:
        raise ValueError(f"{cfg['name']}: {cfg['num_experts_per_tok']} experts a token of "
                         f"{cfg['n_routed_experts']}")
    if not 1 <= cfg["first_k_dense_replace"] < cfg["num_hidden_layers"]:
        raise ValueError(f"{cfg['name']}: first_k_dense_replace {cfg['first_k_dense_replace']}")
    missing = [k for k in SPEC_KEYS + ("dtype", "correction_bias_std") if k not in cfg]
    if missing:
        raise ValueError(f"{cfg['name']}: no {missing}")


# -- faults planted underneath the timed path ---------------------------------
# Each takes (monkeypatch, the configuration file, the cell's limits).


def _shared_left_out(monkeypatch, cfg: dict, limits: dict) -> None:
    """The shared experts left out of every MoE layer."""
    from repro_torch.layers import moe

    monkeypatch.setattr(moe, "shared_experts", lambda params, xf: torch.zeros_like(xf))


def _bias_in_weights(monkeypatch, cfg: dict, limits: dict) -> None:
    """The correction bias added to the chosen experts' weights as well as
    to the scores that choose them."""
    from repro_torch.layers import moe

    def biased(params, x, c):
        scores = torch.sigmoid(x.float() @ params["router"].float()) + params["bias"].float()
        weights, indices = torch.topk(scores, c.num_experts_per_tok, dim=-1)
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
        return weights * c.routed_scaling_factor, indices

    monkeypatch.setattr(moe, "route_sigmoid", biased)


def _unscaled(monkeypatch, cfg: dict, limits: dict) -> None:
    """``routed_scaling_factor`` left out of the routed experts' weights."""
    from repro_torch.layers import moe

    real = moe.route_sigmoid

    def unscaled(params, x, c):
        weights, indices = real(params, x, c)
        return weights / c.routed_scaling_factor, indices

    monkeypatch.setattr(moe, "route_sigmoid", unscaled)


def _one_short(monkeypatch, cfg: dict, limits: dict) -> None:
    """The absorbed decode reading the latent cache one position short: the
    token's own latent, written at ``cache_len``, is never attended to."""
    from repro_torch.layers import mla

    monkeypatch.setattr(mla, "attended",
                        lambda s_max, n: torch.arange(s_max, device=n.device) < n)


def _unwritten(monkeypatch, cfg: dict, limits: dict) -> None:
    """The decode step never writes its token's latent: the cache keeps
    what was there (the stitched zeros, then the previous request's)."""
    from repro_torch.layers import mla

    monkeypatch.setattr(mla, "write_latent", lambda cache, cache_len, latent: None)


def _half_unwritten(monkeypatch, cfg: dict, limits: dict) -> None:
    """The decode step writes its token's latent for the first half of the
    sessions only."""
    from repro_torch.layers import mla

    real = mla.write_latent

    def half(cache, cache_len, latent):
        b = cache.shape[0] // 2
        real(cache[:b], cache_len, latent[:b])

    monkeypatch.setattr(mla, "write_latent", half)


def faults(traffic_kind: str, on_card: bool = False) -> dict:
    """name -> planter of each fault a cell of ``traffic_kind`` can have.
    All are planted in the port's Python, which the CPU's eager decode and
    the card's captured one both run (a fault planted before set-up is in
    the captured graph), so both devices plant the same."""
    return {"shared_left_out": _shared_left_out, "bias_in_weights": _bias_in_weights,
            "unscaled": _unscaled, "one_short": _one_short, "unwritten": _unwritten,
            "half_unwritten": _half_unwritten}
