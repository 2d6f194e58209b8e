"""Roofline terms of a traced dry-run cell: the counterpart of ``repro/roofline/extract.py``.

Three terms per (arch x shape x mesh), each per chip:

    compute    = sum over dtypes of dot FLOPs / that dtype's peak
    memory     = bytes            / HBM_BW
    collective = collective bytes / LINK_BW

The FLOPs, bytes and collective payloads come from the record of the
step's aten ops on rank 0's local shards (``roofline/trace.py``), the
counterpart of the reference's partitioned HLO: both are one device's
program, so every quantity is per chip.  ``flops_ratio`` is MODEL_FLOPS
over the FLOPs of all chips, as in the reference.

The constants are datasheet figures of the NVIDIA H100 80GB HBM3 (SXM5,
700 W), not measurements: the dense bf16 tensor-core peak, the FP32
cores' peak (the port runs with TF32 off, so an f32 product runs there),
HBM3's bandwidth, and one 400 Gb/s NDR InfiniBand port per GPU: the
16-wide axes of the production meshes span two 8-GPU nodes, so every
collective of these meshes crosses InfiniBand.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Optional

# NVIDIA H100 80GB HBM3 (SXM5, 700 W) datasheet figures
PEAK_FLOPS_BY_DTYPE = {
    "bfloat16": 989e12,      # dense bf16 tensor cores
    "float16": 989e12,       # dense fp16 tensor cores
    "float32": 67e12,        # FP32 cores (TF32 off)
    "float64": 67e12,        # FP64 tensor cores
}
PEAK_FLOPS = PEAK_FLOPS_BY_DTYPE["bfloat16"]
HBM_BW = 3.35e12             # bytes/s per GPU
LINK_BW = 50e9               # bytes/s per GPU: one 400 Gb/s NDR port

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")


@dataclass
class CollectiveStats:
    bytes_by_op: dict = field(default_factory=dict)
    count_by_op: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())


def parse_collectives(record: list[dict]) -> CollectiveStats:
    """Per-chip collective payload bytes and counts by kind, read from a
    traced record (the reference parses them from partitioned HLO text)."""
    from repro_torch.roofline.trace import analyze

    totals = analyze(record)
    return CollectiveStats(bytes_by_op={k: int(v) for k, v in totals.coll_by_op.items()},
                           count_by_op={k: int(v) for k, v in totals.coll_count.items()})


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-chip quantities (rank 0's local ops)
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_breakdown: dict
    # terms (seconds)
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    # usefulness
    model_flops: float          # 6*N*D (dense) / 6*N_active*D (MoE); 2*N*D decode
    flops_ratio: float          # MODEL_FLOPS / FLOPs of all chips
    memory_analysis: Optional[str] = None
    note: str = ""
    flops_by_dtype: dict = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=1)


def compute_seconds(flops_by_dtype: dict) -> float:
    """Each dtype's dot FLOPs over its peak, summed (a dtype without a
    listed peak takes the FP32 cores')."""
    return sum(f / PEAK_FLOPS_BY_DTYPE.get(dt, PEAK_FLOPS_BY_DTYPE["float32"])
               for dt, f in flops_by_dtype.items())


def build_report(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    record: list[dict],
    model_flops: float,
    memory_analysis: Optional[str] = None,
    note: str = "",
) -> RooflineReport:
    """Derive the three terms from a traced record."""
    from repro_torch.roofline.trace import analyze

    totals = analyze(record)
    compute_s = compute_seconds(totals.flops_by_dtype)
    memory_s = totals.bytes / HBM_BW
    collective_s = totals.coll_bytes / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    total_flops = totals.flops * chips
    counts = ", ".join(f"{k} x{int(v)}" for k, v in sorted(totals.coll_count.items()))
    notes = [n for n in (note, f"collectives: {counts}" if counts else "") if n]
    return RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        flops_per_chip=float(totals.flops),
        bytes_per_chip=float(totals.bytes),
        coll_bytes_per_chip=float(totals.coll_bytes),
        coll_breakdown={k: int(v) for k, v in totals.coll_by_op.items()},
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=model_flops,
        flops_ratio=(model_flops / total_flops) if total_flops else 0.0,
        memory_analysis=memory_analysis,
        note="; ".join(notes),
        flops_by_dtype={k: float(v) for k, v in totals.flops_by_dtype.items()},
    )


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D train (N = active params, D = tokens);
    2*N*D for single-token decode; 2*N*D for prefill forward-only."""
    n_active = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def active_param_count(cfg) -> float:
    """Active (per-token) parameter count from the config's dims."""
    if cfg.family == "lstm_ae":
        total = 0
        for lx, lh in zip(cfg.lstm_ae.layer_input_sizes(), cfg.lstm_ae.layer_sizes()):
            total += 4 * lh * (lx + lh) + 8 * lh
        return float(total)

    d, f, v, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.num_layers
    hd = cfg.resolved_head_dim()
    attn = d * hd * cfg.num_heads + 2 * d * hd * cfg.num_kv_heads + hd * cfg.num_heads * d

    def ffn_active():
        if cfg.moe is not None:
            dense = 3 * d * f
            return cfg.moe.top_k * dense
        if cfg.activation == "swiglu":
            return 3 * d * f
        return 2 * d * f

    total = 0.0
    if cfg.family == "whisper":
        enc = cfg.encoder_layers * (attn + 2 * d * f)
        dec = L * (2 * attn + 2 * d * f)
        total = enc + dec
    elif cfg.family == "rwkv6":
        tm = 5 * d * d + 2 * d * cfg.rwkv.decay_lora
        cm = 2 * d * f + d * d
        total = L * (tm + cm)
    elif cfg.family == "jamba":
        from repro_torch.layers.mamba import mamba_dims
        d_inner, d_state, dt_rank = mamba_dims(cfg)
        mamba_p = 2 * d * d_inner + d_inner * (dt_rank + 2 * d_state) + dt_rank * d_inner + d_inner * d
        n_attn = L // cfg.attn_every
        n_mamba = L - n_attn
        n_moe = L // cfg.moe.every if cfg.moe else 0
        n_mlp = L - n_moe
        moe_active = cfg.moe.top_k * 3 * d * f if cfg.moe else 0
        total = n_attn * attn + n_mamba * mamba_p + n_moe * moe_active + n_mlp * 3 * d * f
    else:
        total = L * (attn + ffn_active())
    total += 2 * v * d  # embed + unembed (tied counts once for compute anyway)
    return float(total)
