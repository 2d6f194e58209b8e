"""Which ops dominate each roofline term: the counterpart of ``repro/roofline/diagnose.py``.

``top_contributors`` ranks the entries of a traced record (the same
accounting as ``roofline/trace.py``) by bytes, FLOPs or collective
payload, as the reference ranks the trip-count-weighted HLO instructions.
"""
from __future__ import annotations

from collections import Counter

from repro_torch.roofline.trace import (
    _nbytes,
    collective_kind,
    entry_bytes,
    entry_flops,
)


def _shape_text(entry: dict) -> str:
    outs = [o for o in entry["out"] if isinstance(o, dict)]
    return " ".join(f"{o['dtype']}{o['shape']}" for o in outs)[:60]


def top_contributors(record: list[dict], k: int = 15, kind: str = "bytes"):
    """kind: "bytes" | "flops" | "collective".  Returns [(value, op,
    out_shapes, count), ...] sorted descending; entries of one op and one
    output shape are summed."""
    contrib: Counter = Counter()
    for e in record:
        if kind == "collective":
            if not collective_kind(e["op"]):
                continue
            val = _nbytes(e["args"][:1])
        elif kind == "flops":
            val = entry_flops(e)
        else:
            val = entry_bytes(e)
        if val:
            contrib[(e["op"], _shape_text(e))] += val * e["n"]
    counts: Counter = Counter()
    for e in record:
        counts[(e["op"], _shape_text(e))] += e["n"]
    return [(v, op, shape, counts[(op, shape)]) for (op, shape), v in contrib.most_common(k)]


def print_top(record: list[dict], k: int = 15, kind: str = "bytes") -> None:
    unit = "GFLOP" if kind == "flops" else "GB"
    for v, op, shape, n in top_contributors(record, k, kind):
        print(f"{v / 1e9:12.3f} {unit:5s} {op:40s} {shape:60s} x{n}")
