"""Markdown roofline report: the counterpart of ``repro/roofline/report.py``.

Reads a dry-run directory's cell records (the port's or the reference's:
the same keys) and renders the per-(arch x shape) table: three terms,
dominant bottleneck, MODEL_FLOPS ratio, and the one-line movement note
derived from the dominant term + breakdown.

Usage: ``python -m repro_torch.roofline.report [dir]``.
"""
from __future__ import annotations

import json
from pathlib import Path


def _movement_note(r: dict) -> str:
    dom = r["dominant"]
    coll = r.get("coll_breakdown", {})
    if dom == "collective":
        worst = max(coll, key=coll.get) if coll else "all-reduce"
        return f"cut {worst} payloads (dominant collective op)"
    if dom == "memory":
        if r["shape"].startswith("train"):
            return "keep recurrent/attn intermediates tile-resident (kernel/chunked form)"
        if r["shape"].startswith("decode") or r["shape"].startswith("long"):
            return "in-place per-layer cache updates; shrink cache dtype"
        return "fuse softmax chain; bf16 intermediates"
    return "increase per-chip work (batch) or cut redundant FLOPs (wedge/remat)"


def render_table(dryrun_dir: str = "experiments/dryrun",
                 mesh: str = "single_pod_16x16") -> str:
    rows = []
    for f in sorted(Path(dryrun_dir).glob(f"*__{mesh}.json")):
        r = json.loads(f.read_text())
        if r.get("status") != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | — | FAILED: {r['status'][:40]} ||||||")
            continue
        total = r["compute_s"] + r["memory_s"] + r["collective_s"]
        frac = r["compute_s"] / total if total else 0.0
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3g} | {r['memory_s']:.3g} "
            f"| {r['collective_s']:.3g} | **{r['dominant']}** | {frac:.3f} "
            f"| {r['flops_ratio']:.2f} | {_movement_note(r)} |"
        )
    header = (
        "| arch | shape | compute (s) | memory (s) | collective (s) | dominant "
        "| compute-frac | MODEL/HLO flops | what moves the dominant term |\n"
        "|---|---|---|---|---|---|---|---|---|"
    )
    return header + "\n" + "\n".join(rows)


if __name__ == "__main__":
    import sys
    d = sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun"
    print(render_table(d))
