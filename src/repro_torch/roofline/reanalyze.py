"""Re-apply the (possibly updated) cost model to saved dry-run records
without tracing again: the counterpart of ``repro/roofline/reanalyze.py``.

Reads ``<cell>.ops.json.gz`` next to each ``<cell>.json`` (the reference
keeps ``<cell>.hlo.zst``; gzip is in the standard library), rebuilds the
roofline record and rewrites the JSON in place.

Usage: ``python -m repro_torch.roofline.reanalyze [dir ...]``
"""
from __future__ import annotations

import gzip
import json
import sys
from pathlib import Path

from repro_torch.config import get_config, shapes_for
from repro_torch.roofline.extract import build_report, model_flops_estimate

OPS_SUFFIX = ".ops.json.gz"


def write_ops(path: Path, record: list[dict]) -> None:
    path.write_bytes(gzip.compress(json.dumps(record).encode(), compresslevel=6, mtime=0))


def read_ops(path: Path) -> list[dict]:
    return json.loads(gzip.decompress(path.read_bytes()))


def reanalyze_dir(d: Path) -> int:
    n = 0
    for ops_path in sorted(d.glob(f"*{OPS_SUFFIX}")):
        cell_id = ops_path.name.removesuffix(OPS_SUFFIX)
        json_path = d / f"{cell_id}.json"
        if not json_path.exists():
            continue
        rec = json.loads(json_path.read_text())
        if rec.get("status") != "ok":
            continue
        arch, shape_name, mesh_name = cell_id.split("__")
        cfg = get_config(arch)
        shape = next(s for s in shapes_for(cfg) if s.name == shape_name)
        report = build_report(
            arch=arch,
            shape=shape_name,
            mesh_name=mesh_name,
            chips=rec["chips"],
            record=read_ops(ops_path),
            model_flops=model_flops_estimate(cfg, shape),
            memory_analysis=rec.get("memory_analysis"),
        )
        new_rec = json.loads(report.to_json())
        new_rec["status"] = "ok"
        new_rec["compile_s"] = rec.get("compile_s")
        json_path.write_text(json.dumps(new_rec, indent=1))
        n += 1
    return n


def main() -> None:
    dirs = [Path(p) for p in (sys.argv[1:] or ["experiments/dryrun", "experiments/dryrun_opt"])]
    for d in dirs:
        if d.exists():
            n = reanalyze_dir(d)
            print(f"[reanalyze] {d}: {n} cells updated")


if __name__ == "__main__":
    main()
