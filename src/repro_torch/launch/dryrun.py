"""Serving placement report of the port: ``python -m repro_torch.launch.dryrun --placement data=N --arch <id>``.

Counterpart of ``placement_report`` in ``repro/launch/dryrun.py``: an
offline roofline of one gateway placement — micro-batch lanes per shard,
the bucket a request length falls in, the paper's Eq-1 compute floor for
one flush and the per-worker rate the control plane derives from it —
then whether a declared p95 SLO leaves a queueing budget and which
``--autoscale MIN:MAX`` covers a target rate.  Purely analytic: no device,
no capture.  The floor is the paper's FPGA cycle model
(``core/latency.py``), a prior for the batching controller, not a time
measured on a GPU.

Any ``data=N`` is reported, as the reference does: the report needs no
device.  The reference's dry-run of compiled
cells (``lower_cell``, ``run_cell``) reads XLA programs; the port's
counterpart is a redesign, item 11g-3 (its inputs, ``shapes_for`` and
``models/api.py::input_specs``/``cache_struct``/``param_struct``, are
ported): without ``--placement`` this launcher exits naming it.
"""
from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

from repro_torch.config import get_config, list_archs, reduced_config
from repro_torch.core.latency import PAPER_RH_M, serving_floor_ms
from repro_torch.engine import Placement
from repro_torch.gateway.queue import bucket_for

CELLS_ITEM = "ROADMAP.md, queue 1, item 11g-3 (dry-run cells of the LM families)"


def placement_report(args) -> dict:
    """Offline serving roofline for one gateway placement: per-shard
    micro-batch geometry + the Eq-1 latency floor, then the autoscaler
    bounds (``--autoscale MIN:MAX``) that cover ``--target-rps`` — so a
    control-plane deployment can be sanity-checked before any worker is
    spawned."""
    if not args.arch:
        raise SystemExit("--placement needs --arch")
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if cfg.lstm_ae is None:
        raise SystemExit(f"--placement reports the LSTM-AE gateway; {args.arch} is an "
                         f"LM: {CELLS_ITEM}")
    pl = Placement.from_spec(args.placement)
    lanes = pl.pad_rows(args.max_batch)
    rows_per_shard = lanes // pl.data_shards
    t_bucket = bucket_for(args.seq_len)
    floor_ms = serving_floor_ms(cfg.lstm_ae, t_bucket, arch=args.arch)
    # per-worker sustainable rate: one full flush per floor, derated 50%
    # for assemble/wire overheads (matches repro_torch.control's estimate)
    worker_rps = 0.5 * lanes / (max(floor_ms, 1e-3) / 1e3)
    report = {
        "arch": args.arch,
        "placement": str(pl),
        "data_shards": pl.data_shards,
        "lanes": lanes,
        "rows_per_shard": rows_per_shard,
        "bucket_T": t_bucket,
        "floor_ms": floor_ms,
        "worker_rps": worker_rps,
        "eq1_calibrated": args.arch in PAPER_RH_M,
    }
    print(f"[dryrun] placement {pl!r}: {lanes} micro-batch lanes "
          f"({rows_per_shard}/shard x {pl.data_shards} shards), "
          f"bucket T={t_bucket}: floor={floor_ms:.3f} ms/flush, "
          f"~{worker_rps:,.0f} req/s per worker", flush=True)
    if args.slo_p95_ms is not None:
        budget = args.slo_p95_ms - floor_ms
        report["slo_p95_ms"] = args.slo_p95_ms
        report["slo_budget_ms"] = budget
        verdict = ("feasible" if budget > 0 else "INFEASIBLE")
        print(f"[dryrun] SLO p95={args.slo_p95_ms:.1f} ms: {verdict} "
              f"(compute floor {floor_ms:.3f} ms leaves "
              f"{budget:.3f} ms queueing budget)", flush=True)
    if args.target_rps is not None:
        lo = max(1, math.ceil(args.target_rps / worker_rps))
        # headroom for 2x bursts; never below lo
        hi = max(lo, math.ceil(2.0 * args.target_rps / worker_rps))
        report["target_rps"] = args.target_rps
        report["autoscale_min"] = lo
        report["autoscale_max"] = hi
        print(f"[dryrun] target {args.target_rps:,.0f} req/s: recommend "
              f"--autoscale {lo}:{hi} (steady-state {lo} worker(s) at "
              f"{args.target_rps / (lo * worker_rps):.0%} utilization)",
              flush=True)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"placement__{args.arch}__data{pl.data_shards}.json"
    out_path.write_text(json.dumps(report, indent=1))
    print(f"[dryrun] placement report -> {out_path}", flush=True)
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None, choices=list_archs())
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--placement", default=None, metavar="data=N",
                    help="report the gateway roofline for this placement (with --arch)")
    ap.add_argument("--target-rps", type=float, default=None,
                    help="with --placement: arrival rate to cover; "
                         "prints the recommended --autoscale MIN:MAX")
    ap.add_argument("--slo-p95-ms", type=float, default=None,
                    help="with --placement: check the declared p95 SLO "
                         "against the Eq-1 compute floor")
    ap.add_argument("--max-batch", type=int, default=16,
                    help="with --placement: gateway micro-batch flush size (pre-padding)")
    ap.add_argument("--seq-len", type=int, default=64,
                    help="with --placement: request length the floor is "
                         "computed for (rounded up to its bucket)")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full-config", dest="reduced", action="store_false")
    args = ap.parse_args(argv)

    if not args.placement:
        ap.error(f"only --placement is ported to repro_torch; the dry-run of "
                 f"compiled cells is not ported yet: {CELLS_ITEM}")
    placement_report(args)


if __name__ == "__main__":
    main()
