"""Dry-run launcher of the port: ``python -m repro_torch.launch.dryrun``.

Counterpart of ``repro/launch/dryrun.py``, with its CLI and cell ids
(``<arch>__<shape>__single_pod_16x16`` / ``multi_pod_2x16x16``).

**Cells** (the default): each (arch x shape x mesh) cell builds the
production mesh over a fake process group of 256 or 512 ranks
(``torch.testing``'s ``FakeStore``: collectives return at once, nothing
crosses a wire), places params, batch and decode cache as meta DTensors
(shapes and dtypes, no storage) by their specs, with ``_sanitize``
replicating any dim its mesh axes do not divide, and runs the train,
prefill or decode step once under ``roofline/trace.py``'s ``OpTrace``:
the reference lowers and compiles on host devices, the port traces
eagerly on the meta device.  It writes ``<cell>.json`` with the
reference's keys (``compile_s`` is the trace's seconds) and the record of
rank 0's local ops beside it as ``<cell>.ops.json.gz``
(``roofline/reanalyze.py`` rebuilds the JSON from it).  ``--opt`` applies
the reference's overrides.  The launcher touches no GPU, and the fake
process group lives only while a cell is traced.

**Placement** (``--placement data=N --arch <id>``): the counterpart of
``placement_report`` — an offline roofline of one gateway placement:
micro-batch lanes per shard, the bucket a request length falls in, the
paper's Eq-1 compute floor for one flush and the per-worker rate the
control plane derives from it, then whether a declared p95 SLO leaves a
queueing budget and which ``--autoscale MIN:MAX`` covers a target rate.
Purely analytic.  The floor is the paper's FPGA cycle model
(``core/latency.py``), a prior for the batching controller, not a time
measured on a GPU.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

from repro_torch.config import TrainConfig, get_config, reduced_config, reference_archs, shapes_for
from repro_torch.config.core import ShapeConfig
from repro_torch.core.latency import PAPER_RH_M, serving_floor_ms
from repro_torch.engine import Placement
from repro_torch.gateway.queue import bucket_for


def _sanitize(shardings_tree, struct_tree, mesh):
    """Replicate sharded dims that their mesh axes do not divide (the
    reference's: jit's argument shardings need divisibility; e.g. whisper's
    51866 vocab over 16, or the long_500k global_batch=1 over the data
    axis).  Trees of DTensor placement tuples and of meta tensors."""
    from repro_torch.distributed import sharding

    return sharding._zip_shardings(
        lambda t, placements: sharding.fit_placements(placements, t.shape, mesh),
        struct_tree, shardings_tree)


def _batch_shardings(specs: dict, mesh, rules):
    """Input batches: leading dim is the global batch -> (batch, None, ...);
    ``cache_len`` replicated."""
    from repro_torch.distributed import sharding

    return {name: sharding.replicated(mesh) if name == "cache_len" else
            sharding.named_sharding(mesh, rules, ("batch",) + (None,) * (t.ndim - 1))
            for name, t in specs.items()}


@contextlib.contextmanager
def fake_world(world_size: int):
    """A process group of ``world_size`` fake ranks, this process rank 0:
    collectives complete at once and move nothing.  Destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def opt_config(cfg):
    """The reference's ``--opt`` overrides: unrolled decode cache updates,
    constraints in the backward, RWKV's chunked scan, expert-parallel MoE."""
    cfg = cfg.with_overrides(decode_loop="unroll", bwd_constrain=True)
    if cfg.rwkv is not None:
        cfg = cfg.with_overrides(rwkv=dataclasses.replace(cfg.rwkv, scan_impl="chunked"))
    if cfg.moe is not None:
        cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, impl="ep_a2a"))
    return cfg


def lower_cell(arch: str, shape: ShapeConfig, multi_pod: bool, opt: bool = False):
    """Trace one (arch x shape x mesh) cell on meta DTensors over a fake
    process group.  ``opt=False`` is the baseline configuration; ``opt=True``
    applies the reference's overrides (:func:`opt_config`, and
    ``q_chunks=8`` at ``seq_len >= 8192``).  Returns (record, chips, api):
    the record of rank 0's local ops (``roofline/trace.py``)."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build_model
    from repro_torch.models.api import cache_struct, input_specs, param_struct
    from repro_torch.roofline.trace import OpTrace
    from repro_torch.serving import build_decode_step, build_prefill_step
    from repro_torch.training import build_train_step, init_train_state, train_state_specs

    cfg = get_config(arch)
    if opt:
        cfg = opt_config(cfg)
    api = build_model(cfg)
    chips = 512 if multi_pod else 256
    q_chunks = 8 if (opt and shape.seq_len >= 8192) else 1
    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        rules = sharding.rules_for_mesh(mesh)

        def put(tree, specs):
            shardings = sharding.spec_tree_to_shardings(mesh, rules, specs)
            return sharding.device_put(tree, mesh, _sanitize(shardings, tree, mesh))

        specs = input_specs(cfg, shape)
        batch = sharding.device_put(specs, mesh, _sanitize(
            _batch_shardings(specs, mesh, rules), specs, mesh))
        params = put(param_struct(api), api.param_specs())
        if shape.kind == "train":
            tc = TrainConfig()
            step = build_train_step(api, tc, mesh, rules)
            args = (put(init_train_state(params, tc), train_state_specs(api, tc)), batch)
        elif shape.kind == "prefill":
            step = build_prefill_step(api, mesh, rules, q_chunks=q_chunks)
            args = (params, batch)
        else:
            step = build_decode_step(api, mesh, rules)
            cache = put(cache_struct(api, shape.global_batch, shape.seq_len), api.cache_specs())
            args = (params, batch["token"], cache, batch["cache_len"])
        with OpTrace() as tr:
            step(*args)
        return tr.record(), chips, api


def run_cell(arch: str, shape: ShapeConfig, multi_pod: bool, out_dir: Path,
             opt: bool = False) -> dict:
    from repro_torch.roofline.extract import build_report, model_flops_estimate
    from repro_torch.roofline.reanalyze import OPS_SUFFIX, write_ops

    mesh_name = "multi_pod_2x16x16" if multi_pod else "single_pod_16x16"
    cell_id = f"{arch}__{shape.name}__{mesh_name}"
    out_path = out_dir / f"{cell_id}.json"
    if out_path.exists():
        return json.loads(out_path.read_text())

    t0 = time.time()
    try:
        record, chips, api = lower_cell(arch, shape, multi_pod, opt=opt)
        trace_s = time.time() - t0
        out_dir.mkdir(parents=True, exist_ok=True)
        write_ops(out_dir / f"{cell_id}{OPS_SUFFIX}", record)
        report = build_report(
            arch=arch,
            shape=shape.name,
            mesh_name=mesh_name,
            chips=chips,
            record=record,
            model_flops=model_flops_estimate(api.cfg, shape),
            memory_analysis="unavailable: the port traces eagerly on meta tensors",
        )
        rec = json.loads(report.to_json())
        rec["status"] = "ok"
        rec["compile_s"] = trace_s
        print(f"[dryrun] trace: {len(record)} distinct ops, "
              f"{sum(e['n'] for e in record)} run; flops={rec['flops_per_chip']:.6g} "
              f"bytes={rec['bytes_per_chip']:.6g} per chip", flush=True)
    except Exception as e:
        rec = {
            "arch": arch,
            "shape": shape.name,
            "mesh": mesh_name,
            "status": f"error: {e}",
            "traceback": traceback.format_exc(),
            "compile_s": time.time() - t0,
        }
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1))
    flag = rec["status"] if rec["status"] != "ok" else (
        f"ok  dominant={rec['dominant']} compute={rec['compute_s']:.4g}s "
        f"memory={rec['memory_s']:.4g}s coll={rec['collective_s']:.4g}s"
    )
    print(f"[dryrun] {cell_id}: {flag} ({rec['compile_s']:.1f}s trace)", flush=True)
    return rec


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
        raise SystemExit(f"--placement reports on LSTM-AE archs, not {cfg.family}")
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
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description="multi-pod dry-run launcher")
    ap.add_argument("--arch", default=None, help="architecture id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all for arch)")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--opt", action="store_true",
                    help="apply the reference's optimizations (baseline when absent)")
    ap.add_argument("--list", action="store_true", help="list cells and exit")
    ap.add_argument("--placement", default=None, metavar="data=N",
                    help="serving mode: report the per-shard gateway roofline for this "
                         "placement instead of tracing cells (with --arch)")
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

    if args.placement:
        placement_report(args)
        return

    archs = [args.arch] if args.arch else reference_archs()
    out_dir = Path(args.out)
    cells = []
    for arch in archs:
        cfg = get_config(arch)
        for shape in shapes_for(cfg):
            if args.shape and shape.name != args.shape:
                continue
            for mesh_flag in ([False, True] if args.mesh == "both" else [args.mesh == "multi"]):
                cells.append((arch, shape, mesh_flag))

    if args.list:
        for arch, shape, mp in cells:
            print(f"{arch} {shape.name} {'multi' if mp else 'single'}")
        print(f"total: {len(cells)} cells")
        return

    n_ok = 0
    for arch, shape, mp in cells:
        rec = run_cell(arch, shape, mp, out_dir, opt=args.opt)
        n_ok += rec["status"] == "ok"
    print(f"[dryrun] {n_ok}/{len(cells)} cells ok")
    if n_ok != len(cells):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
