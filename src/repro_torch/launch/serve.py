"""Serving launcher of the port: ``python -m repro_torch.launch.serve --arch <id>``.

Runs the LSTM-AE anomaly service (``repro_torch.engine.AnomalyService``) on
a named execution schedule and prints the reference launcher's ``[serve]``
lines.  The device defaults to the GPU and never falls back to the CPU:
``--device cpu`` asks for it.  Request batches are drawn before the timed
loop, so ms/request covers the host-to-device copy, the forward pass and
the scores' return to the host.

The gateway, the socket transport, worker processes and training are not
ported yet; their flags exit with an error that names the ``ROADMAP.md``
item that will port them.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.config import get_config, list_archs, reduced_config
from repro_torch.core.latency import PAPER_RH_M
from repro_torch.data import TimeseriesConfig, make_batch
from repro_torch.engine import AnomalyService, available_schedules

NOT_PORTED = {
    "gateway": "ROADMAP.md, queue 1, item 6 (gateway core)",
    "http": "ROADMAP.md, queue 1, item 7 (transport)",
    "workers": "ROADMAP.md, queue 1, item 8 (durability and multi-process)",
    "train_steps": "ROADMAP.md, queue 1, item 5 (fit: AdamW and the train step)",
}


def serve_lstm_ae(cfg, args) -> None:
    svc = AnomalyService(cfg, schedule=args.schedule, device=args.device)
    data_cfg = TimeseriesConfig(features=cfg.lstm_ae.input_features,
                                seq_len=args.seq_len, batch=args.batch,
                                anomaly_rate=0.05)
    batches = [make_batch(data_cfg, i)[0] for i in range(args.requests)]
    svc.score(batches[0]).cpu()  # warm-up: kernel build and load, allocator
    total_alerts = 0
    t0 = time.perf_counter()
    for series in batches:
        errors = svc.score(series).cpu()
        if svc.threshold is not None:
            total_alerts += int((errors > svc.threshold).sum())
    dt = time.perf_counter() - t0
    steps = args.requests * args.batch * args.seq_len
    dev = svc.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host CPU"
    print(f"[serve] device {dev} ({name})")
    print(f"[serve] {cfg.name} [{svc.engine.schedule.tag}]: {args.requests} requests, "
          f"{dt/args.requests*1e3:.2f} ms/request, {steps/dt:,.0f} timesteps/s"
          + (f", alerts={total_alerts}" if svc.threshold is not None else ""))
    if cfg.name in PAPER_RH_M:  # Eq-1 is calibrated only for Table-1 archs
        est = svc.latency_model(args.seq_len)
        print(f"[serve] Eq-1 model ({est.schedule}) for one sequence "
              f"T={args.seq_len}: {est.ms:.3f} ms ({est.cycles} cycles)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--schedule", default="wavefront", choices=available_schedules(),
                    help="LSTM-AE execution schedule (engine registry name)")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises without a GPU)")
    ap.add_argument("--train-steps", type=int, default=0, help="not ported yet")
    ap.add_argument("--gateway", action="store_true", help="not ported yet")
    ap.add_argument("--http", action="store_true", help="not ported yet")
    ap.add_argument("--workers", type=int, default=0, help="not ported yet")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full-config", dest="reduced", action="store_false")
    args = ap.parse_args(argv)

    for flag, item in NOT_PORTED.items():
        if getattr(args, flag):
            ap.error(f"--{flag.replace('_', '-')} is not ported to repro_torch yet: {item}")
    resolve_device(args.device)  # fail before any work when no GPU is visible
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    serve_lstm_ae(cfg, args)


if __name__ == "__main__":
    main()
