"""Training launcher of the port: ``python -m repro_torch.launch.train --arch <id>``.

Counterpart of the LSTM-AE path of ``repro/launch/train.py``: the config
registry, the train step (autograd + AdamW, ``--grad-compression``), the
checkpointable ``TimeseriesIterator`` of benign windows, async
checkpoints every ``--ckpt-every`` steps with a resume from the newest
one in ``--ckpt-dir`` (params, optimizer state and the iterator's
position), and a heartbeat monitor that names stragglers.

Only the four LSTM-AE models train: an LM ``--arch`` exits naming
ROADMAP.md, queue 1, item 11b (LM training).  One device: the GPU by default (raises without one),
``--device cpu`` on request.  The reference builds a production mesh and
shards its step only at 256 devices or more (``pick_mesh``); that mesh and
the sharded step come with the LM families' sharding rules (``ROADMAP.md``,
queue 1, item 11).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import AsyncCheckpointer, latest_checkpoint, restore_checkpoint
from repro_torch.config import TrainConfig, get_config, list_archs, reduced_config
from repro_torch.core.lstm import init_lstm_ae
from repro_torch.data import TimeseriesConfig, TimeseriesIterator
from repro_torch.distributed import HeartbeatMonitor
from repro_torch.models import build_model
from repro_torch.training import build_train_step, init_train_state
from repro_torch.utils import tree_leaves


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="reduced config (the default)")
    ap.add_argument("--full-config", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: repro_torch_ckpt_<arch> "
                         "under the temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", choices=["none", "int8_ef"], default="none")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises without a GPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if cfg.family != "lstm_ae":
        raise SystemExit(f"{args.arch}: LM training is not ported yet: ROADMAP.md, "
                         f"queue 1, item 11b")
    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                     grad_compression=args.grad_compression,
                     loss_chunk=min(2048, args.seq_len))
    params = init_lstm_ae(torch.Generator().manual_seed(0), cfg, device)
    state = init_train_state(params, tc)
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    print(f"[train] {cfg.name}: {n_params:,} params, mesh=none, device={device}", flush=True)

    api = build_model(cfg)
    step_fn = build_train_step(api, tc)
    it = TimeseriesIterator(TimeseriesConfig(
        features=cfg.lstm_ae.input_features, seq_len=args.seq_len,
        batch=args.batch, anomaly_rate=0.0,
    ))
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             f"repro_torch_ckpt_{args.arch}")
    ckpt = AsyncCheckpointer(ckpt_dir, keep=3)
    resume = latest_checkpoint(ckpt_dir)
    start = 0
    if resume is not None:
        state, meta = restore_checkpoint(resume, state)
        it.load_state_dict(meta["iterator"])
        start = meta["step"]
        print(f"[train] resumed from step {start}", flush=True)

    monitor = HeartbeatMonitor()
    t_start = time.perf_counter()
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        batch = {"series": next(it)[0].to(device)}
        state, metrics = step_fn(state, batch)
        monitor.report("host0", time.perf_counter() - t0)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d}  loss={float(metrics['loss']):.4f}  "
                  f"lr={float(metrics['lr']):.2e}  gnorm={float(metrics['grad_norm']):.2f}",
                  flush=True)
        if (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state, extra_meta={"iterator": it.state_dict()})
    ckpt.wait()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t_start
    tokens = (args.steps - start) * args.batch * args.seq_len
    print(f"[train] done: {dt:.1f}s, {tokens/max(dt, 1e-9):,.0f} tok/s; "
          f"stragglers={monitor.stragglers()}", flush=True)


if __name__ == "__main__":
    main()
