"""Training launcher of the port: ``python -m repro_torch.launch.train --arch <id>``.

Counterpart of ``repro/launch/train.py``: the config registry, the train
step (autograd + AdamW, ``--grad-compression``), the data pipeline (the
checkpointable ``TimeseriesIterator`` of benign windows for the LSTM-AE,
``LMIterator`` for an LM, each batch sliced per process by
``host_slice``), async checkpoints every ``--ckpt-every`` steps with a
resume from the newest one in ``--ckpt-dir`` (params, optimizer state and
the iterator's position), and a heartbeat monitor that names stragglers.
An LM trains with per-layer recompute (``TrainConfig.remat="layer"``) and
``loss_chunk=min(2048, seq_len)``; the vision stub trains on text, as the
reference's iterator gives no ``image_embeds``.  Whisper's batches also
carry ``frames`` (B, encoder_seq_len, d_model), standard normal f32 drawn
with numpy from (seed, batch index), so a resumed run sees the frames an
uninterrupted one would.  This departs from the reference, whose trainer
gives Whisper token batches only and so raises ``KeyError: 'frames'``
in its loss (ROADMAP.md, queue 3).

One device: the GPU by default (raises without one), ``--device cpu`` on
request.  The reference builds a production mesh and shards its step only
at 256 devices or more (``pick_mesh``); that mesh and the sharded step
are ``ROADMAP.md``, queue 1, item 11g-2.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import AsyncCheckpointer, latest_checkpoint, restore_checkpoint
from repro_torch.config import TrainConfig, get_config, list_archs, reduced_config
from repro_torch.data import (
    LMDataConfig,
    LMIterator,
    TimeseriesConfig,
    TimeseriesIterator,
    host_slice,
)
from repro_torch.distributed import HeartbeatMonitor
from repro_torch.models import build_model
from repro_torch.training import build_train_step, init_train_state
from repro_torch.utils import tree_leaves

SHARDING_ITEM = "ROADMAP.md, queue 1, item 11g-2 (the production mesh and the sharded step)"


def pick_mesh():
    """The reference's production mesh needs 256 devices or more; below
    that it trains on one device (``None``)."""
    if torch.cuda.device_count() >= 256:
        raise NotImplementedError(f"a production training mesh is not ported yet: {SHARDING_ITEM}")
    return None


def make_iterator(cfg, args):
    """(iterator, batch builder) for ``cfg``'s family, as the reference's."""
    if cfg.family == "lstm_ae":
        it = TimeseriesIterator(TimeseriesConfig(
            features=cfg.lstm_ae.input_features, seq_len=args.seq_len,
            batch=args.batch, anomaly_rate=0.0,
        ))
        return it, lambda b: {"series": b[0]}
    it = LMIterator(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len, global_batch=args.batch,
    ))
    if cfg.family != "whisper":
        return it, lambda b: b

    def with_frames(b):
        # the batch just drawn is number it.index - 1; its own stream of draws
        rng = np.random.default_rng(np.random.SeedSequence([it.cfg.seed, it.index - 1, 1]))
        frames = rng.standard_normal((args.batch, cfg.encoder_seq_len, cfg.d_model),
                                     dtype=np.float32)
        return dict(b, frames=torch.from_numpy(frames))
    return it, with_frames


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
    api = build_model(cfg)
    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                     grad_compression=args.grad_compression,
                     loss_chunk=min(2048, args.seq_len))
    pick_mesh()   # raises at 256 devices or more, as not ported yet
    # the LSTM-AE draws on the CPU and moves its params; an LM draws on its device
    gen_device = "cpu" if cfg.family == "lstm_ae" else device
    state = init_train_state(api.init(torch.Generator(gen_device).manual_seed(0), device), tc)
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    print(f"[train] {cfg.name}: {n_params:,} params, mesh=none, device={device}", flush=True)

    step_fn = build_train_step(api, tc)
    it, to_batch = make_iterator(cfg, args)
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
        batch = host_slice(to_batch(next(it)))
        batch = {k: v.to(device) for k, v in batch.items()}
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
