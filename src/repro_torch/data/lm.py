"""Synthetic LM token pipeline: Zipf-distributed tokens with induced
bigram structure (so the loss actually falls during the example runs),
deterministic per (seed, index), sharding-aware.

Counterpart of ``repro/data/lm.py``: the same numpy draws, so tokens and
labels equal the reference's value for value; they come back as CPU int64
tensors and the trainer moves them to its device.  ``host_slice``
partitions the global batch by (process_index, process_count), by default
``torch.distributed``'s rank and world size when a process group is up,
else (0, 1).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class LMDataConfig:
    vocab_size: int = 512
    seq_len: int = 128
    global_batch: int = 16
    seed: int = 0


def make_lm_batch(cfg: LMDataConfig, index: int) -> dict[str, torch.Tensor]:
    """Batch #index -> {"tokens": (B,S), "labels": (B,S)} (labels = next token)."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, index]))
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    # zipf-ish marginal + deterministic "grammar": token_{t+1} is a fixed
    # permutation of token_t half the time (learnable bigram signal)
    ranks = np.arange(1, v + 1)
    probs = 1.0 / ranks**1.1
    probs /= probs.sum()
    perm = np.random.default_rng(cfg.seed).permutation(v)
    toks = np.empty((b, s + 1), np.int64)
    toks[:, 0] = rng.choice(v, size=b, p=probs)
    for t in range(1, s + 1):
        follow = perm[toks[:, t - 1]]
        fresh = rng.choice(v, size=b, p=probs)
        use_gram = rng.uniform(size=b) < 0.5
        toks[:, t] = np.where(use_gram, follow, fresh)
    return {
        "tokens": torch.from_numpy(toks[:, :-1].copy()),
        "labels": torch.from_numpy(toks[:, 1:].copy()),
    }


def _process() -> tuple[int, int]:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_slice(batch: dict, process_index: int | None = None,
               process_count: int | None = None) -> dict:
    """Per-process slice of the global batch (multi-host data loading)."""
    rank, world = _process()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count

    def sl(x):
        b = x.shape[0]
        if b % pc:
            raise ValueError(f"global batch {b} does not split over {pc} processes")
        shard = b // pc
        return x[pi * shard:(pi + 1) * shard]

    return {k: sl(v) for k, v in batch.items()}


@dataclass
class LMIterator:
    """Checkpointable iterator: state == (cfg, next_index)."""
    cfg: LMDataConfig
    index: int = 0

    def __next__(self) -> dict[str, torch.Tensor]:
        batch = make_lm_batch(self.cfg, self.index)
        self.index += 1
        return batch

    def __iter__(self) -> "LMIterator":
        return self

    def state_dict(self) -> dict:
        return {"index": self.index, "seed": self.cfg.seed}

    def load_state_dict(self, state: dict) -> None:
        if state["seed"] != self.cfg.seed:
            raise ValueError(f"seed mismatch on restore: state has seed {state['seed']}, "
                             f"this iterator {self.cfg.seed}")
        self.index = int(state["index"])
