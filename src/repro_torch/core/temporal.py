"""Temporal parallelism (paper Section 3): wavefront execution of a
multi-layer recurrent stack, on one device or as a stage pipeline.

Counterpart of ``repro/core/temporal.py``.  Two executors over the
(layer x time) iteration grid:

* :func:`wavefront_forward` — one device.  At wavefront step k every layer
  fires at once, layer i processing timestep ``k - i``: one batched cell
  over the padded layer stack (a batched matmul over the layer dimension
  takes the place of the reference's ``vmap``).

* :func:`pipelined_forward` — a stage pipeline over a device mesh.  Each
  stage owns a contiguous group of layers (chosen by the Eq-8-analogue DP
  in ``core/balancing.py``, :func:`build_stage_params`); at step k stage s
  works on timestep ``k - s`` and hands its output to stage s+1 through a
  depth-1 FIFO, the paper's inter-module queue (the reference's
  ``ppermute``).  Batch rows split over the data axis at the same time.
  Each mesh cell runs on its own device and, on a GPU, its own CUDA
  stream; a mesh may name one device more than once, so one card (or the
  CPU) emulates several.

Latency semantics match Eq (1): K = T + S - 1 wavefront steps.
"""
from __future__ import annotations

import contextlib
import itertools
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.config.core import ModelConfig
from repro_torch.core.balancing import stage_assignment_for
from repro_torch.core.lstm import lstm_cell, stacked_cell_params
from repro_torch.distributed.sharding import lay_out, pad_last
from repro_torch.utils import Params, tree_map


def schedule_table(num_layers: int, timesteps: int) -> list[list[tuple[int, int]]]:
    """Which (layer, timestep) pairs execute at each wavefront step —
    documentation/test helper mirroring Fig. 2's staggered execution."""
    steps = []
    for k in range(timesteps + num_layers - 1):
        active = [(i, k - i) for i in range(num_layers) if 0 <= k - i < timesteps]
        steps.append(active)
    return steps


def wavefront_forward(params: Params, xs: torch.Tensor, pwl: bool = False) -> torch.Tensor:
    """Single-device wavefront execution.  xs: (T, B, F) -> (T, B, F).

    All N layers execute in ONE batched cell per wavefront step — the
    software rendering of "all modules operate concurrently" (paper §3.2).
    """
    layers = params["layers"]
    n = len(layers)
    t_len, b, f = xs.shape
    # under a mesh the cells are padded and stacked from whole weights
    # (torch 2.11's F.pad breaks a DTensor's placements), then the stacked
    # gate columns laid out over the model axis and the carries' batch over
    # the batch axes (each a no-op without a mesh)
    stacked, _, _ = stacked_cell_params(tree_map(
        lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t, layers))
    in_max = stacked["wx"].shape[1]
    h_max = stacked["wh"].shape[1]
    cell_params = {k: lay_out(v, (None, None, "tp"), like=xs) for k, v in (
        ("wx", stacked["wx"]), ("wh", stacked["wh"]), ("b", stacked["b"][:, None, :]))}

    h = lay_out(torch.zeros((n, b, h_max), dtype=xs.dtype, device=xs.device),
                (None, "batch", None), like=xs)
    c = lay_out(torch.zeros((n, b, h_max), dtype=torch.float32, device=xs.device),
                (None, "batch", None), like=xs)
    x_pad = pad_last(xs, in_max - f)
    x_zero = torch.zeros_like(x_pad[0])   # drain steps read zeros
    layer_ids = torch.arange(n, device=xs.device)
    ys = []
    for k in range(t_len + n - 1):
        x_k = x_pad[k] if k < t_len else x_zero
        # layer 0 reads the fresh input; layer i reads layer i-1's carry h
        upstream = pad_last(h[:-1], in_max - h_max)
        in_buf = torch.cat([x_k[None], upstream], dim=0)       # (N, B, in_max)
        h_new, c_new = lstm_cell(cell_params, in_buf, h, c, pwl=pwl)
        t_for_layer = k - layer_ids
        vmask = ((t_for_layer >= 0) & (t_for_layer < t_len))[:, None, None]
        h = torch.where(vmask, h_new, h)
        c = torch.where(vmask, c_new, c)
        if k >= n - 1:
            ys.append(h[-1, :, :f])
    return torch.stack(ys)


# ---------------------------------------------------------------------------
# Stage pipeline over a device mesh
# ---------------------------------------------------------------------------

def build_stage_params(
    params: Params, cfg: ModelConfig, n_stages: int
) -> tuple[Params, torch.Tensor, list[int]]:
    """Group layers into stages (balanced DP) and stack padded cells into
    (S, max_layers_per_stage, ...) tensors, as the reference does.

    Every cell is padded to the model's global (in_max, h_max), gate-aligned,
    the layer dimension is padded to ``max_per`` with zero cells, and a stage
    without layers gets zero cells.  Returns (stage_params, per-stage layer
    counts (S,) int32, assignment list)."""
    layers = params["layers"]
    assignment, _ = stage_assignment_for(cfg.lstm_ae, n_stages)
    groups: list[list] = [[] for _ in range(n_stages)]
    for layer, sid in zip(layers, assignment):
        groups[sid].append(layer)
    max_per = max(len(g) for g in groups)

    stacked_all, _, _ = stacked_cell_params(list(layers))
    in_max = stacked_all["wx"].shape[1]
    h_max = stacked_all["wh"].shape[1]
    dev = stacked_all["wx"].device

    def pad_group(group) -> Params:
        if group:
            g_stacked, _, _ = stacked_cell_params(group, in_max=in_max, h_max=h_max)
        else:
            g_stacked = {
                "wx": torch.zeros((0, in_max, 4 * h_max), dtype=torch.float32, device=dev),
                "wh": torch.zeros((0, h_max, 4 * h_max), dtype=torch.float32, device=dev),
                "b": torch.zeros((0, 4 * h_max), dtype=torch.float32, device=dev),
            }
        return {k: F.pad(v, (0, 0) * (v.ndim - 1) + (0, max_per - v.shape[0]))
                for k, v in g_stacked.items()}

    padded = [pad_group(g) for g in groups]
    stage_params = {k: torch.stack([p[k] for p in padded]) for k in ("wx", "wh", "b")}
    counts = torch.tensor([len(g) for g in groups], dtype=torch.int32)
    return stage_params, counts, assignment


class StageCell(NamedTuple):
    """One mesh cell of the pipeline: a stage's layers on one data shard's device."""
    device: torch.device
    stream: Optional["torch.cuda.Stream"]
    layers: tuple            # the stage's cells {wx, wh, b}, on ``device``


class StageGrid(NamedTuple):
    """``cells[d][s]``: data shard d, stage s (see :func:`place_stages`)."""
    cells: tuple
    in_max: int
    h_max: int


def place_stages(stage_params: Params, counts, mesh, *, stage_axis: str = "model",
                 batch_axes: Sequence[str] = ("data",)) -> StageGrid:
    """Put each stage's layers on the device of every mesh cell that runs
    it (once per device) — the reference's ``in_specs`` over the stage axis.
    Every mesh axis but ``stage_axis`` must be a batch axis."""
    names = tuple(mesh.axis_names)
    if stage_axis not in names:
        raise ValueError(f"mesh axes {names} lack the stage axis {stage_axis!r}")
    extra = [a for a in names if a != stage_axis and a not in batch_axes]
    if extra:
        raise ValueError(f"mesh axes {extra} are neither the stage axis nor batch axes")
    counts = [int(c) for c in counts]
    n_stages = mesh.axis_size(stage_axis)
    if len(counts) != n_stages:
        raise ValueError(f"{len(counts)} stage counts for a stage axis of {n_stages}")
    n_data = mesh.size // n_stages
    on_device: dict = {}
    grid = [[None] * n_stages for _ in range(n_data)]
    for idx in itertools.product(*(range(n) for n in mesh.shape)):
        s, d = 0, 0
        for name, i in zip(names, idx):
            if name == stage_axis:
                s = i
            else:
                d = d * mesh.axis_size(name) + i
        dev = mesh.device(*idx)
        key = (str(dev), s)
        if key not in on_device:
            on_device[key] = tuple(
                {k: stage_params[k][s, j].to(dev) for k in ("wx", "wh", "b")}
                for j in range(counts[s]))
        grid[d][s] = StageCell(dev, mesh.stream(*idx), on_device[key])
    return StageGrid(tuple(tuple(row) for row in grid),
                     int(stage_params["wx"].shape[2]), int(stage_params["wh"].shape[2]))


def _stage_step(s: int, k: int, layers: tuple, cur: torch.Tensor, h: list, c: list,
                pwl: bool, in_max: int, h_max: int) -> torch.Tensor:
    """Stage ``s`` at wavefront step ``k``: its layers in turn on its input
    ``cur`` (B, in_max), each updating its (h, c) in ``h``/``c``; returns the
    stage's output (B, in_max).  A stage without layers passes ``cur``
    through."""
    for j, p in enumerate(layers):
        h[j], c[j] = lstm_cell(p, cur, h[j], c[j], pwl=pwl)
        cur = F.pad(h[j], (0, in_max - h_max))
    return cur


def _on(cell: StageCell):
    return torch.cuda.stream(cell.stream) if cell.stream is not None else contextlib.nullcontext()


def _event(cell: StageCell):
    return torch.cuda.Event() if cell.stream is not None else None


def run_pipeline(grid: StageGrid, xs: torch.Tensor, *, pwl: bool = False) -> torch.Tensor:
    """Run the placed pipeline on xs (T, B, F) -> (T, B, F), on xs's device.

    Data shard d takes rows ``[d*B/D, (d+1)*B/D)``.  At step k stage s runs
    timestep ``k - s``: stage 0 reads ``x_t``, stage s > 0 the FIFO slot
    stage s-1 wrote at step k-1.  Steps where a stage has no timestep (the
    S-1 fill and drain steps) run nothing, which is what the reference's
    masked updates leave of them.  The FIFO is double-buffered on the
    reading stage's device: at step k stage s writes slot ``k % 2`` while
    stage s+1 reads slot ``(k-1) % 2``, so a write never lands on what the
    reader of the same step takes; on CUDA, events order the write after
    the previous read and the read after the write (a peer copy, where the
    two stages sit on different GPUs)."""
    t_len, b, f = xs.shape
    n_data, n_stages = len(grid.cells), len(grid.cells[0])
    in_max, h_max = grid.in_max, grid.h_max
    caller = torch.cuda.current_stream(xs.device) if xs.device.type == "cuda" else None
    streams = [cell.stream for row in grid.cells for cell in row if cell.stream is not None]
    for st in streams:   # after the work queued so far (xs, on the caller's stream)
        st.wait_stream(torch.cuda.current_stream(st.device))

    shards = []
    for d, row in enumerate(grid.cells):
        rows = slice(d * b // n_data, (d + 1) * b // n_data)
        bd = rows.stop - rows.start
        shard = {"h": [], "c": [], "fifo": [], "made": [], "read": []}
        for s, cell in enumerate(row):
            with _on(cell):
                if s == 0:
                    shard["x"] = F.pad(xs[:, rows].to(cell.device), (0, in_max - f))
                shard["h"].append([torch.zeros((bd, h_max), dtype=xs.dtype, device=cell.device)
                                   for _ in cell.layers])
                shard["c"].append([torch.zeros((bd, h_max), dtype=torch.float32,
                                               device=cell.device) for _ in cell.layers])
                if s > 0:   # the FIFO into stage s lives on stage s's device
                    bufs = [torch.empty((bd, in_max), dtype=xs.dtype, device=cell.device)
                            for _ in range(2)]
                    if row[s - 1].stream is not None:
                        for buf in bufs:
                            buf.record_stream(row[s - 1].stream)
                    shard["fifo"].append(bufs)
                if s == n_stages - 1:
                    shard["ys"] = torch.empty((t_len, bd, f), dtype=xs.dtype, device=cell.device)
            shard["made"].append([_event(cell), _event(cell)])   # FIFO slot written
            shard["read"].append([_event(cell), _event(cell)])   # input slot free
        shards.append(shard)

    for k in range(t_len + n_stages - 1):
        for d, row in enumerate(grid.cells):
            sh = shards[d]
            for s, cell in enumerate(row):
                t = k - s
                if not 0 <= t < t_len:
                    continue
                with _on(cell):
                    if s == 0:
                        cur = sh["x"][t]
                    else:
                        if cell.stream is not None:   # stage s-1's write at step k-1
                            cell.stream.wait_event(sh["made"][s - 1][(k - 1) % 2])
                        cur = sh["fifo"][s - 1][(k - 1) % 2]
                    out = _stage_step(s, k, cell.layers, cur, sh["h"][s], sh["c"][s],
                                      pwl, in_max, h_max)
                    if s == n_stages - 1:
                        sh["ys"][t].copy_(out[:, :f])
                    else:
                        if cell.stream is not None:
                            # slot k % 2 was last read by stage s+1 at step k-1
                            cell.stream.wait_event(sh["read"][s + 1][(k - 1) % 2])
                        sh["fifo"][s][k % 2].copy_(out, non_blocking=True)
                        if cell.stream is not None:
                            sh["made"][s][k % 2].record(cell.stream)
                    if cell.stream is not None:
                        # done with its input: a stage without layers hands
                        # the FIFO slot itself on, so the slot is free only now
                        sh["read"][s][k % 2].record(cell.stream)

    parts = []
    for d, row in enumerate(grid.cells):
        last = row[-1]
        with _on(last):
            part = shards[d]["ys"].to(xs.device)
            if caller is not None:
                part.record_stream(caller)
        parts.append(part)
    if caller is not None:
        for st in streams:
            caller.wait_stream(st)
    return torch.cat(parts, dim=1)


def pipelined_forward(
    stage_params: Params,
    counts,
    xs: torch.Tensor,
    *,
    mesh,
    cfg: ModelConfig,
    stage_axis: str = "model",
    batch_axes: tuple[str, ...] = ("data",),
    pwl: bool = False,
) -> torch.Tensor:
    """Pipelined wavefront over ``stage_axis``.  xs: (T, B, F) -> (T, B, F).

    stage_params: (S, max_per, ...) stacked padded cells
    (:func:`build_stage_params`); counts: (S,) layers per stage.  Stages
    beyond the model depth pass activations through, so the last stage's
    stream is always the model output, delayed by S - 1 fill steps."""
    counts = [int(c) for c in counts]
    depth = len(cfg.lstm_ae.layer_sizes())
    if sum(counts) != depth:
        raise ValueError(f"stage counts {counts} hold {sum(counts)} layers; "
                         f"{cfg.name} has {depth}")
    grid = place_stages(stage_params, counts, mesh, stage_axis=stage_axis,
                        batch_axes=batch_axes)
    return run_pipeline(grid, xs, pwl=pwl)
