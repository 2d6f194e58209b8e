"""One run of one cell: set-up, the measured window, the trace, the judgement
and the result line.

A run is one process.  Set-up (counted in ``setup_s`` from the process's start)
imports the port, builds the system under test from the seed (weights on the
device, the port's service; ``families/<family>.py``), draws the traffic's
inputs on the device, and runs the traffic kind's warm-up, the first request of
which captures the port's program.  The window is the traffic kind's own: its
arrivals, concurrency and entry sit in ``traffic/<kind>.py``, which gives

- ``build(cfg, params, gen, device)``: the cell's inputs, from the seed;
- ``warm(system, traffic)``: the set-up's requests; it may start what the kind
  drives (a pool, a server) over the family's system;
- ``drive(system, traffic, seconds) -> Samples``: the measured window;
- ``request(system, traffic, samples) -> bool``: one more request of the same
  load, kept in ``samples``: the traced run profiles a stretch of them;
- and, where it needs them, ``stop(system, traffic)``, which ends what ``warm``
  started, and ``judge(family, system, traffic, samples, limits)``, which takes
  the family's judgement's place where its answers are not one score a window
  of a pool (``closed_loop.py`` holds what the two closed-loop kinds share).

The traced run (``--trace 1``) runs the same window, then profiles a stretch of
further requests (``devtrace.profile``): the profiler's reading of its own trace
takes seconds of host time, which inside the window would stall it.  Once the
window has closed and the device's peak memory is read, the program is freed and
every answer is judged against the plain reference.

The cell's metrics are those of ``BENCHMARK.json`` that list the cell, or list
no cells: the end-to-end ones with ``--trace 0``, the per-layer ones with
``--trace 1``.  Each is read from the finished :class:`Run` by its reader,
``metrics/<name>.py``; a reader that finds nothing returns None and the metric
is left out of the line.  A reader that samples something beside the window
(the card's power, say) also gives ``beside(device)``, a context manager that
the window runs inside; what it yields is ``run.samples.extra[<name>]``.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Optional

import torch

from portbench import devtrace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load(kind: str, name: str) -> ModuleType:
    """The module ``portbench/<kind>/<name>.py``, loaded by its path (a metric's
    name may hold dots)."""
    modname = f"portbench.{kind}.{name}"
    if modname in sys.modules:
        return sys.modules[modname]
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[modname]
        raise
    return mod


def read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Samples:
    """What a traffic kind's window recorded.  ``answers`` holds the traced
    stretch's answers too; ``extra`` holds what a kind, or a metric's
    ``beside``, records besides, by name."""
    start: float = 0.0        # perf_counter at the window's start
    window_s: float = 0.0
    latencies_s: list = field(default_factory=list)   # every request answered in the window
    timesteps: int = 0        # row-timesteps of the requests answered in the window
    answers: dict = field(default_factory=dict)       # request -> its answers
    failed: int = 0
    extra: dict = field(default_factory=dict)

    @property
    def attempted(self) -> int:
        return len(self.answers) + self.failed


@dataclass
class Run:
    """A finished run, as the metric readers see it."""
    config: dict
    work: ModuleType          # work/<family>.py
    device_kind: str
    setup_s: float
    traffic: Any              # what traffic/<kind>.py built
    samples: Samples
    trace: Optional[devtrace.Trace] = None

    @property
    def window_s(self) -> float:
        return self.samples.window_s

    @property
    def completed(self) -> int:
        """Requests answered in the window."""
        return len(self.samples.latencies_s)

    def request_flops(self) -> float:
        return self.work.request_flops(self.config, self.traffic.rows, self.traffic.seq_len)

    def request_bytes(self) -> float:
        return self.work.request_bytes(self.config, self.traffic.rows, self.traffic.seq_len)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]


def load_cell(bench: dict, name: str) -> tuple[dict, dict]:
    """(workload file, configuration file) of cell ``name``; refuses a workload
    file that disagrees with its entry in ``BENCHMARK.json``."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(entries)}")
    wl = read_json(HERE / "workloads" / f"{name}.json")
    for key in ("name", "config", "traffic", "chips"):
        if wl[key] != entries[name][key]:
            raise ValueError(f"workloads/{name}.json has {key}={wl[key]!r}, "
                             f"BENCHMARK.json {entries[name][key]!r}")
    return wl, read_json(HERE / "configs" / f"{wl['config']}.json")


def is_correct(attempted: int, checks: dict) -> bool:
    """Some request was sent, and every compared number lies within its limit."""
    return attempted > 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: torch.device,
             t0: float, params: Optional[dict] = None, phases: Optional[list] = None,
             control: bool = False) -> dict:
    """Run cell ``name`` and return its result (the line's keys).  ``params``
    overrides the workload file's parameters (the tests' small sizes);
    ``phases`` holds (label, time) of the set-up before the call; ``control``
    puts the family's control (``family.control``) in the program's place."""
    bench = read_json(ROOT / "BENCHMARK.json")
    wl, cfg = load_cell(bench, name)
    params = {**wl["params"], **(params or {})}
    family = load("families", cfg["family"])
    kind = load("traffic", wl["traffic"])
    work = load("work", cfg["family"])
    wanted = cell_metrics(bench, name, trace)
    readers = {m["name"]: load("metrics", m["name"]) for m in wanted}
    on_card = device.type == "cuda"
    kind_name = torch.cuda.get_device_name(device) if on_card else "cpu"

    phases = list(phases or []) + [("the cell's files", time.perf_counter())]
    gen = torch.Generator(device=device).manual_seed(seed)
    system = (family.control if control else family.build)(cfg, gen, device)
    phases.append(("program and weights", time.perf_counter()))
    traffic = kind.build(cfg, params, gen, device)
    phases.append(("inputs", time.perf_counter()))
    kind.warm(system, traffic)
    if trace and on_card:                # the profiler's own start-up
        devtrace.warm(lambda: kind.request(system, traffic, Samples()))
    if on_card:
        torch.cuda.synchronize(device)
    gc.collect()
    gc.freeze()
    with contextlib.ExitStack() as beside:
        extra = {n: beside.enter_context(r.beside(device))
                 for n, r in readers.items() if hasattr(r, "beside")}
        samples = kind.drive(system, traffic, seconds)
    samples.extra.update(extra)
    setup_s = samples.start - t0
    phases.append(("capture and warm-up", samples.start))
    log("[setup] " + ", ".join(f"{label} {b - a:.3f} s" for (_, a), (label, b)
                               in zip([("start", t0)] + phases, phases)))

    tr = None
    if trace:
        if not on_card:
            raise RuntimeError("the traced run reads the card's profiler trace")
        tr = devtrace.profile(lambda: kind.request(system, traffic, samples),
                              n=traffic.trace_requests, log=log)
        log(f"[trace] {tr.summary()}")
        if samples.latencies_s:
            log(f"[trace] a profiled request {1e3 * tr.window_s / len(tr.kept):.4f} ms, "
                f"a request of the window {1e3 * samples.window_s / len(samples.latencies_s):.4f}"
                f" ms")
    if hasattr(kind, "stop"):
        kind.stop(system, traffic)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    for key, value in system.counters().items():
        log(f"[program] {key} {value}")
    system.close()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_judge = time.perf_counter()
    if hasattr(kind, "judge"):
        checks = kind.judge(family, system, traffic, samples, wl["limits"])
    else:
        checks = family.judge(system, traffic, samples.answers, wl["limits"])
    checks["failed_requests"] = {"value": samples.failed, "limit": 0}
    log(f"[judge] {len(samples.answers)} requests against the reference in "
        f"{time.perf_counter() - t_judge:.3f} s")
    run = Run(config=cfg, work=work, device_kind=kind_name, setup_s=setup_s,
              traffic=traffic, samples=samples, trace=tr)
    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": is_correct(samples.attempted, checks), "attempted": samples.attempted,
              "failed": samples.failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu", "kind": kind_name,
                         "count": wl["chips"], "memory_peak_bytes": peak}}
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": [[short(n), v] for n, v in tr.device_ops()],
                               "idle_gaps": [[short(n), v] for n, v in tr.idle_gaps()]}
    result["checks"] = checks
    return result


def short(name: str, width: int = 120) -> str:
    """A kernel's name without ``void`` and cut to ``width`` characters: C++
    template names run to thousands."""
    name = name.removeprefix("void ")
    return name if len(name) <= width else name[:width - 3] + "..."


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the benchmark may not load."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_line(device: torch.device) -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unreadable: {exc}"
    return out.stdout.strip()


def parse(argv: list[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: list[str], t0: float) -> int:
    phases = [("python and torch imports", time.perf_counter())]
    args = parse(argv)
    if not torch.cuda.is_available():
        log("portbench: no CUDA device is available; the benchmark runs only on a card")
        return 2
    bench = read_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        log(f"portbench: no workload {args.workload!r} in BENCHMARK.json")
        return 2
    if torch.cuda.device_count() < chips:
        log(f"portbench: {args.workload} needs {chips} cards, {torch.cuda.device_count()} visible")
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.init()
    phases.append(("the card's context", time.perf_counter()))
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device, t0,
                      phases=phases)
    leaked = forbidden_modules()
    if leaked:
        log(f"portbench: the run loaded {', '.join(leaked)}; it may load none of "
            f"{', '.join(FORBIDDEN)}")
        return 3
    log(f"[card] {power_line(device)}")
    for cname, c in result["checks"].items():
        log(f"check {cname} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
