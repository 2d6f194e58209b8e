"""The control of the comparison that decides ``correct``: the plain reference
put in the program's place and computed one precision below the one the
configurations state, TF32 for float32 (``family.control``).  A sound limit
fails it.

For each seed, one run of the cell (``harness.run_cell``) with the control in
the program's place: the cell's weights, traffic, warm-up and window, its
answers judged as a run's are.  The control is captured into a CUDA graph for
each request's shape, as the program is, and its window has to be long enough to
answer every input of the cell's pool, as a run of the program does: the cell's
traffic kind gives that length as ``CONTROL_SECONDS``.  The benchmark's own runs
never run this:

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 40

prints one JSON line per seed: whether the run came out correct, and each
compared number beside its limit.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Optional

if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parent.parent
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def reading(cell: str, seed: int, seconds: float, device: torch.device,
            params: Optional[dict] = None) -> dict:
    """One run of cell ``cell`` at seed ``seed`` with the control in the
    program's place: its ``correct``, its checks and the requests it sent."""
    result = harness.run_cell(cell, seed, seconds, False, device, time.perf_counter(),
                              params=params, control=True)
    return {"cell": cell, "seed": seed, "correct": result["correct"],
            "attempted": result["attempted"], "checks": result["checks"]}


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog="portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench: the control runs on a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(reading(args.workload, seed, args.seconds, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
