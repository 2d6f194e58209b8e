"""Run one cell of the port's benchmark on one card and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The port is not installed: ``src/`` goes on the
import path here.  Without a CUDA card the run exits with code 2 and prints no
result; ``harness.py`` holds the rest.
"""
import time

T0 = time.perf_counter()   # set-up is counted from here, before torch is imported

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the script's own directory would shadow top-level modules by the names of
# portbench's folders; the repo's root and its src/ take its place
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
# compiled bytecode of every module imported (torch's too) is kept at a fixed
# place in the checkout, so that only a checkout's first run compiles it, also
# where the environment turns the writing of bytecode off
if sys.pycache_prefix is None:
    sys.pycache_prefix = str(ROOT / ".portbench-bytecode")
sys.dont_write_bytecode = False

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
