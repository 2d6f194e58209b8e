"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on one NVIDIA card.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` and prints one JSON line last.  Everything
that belongs to one configuration, traffic kind or metric sits in a file of its
own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the widths as run, the source, ``reduced`` and ``assumed``;
- ``workloads/<cell>.json``: the cell's configuration, traffic kind and parameters;
- ``families/<family>.py``: builds the system under test from the seed and judges
  its answers against the plain reference in ``reference/``;
- ``traffic/<kind>.py``: turns a cell's parameters into requests and drives
  them: warm-up, the measured window and the traced stretch's requests;
- ``metrics/<metric>.py``: reads one metric from a finished run (``harness.Run``),
  and may sample something beside the window;
- ``work/<family>.py``: a family's model FLOPs and least bytes, from its widths.

Nothing here imports ``jax`` or the JAX package ``repro``; the reference imports
nothing of ``repro_torch`` either.
"""
