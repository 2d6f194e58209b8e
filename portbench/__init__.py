"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on one NVIDIA card.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` and prints one JSON line last.  Everything
that belongs to one configuration, traffic kind or metric sits in a file of its
own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the widths as run, the source, ``reduced`` and
  ``assumed``, and for each key in ``reduced`` its value at the source under
  ``published``;
- ``workloads/<cell>.json``: the cell's configuration, traffic kind, chips,
  parameters and ``limits``, each the limit of the compared number it names;
- ``families/<family>.py``: builds the system under test and its control from
  the seed (``build``, ``control``), judges its answers against the plain
  reference in ``reference/`` (``judge``), checks a configuration file
  (``check_config``), gives the faults a cell can have (``faults(kind,
  on_card=False)``: name -> planter(monkeypatch, cfg, limits)), and sets
  ``SPANS_CHIPS = True`` where its cells may take four chips;
- ``traffic/<kind>.py``: turns a cell's parameters into requests and drives
  them: warm-up, the measured window and the traced stretch's requests; it
  gives ``SMALL``, the parameters of a test's run, and ``CONTROL_SECONDS``,
  the control's window;
- ``metrics/<metric>.py``: reads one metric from a finished run (``harness.Run``),
  and may sample something beside the window;
- ``work/<family>.py``: a family's model FLOPs and least bytes, from its widths.

Nothing here imports ``jax`` or the JAX package ``repro``; the reference imports
nothing of ``repro_torch`` either.
"""
