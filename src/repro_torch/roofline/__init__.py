"""The dry run's cost model: the counterpart of ``repro/roofline/``.

- trace.py      ``OpTrace``: the aten ops of a step on rank 0's local shards,
                and ``analyze``: their FLOPs, bytes and collective bytes
- extract.py    the roofline report of a cell (H100 datasheet peaks)
- diagnose.py   the ops that dominate each term
- reanalyze.py  rebuild cell reports from their saved records
- report.py     the markdown table
"""
from repro_torch.roofline.extract import (
    HBM_BW,
    LINK_BW,
    PEAK_FLOPS,
    PEAK_FLOPS_BY_DTYPE,
    RooflineReport,
    active_param_count,
    build_report,
    model_flops_estimate,
    parse_collectives,
)
from repro_torch.roofline.trace import OpTrace, analyze

__all__ = [
    "HBM_BW",
    "LINK_BW",
    "OpTrace",
    "PEAK_FLOPS",
    "PEAK_FLOPS_BY_DTYPE",
    "RooflineReport",
    "active_param_count",
    "analyze",
    "build_report",
    "model_flops_estimate",
    "parse_collectives",
]
