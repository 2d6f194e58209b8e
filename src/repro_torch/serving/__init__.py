"""Serving steps of the port: the LSTM-AE score step and the LM's prefill,
decode and greedy decoding (``serving/step.py``)."""
from repro_torch.serving.step import (
    GreedyDecoder,
    build_decode_step,
    build_prefill_step,
    build_score_step,
    greedy_decode_loop,
    stitch_prefill_cache,
)

__all__ = [
    "GreedyDecoder",
    "build_decode_step",
    "build_prefill_step",
    "build_score_step",
    "greedy_decode_loop",
    "stitch_prefill_cache",
]
