"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

- lstm_cell.py  K1, the fused LSTM cell (``csrc/lstm_cell.cu``)
- lstm_seq.py   K2, the sequence-streaming LSTM layer (``csrc/lstm_seq.cu``)
- lstm_stack.py the LSTM-AE's whole stack over a window in one launch, on the
  wavefront schedule (``csrc/lstm_stack.cu``)
- wkv6.py       K3, the RWKV-6 WKV recurrence (``csrc/wkv6.cu``)
- flash_attention.py  K4, the flash-attention forward (``csrc/flash_attention.cu``)
- ops.py        device-dispatching wrappers and the launch counts
- _build.py     nvcc build at first use, ctypes loading

The kernels are built and loaded inside the calls that launch them, never
at import, so the package imports where there is no CUDA toolkit.
"""


def count_launch(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel in ``wrapper.launches``; while
    the current stream is being captured into a CUDA graph the launch is
    only recorded, so it goes to ``wrapper.captured`` instead, and each
    replay of the graph adds it to ``launches`` (``engine/capture.py``)."""
    import torch

    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1
