"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

- lstm_cell.py  K1, the fused LSTM cell (``csrc/lstm_cell.cu``)
- lstm_seq.py   K2, the sequence-streaming LSTM layer (``csrc/lstm_seq.cu``)
- wkv6.py       K3, the RWKV-6 WKV recurrence (``csrc/wkv6.cu``)
- flash_attention.py  K4, the flash-attention forward (``csrc/flash_attention.cu``)
- ops.py        device-dispatching wrappers and the launch counts
- _build.py     nvcc build at first use, ctypes loading

The kernels are built and loaded inside the calls that launch them, never
at import, so the package imports where there is no CUDA toolkit.
"""
