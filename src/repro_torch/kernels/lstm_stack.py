"""The LSTM-AE's whole recurrent stack over a window: the CUDA kernel's launch wrapper and its plain PyTorch version.

Replaces no Pallas kernel: the ``fused`` schedule's chain of D·T K1
launches (one per layer and timestep), at the batches where that chain is
latency-bound, as one launch on the paper's wavefront schedule (§3.2),
written by hand for Hopper in ``csrc/lstm_stack.cu`` (see its header).

Design: one thread-block cluster per group of rows, one block per layer
(depth <= 8); each block keeps its layer's weights in registers for the
whole window and its h and c on chip; at wavefront step s layer l computes
timestep s − l and hands h_l[t] to layer l+1 through distributed shared
memory (``st.async``, counted on an mbarrier there), one relaxed cluster
barrier a step, so a window's chain is T + D − 1 steps
(69 at lstm-ae-f64-d6) and not D·T launches (384).  f32 throughout on FP32
FMAs, the same exact or piecewise-linear activations as K1; h and c start
at zero.

Weights are the core layout {wx (In, 4H), wh (H, 4H), b (4H,)} of each
layer, f32, no packing; xs (T, B, In_0) f32 -> ys (T, B, H_last) f32.  A
stack fits (:func:`fits`) when depth <= 8, each layer's In is the previous
layer's H, every H <= 64, each thread's slice of In + H holds at most 96
weights and the buffers at 8 rows fit 48 KB: every LSTM-AE configuration of
the paper does.

:func:`lstm_stack_cuda` launches the kernel on CUDA tensors and raises on
anything it does not take; :func:`lstm_stack_plain` is the same function in
plain PyTorch, the chain of :func:`~repro_torch.kernels.lstm_cell.lstm_cell_plain`
calls the ``fused`` schedule makes on the CPU, used for CPU tensors and as
the kernel's yardstick.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.lstm_cell import lstm_cell_plain, pack_weights

MAX_DEPTH = 8          # the portable cluster size: one block per layer
_MAX_SLICE = 96        # weights a thread holds: f64-d6's widest layer (32 -> 64)
_MAX_ROWS, _SLOTS, _SMEM_BYTES = 8, 4, 48 * 1024


def _round4(v: int) -> int:
    return (v + 3) // 4 * 4


def _split(hidden: int) -> int:
    """Lanes that share one output's contraction (0: too wide to fit)."""
    return 8 if hidden <= 8 else 4 if hidden <= 16 else 2 if hidden <= 32 else \
        1 if hidden <= 64 else 0


def _slice(in_dim: int, hidden: int) -> int:
    """Weights a thread of the layer holds: its share of the padded In + H
    contraction (``kpt_of`` in ``csrc/lstm_stack.cu``)."""
    return _round4(-(-(_round4(in_dim) + _round4(hidden)) // _split(hidden)))


def slice_width(dims: Sequence[tuple[int, int]]) -> int:
    """Weights a thread of the stack's widest layer holds: the length of the
    dot it runs at each wavefront step (96 at lstm-ae-f64-d6, 24 at
    lstm-ae-f32-d2).  ``dims`` must fit (:func:`fits`)."""
    return max(_slice(i, h) for i, h in dims)


def fits(dims: Sequence[tuple[int, int]]) -> bool:
    """Whether a stack of layers (In, H) fits the kernel; the same rule as
    ``lstm_stack_fits`` in ``csrc/lstm_stack.cu``."""
    if not 1 <= len(dims) <= MAX_DEPTH:
        return False
    for l, (in_dim, hidden) in enumerate(dims):
        if in_dim < 1 or hidden < 1 or _split(hidden) == 0:
            return False
        if l > 0 and in_dim != dims[l - 1][1]:
            return False
        if _slice(in_dim, hidden) > _MAX_SLICE:
            return False
    vs = max(_round4(i) + _round4(h) for i, h in dims)
    hs = max(_round4(h) for _, h in dims)
    # the ring's mbarriers; per row the ring's [x | h] vectors and the gates
    return 4 * (2 * _SLOTS + _MAX_ROWS * (_SLOTS * vs + 4 * hs)) <= _SMEM_BYTES


def layer_dims(layers) -> list[tuple[int, int]]:
    """(In, H) of each core-layout layer {wx (In, 4H), wh (H, 4H), b}."""
    return [(layer["wx"].shape[0], layer["wh"].shape[0]) for layer in layers]


def lstm_stack_plain(xs, layers, *, pwl: bool = False):
    """The kernel's function in plain PyTorch: each layer a chain of
    :func:`lstm_cell_plain` steps from zero state; xs (T, B, In_0) ->
    ys (T, B, H_last)."""
    ys = xs
    t_len, bsz = xs.shape[:2]
    for layer in layers:
        packed = pack_weights(layer)
        hidden = packed[1].shape[1]
        out = torch.empty((t_len, bsz, hidden), dtype=xs.dtype, device=xs.device)
        h = torch.zeros((bsz, hidden), dtype=xs.dtype, device=xs.device)
        c = torch.zeros((bsz, hidden), dtype=torch.float32, device=xs.device)
        for t in range(t_len):
            h, c = lstm_cell_plain(ys[t], h, c, *packed, pwl=pwl)
            out[t] = h
        ys = out
    return ys


def check_stack_args(xs, layers) -> list[tuple[int, int]]:
    """Validate the kernel's arguments; returns the layers' (In, H)."""
    if xs.dim() != 3:
        raise ValueError(f"xs must be (T, B, F), got {tuple(xs.shape)}")
    dims = layer_dims(layers)
    if not fits(dims):
        raise ValueError(f"the stack {dims} does not fit lstm_stack (fits())")
    if dims[0][0] != xs.shape[2]:
        raise ValueError(f"xs has {xs.shape[2]} features, the first layer takes {dims[0][0]}")
    for l, (layer, (in_dim, hidden)) in enumerate(zip(layers, dims)):
        want = {"wx": (in_dim, 4 * hidden), "wh": (hidden, 4 * hidden), "b": (4 * hidden,)}
        for name, shape in want.items():
            if tuple(layer[name].shape) != shape:
                raise ValueError(f"layer {l} {name} has shape {tuple(layer[name].shape)}, "
                                 f"expected {shape}")
    tensors = [xs] + [layer[k] for layer in layers for k in ("wx", "wh", "b")]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("lstm_stack takes float32 xs and weights")
    if any(t.device != xs.device for t in tensors):
        raise ValueError("all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all tensors must be contiguous")
    return dims


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("lstm_stack")
    lib.lstm_stack_forward.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                                       + [ctypes.c_void_p])
    lib.lstm_stack_forward.restype = ctypes.c_int
    lib.lstm_stack_fits.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.lstm_stack_fits.restype = ctypes.c_int
    lib.lstm_stack_rows.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] \
        + [ctypes.c_int] * 3
    lib.lstm_stack_rows.restype = ctypes.c_int
    lib.lstm_stack_error_string.argtypes = [ctypes.c_int]
    lib.lstm_stack_error_string.restype = ctypes.c_char_p
    return lib


def _int_arrays(dims):
    n = len(dims)
    return (ctypes.c_int * n)(*(i for i, _ in dims)), (ctypes.c_int * n)(*(h for _, h in dims))


def library_fits(dims: Sequence[tuple[int, int]]) -> bool:
    """The kernel library's own fit rule (builds the library; needs ``nvcc``)."""
    ins, hs = _int_arrays(dims)
    return bool(_lib().lstm_stack_fits(len(dims), ins, hs))


def lstm_stack_rows(dims: Sequence[tuple[int, int]], t_len: int, batch: int,
                    pwl: bool = False) -> int:
    """Rows per cluster a launch at this shape takes on the current device,
    as the library chooses them (0: the stack does not fit)."""
    ins, hs = _int_arrays(dims)
    return _lib().lstm_stack_rows(len(dims), ins, hs, t_len, batch, int(pwl))


def lstm_stack_cuda(xs, layers, *, pwl: bool = False):
    """Launch the CUDA kernel once on the current stream (no synchronisation).

    Returns ys (T, B, H_last).  Raises on a CPU tensor, on any shape, dtype
    or layout the kernel does not take, and when the launch is refused.
    Each launch adds one to ``lstm_stack_cuda.launches`` (``.captured``
    while a CUDA graph is being captured; :func:`~repro_torch.kernels.count_launch`)."""
    if xs.device.type != "cuda":
        raise ValueError(f"lstm_stack_cuda needs CUDA tensors, got {xs.device}")
    if xs.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors are on {xs.device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    dims = check_stack_args(xs, layers)
    t_len, bsz, _ = xs.shape
    ys = torch.empty((t_len, bsz, dims[-1][1]), dtype=torch.float32, device=xs.device)
    if t_len == 0 or bsz == 0:
        return ys
    depth = len(dims)

    def ptrs(key):
        return (ctypes.c_void_p * depth)(*(layer[key].data_ptr() for layer in layers))

    ins, hs = _int_arrays(dims)
    lib = _lib()
    rc = lib.lstm_stack_forward(
        xs.data_ptr(), ys.data_ptr(), ptrs("wx"), ptrs("wh"), ptrs("b"), ins, hs, depth,
        t_len, bsz, int(pwl), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"lstm_stack kernel launch failed: {lib.lstm_stack_error_string(rc).decode()} "
            f"(T={t_len}, B={bsz}, layers={dims})")
    count_launch(lstm_stack_cuda)
    return ys


lstm_stack_cuda.launches = 0
lstm_stack_cuda.captured = 0   # recorded into CUDA graphs, see count_launch
