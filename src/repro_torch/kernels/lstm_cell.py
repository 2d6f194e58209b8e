"""Fused LSTM cell: the CUDA kernel's launch wrapper and its plain PyTorch version.

Counterpart of ``repro/kernels/lstm_cell.py::lstm_cell_pallas`` (K1).  One
timestep of MVM_X + MVM_H + gates + the element-wise update, as one kernel
written by hand for Hopper in ``csrc/lstm_cell.cu``.

Design: the launch is a GEMM [x | h] (B x (In+H)) times the four gates'
weights, on FP32 FMAs (the f32 bar of 1e-5 rules out plain TF32), with the c'/h'
update fused into its epilogue.  A block owns a tile of batch rows and
hidden units with all four gates; the contraction runs in chunks of 16
through double-buffered shared memory (``cp.async`` where rows are 16-byte
aligned f32), and each thread keeps a register micro-tile of up to 4 rows x
2 units x 4 gates, so one shared-memory load of a weight feeds up to four
FMAs and one of an activation eight.  The first design fed every
FMA with its own load of a weight from L1/L2 and was bound by those loads.
The tile is chosen by shape (:func:`lstm_cell_tile`): large batches take
64-row tiles, small ones spread over hidden-unit blocks.  The ``fused``
schedule launches K1 only above its crossover batch (bulk scoring); one
window a request and the gateway's flushes run the whole stack in one
``lstm_stack`` launch instead (``kernels/lstm_stack.py``).  Its bound on an H100 is the larger of 8·B·H·(In+H)
FLOP at 67 TFLOP/s and its bytes at 3.35 TB/s; at the paper's widths the
operations bound it.  The engine captures the serving path's
per-(layer, timestep) launches into one CUDA graph per shape
(``engine/capture.py``), so the host issues one graph launch per request,
not one launch per cell step.

Weights are gate-major: wx (4, In, H), wh (4, H, H), b (4, H), f32
(:func:`pack_weights` converts the core layout).  x and h are f32 or bf16;
c is f32.  h' comes out in h's dtype and c' always in f32.  Any In and H are
taken; one launch takes at most 65,535 row tiles of 64, so 4,194,240 rows,
and a larger batch is refused (``RuntimeError``).

:func:`lstm_cell_cuda` launches the kernel on CUDA tensors and raises on
anything it does not take; :func:`lstm_cell_plain` is the same function in
plain PyTorch (following ``repro/kernels/ref.py::ref_lstm_cell``), used for
CPU tensors and as the kernel's yardstick of correctness.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build, count_launch

_DTYPES = (torch.float32, torch.bfloat16)


def pack_weights(params: dict) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Core layout {wx (In,4H), wh (H,4H), b (4H,)} -> gate-major, contiguous
    (4, In, H) / (4, H, H) / (4, H)."""
    wx = torch.stack(params["wx"].chunk(4, dim=1))
    wh = torch.stack(params["wh"].chunk(4, dim=1))
    b = torch.stack(params["b"].chunk(4))
    return wx, wh, b


def lstm_cell_plain(x, h, c, wx, wh, b, *, pwl: bool = False):
    """The kernel's function in plain PyTorch: x (B,In); h, c (B,H); packed weights."""
    if pwl:
        def sig(t):
            return torch.clamp(0.25 * t + 0.5, 0.0, 1.0)

        def tnh(t):
            return torch.clamp(t, -1.0, 1.0)
    else:
        sig, tnh = torch.sigmoid, torch.tanh
    # bf16 x / h promote to f32 against the f32 weights, as in JAX
    gates = (
        torch.einsum("bi,gio->gbo", x.float(), wx)
        + torch.einsum("bh,gho->gbo", h.float(), wh)
        + b[:, None, :]
    ).float()
    i_g, f_g, g_g, o_g = gates.unbind(0)
    c_new = sig(f_g) * c.float() + sig(i_g) * tnh(g_g)
    h_new = sig(o_g) * tnh(c_new)
    return h_new.to(h.dtype), c_new


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and b0 < a0 + a.numel() * a.element_size()


def check_cell_args(x, h, c, wx, wh, b, h_out=None, c_out=None):
    """Validate the kernel's arguments; returns (h_out, c_out), allocated with
    ``torch.empty`` where not given.  ``c_out`` may be ``c`` itself (in-place
    update); ``h_out`` must not overlap x, h or c."""
    if x.dim() != 2 or h.dim() != 2:
        raise ValueError(f"x and h must be 2-D, got {tuple(x.shape)} and {tuple(h.shape)}")
    bsz, in_dim = x.shape
    hidden = h.shape[1]
    want = {"h": (h, (bsz, hidden)), "c": (c, (bsz, hidden)), "wx": (wx, (4, in_dim, hidden)),
            "wh": (wh, (4, hidden, hidden)), "b": (b, (4, hidden))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if x.dtype not in _DTYPES or h.dtype != x.dtype:
        raise TypeError(f"x and h must share a dtype in {_DTYPES}, got {x.dtype} and {h.dtype}")
    for name, t in (("c", c), ("wx", wx), ("wh", wh), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if h_out is None:
        h_out = torch.empty((bsz, hidden), dtype=h.dtype, device=x.device)
    if c_out is None:
        c_out = torch.empty((bsz, hidden), dtype=torch.float32, device=x.device)
    if tuple(h_out.shape) != (bsz, hidden) or h_out.dtype != h.dtype:
        raise ValueError(f"h_out must be {(bsz, hidden)} {h.dtype}")
    if tuple(c_out.shape) != (bsz, hidden) or c_out.dtype != torch.float32:
        raise ValueError(f"c_out must be {(bsz, hidden)} float32")
    args = (x, h, c, wx, wh, b, h_out, c_out)
    if any(t.device != x.device for t in args):
        raise ValueError("all tensors must be on one device")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("all tensors must be contiguous")
    if any(_overlap(h_out, t) for t in (x, h, c, c_out)):
        raise ValueError("h_out must not overlap x, h, c or c_out")
    if c_out.data_ptr() != c.data_ptr() and any(_overlap(c_out, t) for t in (x, h, c)):
        raise ValueError("c_out must be c itself or not overlap x, h, c")
    return h_out, c_out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("lstm_cell")
    lib.lstm_cell_forward.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.lstm_cell_forward.restype = ctypes.c_int
    lib.lstm_cell_error_string.argtypes = [ctypes.c_int]
    lib.lstm_cell_error_string.restype = ctypes.c_char_p
    lib.lstm_cell_tile.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.lstm_cell_tile.restype = None
    return lib


def lstm_cell_tile(batch: int, hidden: int) -> tuple[int, int]:
    """(rows, hidden units) of the block tile a launch at this shape uses, as
    the kernel's library chooses it (builds the library; needs ``nvcc``)."""
    bm, bn = ctypes.c_int(), ctypes.c_int()
    _lib().lstm_cell_tile(batch, hidden, ctypes.byref(bm), ctypes.byref(bn))
    return bm.value, bn.value


def lstm_cell_cuda(x, h, c, wx, wh, b, *, pwl: bool = False,
                   h_out: Optional[torch.Tensor] = None,
                   c_out: Optional[torch.Tensor] = None):
    """Launch the CUDA kernel on the current stream (no synchronisation).

    Returns (h', c').  Raises on a CPU tensor, on any shape, dtype, layout or
    aliasing the kernel does not take, and when the launch is refused.
    Each launch adds one to ``lstm_cell_cuda.launches`` (``.captured``
    while a CUDA graph is being captured; :func:`~repro_torch.kernels.count_launch`)."""
    if x.device.type != "cuda":
        raise ValueError(f"lstm_cell_cuda needs CUDA tensors, got {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors are on {x.device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    h_out, c_out = check_cell_args(x, h, c, wx, wh, b, h_out, c_out)
    bsz, in_dim = x.shape
    if bsz == 0:
        return h_out, c_out
    lib = _lib()
    rc = lib.lstm_cell_forward(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), wx.data_ptr(), wh.data_ptr(), b.data_ptr(),
        h_out.data_ptr(), c_out.data_ptr(), bsz, in_dim, h.shape[1],
        int(x.dtype == torch.bfloat16), int(pwl), torch.cuda.current_stream().cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"lstm_cell kernel launch failed: {lib.lstm_cell_error_string(rc).decode()} "
            f"(B={bsz}, In={in_dim}, H={h.shape[1]}, dtype={x.dtype})")
    count_launch(lstm_cell_cuda)
    return h_out, c_out


lstm_cell_cuda.launches = 0
lstm_cell_cuda.captured = 0   # recorded into CUDA graphs, see count_launch
