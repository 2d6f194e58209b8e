"""Sequence-streaming LSTM layer: the CUDA kernel's launch wrapper and its plain PyTorch version.

Counterpart of ``repro/kernels/lstm_seq.py::lstm_seq_pallas`` (K2).  One
LSTM layer over a whole window in one launch, (h, c) kept on chip between
timesteps and the weights stationary, written by hand for Hopper in
``csrc/lstm_seq.cu`` (see its header).  As in the reference it is reached
only through ``ops.lstm_seq_op``; no schedule uses it.

Design: each timestep is a small GEMM [x_t | h_{t-1}] times the four gates'
weights on FP32 FMAs, with the c/h update in its epilogue, as K1 does one
timestep; a block owns a tile of batch rows with all hidden units and all
four gates and runs all T steps, so h_t never leaves it.  Each thread keeps
a register micro-tile of up to 8 rows x 2 units x 4 gates, so one
shared-memory read of a weight feeds up to 8 FMAs (the first design fed
every FMA with its own weight load); x_{t+1} is copied in with ``cp.async``
while step t computes, h_t goes to the other half of a double-buffered
shared tile, and one barrier separates the steps.  Weights sit in shared
memory, gate-interleaved per unit, where they fit (:func:`lstm_seq_plan`);
else each step reads them from L2.  The tile is chosen by shape
(:func:`lstm_seq_tile`).  The f32 bar (1e-5 over up to 64 compounding
steps) keeps it off the tensor cores.  Its bound on an H100 is the larger of
8·T·B·H·(In+H) FLOP at 67 TFLOP/s and its bytes at 3.35 TB/s; at the
paper's widths the operations bound it.

xs (T, B, In) is f32 or bf16; h0 (B, H) f32 or bf16; c0 (B, H) f32; the
weights are gate-major f32 (:func:`~repro_torch.kernels.lstm_cell.pack_weights`).
Returns ys (T, B, H) in xs's dtype, h_T in h0's dtype and c_T in f32.  Each
step casts h to xs's dtype before MVM_H, as the reference does
(``lstm_seq.py:51``), so in bf16 the recurrent h is rounded every step —
unlike K1, which does not round h.  Any In is taken and H up to 1024 (the
block holds a thread for every two hidden units); a wider H is refused
(``RuntimeError``).

:func:`lstm_seq_cuda` launches the kernel on CUDA tensors and raises on
anything it does not take; :func:`lstm_seq_plain` is the same function in
plain PyTorch, used for CPU tensors and as the kernel's yardstick.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, count_launch

_DTYPES = (torch.float32, torch.bfloat16)


def lstm_seq_plain(xs, h0, c0, wx, wh, b, *, pwl: bool = False):
    """The kernel's function in plain PyTorch, a T-step loop in the
    reference's dtype order: xs (T,B,In); h0, c0 (B,H); packed weights."""
    if pwl:
        def sig(t):
            return torch.clamp(0.25 * t + 0.5, 0.0, 1.0)

        def tnh(t):
            return torch.clamp(t, -1.0, 1.0)
    else:
        sig, tnh = torch.sigmoid, torch.tanh
    t_len, bsz, _ = xs.shape
    h = h0.float()
    c = c0.float()
    ys = torch.empty((t_len, bsz, wh.shape[1]), dtype=xs.dtype, device=xs.device)
    for t in range(t_len):
        # bf16 x and h (cast to x's dtype first) promote to f32 against the f32 weights
        gates = (
            torch.einsum("bi,gio->gbo", xs[t].float(), wx)
            + torch.einsum("bh,gho->gbo", h.to(xs.dtype).float(), wh)
            + b[:, None, :]
        )
        i_g, f_g, g_g, o_g = gates.unbind(0)
        c = sig(f_g) * c + sig(i_g) * tnh(g_g)
        h = sig(o_g) * tnh(c)
        ys[t] = h.to(xs.dtype)
    return ys, (h.to(h0.dtype), c)


def check_seq_args(xs, h0, c0, wx, wh, b) -> None:
    """Validate the kernel's arguments; raises on what it does not take."""
    if xs.dim() != 3 or h0.dim() != 2:
        raise ValueError(f"xs must be 3-D and h0 2-D, got {tuple(xs.shape)} and {tuple(h0.shape)}")
    _, bsz, in_dim = xs.shape
    hidden = h0.shape[1]
    want = {"h0": (h0, (bsz, hidden)), "c0": (c0, (bsz, hidden)),
            "wx": (wx, (4, in_dim, hidden)), "wh": (wh, (4, hidden, hidden)),
            "b": (b, (4, hidden))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if xs.dtype not in _DTYPES or h0.dtype not in _DTYPES:
        raise TypeError(f"xs and h0 must be in {_DTYPES}, got {xs.dtype} and {h0.dtype}")
    for name, t in (("c0", c0), ("wx", wx), ("wh", wh), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    args = (xs, h0, c0, wx, wh, b)
    if any(t.device != xs.device for t in args):
        raise ValueError("all tensors must be on one device")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("all tensors must be contiguous")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("lstm_seq")
    lib.lstm_seq_forward.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.lstm_seq_forward.restype = ctypes.c_int
    lib.lstm_seq_weights_in_smem.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_size_t)]
    lib.lstm_seq_weights_in_smem.restype = ctypes.c_int
    lib.lstm_seq_tile.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.lstm_seq_tile.restype = ctypes.c_int
    lib.lstm_seq_error_string.argtypes = [ctypes.c_int]
    lib.lstm_seq_error_string.restype = ctypes.c_char_p
    return lib


def lstm_seq_plan(batch: int, in_dim: int, hidden: int) -> tuple[bool, int]:
    """(weights stationary in shared memory?, shared memory per block in
    bytes) for a launch of this shape on the current CUDA device — the
    kernel's own choice, asked of the built library."""
    lib = _lib()
    smem = ctypes.c_size_t(0)
    rc = lib.lstm_seq_weights_in_smem(batch, in_dim, hidden, ctypes.byref(smem))
    if rc < 0:
        raise RuntimeError(f"lstm_seq has no launch plan for B={batch}, In={in_dim}, "
                           f"H={hidden}: {lib.lstm_seq_error_string(-rc).decode()}")
    return bool(rc), smem.value


def lstm_seq_tile(batch: int, in_dim: int, hidden: int) -> tuple[int, int]:
    """(rows per block, rows per thread) of a launch of this shape on the
    current CUDA device — the kernel's own choice, asked of the built library."""
    lib = _lib()
    bm, tm = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.lstm_seq_tile(batch, in_dim, hidden, ctypes.byref(bm), ctypes.byref(tm))
    if rc < 0:
        raise RuntimeError(f"lstm_seq has no launch plan for B={batch}, In={in_dim}, "
                           f"H={hidden}: {lib.lstm_seq_error_string(-rc).decode()}")
    return bm.value, tm.value


def lstm_seq_cuda(xs, h0, c0, wx, wh, b, *, pwl: bool = False):
    """Launch the CUDA kernel once on the current stream (no synchronisation).

    Returns (ys, (h_T, c_T)).  Raises on a CPU tensor, on any shape, dtype
    or layout the kernel does not take, and when the launch is refused.
    Each launch adds one to ``lstm_seq_cuda.launches`` (``.captured``
    while a CUDA graph is being captured; :func:`~repro_torch.kernels.count_launch`)."""
    if xs.device.type != "cuda":
        raise ValueError(f"lstm_seq_cuda needs CUDA tensors, got {xs.device}")
    if xs.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors are on {xs.device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    check_seq_args(xs, h0, c0, wx, wh, b)
    t_len, bsz, in_dim = xs.shape
    hidden = h0.shape[1]
    ys = torch.empty((t_len, bsz, hidden), dtype=xs.dtype, device=xs.device)
    if t_len == 0 or bsz == 0:
        return ys, (h0.clone(), c0.clone())
    # the kernel reads h0 and writes h_T in f32; bf16 -> f32 -> bf16 is exact
    # for h0, and the final rounding is the reference's astype
    h0_f32 = h0.float()
    h_t = torch.empty((bsz, hidden), dtype=torch.float32, device=xs.device)
    c_t = torch.empty((bsz, hidden), dtype=torch.float32, device=xs.device)
    lib = _lib()
    rc = lib.lstm_seq_forward(
        xs.data_ptr(), h0_f32.data_ptr(), c0.data_ptr(), wx.data_ptr(), wh.data_ptr(),
        b.data_ptr(), ys.data_ptr(), h_t.data_ptr(), c_t.data_ptr(), t_len, bsz, in_dim,
        hidden, int(xs.dtype == torch.bfloat16), int(pwl),
        torch.cuda.current_stream().cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"lstm_seq kernel launch failed: {lib.lstm_seq_error_string(rc).decode()} "
            f"(T={t_len}, B={bsz}, In={in_dim}, H={hidden}, dtype={xs.dtype})")
    count_launch(lstm_seq_cuda)
    return ys, (h_t.to(h0.dtype), c_t)


lstm_seq_cuda.launches = 0
lstm_seq_cuda.captured = 0   # recorded into CUDA graphs, see count_launch
