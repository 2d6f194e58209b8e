"""RWKV-6 WKV recurrence: the CUDA kernel's launch wrapper and its plain PyTorch version.

Counterpart of ``repro/kernels/wkv6.py::wkv6_pallas`` (K3).  Per (batch,
head), with S the (hd, hd) f32 state carried across the sequence::

    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

written by hand for Hopper in ``csrc/wkv6.cu``: each (b, h) is a team of
threads that runs the whole time loop with S in registers, as the Pallas
grid keeps it in VMEM.  S is register-tiled (R rows x C columns a thread,
16 x 4 at hd=64), and the bonus term leaves the inner loop
(y_t = r_t S + (r_t·(u*k_t)) v_t, the scalar computed when a chunk is
staged), so each state element costs three FP32 instructions per step; the
threads that share a column sum their partial y by shuffles.  The streams
reach a 3-stage shared-memory ring by ``cp.async``, two chunks ahead of the
compute.  Its bound on an H100 is the larger of 5·hd² FLOP per (b, h, t) at
67 TFLOP/s (FP32 cores) and its bytes (r, k, v, w, u, s0 read once, y and
S_T written once) at 3.35 TB/s; at rwkv6-7b's heads (H=64, hd=64) the bytes
bound it, and the kernel's own floor, three FP32 instructions per state
element, lies just under them.  It is reached through ``ops.wkv6_op``,
which RWKV-6's layer calls (``layers/rwkv.py``: the exact scan, the decode
step at T=1, and the chunk states ``WKV6``'s backward rebuilds); the
reference's layer computes the same function as a ``lax.scan`` and never
calls its Pallas kernel.

r, k, v (B, T, H, hd) share a dtype, f32 or bf16; w (B, T, H, hd), u (H, hd)
and s0 (B, H, hd, hd) are f32.  Returns y (B, T, H, hd) and S_T (B, H, hd,
hd), both f32.  The kernel takes hd in :data:`HEAD_DIMS`.

:func:`wkv6_cuda` launches the kernel on CUDA tensors and raises on anything
it does not take; :func:`wkv6_plain` is the same function in plain PyTorch
(the step loop of ``repro/kernels/ref.py::ref_wkv6``), used for CPU tensors
and as the kernel's yardstick.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, count_launch

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64)


def wkv6_plain(r, k, v, w, u, s0):
    """The kernel's function in plain PyTorch: a T-step loop, f32 state, f32 y."""
    uf = u.float()[None, :, :, None]                    # (1, H, hd, 1)
    s = s0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t].float()[..., :, None] * v[:, t].float()[..., None, :]   # (B, H, hd, hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t].float(), s + uf * kv))
        s = w[:, t].float()[..., :, None] * s + kv
    y = torch.stack(ys, dim=1) if ys else r.new_empty(r.shape, dtype=torch.float32)
    return y, s


def check_wkv6_args(r, k, v, w, u, s0) -> None:
    """Validate the kernel's arguments; raises on what it does not take."""
    if r.dim() != 4:
        raise ValueError(f"r must be (B, T, H, hd), got {tuple(r.shape)}")
    bsz, _, heads, hd = r.shape
    want = {"k": (k, tuple(r.shape)), "v": (v, tuple(r.shape)), "w": (w, tuple(r.shape)),
            "u": (u, (heads, hd)), "s0": (s0, (bsz, heads, hd, hd))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k, v must share a dtype in {_DTYPES}, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("w", w), ("u", u), ("s0", s0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    args = (r, k, v, w, u, s0)
    if any(t.device != r.device for t in args):
        raise ValueError("all tensors must be on one device")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("all tensors must be contiguous")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("wkv6")
    lib.wkv6_forward.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.wkv6_forward.restype = ctypes.c_int
    lib.wkv6_tile.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.wkv6_tile.restype = ctypes.c_int
    lib.wkv6_error_string.argtypes = [ctypes.c_int]
    lib.wkv6_error_string.restype = ctypes.c_char_p
    return lib


_TILE_KEYS = ("rows", "cols", "threads_per_head", "heads_per_block", "threads_per_block",
              "smem_bytes", "chunk", "stages", "blocks_per_sm")


def wkv6_tile(head_dim: int, dtype=torch.float32) -> dict:
    """The kernel's tile at ``head_dim`` for r, k, v of ``dtype`` on the
    current CUDA device, asked of the built library: rows and columns of S
    per thread, threads per head, heads and threads per block, shared memory
    per block, timesteps per stage, ring stages, resident blocks per SM."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"wkv6 kernel takes head dims {HEAD_DIMS}, got {head_dim}")
    lib = _lib()
    out = (ctypes.c_int * len(_TILE_KEYS))()
    rc = lib.wkv6_tile(head_dim, int(dtype == torch.bfloat16), out)
    if rc != 0:
        raise RuntimeError(f"wkv6_tile failed: {lib.wkv6_error_string(rc).decode()}")
    return dict(zip(_TILE_KEYS, out))


def wkv6_cuda(r, k, v, w, u, s0):
    """Launch the CUDA kernel once on the current stream (no synchronisation).

    Returns (y, S_T).  Raises on a CPU tensor, on any shape, dtype or layout
    the kernel does not take (hd outside :data:`HEAD_DIMS`), and when the
    launch is refused.  The kernel copies the streams 16 bytes at a time, so
    a stream whose data does not start on 16 bytes is copied to one that
    does first.  Each launch adds one to ``wkv6_cuda.launches`` (``.captured``
    while a CUDA graph is being captured; :func:`~repro_torch.kernels.count_launch`)."""
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_cuda needs CUDA tensors, got {r.device}")
    if r.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors are on {r.device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    check_wkv6_args(r, k, v, w, u, s0)
    bsz, t_len, heads, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6 kernel takes head dims {HEAD_DIMS}, got {hd}")
    y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    if t_len == 0 or bsz == 0 or heads == 0:
        return y, s0.clone()
    s_out = torch.empty(s0.shape, dtype=torch.float32, device=r.device)
    r, k, v, w = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (r, k, v, w))
    lib = _lib()
    rc = lib.wkv6_forward(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), s0.data_ptr(),
        y.data_ptr(), s_out.data_ptr(), bsz, t_len, heads, hd,
        int(r.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"wkv6 kernel launch failed: {lib.wkv6_error_string(rc).decode()} "
            f"(B={bsz}, T={t_len}, H={heads}, hd={hd}, dtype={r.dtype})")
    count_launch(wkv6_cuda)
    return y, s_out


wkv6_cuda.launches = 0
wkv6_cuda.captured = 0   # recorded into CUDA graphs, see count_launch
