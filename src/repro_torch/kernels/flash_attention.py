"""Flash-attention forward: the CUDA kernel's launch wrapper and its plain PyTorch version.

Counterpart of ``repro/kernels/flash_attention.py::flash_attention_pallas``
(K4): attention with an online softmax over K/V tiles, causal or not,
written by hand for Hopper in ``csrc/flash_attention.cu`` (see its header
for the design).  As in the reference it is reached only through
``ops.flash_attention_op``; no model layer calls it.

The dtype picks the kernel, and neither stands in for the other.  Both run
on the tensor cores with ``mma.sync``, FlashAttention-2 style: K/V tiles
double-buffered in shared memory by ``cp.async`` (zero-filled past Sk), Q
fragments and the online softmax in registers, P fed to P·V from registers.
bf16 runs m16n8k16 bf16 products.  f32 runs **3xTF32** m16n8k8 products:
each f32 operand is split into a TF32 "big" part and a TF32 "small"
remainder and a·b is taken as a_small·b_big + a_big·b_small + a_big·b_big,
which keeps about 20 bits of each operand.  The f32 limit rules out plain
(1x) TF32, which keeps 10 mantissa bits, not 3xTF32
(``tests/test_torch_flash_attention.py`` pins both sides).  The first
design ran f32 on the FP32 FMAs, with K staged synchronously and P sent
through shared memory, at 29% of the FP32 cores' 67 TFLOP/s.
:func:`kernel_name` names the kernel that serves a call and
:func:`copy_path` the f32 kernel's copy path (16-byte ``cp.async`` where
every row starts on 16 bytes, else 4-byte).  Its bound on an H100 is 4·d
FLOP per visible (query, key) pair, at 989 TFLOP/s for bf16, and 3x that
FLOP at the TF32 tensor cores' 495 TFLOP/s for f32, against q, k, v and o
once at 3.35 TB/s; at phi4-mini-3.8b's heads the operations bound both.
Left for later: ``wgmma`` with TMA loads and warp specialisation, the only
way to the tensor cores' full rate.

Layout (B, H, S, d) for q and o, (B, H, Sk, d) for k and v, as the Pallas
kernel takes them; f32 or bf16, one dtype for all three.  The kernel reads
rows through strides, so views whose last dimension is contiguous are taken
as they are, and o is written through its own strides
(``ops.flash_attention_op`` hands it transposed (B, S, H, d) tensors and a
transposed contiguous (B, S, H, d) o, so nothing is copied).  Scores are
f32 at scale 1/sqrt(d); P is cast to v's dtype before P·V; o = acc /
max(l, 1e-30) comes out in q's dtype.

**Causal alignment.** Under ``causal`` key j is visible to query i iff
j <= i: the mask is aligned top-left, as the Pallas kernel's
``k_pos <= q_pos`` (``flash_attention.py:53-55``) and as
``layers/attention.py::blocked_attention`` with ``q_offset=0``.
``kernels/ref.py::ref_attention`` aligns it bottom-right (``tril(k=Sk-S)``),
so it differs from the kernel, and from this port, only when S != Sk.  The
kernel takes any S and Sk (the Pallas kernel needs them divisible by its
blocks) and d in :data:`HEAD_DIMS`.  In bf16 every row of q, k, v and o
must start on 16 bytes (the tiles are copied 16 bytes at a time): the data
pointers, and the strides of every dimension longer than 1 in multiples of
8 elements; a contiguous tensor, or a transposed (B, S, H, d) one, is.  f32
takes any view with d contiguous.

:func:`flash_attention_cuda` launches the kernel on CUDA tensors and raises
on anything it does not take; :func:`flash_attention_plain` is the same
function in plain PyTorch (exact softmax in f32), used for CPU tensors and as
the kernel's yardstick.
"""
from __future__ import annotations

import ctypes
import functools
import math
import torch

from repro_torch.kernels import _build, count_launch

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (64, 128)


def flash_attention_plain(q, k, v, *, causal: bool = True):
    """The kernel's function in plain PyTorch: exact softmax in f32 over
    (B, H, S, Sk) with the top-left causal mask; q (B,H,S,d), k/v (B,H,Sk,d)."""
    s, sk, d = q.shape[2], k.shape[2], q.shape[3]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(d))
    if causal:
        visible = torch.ones((s, sk), dtype=torch.bool, device=q.device).tril()
        scores.masked_fill_(~visible, -1e30)
    p = torch.softmax(scores, dim=-1)
    del scores
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def check_attention_args(q, k, v) -> None:
    """Validate the kernel's arguments; raises on what it does not take."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be (B, H, S, d), got {tuple(q.shape)} and {tuple(k.shape)}")
    bsz, heads, _, d = q.shape
    sk = k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (bsz, heads, sk, d):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(bsz, heads, sk, d)}")
    args = (q, k, v)
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in args):
        raise TypeError(f"q, k, v must share a dtype in {_DTYPES}, got {[t.dtype for t in args]}")
    if any(t.device != q.device for t in args):
        raise ValueError("all tensors must be on one device")
    if any(t.stride(-1) != 1 for t in args):
        raise ValueError("the last dimension of q, k and v must be contiguous")
    if sk == 0:
        raise ValueError("attention needs at least one key (Sk = 0)")


def rows_on_16_bytes(*tensors) -> bool:
    """Whether every row of each (B, H, rows, d) view starts on 16 bytes:
    its data pointer, and the stride of each dimension longer than 1, a
    multiple of 16 bytes (the kernel's own test, in ``flash_attention.cu``)."""
    for t in tensors:
        size = t.element_size()
        if t.data_ptr() % 16 or any(t.shape[dim] > 1 and (t.stride(dim) * size) % 16
                                    for dim in range(t.dim() - 1)):
            return False
    return True


def check_row_alignment(*tensors) -> None:
    """Raise unless every row of each bf16 (B, H, rows, d) view starts on 16
    bytes (:func:`rows_on_16_bytes`).  The bf16 kernel copies tiles 16 bytes
    at a time."""
    for t in tensors:
        if not rows_on_16_bytes(t):
            raise ValueError(
                f"the bf16 kernel needs every row of q, k, v and o on 16 bytes: a view with "
                f"data pointer {t.data_ptr():#x} and strides {t.stride()} breaks this")


def copy_path(q, k, v, out) -> str:
    """How the kernel copies K/V tiles for these views: 16-byte ``cp.async``
    when every row of q, k, v and out starts on 16 bytes (always for bf16,
    which refuses other views), else 4-byte ``cp.async`` (f32 only)."""
    return "16-byte cp.async" if rows_on_16_bytes(q, k, v, out) else "4-byte cp.async"


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_forward.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                                            + [ctypes.c_void_p])
    lib.flash_attention_forward.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    lib.flash_attention_kernel_name.argtypes = [ctypes.c_int] * 3
    lib.flash_attention_kernel_name.restype = ctypes.c_char_p
    return lib


def kernel_name(dtype: torch.dtype, head_dim: int, causal: bool) -> str:
    """The kernel instantiation that serves (dtype, d, causal), as the
    library names it (builds the library; needs ``nvcc``)."""
    return _lib().flash_attention_kernel_name(
        int(dtype == torch.bfloat16), head_dim, int(causal)).decode()


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the CUDA kernel once on the current stream (no synchronisation).

    q (B,H,S,d), k/v (B,H,Sk,d), each with its last dimension contiguous;
    returns o (B,H,S,d) in q's dtype: a new contiguous tensor, or ``out``
    written through its strides (any (B,H,S,d) view with d contiguous that
    shares no storage with q, k, v; ``ops.flash_attention_op`` passes the
    transpose of a contiguous (B,S,H,d) tensor).  Raises on a CPU tensor, on
    any shape, dtype or layout the kernel does not take (d outside
    :data:`HEAD_DIMS`, a bf16 row off 16 bytes), and when the launch is
    refused.  Each launch adds one
    to ``flash_attention_cuda.launches`` (``.captured``
    while a CUDA graph is being captured; :func:`~repro_torch.kernels.count_launch`)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {q.device}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors are on {q.device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    check_attention_args(q, k, v)
    if out is not None and (out.shape != q.shape or out.dtype != q.dtype
                            or out.device != q.device or out.stride(-1) != 1):
        raise ValueError(f"out must be a {tuple(q.shape)} {q.dtype} view on {q.device} with its "
                         f"last dimension contiguous, got {tuple(out.shape)} {out.dtype} on "
                         f"{out.device} with strides {out.stride()}")
    if out is not None and out.numel() and any(
            out.untyped_storage().data_ptr() == t.untyped_storage().data_ptr() for t in (q, k, v)):
        raise ValueError("out must not share storage with q, k or v")
    bsz, heads, s, d = q.shape
    sk = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims {HEAD_DIMS}, got {d}")
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if bsz == 0 or heads == 0 or s == 0:
        return out
    if q.dtype == torch.bfloat16:
        check_row_alignment(q, k, v, out)
    strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, v, out) for st in t.stride()[:3]))
    lib = _lib()
    rc = lib.flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ctypes.addressof(strides),
        bsz, heads, s, sk, d, int(q.dtype == torch.bfloat16), int(causal),
        torch.cuda.current_stream().cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: "
            f"{lib.flash_attention_error_string(rc).decode()} "
            f"(B={bsz}, H={heads}, S={s}, Sk={sk}, d={d}, dtype={q.dtype}, causal={causal})")
    count_launch(flash_attention_cuda)
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.captured = 0   # recorded into CUDA graphs, see count_launch
