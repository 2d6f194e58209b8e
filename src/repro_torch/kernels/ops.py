"""Public wrappers around the hand-written kernels.

Counterpart of ``repro/kernels/ops.py``.  The reference picks interpret
mode off the TPU; here the device of the tensors decides: a CPU tensor goes
to the kernel's plain PyTorch version, a CUDA tensor to the kernel, which
launches or raises, and a meta tensor (the dry run) to the kernel's meta
op (``meta.py``: the kernel's output shapes and its FLOPs, nothing run).  Nothing falls back from the kernel to the plain version.

- :func:`lstm_cell_op` — K1, one LSTM timestep; the body of the ``fused``
  schedule at batches above its crossover (bulk scoring), once per (layer,
  timestep).
- :func:`lstm_stack_op` — the LSTM-AE's whole recurrent stack over a window
  in one launch on the wavefront schedule; the ``fused`` schedule's forward
  at small batches (one window a request, the gateway's flushes).
- :func:`lstm_seq_op` — K2, one LSTM layer over a whole window in one
  launch.  As in the reference, this wrapper is K2's only entry point and
  no schedule uses it.  Its bound on an H100 is the larger of
  8·T·B·H·(In+H) FLOP at 67 TFLOP/s (FP32 cores) and its bytes (inputs and
  outputs once, weights once) at 3.35 TB/s; at the paper's widths the
  FLOP bound it.  Left for later: tensor cores, and splitting H across a
  thread-block cluster for weights larger than one block's shared memory
  (today those are read from L2 every step).
- :func:`wkv6_op` — K3, the RWKV-6 WKV recurrence over (B, T, H, hd); the
  RWKV-6 layer's exact scan and decode step (``layers/rwkv.py``).
- :func:`flash_attention_op` — K4, the flash-attention forward over
  (B, S, H, d), causal mask aligned top-left.

K3 and K4 are reached only through these two wrappers.  The RWKV-6 layer
calls ``wkv6_op`` (the reference's layer computes K3's function in jnp and
never calls its kernel); no model layer calls ``flash_attention_op``.  The reference wrappers' ``block_q``/``block_k``
and ``interpret`` are TPU tiling and mode knobs that do not change the
function; they are not carried over.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import meta
from repro_torch.kernels.lstm_cell import (
    check_cell_args,
    lstm_cell_cuda,
    lstm_cell_plain,
    pack_weights,
)
from repro_torch.kernels.flash_attention import (
    check_attention_args,
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.lstm_seq import check_seq_args, lstm_seq_cuda, lstm_seq_plain
from repro_torch.kernels.lstm_stack import check_stack_args, lstm_stack_cuda, lstm_stack_plain
from repro_torch.kernels.wkv6 import check_wkv6_args, wkv6_cuda, wkv6_plain


def lstm_cell_op(params, x, h, c, *, pwl: bool = False,
                 h_out: Optional[torch.Tensor] = None,
                 c_out: Optional[torch.Tensor] = None):
    """Fused LSTM cell.  ``params`` is the core layout {wx, wh, b} or the
    (wx, wh, b) tuple of :func:`pack_weights` (pack once, call per timestep).
    c is taken in f32, as the kernel keeps it.  Returns (h', c'), written into
    ``h_out`` / ``c_out`` when given (``c_out`` may be ``c``)."""
    wx, wh, b = params if isinstance(params, tuple) else pack_weights(params)
    c = c.float()
    if x.device.type == "cuda":
        return lstm_cell_cuda(x, h, c, wx, wh, b, pwl=pwl, h_out=h_out, c_out=c_out)
    if x.device.type == "meta":
        h_new, c_new = meta.lstm_cell(x, h, c, wx, wh, b, pwl)
        return (h_new if h_out is None else h_out), (c_new if c_out is None else c_out)
    if x.device.type != "cpu":
        raise ValueError(f"lstm_cell_op runs on cuda or cpu tensors, got {x.device}")
    h_out, c_out = check_cell_args(x, h, c, wx, wh, b, h_out, c_out)
    h_new, c_new = lstm_cell_plain(x, h, c, wx, wh, b, pwl=pwl)
    h_out.copy_(h_new)
    c_out.copy_(c_new)
    return h_out, c_out


def lstm_seq_op(params, xs, h0=None, c0=None, *, pwl: bool = False):
    """Sequence-streaming LSTM layer, state on chip across T.

    ``params`` is the core layout {wx, wh, b} or a packed (wx, wh, b) tuple;
    xs (T, B, In) -> (ys (T, B, H), (h_T, c_T)).  h0 defaults to zeros in
    xs's dtype and c0 to zeros in f32, as in the reference; c0 is taken in
    f32."""
    wx, wh, b = params if isinstance(params, tuple) else pack_weights(params)
    bsz, hidden = xs.shape[1], wh.shape[1]
    if h0 is None:
        h0 = torch.zeros((bsz, hidden), dtype=xs.dtype, device=xs.device)
    c0 = torch.zeros((bsz, hidden), dtype=torch.float32, device=xs.device) if c0 is None \
        else c0.float()
    if xs.device.type == "cuda":
        return lstm_seq_cuda(xs, h0, c0, wx, wh, b, pwl=pwl)
    if xs.device.type == "meta":
        return meta.lstm_seq(xs, h0, c0, wx, wh, b, pwl)
    if xs.device.type != "cpu":
        raise ValueError(f"lstm_seq_op runs on cuda or cpu tensors, got {xs.device}")
    check_seq_args(xs, h0, c0, wx, wh, b)
    return lstm_seq_plain(xs, h0, c0, wx, wh, b, pwl=pwl)


def lstm_stack_op(layers, xs, *, pwl: bool = False):
    """The recurrent stack of an LSTM-AE over a window from zero state:
    ``layers`` the core layout {wx, wh, b} of each layer, xs (T, B, In_0)
    f32 -> the last layer's h, (T, B, H_last).  The weights are read as they
    are (made contiguous where they are not); no pack, no zero-fill."""
    layers = [{k: layer[k].contiguous() for k in ("wx", "wh", "b")} for layer in layers]
    xs = xs.contiguous()
    if xs.device.type == "cuda":
        return lstm_stack_cuda(xs, layers, pwl=pwl)
    if xs.device.type == "meta":
        return meta.lstm_stack(xs, layers, pwl)
    if xs.device.type != "cpu":
        raise ValueError(f"lstm_stack_op runs on cuda or cpu tensors, got {xs.device}")
    check_stack_args(xs, layers)
    return lstm_stack_plain(xs, layers, pwl=pwl)


def wkv6_op(r, k, v, w, u, s0):
    """RWKV-6 WKV recurrence: r, k, v (B, T, H, hd) in one dtype (f32 or
    bf16), w (B, T, H, hd), u (H, hd) and s0 (B, H, hd, hd) in f32 ->
    (y (B, T, H, hd) f32, S_T (B, H, hd, hd) f32).  Chunks chain: a call on
    the rest of a sequence with the state the first call returned equals one
    call on the whole."""
    if r.device.type == "cuda":
        return wkv6_cuda(r, k, v, w, u, s0)
    if r.device.type == "meta":
        return meta.wkv6(r, k, v, w, u, s0)
    if r.device.type != "cpu":
        raise ValueError(f"wkv6_op runs on cuda or cpu tensors, got {r.device}")
    check_wkv6_args(r, k, v, w, u, s0)
    return wkv6_plain(r, k, v, w, u, s0)


def flash_attention_op(q, k, v, *, causal: bool = True):
    """Attention over the (B, S, H, d) layout: q (B, S, H, d), k/v
    (B, Sk, H, d) with kv heads already expanded, one dtype (f32 or bf16);
    returns a contiguous (B, S, H, d) tensor in q's dtype on either device,
    whatever q's strides.  Under ``causal`` key j is visible to query i iff
    j <= i (top-left, as the Pallas kernel; ``ref_attention`` aligns
    bottom-right and agrees only when S == Sk).  The kernel reads the
    (B, H, S, d) views through strides and writes o through the transpose of
    a contiguous (B, S, H, d) tensor: no transpose is copied."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if q.device.type == "cuda":
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        flash_attention_cuda(qt, kt, vt, causal=causal, out=out.transpose(1, 2))
        return out
    if q.device.type == "meta":
        return meta.flash_attention(qt, kt, vt, causal).transpose(1, 2).contiguous()
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention_op runs on cuda or cpu tensors, got {q.device}")
    check_attention_args(qt, kt, vt)
    return flash_attention_plain(qt, kt, vt, causal=causal).transpose(1, 2).contiguous()


_WRAPPERS = {"lstm_cell": lstm_cell_cuda, "lstm_seq": lstm_seq_cuda, "wkv6": wkv6_cuda,
             "flash_attention": flash_attention_cuda, "lstm_stack": lstm_stack_cuda}


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel (plain-version calls are not
    counted; a CUDA graph's launches count at each replay)."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


def captured_counts() -> dict[str, int]:
    """Kernel launches recorded into CUDA graphs so far, by kernel."""
    return {name: fn.captured for name, fn in _WRAPPERS.items()}


def add_launches(counts: dict[str, int]) -> None:
    """Count the kernel launches of one CUDA graph replay."""
    for name, n in counts.items():
        _WRAPPERS[name].launches += n
