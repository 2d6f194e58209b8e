"""The LSTM autoencoder's forward and per-window reconstruction error in plain
float32 torch: the reference that decides a run's ``correct``.

It follows the paper's model (Section 2): stacked LSTM layers, the encoder
halving the width to the bottleneck and the decoder doubling it back, the last
layer's hidden state the reconstruction of x_t.  Each cell, gates in the order
(i, f, g, o):

    z = x_t Wx + h_{t-1} Wh + b,  i, f, g, o = split(z, 4)
    c_t = sigmoid(f) c_{t-1} + sigmoid(i) tanh(g),  h_t = sigmoid(o) tanh(c_t)

with h_0 = c_0 = 0, and a window's score is the mean over (t, feature) of the
squared difference between reconstruction and input, summed in float64: the
compared score then carries no rounding of its own.  The weights come in their
raw layout, a list of {"wx": (In, 4H), "wh": (H, 4H), "b": (4H,)}: nothing a
program derived from them (packed or padded gates) is read.

Plain float32 means no TF32: the matrix products run with
``torch.backends.cuda.matmul.allow_tf32`` and ``torch.backends.cudnn.allow_tf32``
False.  ``tf32=True`` computes the same in TF32 instead, which is the control a
sound comparison has to fail: every operand of a product is rounded to TF32's
10 bits of mantissa (to nearest, ties away from zero, as the tensor cores'
conversion rounds) and the products still sum in float32.  The rounding is
explicit, so the control is TF32 at any batch: a library's choice of kernel at
one window a request would otherwise decide whether TF32 is used at all.  This
module imports nothing of the program.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Sequence

import torch


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """TF32 off for the block's products, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32's 10 bits of mantissa, to nearest with ties
    away from zero: 2^12 added to the magnitude's bits, the low 13 cleared."""
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def lstm_layer(layer: dict, xs: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """One layer over a window: xs (T, B, In) -> hidden states (T, B, H)."""
    wx, wh, b = layer["wx"], layer["wh"], layer["b"]
    cast = to_tf32 if tf32 else (lambda t: t)
    wx, wh = cast(wx), cast(wh)
    hidden = wh.shape[0]
    h = xs.new_zeros((xs.shape[1], hidden))
    c = xs.new_zeros((xs.shape[1], hidden))
    gx = torch.matmul(cast(xs), wx) + b            # the x product of every step at once
    out = []
    for t in range(xs.shape[0]):
        i, f, g, o = (gx[t] + cast(h) @ wh).chunk(4, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    return torch.stack(out)


def reconstruct(layers: Sequence[dict], series: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """series (B, T, F) -> reconstruction (B, T, F)."""
    ys = series.transpose(0, 1)
    for layer in layers:
        ys = lstm_layer(layer, ys, tf32)
    return ys.transpose(0, 1)


def scores(layers: Sequence[dict], series: torch.Tensor, *, block: int = 8192,
           tf32: bool = False) -> torch.Tensor:
    """Per-window mean squared reconstruction error (B,) of ``series`` (B, T, F)
    in float64 on the weights' device, computed ``block`` windows at a time."""
    dev = layers[0]["wx"].device
    out = []
    with torch.no_grad(), no_tf32():
        for lo in range(0, series.shape[0], block):
            x = series[lo:lo + block].to(dev, torch.float32)
            err = (reconstruct(layers, x, tf32).double() - x.double()).square().mean(dim=(1, 2))
            out.append(err)
    return torch.cat(out)
