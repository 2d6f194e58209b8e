"""The kernels on the meta device: shapes and dtypes, no launch, one op each.

The dry run traces a step on meta tensors (``launch/dryrun.py``).  A
kernel's wrapper in ``ops.py`` sends meta tensors here: each kernel is
one op of the ``repro_torch`` namespace, ``torch.ops.repro_torch.<name>``,
whose Meta implementation returns the kernel's outputs (shapes and
dtypes, as the CUDA wrapper makes them) without running the plain
version's loop.  Its FLOPs are registered with ``torch.utils.flop_counter``
and equal what ``FlopCounterMode`` reads from the kernel's plain version
on the same shapes (its dots: the plain versions compute in f32), so the
dry run's cost model (``roofline/trace.py``) sees one op with those FLOPs
and the bytes of its inputs and outputs, counted once:

- ``lstm_cell`` (K1): 8·B·H·(In+H), the two gate products
- ``lstm_seq``  (K2): T times K1's
- ``lstm_stack``: K1's summed over the layers and T, 8·B·T·Σ H·(In+H)
- ``wkv6``      (K3): 2·B·T·H·hd², the einsum ``bhk,bhkv->bhv`` a step
  (the reference's ``lax.scan`` has the same single dot)
- ``flash_attention`` (K4): 4·B·H·S·Sk·d, QK^T and PV over every pair

The CUDA and CPU branches of the wrappers do not come here.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import flop_registry, register_flop_formula

_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("lstm_cell(Tensor x, Tensor h, Tensor c, Tensor wx, Tensor wh, Tensor b, "
            "bool pwl) -> (Tensor, Tensor)")
_LIB.define("lstm_seq(Tensor xs, Tensor h0, Tensor c0, Tensor wx, Tensor wh, Tensor b, "
            "bool pwl) -> (Tensor, Tensor, Tensor)")
_LIB.define("lstm_stack(Tensor xs, Tensor[] wx, Tensor[] wh, Tensor[] b, bool pwl) -> Tensor")
_LIB.define("wkv6(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor s0) "
            "-> (Tensor, Tensor)")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal) -> Tensor")


def _lstm_cell_meta(x, h, c, wx, wh, b, pwl):
    return torch.empty_like(h), torch.empty(c.shape, dtype=torch.float32, device=c.device)


def _lstm_seq_meta(xs, h0, c0, wx, wh, b, pwl):
    t_len, bsz, hidden = xs.shape[0], xs.shape[1], wh.shape[1]
    ys = torch.empty((t_len, bsz, hidden), dtype=xs.dtype, device=xs.device)
    return (ys, torch.empty_like(h0),
            torch.empty((bsz, hidden), dtype=torch.float32, device=xs.device))


def _lstm_stack_meta(xs, wx, wh, b, pwl):
    t_len, bsz = xs.shape[:2]
    return torch.empty((t_len, bsz, wh[-1].shape[0]), dtype=torch.float32, device=xs.device)


def _wkv6_meta(r, k, v, w, u, s0):
    b, _, h, hd = r.shape
    return (torch.empty(r.shape, dtype=torch.float32, device=r.device),
            torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device))


def _flash_attention_meta(q, k, v, causal):
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


for _name, _fn in (("lstm_cell", _lstm_cell_meta), ("lstm_seq", _lstm_seq_meta),
                   ("lstm_stack", _lstm_stack_meta), ("wkv6", _wkv6_meta),
                   ("flash_attention", _flash_attention_meta)):
    _LIB.impl(_name, _fn, "Meta")


def _register(packet):
    def deco(formula):
        if packet not in flop_registry:
            register_flop_formula(packet)(formula)
        return formula
    return deco


@_register(torch.ops.repro_torch.lstm_cell)
def _lstm_cell_flops(x, h, c, wx, wh, b, *args, out_shape=None, **kwargs) -> int:
    bsz, in_dim = x
    return 8 * bsz * h[1] * (in_dim + h[1])


@_register(torch.ops.repro_torch.lstm_seq)
def _lstm_seq_flops(xs, h0, c0, wx, wh, b, *args, out_shape=None, **kwargs) -> int:
    t_len, bsz, in_dim = xs
    return 8 * t_len * bsz * h0[1] * (in_dim + h0[1])


@_register(torch.ops.repro_torch.lstm_stack)
def _lstm_stack_flops(xs, wx, wh, b, *args, out_shape=None, **kwargs) -> int:
    t_len, bsz, _ = xs
    return sum(8 * t_len * bsz * h_shape[0] * (x_shape[0] + h_shape[0])
               for x_shape, h_shape in zip(wx, wh))


@_register(torch.ops.repro_torch.wkv6)
def _wkv6_flops(r, k, v, w, u, s0, *args, out_shape=None, **kwargs) -> int:
    b, t_len, h, hd = r
    return 2 * b * t_len * h * hd * hd


@_register(torch.ops.repro_torch.flash_attention)
def _flash_attention_flops(q, k, v, *args, out_shape=None, **kwargs) -> int:
    b, h, s, d = q
    return 4 * b * h * s * k[2] * d


def lstm_cell(x, h, c, wx, wh, b, pwl: bool = False):
    return torch.ops.repro_torch.lstm_cell(x, h, c, wx, wh, b, pwl)


def lstm_seq(xs, h0, c0, wx, wh, b, pwl: bool = False):
    ys, h_t, c_t = torch.ops.repro_torch.lstm_seq(xs, h0, c0, wx, wh, b, pwl)
    return ys, (h_t, c_t)


def lstm_stack(xs, layers, pwl: bool = False):
    return torch.ops.repro_torch.lstm_stack(xs, [layer["wx"] for layer in layers],
                                            [layer["wh"] for layer in layers],
                                            [layer["b"] for layer in layers], pwl)


def wkv6(r, k, v, w, u, s0):
    return torch.ops.repro_torch.wkv6(r, k, v, w, u, s0)


def flash_attention(q, k, v, causal: bool = True):
    return torch.ops.repro_torch.flash_attention(q, k, v, causal)
