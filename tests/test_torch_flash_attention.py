"""K4, the flash-attention forward: the port's ``flash_attention_op`` on CPU
tensors (its plain version) against the JAX package's Pallas kernel in
interpret mode, ``ref_attention`` and ``blocked_attention``, mirroring
tests/test_kernels.py.  The causal mask is aligned top-left, as the Pallas
kernel's; the S != Sk cases pin that choice down.  The CUDA kernel itself is
held to the plain version in tests/test_torch_cuda.py and chip_smoke.py."""
import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (its full-width limit for K4, tested here)

from repro.kernels.ops import flash_attention_op as jax_flash_attention_op  # noqa: E402
from repro.kernels.ref import ref_attention  # noqa: E402
from repro.layers.attention import blocked_attention  # noqa: E402
from repro_torch.kernels import flash_attention as tk  # noqa: E402
from repro_torch.kernels.ops import (  # noqa: E402
    flash_attention_op,
    launch_counts,
    reset_launch_counts,
)

# the (s, d, blocks) of tests/test_kernels.py::test_flash_attention_sweep, B=2, H=3
SWEEP = [(128, 64, (64, 64)), (256, 64, (64, 128)), (256, 128, (128, 64))]
TOL = {"float32": 2e-3, "bfloat16": 3e-2}


def _case(b, s, sk, h, d, seed):
    """numpy f32 q (B,S,H,d) and k, v (B,Sk,H,d)."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, n, h, d)).astype(np.float32) for n in (s, sk, sk))


def _jax(arrays, dtype):
    return tuple(jnp.asarray(a).astype(dtype) for a in arrays)


def _torch(arrays, dtype):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrays)


def _ref_attention(q, k, v, causal):
    """ref_attention over the (B, S, H, d) layout."""
    out = ref_attention(*(jnp.swapaxes(t, 1, 2) for t in (q, k, v)), causal=causal)
    return jnp.swapaxes(out, 1, 2)


def _f32(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor) else t, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d,blocks", SWEEP)
def test_flash_attention_op_matches_kernel_ref_and_blocked(s, d, blocks, causal, dtype):
    arrays = _case(2, s, s, 3, d, seed=s + d)
    out = flash_attention_op(*_torch(arrays, getattr(torch, dtype)), causal=causal)
    assert out.dtype == getattr(torch, dtype) and out.shape == (2, s, 3, d)
    q, k, v = _jax(arrays, getattr(jnp, dtype))
    kern = jax_flash_attention_op(q, k, v, causal=causal, block_q=blocks[0], block_k=blocks[1],
                                  interpret=True)
    for want in (kern, _ref_attention(q, k, v, causal),
                 blocked_attention(q, k, v, causal=causal, kv_chunk=blocks[1])):
        _close(out, want, TOL[dtype])


@pytest.mark.parametrize("s,sk", [(128, 256), (256, 128)])
def test_causal_mask_is_top_left_when_s_differs_from_sk(s, sk):
    """S != Sk: the port follows the Pallas kernel and blocked_attention
    (q_offset 0), key j visible to query i iff j <= i; ref_attention, aligned
    bottom-right, differs."""
    arrays = _case(2, s, sk, 2, 64, seed=s + 3 * sk)
    out = flash_attention_op(*_torch(arrays, torch.float32), causal=True)
    q, k, v = _jax(arrays, jnp.float32)
    kern = jax_flash_attention_op(q, k, v, causal=True, block_q=64, block_k=64, interpret=True)
    _close(out, kern, TOL["float32"])
    _close(out, blocked_attention(q, k, v, causal=True, kv_chunk=64, q_offset=0), TOL["float32"])
    bottom_right = _f32(_ref_attention(q, k, v, True))
    assert np.abs(_f32(out) - bottom_right).max() > 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_ragged_lengths_match_blocked_attention(causal, dtype):
    """S and Sk that no tile divides (the Pallas kernel asserts divisibility;
    the port takes them): the port against blocked_attention."""
    arrays = _case(1, 200, 136, 2, 64, seed=7)
    out = flash_attention_op(*_torch(arrays, getattr(torch, dtype)), causal=causal)
    q, k, v = _jax(arrays, getattr(jnp, dtype))
    _close(out, blocked_attention(q, k, v, causal=causal, kv_chunk=64), TOL[dtype])


def test_flash_attention_op_returns_contiguous_for_a_sliced_q():
    """Heads sliced out of a wider tensor (q not dense): the output is a
    contiguous (B, S, H, d) tensor, as the CUDA path returns it."""
    arrays = _case(1, 64, 64, 4, 64, seed=9)
    q, k, v = (t[:, :, :2] for t in _torch(arrays, torch.float32))
    assert not q.is_contiguous()
    out = flash_attention_op(q, k, v)
    assert out.is_contiguous() and out.shape == (1, 64, 2, 64)
    qj, kj, vj = (t[:, :, :2] for t in _jax(arrays, jnp.float32))
    _close(out, blocked_attention(qj, kj, vj, causal=True, kv_chunk=32), TOL["float32"])


def test_full_width_limit_admits_the_kernels_rounding_and_catches_a_fault():
    """chip_smoke.py's row-scaled bf16 limit for K4 at full width: the Pallas
    kernel (interpret mode), which rounds P relative to the running maximum
    as K4 does, passes it against the plain version; 5% off on the late
    rows, whose outputs are small, fails it, as it passes the reference's
    absolute 3e-2."""
    arrays = _case(1, 512, 512, 2, 128, seed=21)
    q, k, v = _jax(arrays, jnp.bfloat16)
    kern = jax_flash_attention_op(q, k, v, causal=True, block_q=64, block_k=64, interpret=True)
    got = torch.from_numpy(_f32(kern)).transpose(1, 2)
    want = tk.flash_attention_plain(*(t.transpose(1, 2) for t in _torch(arrays, torch.bfloat16)),
                                    causal=True)
    assert chip_smoke.check_wide(torch, got, want, torch.bfloat16)["limit_share"] < 0.5
    bad = got.clone()
    bad[:, :, 256:] *= 1.05
    _close(bad, want, TOL["bfloat16"])
    with pytest.raises(AssertionError, match="of the limit"):
        chip_smoke.check_wide(torch, bad, want, torch.bfloat16)


def test_flash_attention_op_refuses_what_the_kernel_does_not_take():
    """The CPU path holds its arguments to the kernel's contract."""
    q, k, v = _torch(_case(1, 8, 8, 2, 64, seed=1), torch.float32)
    strided = torch.zeros(1, 8, 2, 128)[..., ::2]       # q's shape, every other float
    strided.copy_(q)
    bad = [
        ((q, k[:, :4], v), ValueError, "v has shape"),
        ((q, k[..., :32], v[..., :32]), ValueError, "k has shape"),
        ((q, k.to(torch.bfloat16), v), TypeError, "share a dtype"),
        ((q.half(), k.half(), v.half()), TypeError, "share a dtype"),
        ((strided, k, v), ValueError, "contiguous"),
        ((q, k[:, :0], v[:, :0]), ValueError, "at least one key"),
        ((q[0], k, v), ValueError, "must be"),
    ]
    for args, exc, msg in bad:
        with pytest.raises(exc, match=msg):
            flash_attention_op(*args)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tk.flash_attention_cuda(q, k, v)


def test_flash_attention_plain_calls_are_not_counted():
    reset_launch_counts()
    flash_attention_op(*_torch(_case(1, 4, 4, 1, 64, seed=2), torch.float32))
    assert launch_counts()["flash_attention"] == 0


def test_bf16_row_alignment_check():
    """The bf16 kernel's 16-byte row rule, checked before any launch:
    contiguous and transposed (B, S, H, d) views pass, a view 2 bytes off or
    with a 65-element row stride is refused, and a dimension of length 1
    may have any stride."""
    q = torch.zeros(2, 3, 40, 64, dtype=torch.bfloat16)
    tk.check_row_alignment(q, q.transpose(1, 2).contiguous().transpose(1, 2), q[:, 1:2])
    wide = torch.zeros(2, 3, 40, 65, dtype=torch.bfloat16)
    for bad in (wide[..., 1:], wide[..., :64]):
        with pytest.raises(ValueError, match="16 bytes"):
            tk.check_row_alignment(q, bad)
    single = torch.zeros(1, 1, 1, 65, dtype=torch.bfloat16)[..., :64]   # strides 65, one row
    tk.check_row_alignment(single)


def _tf32(x: torch.Tensor, cut: bool = False) -> torch.Tensor:
    """x (f32) rounded to TF32 (10 mantissa bits) by integer ops on its bits:
    to nearest even, or with ``cut`` toward zero (the 13 low bits dropped,
    as the tensor core reads a TF32 operand and as K4's split takes big)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if not cut:
        bits = bits + 0xFFF + ((bits >> 13) & 1)
    bits = bits & 0xFFFFE000
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32).view(torch.float32)


def _tf32_matmul(a: torch.Tensor, b: torch.Tensor, passes: int, cut: bool) -> torch.Tensor:
    """a @ b with TF32 operands and f32 sums: 1 pass is plain TF32 (big.big);
    3 passes add small.big and big.small first (3xTF32, small = the rest of
    each operand in TF32)."""
    a_big, b_big = _tf32(a, cut), _tf32(b, cut)
    if passes == 1:
        return a_big @ b_big
    a_small, b_small = _tf32(a - a_big, cut), _tf32(b - b_big, cut)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def _attention_tf32(q, k, v, passes: int, cut: bool) -> torch.Tensor:
    """Causal (top-left) attention of one head with both products in TF32
    (``passes`` 1 or 3) and the softmax in f32, as K4's f32 kernel runs it."""
    s, d = q.shape[-2], q.shape[-1]
    scores = _tf32_matmul(q, k.transpose(-1, -2), passes, cut) * (1.0 / math.sqrt(d))
    scores.masked_fill_(~torch.ones(s, k.shape[-2], dtype=torch.bool).tril(), -1e30)
    return _tf32_matmul(torch.softmax(scores, dim=-1), v, passes, cut)


@pytest.mark.parametrize("cut", [False, True], ids=["nearest", "toward_zero"])
def test_f32_limit_admits_3xtf32_and_refuses_tf32(cut):
    """Why K4's f32 kernel runs 3xTF32 and not plain TF32: with both products
    emulated on the CPU, 3xTF32 stays within chip_smoke.py's full-width f32
    limit (1e-4 |want| + 1e-5) of the plain version, and 1xTF32 does not,
    whether TF32 rounds to nearest even or toward zero (the kernel's split)."""
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -1.0 - 2.0 ** -10 - 2.0 ** -12])
    assert torch.equal(_tf32(x), torch.tensor([1.0, 1.0 + 2.0 ** -9, -1.0 - 2.0 ** -10]))
    assert torch.equal(_tf32(x, cut=True), torch.tensor([1.0, 1.0 + 2.0 ** -10, -1.0 - 2.0 ** -10]))
    q, k, v = (torch.from_numpy(a[:, :, 0]).transpose(0, 1)
               for a in _case(1, 512, 512, 1, 128, seed=31))   # (1, S, d) each
    want = tk.flash_attention_plain(q[None], k[None], v[None], causal=True)[0]
    three = _attention_tf32(q, k, v, passes=3, cut=cut)
    share = chip_smoke.check_wide(torch, three, want, torch.float32)["limit_share"]
    assert share < 0.5
    with pytest.raises(AssertionError, match="of the limit"):
        chip_smoke.check_wide(torch, _attention_tf32(q, k, v, passes=1, cut=cut), want,
                              torch.float32)
