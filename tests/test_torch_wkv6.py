"""K3, the RWKV-6 WKV recurrence: the port's ``wkv6_op`` on CPU tensors (its
plain version) against the JAX package's Pallas kernel in interpret mode and
against ``repro.layers.rwkv.wkv_scan``, mirroring tests/test_kernels.py; and
an f32 emulation of the CUDA kernel's order of arithmetic against the same
references.  The CUDA kernel itself is held to the plain version in
tests/test_torch_cuda.py and chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ops import wkv6_op as jax_wkv6_op  # noqa: E402
from repro.kernels.ref import ref_wkv6  # noqa: E402
from repro.layers.rwkv import wkv_scan  # noqa: E402
from repro_torch.kernels import wkv6 as tk  # noqa: E402
from repro_torch.kernels.ops import launch_counts, reset_launch_counts, wkv6_op  # noqa: E402

# the (t_len, hd, h) of tests/test_kernels.py::test_wkv6_kernel_sweep, B = 2
SWEEP = [(8, 16, 2), (32, 32, 4), (64, 64, 2)]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
GROUPS = 4      # csrc/wkv6.cu kGroups: row groups whose partial y are summed


def _fma(a, b, c):
    """f32 fma(a, b, c): the product of two f32 is exact in f64, so one
    rounding to f32 after the f64 sum (double rounding aside)."""
    return (a.double() * b.double() + c.double()).float()


def _kernel_order(r, k, v, w, u, s0, groups=GROUPS):
    """The CUDA kernel's arithmetic in f32, step by step: a_t = sum_i r_i u_i
    k_i; in each of ``groups`` row groups of R = hd / groups rows a partial
    y = fma(r_i, S_ij, y) from 0 in row order; the partials summed as a
    pairwise tree ((p0 + p1) + (p2 + p3)); y = fma(a_t, v_j, tree); then
    S_ij = fma(w_i, S_ij, k_i * v_j).  a_t's own order is not emulated."""
    r, k, v = (t.float() for t in (r, k, v))
    bsz, t_len, heads, hd = r.shape
    rows = hd // groups
    a = (r * u[None, None] * k).sum(-1)                        # (B, T, H)
    s = s0.clone()
    ys = []
    for t in range(t_len):
        rg = r[:, t].reshape(bsz, heads, groups, rows)
        sg = s.reshape(bsz, heads, groups, rows, hd)
        part = torch.zeros(bsz, heads, groups, hd)
        for i in range(rows):
            part = _fma(rg[..., i, None], sg[..., i, :], part)
        while part.shape[2] > 1:
            part = part[:, :, 0::2] + part[:, :, 1::2]
        ys.append(_fma(a[:, t, :, None], v[:, t], part[:, :, 0]))
        s = _fma(w[:, t, ..., None], s, k[:, t, ..., :, None] * v[:, t, ..., None, :])
    return torch.stack(ys, dim=1), s


def _case(b, t_len, h, hd, seed, zero_state=False):
    """numpy f32 inputs drawn as the reference sweep draws them."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    r, k, v = (normal(b, t_len, h, hd) * np.float32(0.3) for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-normal(b, t_len, h, hd)))).astype(np.float32)
    u = normal(h, hd) * np.float32(0.1)
    s0 = np.zeros((b, h, hd, hd), np.float32) if zero_state else normal(b, h, hd, hd) * np.float32(0.1)
    return r, k, v, w, u, s0


def _rwkv_case(b, t_len, h, hd, seed):
    """Like :func:`_case`, but the decays drawn as the RWKV layer makes them
    (layers/rwkv.py: w = exp(-exp(wbase + ...)), wbase = -6), near 1, so
    the state sums hundreds of steps."""
    r, k, v, _, u, s0 = _case(b, t_len, h, hd, seed)
    rng = np.random.default_rng(seed + 1)
    w_log = np.float32(-6.0) + np.float32(0.5) * rng.standard_normal((b, t_len, h, hd)).astype(np.float32)
    return r, k, v, np.exp(-np.exp(w_log)).astype(np.float32), u, s0


def _jax(arrays, dtype):
    """JAX arrays; r, k, v cast from the same f32 arrays as the torch side."""
    r, k, v, w, u, s0 = (jnp.asarray(a) for a in arrays)
    return (r.astype(dtype), k.astype(dtype), v.astype(dtype), w, u, s0)


def _torch(arrays, dtype):
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in arrays)
    return (r.to(dtype), k.to(dtype), v.to(dtype), w, u, s0)


def _close(got, want, tol, atol=None):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=tol,
                               atol=tol if atol is None else atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t_len,hd,h", SWEEP)
def test_wkv6_op_matches_kernel_and_scan(t_len, hd, h, dtype):
    arrays = _case(2, t_len, h, hd, seed=t_len + hd)
    y, s = wkv6_op(*_torch(arrays, getattr(torch, dtype)))
    assert y.dtype == s.dtype == torch.float32
    assert y.shape == (2, t_len, h, hd) and s.shape == (2, h, hd, hd)
    jargs = _jax(arrays, getattr(jnp, dtype))
    y_k, s_k = jax_wkv6_op(*jargs, interpret=True)
    y_r, s_r = wkv_scan(*jargs)
    for want_y, want_s in ((y_k, s_k), (y_r, s_r)):
        _close(y, want_y, TOL[dtype])
        _close(s, want_s, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t_len,hd,h", SWEEP)
def test_kernel_order_matches_pallas_kernel(t_len, hd, h, dtype):
    """The CUDA kernel's reassociated y (row groups, a tree, then a_t v_j)
    stays within the reference sweep's limits of the Pallas kernel."""
    arrays = _case(2, t_len, h, hd, seed=t_len + hd)
    y, s = _kernel_order(*_torch(arrays, getattr(torch, dtype)))
    y_k, s_k = jax_wkv6_op(*_jax(arrays, getattr(jnp, dtype)), interpret=True)
    _close(y, y_k, TOL[dtype])
    _close(s, s_k, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 32, 64])
def test_kernel_order_matches_ref_on_rwkv_decays(hd, dtype):
    """A long sequence with the RWKV layer's slow decays: the kernel's order
    against ``ref_wkv6`` and against the port's plain version."""
    arrays = _rwkv_case(1, 512, 2, hd, seed=160 + hd)
    targs = _torch(arrays, getattr(torch, dtype))
    y, s = _kernel_order(*targs)
    y_r, s_r = ref_wkv6(*_jax(arrays, getattr(jnp, dtype)))
    _close(y, y_r, TOL[dtype])
    _close(s, s_r, TOL[dtype])
    y_p, s_p = tk.wkv6_plain(*targs)
    _close(y, y_p.numpy(), TOL[dtype])
    _close(s, s_p.numpy(), TOL[dtype])


def test_kernel_order_rounds_the_state_as_the_plain_version():
    """Only y is reassociated: S = fma(w, S, k v) element by element, so in
    f32 the emulated state and the plain version's (w S + k v, two
    roundings) differ by rounding alone, and the emulated y moves off the
    plain version's without leaving the limit."""
    arrays = _rwkv_case(1, 64, 2, 64, seed=7)
    targs = _torch(arrays, torch.float32)
    y, s = _kernel_order(*targs)
    y_p, s_p = tk.wkv6_plain(*targs)
    torch.testing.assert_close(s, s_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(y, y_p, rtol=1e-4, atol=1e-4)


def test_wkv6_op_chains_across_chunks():
    """Two calls with the state handed through == one call on the whole
    sequence == the JAX kernel's chained calls (test_kernels.py:105)."""
    b, t, h, hd = 2, 32, 2, 16
    arrays = _case(b, t, h, hd, seed=11, zero_state=True)
    r, k, v, w, u, s0 = _torch(arrays, torch.float32)
    y1, s1 = wkv6_op(r[:, :16].contiguous(), k[:, :16].contiguous(), v[:, :16].contiguous(),
                     w[:, :16].contiguous(), u, s0)
    y2, s2 = wkv6_op(r[:, 16:].contiguous(), k[:, 16:].contiguous(), v[:, 16:].contiguous(),
                     w[:, 16:].contiguous(), u, s1)
    y, s = wkv6_op(r, k, v, w, u, s0)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(s2, s, rtol=1e-4, atol=1e-5)
    jr, jk, jv, jw, ju, js0 = _jax(arrays, jnp.float32)
    jy1, js1 = jax_wkv6_op(jr[:, :16], jk[:, :16], jv[:, :16], jw[:, :16], ju, js0, interpret=True)
    jy2, js2 = jax_wkv6_op(jr[:, 16:], jk[:, 16:], jv[:, 16:], jw[:, 16:], ju, js1, interpret=True)
    _close(torch.cat([y1, y2], dim=1), np.concatenate([jy1, jy2], axis=1), 1e-4, 1e-5)
    _close(s2, js2, 1e-4, 1e-5)


def test_wkv6_op_refuses_what_the_kernel_does_not_take():
    """The CPU path holds its arguments to the kernel's contract."""
    r, k, v, w, u, s0 = _torch(_case(2, 4, 2, 16, seed=3), torch.float32)
    strided = torch.zeros(2, 4, 2, 32)[..., ::2]      # r's shape, every other float
    strided.copy_(r)
    bad = [
        ((r, k, v, w, u[:1], s0), ValueError, "u has shape"),
        ((r, k, v, w, u, s0[:, :, :8]), ValueError, "s0 has shape"),
        ((r, k.to(torch.bfloat16), v, w, u, s0), TypeError, "share a dtype"),
        ((r.half(), k.half(), v.half(), w, u, s0), TypeError, "share a dtype"),
        ((r, k, v, w.double(), u, s0), TypeError, "w must be float32"),
        ((strided, k, v, w, u, s0), ValueError, "contiguous"),
        ((r[0], k, v, w, u, s0), ValueError, "must be"),
    ]
    for args, exc, msg in bad:
        with pytest.raises(exc, match=msg):
            wkv6_op(*args)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tk.wkv6_cuda(r, k, v, w, u, s0)


def test_wkv6_plain_calls_are_not_counted():
    reset_launch_counts()
    wkv6_op(*_torch(_case(1, 3, 1, 16, seed=5), torch.float32))
    assert launch_counts()["wkv6"] == 0
