"""K2, the sequence-streaming LSTM layer: the port's ``lstm_seq_op`` on CPU
tensors (its plain version) against the JAX package's Pallas kernel in
interpret mode and against ``repro.core.lstm.lstm_layer``, mirroring
tests/test_kernels.py.  The CUDA kernel itself is held to the plain version
in tests/test_torch_cuda.py and chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core.lstm import init_lstm_cell, lstm_layer  # noqa: E402
from repro.kernels.ops import lstm_seq_op as jax_lstm_seq_op  # noqa: E402
from repro_torch.kernels import lstm_seq as tk  # noqa: E402
from repro_torch.kernels.lstm_cell import pack_weights  # noqa: E402
from repro_torch.kernels.ops import launch_counts, lstm_seq_op, reset_launch_counts  # noqa: E402
from repro_torch.utils import params_from_numpy  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
BF16_TOL = 2e-2
# the shapes of tests/test_kernels.py::test_lstm_seq_kernel_matches_layer_scan
SHAPES = [(4, 4, 16, 16), (12, 8, 32, 64), (7, 2, 64, 128)]


def _case(t_len, b, in_dim, hidden, seed, bias=False):
    """Weights from the JAX init (numpy copies) and numpy inputs."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray, init_lstm_cell(jax.random.PRNGKey(seed), in_dim, hidden))
    if bias:
        p["b"] = (rng.standard_normal(4 * hidden) * 0.1).astype(np.float32)
    xs = rng.standard_normal((t_len, b, in_dim)).astype(np.float32)
    return p, xs


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("pwl", [False, True])
@pytest.mark.parametrize("t_len,b,in_dim,hidden", SHAPES)
def test_lstm_seq_op_matches_kernel_and_layer(t_len, b, in_dim, hidden, pwl):
    p, xs = _case(t_len, b, in_dim, hidden, t_len + hidden)
    ys_k, (h_k, c_k) = jax_lstm_seq_op(p, jnp.asarray(xs), block_b=min(4, b), pwl=pwl,
                                       interpret=True)
    ys_r, (h_r, c_r) = lstm_layer(p, jnp.asarray(xs), pwl=pwl)
    ys, (h, c) = lstm_seq_op(params_from_numpy(p, "cpu"), torch.from_numpy(xs), pwl=pwl)
    assert ys.dtype == h.dtype == c.dtype == torch.float32
    assert ys.shape == (t_len, b, hidden) and h.shape == c.shape == (b, hidden)
    for got, kern, layer in ((ys, ys_k, ys_r), (h, h_k, h_r), (c, c_k, c_r)):
        _close(got, kern)
        _close(got, layer)


@pytest.mark.parametrize("pwl", [False, True])
@pytest.mark.parametrize("t_len,b,in_dim,hidden", SHAPES)
def test_lstm_seq_op_bf16_matches_kernel(t_len, b, in_dim, hidden, pwl):
    """bf16 xs: h is rounded to bf16 before MVM_H every step, as the JAX
    kernel does; ys and h_T come out in bf16, c_T in f32."""
    p, xs = _case(t_len, b, in_dim, hidden, 2 * t_len + hidden, bias=True)
    jxs = jnp.asarray(xs, jnp.bfloat16)
    ys_k, (h_k, c_k) = jax_lstm_seq_op(p, jxs, block_b=min(4, b), pwl=pwl, interpret=True)
    ys, (h, c) = lstm_seq_op(params_from_numpy(p, "cpu"),
                             torch.from_numpy(xs).to(torch.bfloat16), pwl=pwl)
    assert ys.dtype == h.dtype == torch.bfloat16 and c.dtype == torch.float32
    assert ys_k.dtype == h_k.dtype == jnp.bfloat16
    for got, want in ((ys, ys_k), (h, h_k), (c, c_k)):
        _close(got, want, BF16_TOL, BF16_TOL)


@pytest.mark.parametrize("b", [1, 5, 37])
def test_ragged_batch(b):
    """A batch no tile divides: the kernel masks it; the reference takes
    it with block_b == B."""
    p, xs = _case(6, b, 16, 32, b, bias=True)
    ys_k, (h_k, c_k) = jax_lstm_seq_op(p, jnp.asarray(xs), block_b=b, interpret=True)
    ys, (h, c) = lstm_seq_op(params_from_numpy(p, "cpu"), torch.from_numpy(xs))
    for got, want in ((ys, ys_k), (h, h_k), (c, c_k)):
        _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_initial_state_given_and_omitted(dtype):
    """h0/c0 given equal the reference with the same state; zeros given equal
    the defaults (h0 zeros in xs's dtype, c0 zeros in f32)."""
    p, xs = _case(5, 4, 16, 32, 11, bias=True)
    rng = np.random.default_rng(3)
    h0 = rng.standard_normal((4, 32)).astype(np.float32)
    c0 = rng.standard_normal((4, 32)).astype(np.float32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    tol = BF16_TOL if dtype == "bfloat16" else RTOL
    params = params_from_numpy(p, "cpu")
    txs = torch.from_numpy(xs).to(td)
    ys_k, (h_k, c_k) = jax_lstm_seq_op(p, jnp.asarray(xs, jd), jnp.asarray(h0, jd),
                                       jnp.asarray(c0), block_b=4, interpret=True)
    ys, (h, c) = lstm_seq_op(params, txs, torch.from_numpy(h0).to(td), torch.from_numpy(c0))
    assert h.dtype == td
    for got, want in ((ys, ys_k), (h, h_k), (c, c_k)):
        _close(got, want, tol, tol if dtype == "bfloat16" else ATOL)
    zero = lstm_seq_op(params, txs, torch.zeros(4, 32, dtype=td), torch.zeros(4, 32))
    omitted = lstm_seq_op(params, txs)
    for got, want in zip((zero[0], *zero[1]), (omitted[0], *omitted[1])):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_packed_weights_and_bf16_c0():
    """Pre-packed weights equal the core layout; a bf16 c0 is taken in f32."""
    p, xs = _case(4, 3, 8, 16, 5, bias=True)
    params = params_from_numpy(p, "cpu")
    txs = torch.from_numpy(xs)
    c0 = torch.randn(3, 16, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    a = lstm_seq_op(params, txs, c0=c0)
    b = lstm_seq_op(pack_weights(params), txs, c0=c0.float())
    assert a[1][1].dtype == torch.float32
    for got, want in zip((a[0], *a[1]), (b[0], *b[1])):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    p, xs = _case(3, 4, 16, 32, 7)
    wx, wh, b = pack_weights(params_from_numpy(p, "cpu"))
    xs = torch.from_numpy(xs)
    h0, c0 = torch.zeros(4, 32), torch.zeros(4, 32)
    bad = [
        ((xs[0], h0, c0, wx, wh, b), ValueError, "3-D"),
        ((xs[:, :, :8], h0, c0, wx, wh, b), ValueError, "wx has shape"),
        ((xs, h0, c0[:2], wx, wh, b), ValueError, "c0 has shape"),
        ((xs.double(), h0, c0, wx, wh, b), TypeError, "must be in"),
        ((xs, h0, c0.double(), wx, wh, b), TypeError, "c0 must be float32"),
        ((xs, h0, c0, wx, wh.double(), b), TypeError, "wh must be float32"),
        ((xs.transpose(0, 1).contiguous().transpose(0, 1), h0, c0, wx, wh, b),
         ValueError, "contiguous"),
    ]
    for args, exc, msg in bad:
        with pytest.raises(exc, match=msg):
            tk.check_seq_args(*args)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tk.lstm_seq_cuda(xs, h0, c0, wx, wh, b)


def test_plain_calls_are_not_counted():
    p, xs = _case(3, 2, 8, 8, 9)
    reset_launch_counts()
    lstm_seq_op(params_from_numpy(p, "cpu"), torch.from_numpy(xs))
    assert launch_counts() == {"lstm_cell": 0, "lstm_seq": 0, "wkv6": 0,
                               "flash_attention": 0, "lstm_stack": 0}


def test_layer_stack_through_lstm_seq_op_equals_sequential():
    """A whole LSTM-AE, layer by layer through lstm_seq_op (K2's path in
    chip_smoke.py), equals the port's sequential schedule."""
    from repro_torch.config import reduced_config
    from repro_torch.core.lstm import init_lstm_ae, lstm_ae_sequential

    cfg = reduced_config("lstm-ae-f32-d6")
    params = init_lstm_ae(torch.Generator().manual_seed(0), cfg, "cpu")
    xs = torch.randn(9, 5, cfg.lstm_ae.input_features, generator=torch.Generator().manual_seed(1))
    ys = xs
    for layer in params["layers"]:
        ys, _ = lstm_seq_op(layer, ys)
    torch.testing.assert_close(ys, lstm_ae_sequential(params, xs), rtol=RTOL, atol=ATOL)
