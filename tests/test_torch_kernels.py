"""K1, the fused LSTM cell: the port's wrapper on CPU tensors (its plain
version) against the JAX package's Pallas kernel in interpret mode and its
oracle, mirroring tests/test_kernels.py.  The CUDA kernel itself is held
to the plain version in tests/test_torch_cuda.py and chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core.lstm import init_lstm_cell, lstm_cell  # noqa: E402
from repro.kernels import lstm_cell as jk  # noqa: E402
from repro.kernels.ops import lstm_cell_op as jax_lstm_cell_op  # noqa: E402
from repro.kernels.ref import ref_lstm_cell  # noqa: E402
from repro_torch.kernels import lstm_cell as tk  # noqa: E402
from repro_torch.kernels.ops import launch_counts, lstm_cell_op, reset_launch_counts  # noqa: E402
from repro_torch.utils import params_from_numpy  # noqa: E402

SWEEP = [(16, 16), (32, 64), (64, 128), (128, 256)]


def _case(in_dim, hidden, b, seed, dtype="float32"):
    """Weights from the JAX init (plus a random bias) and numpy inputs."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray, init_lstm_cell(jax.random.PRNGKey(seed), in_dim, hidden))
    p["b"] = (rng.standard_normal(4 * hidden) * 0.1).astype(np.float32)
    x = rng.standard_normal((b, in_dim)).astype(np.float32)
    h = rng.standard_normal((b, hidden)).astype(np.float32)
    c = rng.standard_normal((b, hidden)).astype(np.float32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    jax_args = (jnp.asarray(x, jd), jnp.asarray(h, jd), jnp.asarray(c))
    torch_args = (torch.from_numpy(x).to(td), torch.from_numpy(h).to(td), torch.from_numpy(c))
    return p, jax_args, torch_args


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_pack_weights_matches_reference():
    p, _, _ = _case(32, 64, 1, 0)
    mine = tk.pack_weights(params_from_numpy(p, "cpu"))
    for m, r in zip(mine, jk.pack_weights(p)):
        assert m.is_contiguous()
        np.testing.assert_array_equal(m.numpy(), np.asarray(r))


@pytest.mark.parametrize("pwl", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("in_dim,hidden", SWEEP)
def test_lstm_cell_op_sweep(in_dim, hidden, dtype, pwl):
    p, jargs, targs = _case(in_dim, hidden, 64, in_dim * hidden, dtype)
    hk, ck = jax_lstm_cell_op(p, *jargs, block_b=32, block_h=min(64, hidden), pwl=pwl,
                              interpret=True)
    hr, cr = ref_lstm_cell(*jargs, *jk.pack_weights(p), pwl=pwl)
    ht, ct = lstm_cell_op(params_from_numpy(p, "cpu"), *targs, pwl=pwl)
    assert ht.dtype == targs[1].dtype and ct.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2e-2
    for got, want in ((ht, hk), (ct, ck), (ht, hr), (ct, cr)):
        _close(got, want, tol)


@pytest.mark.parametrize("pwl", [False, True])
def test_lstm_cell_op_matches_framework_cell(pwl):
    """The kernel path == the core cell the other schedules run (f32)."""
    p, jargs, targs = _case(32, 64, 16, 3)
    h2, c2 = lstm_cell(p, *jargs, pwl=pwl)
    ht, ct = lstm_cell_op(params_from_numpy(p, "cpu"), *targs, pwl=pwl)
    np.testing.assert_allclose(ht.numpy(), np.asarray(h2), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(c2), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b", [1, 37, 130])
def test_ragged_batch(b):
    """B that divides no tile: the reference kernel cannot take it, its oracle can."""
    p, jargs, targs = _case(16, 32, b, b)
    hr, cr = ref_lstm_cell(*jargs, *jk.pack_weights(p))
    ht, ct = lstm_cell_op(params_from_numpy(p, "cpu"), *targs)
    _close(ht, hr, 1e-5)
    _close(ct, cr, 1e-5)


def test_packed_weights_and_in_place_outputs():
    """Pre-packed weights, h' into a given buffer and c updated in place —
    the fused schedule's calling convention."""
    p, _, (x, h, c) = _case(16, 32, 8, 1)
    params = params_from_numpy(p, "cpu")
    want_h, want_c = lstm_cell_op(params, x, h, c)
    h_out, c_io = torch.empty_like(h), c.clone()
    got_h, got_c = lstm_cell_op(tk.pack_weights(params), x, h, c_io, h_out=h_out, c_out=c_io)
    assert got_h is h_out and got_c is c_io
    torch.testing.assert_close(h_out, want_h, rtol=0, atol=0)
    torch.testing.assert_close(c_io, want_c, rtol=0, atol=0)


def test_bf16_c_is_taken_in_f32():
    p, _, (x, h, c) = _case(16, 16, 4, 2)
    params = params_from_numpy(p, "cpu")
    h1, c1 = lstm_cell_op(params, x, h, c.to(torch.bfloat16))
    h2, c2 = lstm_cell_op(params, x, h, c.to(torch.bfloat16).float())
    assert c1.dtype == torch.float32
    torch.testing.assert_close(c1, c2, rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    p, _, (x, h, c) = _case(16, 32, 8, 4)
    wx, wh, b = tk.pack_weights(params_from_numpy(p, "cpu"))
    bad = [
        ((x[:, :8], h, c, wx, wh, b), {}, ValueError, "wx has shape"),
        ((x, h, c[:4], wx, wh, b), {}, ValueError, "c has shape"),
        ((x.double(), h.double(), c, wx, wh, b), {}, TypeError, "share a dtype"),
        ((x, h.to(torch.bfloat16), c, wx, wh, b), {}, TypeError, "share a dtype"),
        ((x, h, c, wx.double(), wh, b), {}, TypeError, "wx must be float32"),
        ((x.t().contiguous().t(), h, c, wx, wh, b), {}, ValueError, "contiguous"),
        ((x, h, c, wx, wh, b), {"h_out": h}, ValueError, "h_out must not overlap"),
        ((x, h, c, wx, wh, b), {"c_out": torch.empty(8, 32, dtype=torch.bfloat16)},
         ValueError, "c_out must be"),
        ((x, h, c, wx, wh, b), {"c_out": h}, ValueError, "c_out must be c itself"),
    ]
    for args, kw, exc, msg in bad:
        with pytest.raises(exc, match=msg):
            tk.check_cell_args(*args, **kw)
    with pytest.raises(ValueError, match="h_out must not overlap"):
        lstm_cell_op((wx, wh, b), x, h, c, h_out=h)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tk.lstm_cell_cuda(x, h, c, wx, wh, b)


def test_plain_calls_are_not_counted():
    p, _, targs = _case(16, 16, 4, 5)
    reset_launch_counts()
    lstm_cell_op(params_from_numpy(p, "cpu"), *targs)
    assert launch_counts() == {"lstm_cell": 0, "lstm_seq": 0, "wkv6": 0,
                               "flash_attention": 0, "lstm_stack": 0}


def test_build_is_keyed_by_source_and_raises_without_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    path = _build.library_path("lstm_cell")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("lstm_cell-")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path("lstm_cell") != path
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(("lstm_cell",))
