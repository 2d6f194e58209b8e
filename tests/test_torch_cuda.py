"""The port's CUDA kernels on a GPU, against their plain PyTorch versions.

Needs only torch (the GPU machine has no JAX).  Every test is marked
``cuda`` and skips without a GPU, deciding inside the test.  On a GPU:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import get_config  # noqa: E402
from repro_torch.core.lstm import init_lstm_ae  # noqa: E402
from repro_torch.engine import build_engine  # noqa: E402
from repro_torch.kernels import lstm_cell as tk  # noqa: E402
from repro_torch.kernels.ops import launch_counts, lstm_cell_op  # noqa: E402

SHAPES = [(16, 16), (32, 64), (64, 128), (128, 256), (64, 32), (8, 4)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, in_dim, hidden, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    return (randn(b, in_dim).to(dtype), randn(b, hidden).to(dtype), randn(b, hidden),
            randn(4, in_dim, hidden, scale=in_dim ** -0.5),
            randn(4, hidden, hidden, scale=hidden ** -0.5), randn(4, hidden, scale=0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("pwl", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_dim,hidden", SHAPES)
def test_lstm_cell_kernel_matches_plain(cuda, in_dim, hidden, dtype, pwl):
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for b in (1, 37, 512):
        args = _inputs(b, in_dim, hidden, dtype, seed=b + hidden)
        before = launch_counts()["lstm_cell"]
        hk, ck = lstm_cell_op(args[3:], *args[:3], pwl=pwl)
        torch.cuda.synchronize()
        assert launch_counts()["lstm_cell"] == before + 1
        hp, cp = tk.lstm_cell_plain(*args, pwl=pwl)
        assert hk.dtype == dtype and ck.dtype == torch.float32
        torch.testing.assert_close(hk.float(), hp.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(ck, cp, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_lstm_cell_kernel_in_place_c(cuda):
    x, h, c, wx, wh, b = _inputs(300, 32, 64, torch.float32, seed=1)
    hp, cp = tk.lstm_cell_plain(x, h, c, wx, wh, b)
    h_out = torch.empty_like(h)
    tk.lstm_cell_cuda(x, h, c, wx, wh, b, h_out=h_out, c_out=c)
    torch.cuda.synchronize()
    torch.testing.assert_close(h_out, hp, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(c, cp, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_refused_launch_raises(cuda):
    """A launch the kernel cannot take (too much shared memory) raises."""
    args = _inputs(4, 6000, 200, torch.float32, seed=2)
    with pytest.raises(RuntimeError, match="lstm_cell kernel launch failed"):
        tk.lstm_cell_cuda(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["lstm-ae-f32-d6", "lstm-ae-f64-d6"])
def test_fused_schedule_on_the_card(cuda, arch):
    """The kernel path serves the same scores as the plain schedules, with
    one launch per (layer, timestep)."""
    cfg = get_config(arch)
    series = torch.randn(64, 16, cfg.lstm_ae.input_features,
                         generator=torch.Generator().manual_seed(0))
    params = init_lstm_ae(torch.Generator().manual_seed(0), cfg, device=cuda)
    fused = build_engine(cfg, "fused", params=params, device=cuda)
    before = launch_counts()["lstm_cell"]
    got = fused.score({"series": series})
    assert launch_counts()["lstm_cell"] == before + cfg.num_layers * 16
    for name in ("sequential", "wavefront"):
        want = build_engine(cfg, name, params=fused.params, device=cuda).score({"series": series})
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
