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
from repro_torch.kernels import lstm_seq as ts  # noqa: E402
from repro_torch.kernels.ops import launch_counts, lstm_cell_op, lstm_seq_op  # noqa: E402

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


@pytest.mark.cuda
@pytest.mark.parametrize("pwl", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_dim,hidden", SHAPES)
def test_lstm_seq_kernel_matches_plain(cuda, in_dim, hidden, dtype, pwl):
    """K2 against its plain version, on both sides of the shared-memory fit
    ((64, 128) and (128, 256) read their weights from L2)."""
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    in_smem = ts.lstm_seq_plan(37, in_dim, hidden)[0]
    assert in_smem == (16 * hidden * (in_dim + hidden) < 200_000)
    for b, t_len in ((1, 9), (37, 16), (512, 8)):
        x, h0, c0, wx, wh, bias = _inputs(b, in_dim, hidden, dtype, seed=b + hidden)
        xs = torch.stack([x] + [torch.roll(x, k, dims=1) for k in range(1, t_len)])
        before = launch_counts()["lstm_seq"]
        ys, (hk, ck) = lstm_seq_op((wx, wh, bias), xs, h0, c0, pwl=pwl)
        torch.cuda.synchronize()
        assert launch_counts()["lstm_seq"] == before + 1
        yp, (hp, cp) = ts.lstm_seq_plain(xs, h0, c0, wx, wh, bias, pwl=pwl)
        assert ys.dtype == hk.dtype == dtype and ck.dtype == torch.float32
        for got, want in ((ys, yp), (hk, hp), (ck, cp)):
            torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ts.lstm_seq_cuda(xs.cpu(), h0.cpu(), c0.cpu(), wx.cpu(), wh.cpu(), bias.cpu())


@pytest.mark.cuda
def test_lstm_seq_refused_launch_raises(cuda):
    """A hidden width past one thread per unit has no launch plan: it raises."""
    x, h0, c0, wx, wh, b = _inputs(2, 8, 1100, torch.float32, seed=3)
    with pytest.raises(RuntimeError, match="lstm_seq kernel launch failed"):
        ts.lstm_seq_cuda(x[None], h0, c0, wx, wh, b)


@pytest.mark.cuda
def test_lstm_seq_layer_stack_equals_the_engine(cuda):
    """lstm-ae-f64-d6 layer by layer through K2 reconstructs what the
    engine's sequential schedule does."""
    cfg = get_config("lstm-ae-f64-d6")
    series = torch.randn(300, 24, cfg.lstm_ae.input_features,
                         generator=torch.Generator().manual_seed(0))
    params = init_lstm_ae(torch.Generator().manual_seed(0), cfg, device=cuda)
    want = build_engine(cfg, "sequential", params=params, device=cuda).reconstruct(
        {"series": series})
    ys = series.to(cuda).transpose(0, 1).contiguous()
    for layer in params["layers"]:
        ys, _ = lstm_seq_op(layer, ys)
    torch.testing.assert_close(ys.transpose(0, 1), want, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_gateway_on_the_card(cuda):
    """The gateway over the fused schedule on the GPU: pooled streams equal
    solo streams, bucketed scores equal direct scores, and every flush
    launched K1 6 x bucket_T times."""
    from repro_torch.engine import AnomalyService
    from repro_torch.gateway import drive_stream_churn

    svc = AnomalyService("lstm-ae-f32-d6", schedule="fused", device=cuda)
    gw = svc.open_gateway(capacity=8, max_batch=4, max_wait_ms=1e9)
    rng = torch.Generator().manual_seed(1)
    windows = torch.randn(12, 10, svc.features, generator=rng)
    finals, unserved = drive_stream_churn(gw, windows, churn_every=4)
    assert len(finals) + len(unserved) == 12
    sess = svc.stream_start(1)
    for t in range(5):   # stream 0 stepped 0..4, then evicted at t=4
        errs, sess = svc.stream_step(windows[0:1, t], sess)
    torch.testing.assert_close(torch.tensor(finals[0]), errs[0].cpu(), rtol=1e-4, atol=1e-6)
    lens = [3, 8, 9, 16, 5]
    before = launch_counts()["lstm_cell"]
    scores = gw.score([windows[i, :n] for i, n in enumerate(lens)])
    # buckets 8: lens 3, 8, 5 (one flush); 16: lens 9, 16 (one flush)
    assert launch_counts()["lstm_cell"] == before + 6 * (8 + 16)
    for i, n in enumerate(lens):
        direct = svc.score(windows[i:i + 1, :n])
        torch.testing.assert_close(torch.tensor(scores[i]), direct[0].cpu(), rtol=1e-4, atol=1e-6)
