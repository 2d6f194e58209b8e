"""The port's CUDA kernels on a GPU, against their plain PyTorch versions.

Needs only torch (the GPU machine has no JAX).  Every test is marked
``cuda`` and skips without a GPU, deciding inside the test.  On a GPU:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import functools
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# chip_smoke.py holds the one definition of the K3 and K4 inputs that both
# GPU checks draw (it imports nothing at module level beyond the stdlib)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

from repro_torch.config import get_config  # noqa: E402
from repro_torch.core.lstm import init_lstm_ae  # noqa: E402
from repro_torch.engine import build_engine  # noqa: E402
from repro_torch.kernels import flash_attention as tf  # noqa: E402
from repro_torch.kernels import lstm_cell as tk  # noqa: E402
from repro_torch.kernels import lstm_seq as ts  # noqa: E402
from repro_torch.kernels import wkv6 as tw  # noqa: E402
from repro_torch.kernels.ops import (  # noqa: E402
    flash_attention_op,
    launch_counts,
    lstm_cell_op,
    lstm_seq_op,
    wkv6_op,
)
from repro_torch.utils import tree_leaves  # noqa: E402

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
    """A launch the kernel cannot take raises.  The K-looped kernel takes any
    width, so the refused launch is one row past its 65,535 row tiles of 64
    (CUDA's cap on the grid's second dimension)."""
    args = _inputs(65535 * 64 + 1, 4, 4, torch.float32, seed=2)
    assert tk.lstm_cell_tile(65535 * 64 + 1, 4) == (64, 8)
    with pytest.raises(RuntimeError, match="lstm_cell kernel launch failed"):
        tk.lstm_cell_cuda(*args)


def _cell_against_plain(args, pwl, in_place):
    """K1 on ``args`` (c updated in place when ``in_place``) against its plain version."""
    x, h, c, wx, wh, b = args
    dtype = x.dtype
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    hp, cp = tk.lstm_cell_plain(x, h, c, wx, wh, b, pwl=pwl)
    c_out = c if in_place else None
    hk, ck = tk.lstm_cell_cuda(x, h, c, wx, wh, b, pwl=pwl, c_out=c_out)
    torch.cuda.synchronize()
    if in_place:
        assert ck.data_ptr() == c.data_ptr()
    assert hk.dtype == dtype and ck.dtype == torch.float32
    torch.testing.assert_close(hk.float(), hp.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(ck, cp, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("pwl", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_dim,hidden,b", [(24, 40, 37), (8, 4, 1), (128, 256, 300),
                                             (7, 13, 37)])
def test_lstm_cell_kernel_tile_edges(cuda, in_dim, hidden, b, dtype, pwl):
    """K1 where In, H and B are no multiples of the contraction chunk (16),
    the unit tile or the row tile, c updated in place; (7, 13) also takes
    the path for rows that are not 16-byte aligned."""
    _cell_against_plain(_inputs(b, in_dim, hidden, dtype, seed=in_dim + b), pwl, in_place=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 256])
@pytest.mark.parametrize("in_dim,hidden", [(64, 32), (32, 64), (16, 8)])
def test_lstm_cell_kernel_small_batch_spreads(cuda, in_dim, hidden, b, dtype):
    """At B=1 and the gateway's 256-row flushes the kernel takes 16-row tiles
    and narrows its unit tile, so the grid spreads over hidden-unit blocks."""
    bm, bn = tk.lstm_cell_tile(b, hidden)
    assert bm == 16 and bn <= min(32, max(8, hidden))
    if b == 256 and hidden == 64:
        assert bn == 8   # 16 row tiles x 8 unit tiles
    for pwl in (False, True):
        _cell_against_plain(_inputs(b, in_dim, hidden, dtype, seed=b + hidden), pwl,
                            in_place=False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_cell_kernel_wide_and_offset_rows(cuda, dtype):
    """Rows wider than any tile (In=6000, which the first design refused)
    and x, h, wx views that start 4 bytes off a 16-byte boundary."""
    _cell_against_plain(_inputs(40, 6000, 200, dtype, seed=9), False, in_place=False)
    x, h, c, wx, wh, b = _inputs(37, 32, 64, dtype, seed=10)

    def offset(t):   # the same values, one element into a larger buffer
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    x2, h2, wx2 = offset(x), offset(h), offset(wx)
    assert x2.is_contiguous() and x2.data_ptr() % 16 and wx2.data_ptr() % 16
    _cell_against_plain((x2, h2, c, wx2, wh, b), True, in_place=True)


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


# (t_len, b, in_dim, hidden, dtype, seed) -> xs (T,B,In), h0, c0, wx, wh, b
_seq_inputs = functools.partial(chip_smoke.seq_inputs, torch)


def _seq_against_plain(args, pwl):
    dtype = args[0].dtype
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    ys, (hk, ck) = ts.lstm_seq_cuda(*args, pwl=pwl)
    torch.cuda.synchronize()
    yp, (hp, cp) = ts.lstm_seq_plain(*args, pwl=pwl)
    assert ys.dtype == hk.dtype == dtype and ck.dtype == torch.float32
    for got, want in ((ys, yp), (hk, hp), (ck, cp)):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("pwl", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_dim,hidden,b,t_len", [(24, 40, 37, 9), (8, 4, 1, 16),
                                                   (64, 128, 300, 8), (7, 13, 37, 9)])
def test_lstm_seq_kernel_tile_edges(cuda, in_dim, hidden, b, t_len, dtype, pwl):
    """K2 where In and H are no multiples of the register tile's 4 k or 2
    units, B no multiple of the block's rows; (64, 128) reads its weights
    from L2, (7, 13) takes the plain-load path for x."""
    _seq_against_plain(_seq_inputs(t_len, b, in_dim, hidden, dtype, seed=in_dim + b), pwl)


@pytest.mark.cuda
def test_lstm_seq_kernel_wide_layer_full_batch(cuda):
    """K2 at the paper's widest layer (32, 64) and the main path's B=8192,
    where the tile is 64 rows per block and 8 per thread, weights stationary
    in shared memory."""
    assert ts.lstm_seq_tile(8192, 32, 64) == (64, 8)
    assert ts.lstm_seq_plan(8192, 32, 64)[0]
    _seq_against_plain(_seq_inputs(16, 8192, 32, 64, torch.float32, seed=64), False)


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


# (b, t_len, h, hd, dtype, seed, zero_state=False) -> r, k, v, w, u, s0
_wkv6_inputs = functools.partial(chip_smoke.wkv_inputs, torch)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t_len,hd,h", [(8, 16, 2), (32, 32, 4), (64, 64, 2), (37, 64, 3)])
def test_wkv6_kernel_matches_plain(cuda, t_len, hd, h, dtype):
    """K3 against its plain version: the reference sweep and a T that is no
    multiple of the kernel's staging chunk."""
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    args = _wkv6_inputs(2, t_len, h, hd, dtype, seed=t_len + hd)
    before = launch_counts()["wkv6"]
    y, s = wkv6_op(*args)
    torch.cuda.synchronize()
    assert launch_counts()["wkv6"] == before + 1
    yp, sp = tw.wkv6_plain(*args)
    assert y.dtype == s.dtype == torch.float32
    torch.testing.assert_close(y, yp, rtol=tol, atol=tol)
    torch.testing.assert_close(s, sp, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t_len", [1, 7, 8, 9, 25])
@pytest.mark.parametrize("hd", [16, 32, 64])
def test_wkv6_kernel_tile_edges(cuda, hd, t_len, dtype):
    """K3 at T = 1, below, at and past one staging chunk (8 steps) and past
    the 3-stage ring, with 3 heads, so that the last block of 2 or 4 heads
    has slots that hold no head."""
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    args = _wkv6_inputs(1, t_len, 3, hd, dtype, seed=100 * hd + t_len)
    y, s = wkv6_op(*args)
    torch.cuda.synchronize()
    yp, sp = tw.wkv6_plain(*args)
    torch.testing.assert_close(y, yp, rtol=tol, atol=tol)
    torch.testing.assert_close(s, sp, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64])
def test_wkv6_kernel_on_rwkv_decays(cuda, hd, dtype):
    """Decays drawn as the RWKV layer makes them (near 1), over 1000 steps:
    the state sums hundreds of them."""
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    args = _wkv6_inputs(2, 1000, 4, hd, dtype, seed=hd, rwkv_decay=True)
    y, s = wkv6_op(*args)
    torch.cuda.synchronize()
    yp, sp = tw.wkv6_plain(*args)
    torch.testing.assert_close(y, yp, rtol=tol, atol=tol)
    torch.testing.assert_close(s, sp, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_takes_streams_off_16_bytes(cuda, dtype):
    """Streams whose data start 4 (f32) or 2 (bf16) bytes off 16 give what
    aligned copies give."""
    args = _wkv6_inputs(2, 19, 3, 64, dtype, seed=8)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0
        return view

    y, s = wkv6_op(*(shifted(t) for t in args[:4]), *args[4:])
    y_ref, s_ref = wkv6_op(*args)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    torch.testing.assert_close(s, s_ref, rtol=0, atol=0)


@pytest.mark.cuda
def test_wkv6_tile_rule(cuda):
    """The tile the library reports: 16 x 4 of S a thread at hd=64 in 2
    heads of 64 threads a block, and blocks resident enough for 8 heads an SM."""
    got = tw.wkv6_tile(64)
    assert (got["rows"], got["cols"], got["threads_per_head"], got["heads_per_block"]) == (16, 4, 64, 2)
    assert got["blocks_per_sm"] * got["heads_per_block"] >= 8
    for hd in (16, 32):
        t = tw.wkv6_tile(hd, torch.bfloat16)
        assert t["rows"] * 4 == hd and t["threads_per_head"] == 32 and t["blocks_per_sm"] >= 1


@pytest.mark.cuda
def test_wkv6_kernel_chains_across_chunks(cuda):
    """Two launches with the state handed through equal one launch."""
    r, k, v, w, u, s0 = _wkv6_inputs(2, 32, 2, 16, torch.float32, seed=11, zero_state=True)
    halves = [tuple(t[:, sl].contiguous() for t in (r, k, v, w)) for sl in (slice(0, 16), slice(16, 32))]
    y1, s1 = wkv6_op(*halves[0], u, s0)
    y2, s2 = wkv6_op(*halves[1], u, s1)
    y, s = wkv6_op(r, k, v, w, u, s0)
    yp, sp = tw.wkv6_plain(r, k, v, w, u, s0)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(s2, s, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(y, yp, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(s, sp, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_wkv6_refused_launches_raise(cuda):
    r, k, v, w, u, s0 = _wkv6_inputs(2, 8, 2, 16, torch.float32, seed=4)
    with pytest.raises(ValueError, match="head dims"):
        tw.wkv6_cuda(*_wkv6_inputs(2, 8, 2, 24, torch.float32, seed=4))
    with pytest.raises(TypeError, match="share a dtype"):
        tw.wkv6_cuda(r, k.to(torch.bfloat16), v, w, u, s0)
    strided = torch.zeros(2, 8, 2, 32, device="cuda")[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        tw.wkv6_cuda(strided, k, v, w, u, s0)
    with pytest.raises(ValueError, match="one device"):
        tw.wkv6_cuda(r, k, v, w, u.cpu(), s0)


# (b, h, s, sk, d, dtype, seed) -> q (B,H,S,d), k/v (B,H,Sk,d), standard normal
_attention_inputs = functools.partial(chip_smoke.attention_inputs, torch)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,sk,d", [(128, 128, 64), (256, 256, 64), (256, 256, 128),
                                    (128, 256, 64), (256, 128, 128), (200, 200, 64),
                                    (77, 130, 128)])
def test_flash_attention_kernel_matches_plain(cuda, s, sk, d, causal, dtype):
    """K4 against its plain version (top-left causal mask): the reference
    sweep, S != Sk both ways, and ragged S and Sk."""
    tol = 2e-3 if dtype == torch.float32 else 3e-2
    q, k, v = _attention_inputs(2, 3, s, sk, d, dtype, seed=s + sk + d)
    want = tf.flash_attention_plain(q, k, v, causal=causal)
    got = tf.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # the public (B, S, H, d) wrapper: strided views, one launch, same values
    before = launch_counts()["flash_attention"]
    out = flash_attention_op(*(t.transpose(1, 2).contiguous() for t in (q, k, v)), causal=causal)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == before + 1
    assert out.is_contiguous() and out.shape == (2, s, 3, d)   # written in q's layout
    torch.testing.assert_close(out.transpose(1, 2), got, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_bf16_ragged_tiles_are_zero_filled(cuda, d, causal):
    """bf16 with S and Sk no multiples of 64 and NaN in the storage past them
    (narrowed views of larger tensors): the tensor-core kernel must load the
    rows past Sk as zeros, or 0 * NaN would reach every row."""
    s, sk = 77, 130
    q, k, v = _attention_inputs(2, 3, s, sk, d, torch.bfloat16, seed=d + s)
    want = tf.flash_attention_plain(q, k, v, causal=causal)
    views = []
    for t, n in ((q, s), (k, sk), (v, sk)):
        big = torch.full((2, 3, n + 64, d), float("nan"), dtype=t.dtype, device=t.device)
        big[:, :, :n] = t
        views.append(big[:, :, :n])
    got = tf.flash_attention_cuda(*views, causal=causal)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2, atol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_bf16_transposed_views(cuda, d, causal):
    """bf16 on (B, H, S, d) views of contiguous (B, S, H, d) tensors, read and
    written through their strides."""
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in _attention_inputs(2, 4, 200, 136, d, torch.bfloat16, seed=d))
    assert not q.is_contiguous()
    out = torch.empty(2, 200, 4, d, dtype=torch.bfloat16, device="cuda").transpose(1, 2)
    got = tf.flash_attention_cuda(q, k, v, causal=causal, out=out)
    torch.cuda.synchronize()
    want = tf.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2, atol=3e-2)


def _nan_padded_views(tensors, lengths):
    """Each (B, H, n, d) tensor as a narrowed view of a larger one whose
    rows past n hold NaN."""
    views = []
    for t, n in zip(tensors, lengths):
        big = torch.full((*t.shape[:2], n + 64, t.shape[3]), float("nan"), dtype=t.dtype,
                         device=t.device)
        big[:, :, :n] = t
        views.append(big[:, :, :n])
    return views


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_f32_ragged_tiles_are_zero_filled(cuda, d, causal):
    """f32 (3xTF32) with S and Sk no multiples of the 32-key tile and NaN in
    the storage past them: rows past Sk must load as zeros."""
    s, sk = 77, 130
    q, k, v = _attention_inputs(2, 3, s, sk, d, torch.float32, seed=d + s)
    want = tf.flash_attention_plain(q, k, v, causal=causal)
    got = tf.flash_attention_cuda(*_nan_padded_views((q, k, v), (s, sk, sk)), causal=causal)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_f32_transposed_and_offset_views(cuda, d, causal):
    """f32 on (B, H, S, d) views of contiguous (B, S, H, d) tensors (the
    16-byte copy path) and on views 4 bytes off 16 with rows of d + 1 (the
    4-byte copy path), read and written through their strides."""
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in _attention_inputs(2, 4, 200, 136, d, torch.float32, seed=d))
    want = tf.flash_attention_plain(q, k, v, causal=causal)
    out = torch.empty(2, 200, 4, d, device="cuda").transpose(1, 2)
    assert not q.is_contiguous() and tf.copy_path(q, k, v, out) == "16-byte cp.async"
    got = tf.flash_attention_cuda(q, k, v, causal=causal, out=out)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
    views = [chip_smoke.offset_view(torch, t) for t in (q, k, v, torch.empty_like(q))]
    assert views[0].data_ptr() % 16 and views[0].stride(2) == d + 1
    assert tf.copy_path(*views) == "4-byte cp.async"
    got = tf.flash_attention_cuda(*views[:3], causal=causal, out=views[3])
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s,sk", [(100, 300), (300, 100)])
def test_flash_attention_f32_s_differs_from_sk(cuda, s, sk, d, causal):
    """f32 with S != Sk both ways (top-left causal mask), against the plain
    version."""
    q, k, v = _attention_inputs(2, 2, s, sk, d, torch.float32, seed=s + 2 * sk + d)
    got = tf.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tf.flash_attention_plain(q, k, v, causal=causal),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
def test_flash_attention_bf16_refuses_misaligned_views(cuda):
    """A bf16 view whose rows are off 16 bytes is refused with an error,
    before any launch; the f32 kernel takes the same view through its
    4-byte copy path."""
    from repro_torch.kernels.ops import reset_launch_counts

    q, k, v = _attention_inputs(1, 2, 64, 64, 64, torch.bfloat16, seed=12)
    wide = torch.zeros(1, 2, 64, 65, dtype=torch.bfloat16, device="cuda")
    wide[..., 1:] = q
    bad = wide[..., 1:]                     # pointer 2 bytes off, row stride 65
    reset_launch_counts()
    with pytest.raises(ValueError, match="16 bytes"):
        tf.flash_attention_cuda(bad, k, v)
    with pytest.raises(ValueError, match="16 bytes"):
        tf.flash_attention_cuda(q, k, v, out=torch.empty(1, 2, 64, 65, dtype=torch.bfloat16,
                                                         device="cuda")[..., 1:])
    assert launch_counts()["flash_attention"] == 0
    wide_f32 = torch.zeros(1, 2, 64, 65, device="cuda")
    wide_f32[..., 1:] = q.float()
    bad_f32 = wide_f32[..., 1:]             # pointer 4 bytes off, row stride 65
    assert bad_f32.data_ptr() % 16 and bad_f32.stride(2) == 65
    got = tf.flash_attention_cuda(bad_f32, k.float(), v.float())
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 1
    torch.testing.assert_close(got, tf.flash_attention_plain(q.float(), k.float(), v.float()),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
def test_flash_attention_refused_launches_raise(cuda):
    q, k, v = _attention_inputs(1, 2, 64, 64, 64, torch.float32, seed=5)
    with pytest.raises(ValueError, match="head dims"):
        tf.flash_attention_cuda(*_attention_inputs(1, 2, 64, 64, 96, torch.float32, seed=5))
    with pytest.raises(TypeError, match="share a dtype"):
        tf.flash_attention_cuda(q, k.to(torch.bfloat16), v)
    strided = torch.zeros(1, 2, 64, 128, device="cuda")[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        tf.flash_attention_cuda(strided, k, v)
    with pytest.raises(ValueError, match="one device"):
        tf.flash_attention_cuda(q, k.cpu(), v)
    with pytest.raises(ValueError, match="out must be"):
        tf.flash_attention_cuda(q, k, v, out=torch.empty_like(q)[:, :1])
    with pytest.raises(ValueError, match="share storage"):
        tf.flash_attention_cuda(q, k, v, out=q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_op_output_layout_is_fixed(cuda, dtype):
    """The (B, S, H, d) wrapper returns a contiguous tensor for a q that is
    not dense (heads sliced out of a wider tensor), as on the CPU, and the
    kernel wrapper writes a given ``out`` through its strides."""
    q, k, v = _attention_inputs(2, 4, 72, 72, 64, dtype, seed=8)
    q2, k2, v2 = (t.transpose(1, 2)[:, :, :2] for t in (q, k, v))   # (B, S, 2 of 4 heads, d)
    assert not q2.is_contiguous()
    out = flash_attention_op(q2, k2, v2)
    cpu = flash_attention_op(q2.cpu(), k2.cpu(), v2.cpu())
    assert out.is_contiguous() and cpu.is_contiguous() and out.shape == cpu.shape == q2.shape
    want = tf.flash_attention_plain(*(t.transpose(1, 2) for t in (q2, k2, v2)))
    tol = 2e-3 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(out.transpose(1, 2).float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(out.cpu().float(), cpu.float(), rtol=tol, atol=tol)
    wide = torch.zeros(2, 3, 72, 128, dtype=dtype, device="cuda")
    got = tf.flash_attention_cuda(q[:, :3], k[:, :3], v[:, :3], out=wide[..., 32:96])
    torch.cuda.synchronize()
    assert got.data_ptr() == wide[..., 32:96].data_ptr()
    assert not wide[..., :32].any() and not wide[..., 96:].any()
    torch.testing.assert_close(got, tf.flash_attention_cuda(q[:, :3], k[:, :3], v[:, :3]),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_launch_counters_count_kernel_launches_only(cuda):
    """Each wrapper adds one per launch; refused launches and plain versions
    add nothing."""
    from repro_torch.kernels.ops import reset_launch_counts

    reset_launch_counts()
    wargs = _wkv6_inputs(1, 4, 1, 16, torch.float32, seed=6)
    wkv6_op(*wargs)
    tw.wkv6_plain(*wargs)
    q, k, v = _attention_inputs(1, 1, 8, 8, 64, torch.float32, seed=6)
    flash_attention_op(q, k, v)
    flash_attention_op(q, k, v, causal=False)
    tf.flash_attention_plain(q, k, v)
    with pytest.raises(ValueError):
        tf.flash_attention_cuda(q[..., :32], k[..., :32], v[..., :32])
    torch.cuda.synchronize()
    assert launch_counts() == {"lstm_cell": 0, "lstm_seq": 0, "wkv6": 1, "flash_attention": 2}


# -- captured programs (engine/capture.py) -----------------------------------

CAPTURE_ARCH = "lstm-ae-f32-d6"


def _capture_pair(schedule, cuda):
    """A capturing engine and an eager (jit=False) one on the same params."""
    from repro_torch.engine import EngineConfig

    cfg = get_config(CAPTURE_ARCH)
    params = init_lstm_ae(torch.Generator().manual_seed(3), cfg, device=cuda)
    captured = build_engine(cfg, EngineConfig(schedule=schedule), params=params, device=cuda)
    eager = build_engine(cfg, EngineConfig(schedule=schedule, jit=False), params=params,
                         device=cuda)
    assert captured._graphs is not None and eager._graphs is None
    return captured, eager


def _programs(engine, series, lengths, state, mask):
    """Every program of the engine once: reconstruct, score, score_masked,
    step, mstep (the stream outputs flattened)."""
    y, st = engine.stream(series[:, 0], state)
    my, mst = engine.stream_masked(series[:, 1], state, mask)
    return [engine.reconstruct({"series": series}), engine.score({"series": series}),
            engine.score_masked({"series": series, "lengths": lengths}),
            y, *st["h"], *st["c"], my, *mst["h"], *mst["c"]]


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["sequential", "wavefront", "pipelined", "fused"])
def test_captured_programs_equal_eager(cuda, schedule):
    """Every program, captured (first call: the warm-up; later: replays)
    against the same program run eagerly, within the schedule bar of
    tests/test_engine.py::test_schedule_equivalence (1e-5 / 1e-6)."""
    captured, eager = _capture_pair(schedule, cuda)
    gen = torch.Generator().manual_seed(4)
    series = torch.randn(6, 9, 32, generator=gen)
    lengths = torch.tensor([9, 1, 4, 7, 9, 2], dtype=torch.int32)
    state = eager.init_stream_state(6)
    state["h"] = tuple(torch.randn(h.shape, generator=gen).to(cuda) for h in state["h"])
    mask = torch.tensor([True, False, True, True, False, True])
    want = _programs(eager, series, lengths, state, mask)
    for call in range(3):
        got = _programs(captured, series, lengths, state, mask)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    info = captured.profile_info()
    assert info["compiles"] == 5 and len(captured._graphs.programs) == 5
    assert captured._graphs.replays == 10
    assert set(info["per_program"]) == {"reconstruct", "score", "score_masked", "step", "mstep"}


@pytest.mark.cuda
def test_captured_fused_schedule_counts_every_launch(cuda):
    """The fused schedule is captured whole: the graph holds depth x T K1
    launches, and every call (the warm-up, then each replay) counts them."""
    captured, _ = _capture_pair("fused", cuda)
    depth, t_len = len(captured.params["layers"]), 9
    series = torch.randn(5, t_len, 32, generator=torch.Generator().manual_seed(5))
    for call in range(3):
        before = launch_counts()["lstm_cell"]
        captured.score({"series": series})
        assert launch_counts()["lstm_cell"] == before + depth * t_len
    (prog,) = captured._graphs.programs.values()
    assert prog.launches == {"lstm_cell": depth * t_len} and prog.replays == 2


@pytest.mark.cuda
def test_captured_score_spans_and_launches(cuda):
    """The port's spans around a captured fused score.  Profiled, one request
    holds one ``repro_torch.capture.replay`` range with the request's graph
    launch inside it, inside the ``repro_torch.service.score`` range, and no
    span is projected onto the device's timeline (a reader of the device's
    trace would count the projection as a kernel).  Recorded, copy-in and
    replay run once a request, the bytes copied in are counted by the source's
    memory, and the port's launches a request equal the graph's launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine import AnomalyService
    from repro_torch.obs import trace

    svc = AnomalyService(CAPTURE_ARCH, schedule="fused", device=cuda)
    x = torch.randn(1, 9, 32, generator=torch.Generator().manual_seed(8))
    svc.score(x)                                   # the capture
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        svc.score(x).cpu()
    events = list(prof.events())

    def host(name):
        return [e.time_range for e in events
                if e.name == name and e.device_type == DeviceType.CPU]

    (root,), (replay,), (launch,) = (host("repro_torch.service.score"),
                                     host("repro_torch.capture.replay"), host("cudaGraphLaunch"))
    assert root.start <= replay.start <= launch.start <= launch.end <= replay.end <= root.end
    assert [e.name for e in events if e.name.startswith("repro_torch.")
            and e.device_type == DeviceType.CUDA] == []

    (prog,) = svc.engine._graphs.programs.values()
    sources = (x, x.pin_memory(), x.to(cuda))
    before = sum(launch_counts().values())
    with trace.PROGRAM.recording() as rec:
        for src in sources:
            svc.score(src)
    assert sum(launch_counts().values()) - before == len(sources) * sum(prog.launches.values())
    assert rec.requests == len(sources)
    for stage in ("copy_in", "replay", "clone_out"):
        assert rec.calls[f"repro_torch.capture.{stage}"] == len(sources)
    assert "repro_torch.engine.capture" not in rec.calls
    nbytes = x.numel() * x.element_size()
    assert rec.h2d_bytes == {"pinned": nbytes, "pageable": nbytes, "device": nbytes}
    assert {s.program for s in rec.last[-1][1:]} == {"score"}


@pytest.mark.cuda
def test_bind_after_capture_serves_the_new_params(cuda):
    """Binding params of the same layout copies them in place: the captured
    graph serves them, nothing is recaptured.  A new layout (f64 params on
    the wavefront schedule) drops the graphs and recaptures at the next
    call."""
    captured, eager = _capture_pair("wavefront", cuda)
    series = torch.randn(4, 7, 32, generator=torch.Generator().manual_seed(6))
    captured.score({"series": series})
    bound = [t.data_ptr() for t in tree_leaves(captured._weights)]
    other = init_lstm_ae(torch.Generator().manual_seed(9), captured.cfg, device="cpu")
    for engine in (captured, eager):
        engine.bind(other)
    assert [t.data_ptr() for t in tree_leaves(captured._weights)] == bound
    got = captured.score({"series": series})
    torch.testing.assert_close(got, eager.score({"series": series}), rtol=1e-5, atol=1e-6)
    assert captured.profile_info()["compiles"] == 1 and captured._graphs.replays == 1
    wide = {"layers": tuple({k: v.double() for k, v in layer.items()}
                            for layer in other["layers"])}
    for engine in (captured, eager):
        engine.bind(wide)
    assert captured.params["layers"][0]["wx"].dtype == torch.float64
    assert not captured._graphs.programs
    got = captured.score({"series": series})
    torch.testing.assert_close(got, eager.score({"series": series}), rtol=1e-5, atol=1e-6)
    assert captured.profile_info()["compiles"] == 2


@pytest.mark.cuda
def test_captured_results_belong_to_the_caller(cuda):
    """A later call never overwrites what an earlier call returned; a new
    shape adds exactly one capture, a seen one none."""
    captured, eager = _capture_pair("fused", cuda)
    gen = torch.Generator().manual_seed(7)
    xs = [torch.randn(4, 8, 32, generator=gen) for _ in range(3)]
    outs = [captured.reconstruct({"series": x}) for x in xs]
    for x, out in zip(xs, outs):
        torch.testing.assert_close(out, eager.reconstruct({"series": x}), rtol=1e-5, atol=1e-6)
    assert captured.profile_info()["compiles"] == 1
    captured.reconstruct({"series": torch.randn(5, 8, 32, generator=gen)})
    assert captured.profile_info()["compiles"] == 2 and len(captured._graphs.programs) == 2
    captured.reconstruct({"series": xs[0]})
    assert captured.profile_info()["compiles"] == 2


@pytest.mark.cuda
def test_capture_refusing_a_launch_raises(cuda):
    """A kernel that refuses its launch raises out of the first call (its
    warm-up) and leaves no program behind; nothing runs eagerly instead."""
    captured, _ = _capture_pair("fused", cuda)
    rows = 65535 * 64 + 1     # one row past K1's grid (test_refused_launch_raises)
    with pytest.raises(RuntimeError, match="lstm_cell kernel launch failed"):
        captured.score({"series": torch.zeros(rows, 1, 32, device=cuda)})
    assert not captured._graphs.programs and captured.profile_info()["compiles"] == 0


@pytest.mark.cuda
def test_capture_refusing_a_launch_inside_the_graph_raises(cuda, monkeypatch):
    """A K1 launch that the warm-up makes but the capture refuses raises out
    of the capture and leaves no program behind; nothing runs eagerly
    instead."""
    captured, _ = _capture_pair("fused", cuda)
    real = tk._lib()

    class RefusedWhileCapturing:
        def __getattr__(self, name):
            return getattr(real, name)

        def lstm_cell_forward(self, *args):
            if torch.cuda.is_current_stream_capturing():
                return 9      # cudaErrorInvalidConfiguration
            return real.lstm_cell_forward(*args)

    monkeypatch.setattr(tk, "_lib", RefusedWhileCapturing)
    before = launch_counts()["lstm_cell"]
    series = torch.randn(4, 3, 32, generator=torch.Generator().manual_seed(11))
    with pytest.raises(RuntimeError, match="lstm_cell kernel launch failed"):
        captured.score({"series": series})
    depth = len(captured.params["layers"])
    assert launch_counts()["lstm_cell"] == before + depth * 3     # the warm-up's alone
    assert not captured._graphs.programs and captured.profile_info()["compiles"] == 0


@pytest.mark.cuda
def test_capture_survives_a_collected_cycle_holding_an_old_graph(cuda):
    """An earlier program left in a garbage cycle while a new one captures
    and allocates enough Python objects to start the cyclic collector: the
    old graph is not destroyed mid-capture (a capturing thread may not make
    that call, and the capture would be lost); the collector runs after."""
    import gc
    import weakref

    from repro_torch.engine.capture import CapturedProgram

    stream = torch.cuda.Stream(cuda)
    x = torch.ones(64, device=cuda)
    holder = [CapturedProgram(lambda t: t * 2.0, (x,), cuda, stream)]
    gone = weakref.ref(holder[0])

    def fn(t):
        if torch.cuda.is_current_stream_capturing() and holder:
            cycle = [holder.pop()]
            cycle.append(cycle)            # the old program, now only in a cycle
            del cycle
            junk = [[i] for i in range(50_000)]
            for j in junk:                 # allocations past gen0's threshold
                j.append(j)
        return t + 1.0

    gc.collect()
    program = CapturedProgram(fn, (x,), cuda, stream)
    assert torch.equal(program((x,)), x + 1.0)
    gc.collect()
    assert gone() is None


@pytest.mark.cuda
def test_a_params_snapshot_serves_again_after_a_swap(cuda):
    """The reference's swap and restore (tests/test_gateway.py::
    test_recalibrate_swaps_params_atomically) on a captured engine: a
    snapshot of ``svc.params`` taken before a swap is not written by the
    swap, and rebinding it serves it again, through the score graph and
    the gateway's pool step, without a recapture."""
    from repro_torch.engine import AnomalyService

    svc = AnomalyService(CAPTURE_ARCH, schedule="fused", device=cuda)
    other = AnomalyService(CAPTURE_ARCH, schedule="fused", device=cuda, seed=5)
    gw = svc.open_gateway(capacity=2, max_batch=2)
    series = torch.randn(3, 6, svc.features, generator=torch.Generator().manual_seed(12))

    def served():
        gw.admit("a")
        for t in range(series.shape[1]):
            running = gw.step({"a": series[0, t].numpy()})["a"]
        gw.evict("a")
        return svc.score(series), running

    old = svc.params
    kept = [t.clone() for t in tree_leaves(old)]
    want, want_running = served()
    compiles = svc.engine.profile_info()["compiles"]
    svc.recalibrate(params=other.params)
    swapped, _ = served()
    torch.testing.assert_close(swapped, other.score(series), rtol=1e-5, atol=1e-6)
    assert not torch.allclose(swapped, want, rtol=1e-5, atol=1e-6)
    svc.recalibrate(params=old)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(old), kept))
    got, got_running = served()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert got_running == pytest.approx(want_running, rel=1e-5, abs=1e-6)
    assert svc.engine.profile_info()["compiles"] == compiles


@pytest.mark.cuda
def test_each_pool_counts_its_own_capture(cuda):
    """Two pools on one captured engine each capture their step, and each
    capture counts in the engine's profile."""
    from repro_torch.engine import AnomalyService

    svc = AnomalyService(CAPTURE_ARCH, schedule="fused", device=cuda)
    x = np.zeros(svc.features, np.float32)
    for n in (1, 2):
        gw = svc.open_gateway(capacity=4, max_batch=4)
        gw.admit("a")
        gw.step({"a": x})
        gw.step({"a": x})
        assert gw.pool.captures == 1
        assert svc.engine.profile_info()["per_program"]["mstep"]["compiles"] == n


@pytest.mark.cuda
def test_pool_churn_adds_no_capture(cuda):
    """The pool step is one captured program per pool: slot churn (admit,
    evict, reset, restore) replays it and equals the eager pool."""
    from repro_torch.engine import AnomalyService, EngineConfig
    from repro_torch.gateway import drive_stream_churn

    svc = AnomalyService(CAPTURE_ARCH, schedule="fused", device=cuda)
    eager = AnomalyService(CAPTURE_ARCH, schedule=EngineConfig("fused", jit=False), device=cuda)
    eager.recalibrate(params=svc.params)
    windows = torch.randn(20, 12, svc.features, generator=torch.Generator().manual_seed(8))
    finals = []
    for s in (svc, eager):
        gw = s.open_gateway(capacity=6, max_batch=4)
        finals.append(drive_stream_churn(gw, windows, churn_every=3)[0])
        gw.admit("x")
        gw.reset("x")
        rows, sq, n = gw.pool.export_slot("x")
        gw.evict("x")
        gw.pool.restore("y", rows, sq, n)
        gw.step({"y": windows[0, 0].numpy()})
        finals[-1]["y"] = gw.evict("y")
        assert gw.pool.captures == (1 if s is svc else 0)
    assert finals[0].keys() == finals[1].keys()
    for sid in finals[0]:
        assert finals[0][sid] == pytest.approx(finals[1][sid], rel=1e-5, abs=1e-6)


@pytest.mark.cuda
def test_fit_on_the_card_matches_the_cpu(cuda):
    """Three steps of AnomalyService.fit on the card against the same fit on
    the CPU (same seed, so the same init, and the same batches): loss within
    rtol 1e-5, params within atol 1e-5; the captured engine then scores
    with the fitted params."""
    from repro_torch.data import TimeseriesConfig
    from repro_torch.engine import AnomalyService

    dc = TimeseriesConfig(features=32, seq_len=16, batch=32)
    gpu = AnomalyService(CAPTURE_ARCH, schedule="fused", device=cuda)
    cpu = AnomalyService(CAPTURE_ARCH, schedule="fused", device="cpu")
    series = torch.randn(8, 16, 32, generator=torch.Generator().manual_seed(10))
    before = gpu.score(series)             # captured before the fit
    got, want = gpu.fit(dc, steps=3), cpu.fit(dc, steps=3)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5)
    for g, w in zip(tree_leaves(gpu.params), tree_leaves(cpu.params)):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-5)
    after = gpu.score(series)
    assert gpu.engine.profile_info()["compiles"] == 1      # the fit rebound in place
    assert float((after - before).abs().max()) > 0
    torch.testing.assert_close(after.cpu(), cpu.score(series), rtol=1e-4, atol=1e-6)


# -- the socket transport on the card ---------------------------------------


def _serve(gw, **kw):
    from repro_torch.gateway.server import GatewayServer

    server = GatewayServer(gw, port=0, pump_interval_ms=1.0, **kw)
    host, port = server.start_in_thread()
    return server, host, port


def _eager_twin(svc):
    """The same model and params on an engine that runs eagerly."""
    from repro_torch.engine import AnomalyService, EngineConfig

    eager = AnomalyService(svc.cfg, schedule=EngineConfig("fused", jit=False),
                           device=svc.device)
    eager.recalibrate(params=svc.params)
    return eager


@pytest.mark.cuda
def test_socket_server_scores_bit_equal_over_bp1_and_json(cuda):
    """A server in front of a captured gateway: bp1 and JSON scores are
    bit-equal, within 1e-4 / 1e-6 of eager direct scores; a bp1 stream
    equals solo stream_step; every capture ran on the server's thread."""
    from repro_torch.engine import AnomalyService
    from repro_torch.gateway.client import GatewayClient

    svc = AnomalyService(CAPTURE_ARCH, schedule="fused", device=cuda)
    eager = _eager_twin(svc)
    gw = svc.open_gateway(capacity=8, max_batch=4, max_wait_ms=2.0)
    windows = [torch.randn(n, svc.features, generator=torch.Generator().manual_seed(n)).numpy()
               for n in (5, 8, 12, 16, 30, 7)]
    captures = svc.engine._graphs.captures
    server, host, port = _serve(gw)
    try:
        with GatewayClient(host, port, protocol="binary") as cb, \
                GatewayClient(host, port, protocol="json") as cj:
            got_b, got_j = cb.score_many(windows), cj.score_many(windows)
            data = windows[3][:10]
            steps = cb.step_many(data)
            cb.end_session()
    finally:
        server.stop_in_thread()
    assert got_b == got_j
    for w, s in zip(windows, got_b):
        assert s == pytest.approx(float(eager.score(w[None])[0]), rel=1e-4, abs=1e-6)
    sess = eager.stream_start(1)
    for t, got in enumerate(steps):
        errs, sess = eager.stream_step(data[t:t + 1], sess)
        assert got == pytest.approx(float(errs[0]), rel=1e-4, abs=1e-6)
    assert svc.engine._graphs.captures == captures + 3      # buckets 8, 16, 32
    assert gw.pool.captures == 1


def _hammer(stop, errors, fn):
    """Call ``fn`` until ``stop`` is set, keeping the first failure."""
    def run():
        try:
            while not stop.is_set():
                fn()
        except Exception as exc:  # reported by the test that started it
            errors.append(exc)
    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th


@pytest.mark.cuda
@pytest.mark.parametrize("neighbour", ["metrics_scrape", "cuda_work"])
def test_capture_on_the_server_thread_survives_a_busy_neighbour(cuda, neighbour):
    """New buckets are captured on the server's thread while another thread
    scrapes /metrics in a loop (``gw.stats()`` makes no CUDA call), or runs
    CUDA work of its own (captures check only their own thread's calls):
    every scrape answers, every capture completes, every score is right."""
    import urllib.request

    from repro_torch.engine import AnomalyService
    from repro_torch.gateway.client import GatewayClient
    from repro_torch.obs import MetricsServer

    svc = AnomalyService(CAPTURE_ARCH, schedule="fused", device=cuda)
    eager = _eager_twin(svc)
    gw = svc.open_gateway(capacity=4, max_batch=2, max_wait_ms=1.0)
    metrics = MetricsServer(gw.stats, port=0).start()
    server, host, port = _serve(gw)
    stop, errors, done = threading.Event(), [], []
    url = f"http://127.0.0.1:{metrics.port}/metrics"
    if neighbour == "metrics_scrape":
        work = lambda: done.append(urllib.request.urlopen(url, timeout=30).status)  # noqa: E731
    else:
        side = torch.randn(512, 512, device=cuda)
        work = lambda: done.append(float((side @ side).sum()))  # noqa: E731
    th = _hammer(stop, errors, work)
    captures = svc.engine._graphs.captures
    windows = [torch.randn(n, svc.features, generator=torch.Generator().manual_seed(n)).numpy()
               for n in (5, 9, 17, 33, 65)]
    try:
        with GatewayClient(host, port) as c:
            scores = [c.score(w) for w in windows]      # one new bucket each
    finally:
        stop.set()
        th.join(30)
        server.stop_in_thread()
        metrics.stop()
    assert not th.is_alive() and not errors, errors
    assert done and (neighbour != "metrics_scrape" or set(done) == {200})
    assert svc.engine._graphs.captures == captures + len(windows)
    for w, s in zip(windows, scores):
        assert s == pytest.approx(float(eager.score(w[None])[0]), rel=1e-4, abs=1e-6)


@pytest.mark.cuda
def test_two_threads_on_one_captured_program_never_mix_scores(cuda):
    """Two threads replay one captured program on different inputs: the
    graph cache runs one call at a time, so neither ever gets a score of
    the other's input (unserialised, one thread's copy into the static
    input lands between the other's copy and replay)."""
    from repro_torch.engine import AnomalyService

    svc = AnomalyService(CAPTURE_ARCH, schedule="fused", device=cuda)
    gen = torch.Generator().manual_seed(12)
    batches = [torch.randn(4, 16, svc.features, generator=gen) for _ in range(2)]
    want = [svc.engine.score({"series": b}).cpu() for b in batches]
    assert svc.engine._graphs.captures == 1
    errors = []

    def run(i):
        for _ in range(300):
            got = svc.engine.score({"series": batches[i]}).cpu()
            if not torch.equal(got, want[i]):
                errors.append((i, got, want[i]))
                return

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[0]
    assert svc.engine._graphs.captures == 1 and svc.engine._graphs.replays >= 601


@pytest.mark.cuda
def test_a_restore_adds_no_capture(cuda, tmp_path):
    """Park, snapshot and resume a durable session on a captured pool: the
    pool step stays the one graph it captured first, and the resumed run
    is bit-equal to an uninterrupted one."""
    from repro_torch.engine import AnomalyService
    from repro_torch.gateway.durability import enable_durability

    svc = AnomalyService(CAPTURE_ARCH, schedule="fused", device=cuda)
    data = torch.randn(10, svc.features, generator=torch.Generator().manual_seed(13)).numpy()
    ref = svc.open_gateway(capacity=4)
    ref.admit("u")
    uninterrupted = [ref.step({"u": x})["u"] for x in data]
    gw = svc.open_gateway(capacity=4)
    dur = enable_durability(gw, tmp_path)
    sid, _ = dur.admit()
    got = []
    for x in data[:4]:
        running, _, token = dur.step(sid, x)
        got.append(running)
    dur.suspend(sid)
    dur.snapshot_now(wait=True)
    assert gw.pool.captures == 1
    assert dur.resume(token)["seq"] == 4
    got += [dur.step(sid, x)[0] for x in data[4:]]
    # a second worker on the store resumes from the snapshot, as after a restart
    dur.suspend(sid)
    dur.snapshot_now(wait=True)
    gw2 = svc.open_gateway(capacity=4)
    dur2 = enable_durability(gw2, tmp_path, shard="worker-1")
    dur2.resume(token)
    extra = dur2.step(sid, data[0])[0]
    assert got == uninterrupted
    assert extra == ref.step({"u": data[0]})["u"]
    assert gw.pool.captures == 1 and gw2.pool.captures == 1


@pytest.mark.cuda
def test_server_thread_runs_on_the_gateway_device(cuda):
    """A gateway on the second GPU: the server's loop thread takes it as its
    current device before any CUDA call, so its captures and replays run
    there, and scores are right."""
    import asyncio

    from repro_torch.engine import AnomalyService
    from repro_torch.gateway.client import GatewayClient

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs: the gateway must live off device 0")
    dev = torch.device("cuda", 1)
    svc = AnomalyService(CAPTURE_ARCH, schedule="fused", device=dev)
    eager = _eager_twin(svc)
    gw = svc.open_gateway(capacity=4, max_batch=2, max_wait_ms=1.0)
    server, host, port = _serve(gw)

    async def current():
        return torch.cuda.current_device()

    try:
        on_loop = asyncio.run_coroutine_threadsafe(current(), server._loop).result(30)
        w = torch.randn(12, svc.features, generator=torch.Generator().manual_seed(14)).numpy()
        with GatewayClient(host, port) as c:
            score = c.score(w)
            c.step(w[0])
    finally:
        server.stop_in_thread()
    assert on_loop == 1
    assert score == pytest.approx(float(eager.score(w[None])[0]), rel=1e-4, abs=1e-6)
    assert all(p.graph is not None for p in svc.engine._graphs.programs.values())
    assert gw.pool._blocks[0].state["h"][0].device == dev


# -- the multi-worker front on the card ---------------------------------------


WORKER_KW = {"capacity": 4, "max_batch": 4, "max_wait_ms": 5.0, "warm_seq_len": 16}


def device_reporting_gateway(report_dir: str, **kw):
    """Per-worker factory (spawn imports this module in each worker): the
    port's default gateway on the current CUDA device, which writes the
    device its engine took to ``report_dir/<pid>``."""
    from repro_torch.gateway.workers import default_gateway_factory

    gw = default_gateway_factory(CAPTURE_ARCH, "fused", **{**WORKER_KW, **kw})
    with open(os.path.join(report_dir, str(os.getpid())), "w") as f:
        f.write(str(gw.engine.device))
    return gw


@pytest.mark.cuda
def test_workers_on_the_card_score_bit_equal_to_in_process(cuda, tmp_path):
    """Two workers on cuda:0, each with its own CUDA context and captured
    bucket graph: one-shot scores and a stream over the socket bit-equal
    to an in-process gateway on the same card with the same seed."""
    from repro_torch.engine import AnomalyService
    from repro_torch.gateway.client import GatewayClient
    from repro_torch.gateway.workers import WorkerFront

    svc = AnomalyService(CAPTURE_ARCH, schedule="fused", device=cuda)
    gw = svc.open_gateway(**{k: v for k, v in WORKER_KW.items() if k != "warm_seq_len"})
    rng = np.random.default_rng(3)
    windows = [rng.standard_normal((16, svc.features)).astype(np.float32) for _ in range(6)]
    local = [float(gw.score([w])[0]) for w in windows]
    gw.admit("s")
    stream = [gw.step({"s": w[0]})["s"] for w in windows]
    f = WorkerFront(functools.partial(device_reporting_gateway, str(tmp_path)), n_workers=2)
    host, port = f.start(ready_timeout=300.0)
    try:
        for _ in range(8):  # several connections: the kernel spreads them
            with GatewayClient(host, port) as c:
                assert [c.score(w) for w in windows] == local
        with GatewayClient(host, port) as c:
            assert [c.step(w[0])["running_error"] for w in windows] == stream
        per = f.stats()["per_worker"]
        assert all(w["counters"].get("queue.completed", 0) > 0 for w in per), per
    finally:
        summary = f.shutdown()
    assert summary["clean_exits"] == 2 and summary["dropped_tickets"] == 0
    assert sorted(p.read_text() for p in tmp_path.iterdir()) == ["cuda:0", "cuda:0"]


@pytest.mark.cuda
def test_supervisor_leaves_cuda_uninitialised(cuda):
    """A process that starts a front of CUDA workers and recalibrates it
    with new params never initialises CUDA itself: params cross the pipes
    as numpy, stats as plain Python.  Run in a fresh interpreter, as this
    test process has long initialised CUDA."""
    import subprocess

    script = f"""
import functools, numpy as np, torch
from repro_torch.gateway.workers import WorkerFront, default_gateway_factory
from repro_torch.engine import AnomalyService
cpu = AnomalyService({CAPTURE_ARCH!r}, schedule="fused", device="cpu")
f = WorkerFront(functools.partial(default_gateway_factory, {CAPTURE_ARCH!r}, "fused",
                                  **{WORKER_KW!r}), n_workers=2)
f.start(ready_timeout=300.0)
out = f.recalibrate(params=cpu.params, threshold=0.5)
s = f.stats()
summary = f.shutdown()
assert out["workers"] == 2 and out["params_swapped"], out
assert [w["threshold"] for w in s["per_worker"]] == [0.5, 0.5]
assert summary["clean_exits"] == 2, summary
print("initialised", torch.cuda.is_initialized())
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
    out = subprocess.run([sys.executable, "-c", script], env=env, cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "initialised False" in out.stdout


@pytest.mark.cuda
def test_claim_of_cuda_1_sets_the_workers_device(cuda, tmp_path):
    """A worker that claims ``cuda:1`` makes it its current device before
    it builds its gateway: ``device=None`` resolves there, and the claim
    is in the registry while the worker lives."""
    from repro_torch.gateway.claims import DeviceClaimRegistry
    from repro_torch.gateway.client import GatewayClient
    from repro_torch.gateway.workers import WorkerFront

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs: the worker must live off device 0")
    report = tmp_path / "report"
    report.mkdir()
    f = WorkerFront(functools.partial(device_reporting_gateway, str(report)), n_workers=1,
                    device_claims={0: ["cuda:1"]}, claims_dir=str(tmp_path))
    host, port = f.start(ready_timeout=300.0)
    try:
        assert DeviceClaimRegistry(tmp_path).claims()["worker-0"]["devices"] == ["cuda:1"]
        with GatewayClient(host, port) as c:
            assert np.isfinite(c.score(np.zeros((16, 32), np.float32)))
    finally:
        f.shutdown()
    assert [p.read_text() for p in report.iterdir()] == ["cuda:1"]


# -- multi-GPU placement and the stage pipeline on the card -------------------
#
# One card stands in for several devices by naming it more than once
# (``devices=("cuda:0",) * n``), each shard or stage on its own stream; the
# distinct-GPU cases skip inside the test with fewer than two GPUs.


def _multi_engine(placement, arch="lstm-ae-f32-d6", schedule="fused", seed=0):
    from repro_torch.engine import EngineConfig

    cfg = get_config(arch)
    params = init_lstm_ae(torch.Generator().manual_seed(seed), cfg, "cuda")
    return build_engine(cfg, EngineConfig(schedule, placement=placement), params=params,
                        device="cuda:0")


@pytest.mark.cuda
def test_data2_engine_on_one_card_runs_k1_per_shard_bit_equal(cuda):
    """``Placement.data(2)`` over cuda:0 twice: every row program equals the
    single placement's bit for bit, one captured graph per shard, and K1
    runs 2 x depth x T times per request (once per shard's rows)."""
    from repro_torch.engine import Placement
    from repro_torch.kernels.ops import reset_launch_counts

    two = _multi_engine(Placement.data(2, devices=("cuda:0", "cuda:0")))
    one = two.with_placement(Placement.single())
    series = torch.randn(64, 16, 32, generator=torch.Generator().manual_seed(1))
    lengths = torch.randint(1, 17, (64,), generator=torch.Generator().manual_seed(2))
    for name, batch in (("score", {"series": series}), ("reconstruct", {"series": series}),
                        ("score_masked", {"series": series, "lengths": lengths})):
        want = getattr(one, name)(batch)
        getattr(two, name)(batch)                       # the captures
        reset_launch_counts()
        got = getattr(two, name)(batch)
        torch.cuda.synchronize()
        assert launch_counts()["lstm_cell"] == 2 * 6 * 16
        assert torch.equal(got, want), name
    per = two.profile_info()["per_program"]
    assert per["score@shard0"]["compiles"] == per["score@shard1"]["compiles"] == 1
    assert "score" not in per
    state = one.init_stream_state(64)
    ys = [e.stream_masked(series[:, 0], state, torch.arange(64) % 3 > 0) for e in (one, two)]
    assert all(torch.allclose(a, b, rtol=1e-6, atol=1e-7)
               for a, b in zip(tree_leaves(ys[0]), tree_leaves(ys[1])))


@pytest.mark.cuda
def test_data2_bind_after_capture_refreshes_every_shard(cuda):
    from repro_torch.engine import Placement

    two = _multi_engine(Placement.data(2, devices=("cuda:0", "cuda:0")))
    series = torch.randn(8, 5, 32, generator=torch.Generator().manual_seed(3))
    two.score({"series": series})
    other = init_lstm_ae(torch.Generator().manual_seed(9), get_config("lstm-ae-f32-d6"), "cuda")
    two.bind(other)
    fresh = build_engine(get_config("lstm-ae-f32-d6"), "fused", params=other, device="cuda:0")
    assert torch.equal(two.score({"series": series}), fresh.score({"series": series}))
    assert two.profile_info()["per_program"]["score@shard1"]["compiles"] == 1   # in place


@pytest.mark.cuda
def test_data2_gateway_on_one_card(cuda):
    from repro_torch.engine import AnomalyService, Placement

    svc = AnomalyService("lstm-ae-f32-d2", schedule="fused", device="cuda")
    gws = svc.open_gateway(capacity=8, max_batch=8,
                           placement=Placement.data(2, devices=("cuda:0", "cuda:0")))
    gwu = svc.open_gateway(capacity=8, max_batch=8)
    rng = np.random.default_rng(4)
    data = rng.standard_normal((8, 6, 32)).astype(np.float32)
    for i in range(8):
        gws.admit(i), gwu.admit(i)
    assert gws.pool.per_device_active() == [4, 4]
    for t in range(6):
        rs, ru = gws.step({i: data[i, t] for i in range(8)}), gwu.step({i: data[i, t] for i in range(8)})
        for i in range(8):
            assert rs[i] == pytest.approx(ru[i], rel=1e-6, abs=1e-7)
    assert gws.pool.captures == 2
    windows = [data[i, : 3 + i % 4] for i in range(8)]
    np.testing.assert_array_equal(gws.score(windows), gwu.score(windows))
    assert len(gws.stats()["gauge_vecs"]["queue.device_fill"]) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_pipeline_on_one_card_matches_sequential(cuda, shape, monkeypatch):
    """The stage pipeline over cuda:0 with a stream per cell agrees with
    ``sequential``, and its FIFO holds exactly one step on the card too."""
    from repro_torch.core import temporal as tt
    from repro_torch.core.lstm import lstm_ae_sequential
    from repro_torch.launch.mesh import make_host_mesh

    seen: dict = {}
    real = tt._stage_step

    def record(s, k, layers, cur, h, c, pwl, in_max, h_max):
        inp = cur.clone()
        out = real(s, k, layers, cur, h, c, pwl, in_max, h_max)
        seen[(s, k)] = (inp, out.clone())
        return out

    monkeypatch.setattr(tt, "_stage_step", record)
    cfg = get_config("lstm-ae-f32-d6")
    params = init_lstm_ae(torch.Generator().manual_seed(5), cfg, "cuda")
    xs = torch.randn(11, 64, 32, generator=torch.Generator().manual_seed(6)).cuda()
    mesh = make_host_mesh(shape, ("data", "model"), devices=("cuda:0",) * (shape[0] * shape[1]))
    sp, counts, _ = tt.build_stage_params(params, cfg, shape[1])
    ys = tt.pipelined_forward(sp, counts, xs, mesh=mesh, cfg=cfg)
    torch.testing.assert_close(ys, lstm_ae_sequential(params, xs), rtol=1e-4, atol=1e-5)
    torch.cuda.synchronize()
    if shape[0] == 1:
        for (s, k), (inp, _) in seen.items():
            if s > 0:
                assert torch.equal(inp, seen[(s - 1, k - 1)][1]), (s, k)


@pytest.mark.cuda
def test_pipelined_engine_on_one_card(cuda):
    from repro_torch.core.lstm import lstm_ae_sequential
    from repro_torch.engine import EngineConfig, Placement

    cfg = get_config("lstm-ae-f32-d6")
    params = init_lstm_ae(torch.Generator().manual_seed(7), cfg, "cuda")
    series = torch.randn(8, 9, 32, generator=torch.Generator().manual_seed(8)).cuda()
    want = lstm_ae_sequential(params, series.transpose(0, 1)).transpose(0, 1)
    for pl in (Placement(devices=("cuda:0",) * 2), Placement.data(2, devices=("cuda:0",) * 4)):
        e = build_engine(cfg, EngineConfig("pipelined", n_stages=2, placement=pl), params=params,
                         device="cuda:0")
        assert e.schedule.tag == "pipelined"
        torch.testing.assert_close(e.reconstruct({"series": series}), want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_data2_over_two_gpus(cuda):
    """Without ``devices=``, ``Placement.data(2)`` takes cuda:0 and cuda:1
    (bit-equal to one GPU), and the (1, 2) pipeline runs across them with a
    peer copy as its FIFO hop; with one GPU the placement raises."""
    from repro_torch.core import temporal as tt
    from repro_torch.core.lstm import lstm_ae_sequential
    from repro_torch.engine import Placement
    from repro_torch.launch.mesh import make_host_mesh

    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="1 GPU\\(s\\) are visible; pass devices="):
            _multi_engine(Placement.data(2))
        pytest.skip(f"needs two GPUs; {torch.cuda.device_count()} visible")
    two = _multi_engine(Placement.data(2))
    assert two.shard_devices == [torch.device("cuda:0"), torch.device("cuda:1")]
    series = torch.randn(16, 7, 32, generator=torch.Generator().manual_seed(9))
    one = two.with_placement(Placement.single())
    assert torch.equal(two.score({"series": series}), one.score({"series": series}))
    cfg = get_config("lstm-ae-f32-d6")
    params = init_lstm_ae(torch.Generator().manual_seed(10), cfg, "cuda")
    xs = torch.randn(9, 6, 32, generator=torch.Generator().manual_seed(11)).cuda()
    sp, counts, _ = tt.build_stage_params(params, cfg, 2)
    ys = tt.pipelined_forward(sp, counts, xs, mesh=make_host_mesh((1, 2), ("data", "model")),
                              cfg=cfg)
    torch.testing.assert_close(ys, lstm_ae_sequential(params, xs), rtol=1e-4, atol=1e-5)


# -- the Engine's per-call params and the LM's captured decode step --------

WITH_FORMS = ("reconstruct", "score", "score_masked", "stream", "stream_masked")
WITH_PROGRAM = {"reconstruct": "reconstruct", "score": "score", "score_masked": "score_masked",
                "stream": "step", "stream_masked": "mstep"}


def _with_call(engine, form, params, series):
    """``engine.<form>`` (params None) or ``engine.<form>_with(params, ...)``,
    outputs flattened."""
    b = series.shape[0]
    if form in ("stream", "stream_masked"):
        args = (series[:, 0], engine.init_stream_state(b))
        if form == "stream_masked":
            args += (torch.arange(b) % 2 == 0,)
    else:
        batch = {"series": series}
        if form == "score_masked":
            batch["lengths"] = torch.arange(b, dtype=torch.int32) % series.shape[1]
        args = (batch,)
    out = getattr(engine, form)(*args) if params is None else \
        getattr(engine, f"{form}_with")(params, *args)
    return tree_leaves(out)


@pytest.mark.cuda
@pytest.mark.parametrize("form", WITH_FORMS)
def test_with_forms_captured_leave_bound_programs(cuda, form):
    """Each ``*_with`` is a captured program of its own, bit-equal to an
    engine bound to those params; it neither recaptures nor changes the
    bound program, whose next call is bit-equal to its first."""
    cfg = get_config("lstm-ae-f32-d6")
    p1 = init_lstm_ae(torch.Generator().manual_seed(0), cfg, "cuda")
    p2 = init_lstm_ae(torch.Generator().manual_seed(1), cfg, "cuda")
    engine = build_engine(cfg, "fused", params=p1, device=cuda)
    other = build_engine(cfg, "fused", params=p2, device=cuda)
    series = torch.randn(8, 7, 32, generator=torch.Generator().manual_seed(2))
    before = _with_call(engine, form, None, series)
    (bound_key,) = engine._graphs.programs
    bound_prog = engine._graphs.programs[bound_key]
    for call in range(2):
        got = _with_call(engine, form, p2, series)
        assert all(torch.equal(g, w) for g, w in zip(got, _with_call(other, form, None, series)))
    names = [key[0] for key in engine._graphs.programs]
    assert names == [WITH_PROGRAM[form], f"{WITH_PROGRAM[form]}_with"]
    assert engine._graphs.programs[bound_key] is bound_prog and engine._graphs.captures == 2
    after = _with_call(engine, form, None, series)
    assert all(torch.equal(a, b) for a, b in zip(after, before)) and engine._graphs.captures == 2


@pytest.mark.cuda
@pytest.mark.parametrize("form", WITH_FORMS)
def test_with_forms_data2_on_one_card(cuda, form):
    """``*_with`` under ``Placement.data(2)`` over cuda:0 twice: captured
    per shard, bit-equal to the single placement's."""
    from repro_torch.engine import Placement

    two = _multi_engine(Placement.data(2, devices=("cuda:0",) * 2))
    one = two.with_placement(Placement.single())
    p2 = init_lstm_ae(torch.Generator().manual_seed(5), two.cfg, "cuda")
    series = torch.randn(8, 7, 32, generator=torch.Generator().manual_seed(6))
    for call in range(2):
        got = _with_call(two, form, p2, series)
        assert all(torch.equal(g, w) for g, w in zip(got, _with_call(one, form, p2, series)))
    for shard in two._shards:
        assert [key[0] for key in shard.graphs.programs] == \
            [f"{WITH_PROGRAM[form]}_with@shard{shard.index}"]
        assert shard.graphs.captures == 1 and shard.graphs.replays == 1


@pytest.mark.cuda
@pytest.mark.parametrize("decode_loop", ["scan", "unroll"])
def test_captured_greedy_decode_equals_eager(cuda, decode_loop):
    """The LM's decode step captured once and replayed per token gives the
    eager loop's tokens, last logits and cache bit for bit; a second loop
    at the same signature replays without a recapture."""
    from repro_torch.config import reduced_config
    from repro_torch.models import build_model
    from repro_torch.serving import GreedyDecoder, stitch_prefill_cache

    api = build_model(reduced_config("tinyllama-1.1b").with_overrides(decode_loop=decode_loop))
    params = api.init(torch.Generator(cuda).manual_seed(0), device=cuda)
    toks = torch.randint(0, api.cfg.vocab_size, (3, 9), generator=torch.Generator(cuda).manual_seed(1),
                         device=cuda, dtype=torch.int32)
    logits, pre = api.prefill(params, {"tokens": toks})
    first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    eager = GreedyDecoder(api, jit=False)
    captured = GreedyDecoder(api)
    want, want_cache = eager(params, stitch_prefill_cache(api, pre, 9 + 6), first, 9, 6)
    for call in range(2):
        got, got_cache = captured(params, stitch_prefill_cache(api, pre, 9 + 6), first, 9, 6)
        assert torch.equal(got, want) and torch.equal(captured.logits, eager.logits)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got_cache),
                                                     tree_leaves(want_cache)))
    assert captured.captures == 1 and captured.replays == 2 * 6 - 1
    assert eager.captures == 0



# -- LM training on the card -------------------------------------------------

LM_TRAIN_F32 = dict(rtol=1e-4, atol=1e-5)   # tests/test_torch_lm_training.py's f32 bar
LM_TRAIN_BF16_LOSS = 6e-2
LM_TRAIN_BF16_GRAD_REL = 5e-2               # relative Frobenius error per grad leaf


def _lm_value_and_grad(api, params, batch, **kw):
    """(loss, grads in tree_leaves order) of ``api.loss``."""
    from repro_torch.utils import tree_map

    leaves = []
    tracked = tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
    tree_map(leaves.append, tracked)
    loss, _ = api.loss(tracked, batch, **kw)
    grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return loss.detach(), [grads[id(p)] for p in tree_leaves(tracked)]


def _lm_setup(arch, dtype, device, b=2, s=12):
    from repro_torch.config import reduced_config
    from repro_torch.data import LMDataConfig, make_lm_batch
    from repro_torch.models import build_model
    from repro_torch.utils import tree_map

    api = build_model(reduced_config(arch).with_overrides(compute_dtype=dtype))
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    batch = make_lm_batch(LMDataConfig(vocab_size=api.cfg.vocab_size, seq_len=s,
                                       global_batch=b), 0)
    batch["labels"][:, -2:] = -1
    if api.cfg.frontend == "vision_stub":
        batch["image_embeds"] = torch.randn(b, api.cfg.vision_patches, api.cfg.d_model,
                                            generator=torch.Generator().manual_seed(1))
    if api.cfg.family == "whisper":
        batch["frames"] = torch.randn(b, api.cfg.encoder_seq_len, api.cfg.d_model,
                                      generator=torch.Generator().manual_seed(1))
    on = tree_map(lambda t: t.to(device), params), {k: v.to(device) for k, v in batch.items()}
    return api, (params, batch), on


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmo-1b", "phi-3-vision-4.2b"])
def test_lm_train_loss_card_matches_cpu(cuda, arch, dtype):
    """``train_loss`` and every grad leaf on the card against the CPU (TF32
    off): f32 at the CPU parity bar, bf16 the loss at 6e-2 and each grad
    leaf by relative Frobenius error; olmo-1b ties its table."""
    api, cpu, card = _lm_setup(arch, dtype, cuda)
    want, wgrads = _lm_value_and_grad(api, *cpu, loss_chunk=5)
    got, ggrads = _lm_value_and_grad(api, *card, loss_chunk=5)
    if dtype == "float32":
        torch.testing.assert_close(got.cpu(), want, **LM_TRAIN_F32)
        for g, w in zip(ggrads, wgrads):
            torch.testing.assert_close(g.cpu(), w, **LM_TRAIN_F32)
    else:
        torch.testing.assert_close(got.cpu(), want, rtol=LM_TRAIN_BF16_LOSS,
                                   atol=LM_TRAIN_BF16_LOSS)
        errs = [float(torch.linalg.vector_norm(g.cpu() - w) / torch.linalg.vector_norm(w))
                for g, w in zip(ggrads, wgrads)]
        assert max(errs) < LM_TRAIN_BF16_GRAD_REL, errs


@pytest.mark.cuda
def test_lm_remat_on_card(cuda):
    """Per-layer recompute on the card: the same loss bit for bit, the
    grads within 1e-5 relative (the table's gather backward accumulates
    in an order of its own)."""
    api, _, card = _lm_setup("tinyllama-1.1b", "bfloat16", cuda)
    lr, gr = _lm_value_and_grad(api, *card, remat=True, loss_chunk=5)
    ln, gn = _lm_value_and_grad(api, *card, remat=False, loss_chunk=5)
    assert torch.equal(lr, ln)
    for a, b in zip(gr, gn):
        assert float(torch.linalg.vector_norm(a - b)) <= 1e-5 * float(torch.linalg.vector_norm(b))


@pytest.mark.cuda
@pytest.mark.parametrize("form", [{}, {"microbatch": 2}, {"grad_compression": "int8_ef"}])
def test_lm_train_step_card_matches_cpu(cuda, form):
    """One AdamW step of the reduced tinyllama in f32 (plain, microbatched,
    int8_ef) on the card against the CPU: metrics at rtol 1e-5, params at
    atol 1e-6 except where the CPU's |g| is below 100 eps (AdamW's first
    update g/(|g|+eps) turns on the grads' last bits there: one update,
    2 lr) or an int8 level flipped (at most 0.1% of the elements)."""
    from repro_torch.config import TrainConfig
    from repro_torch.training import build_train_step, init_train_state

    tc = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10, loss_chunk=8, **form)
    api, cpu, card = _lm_setup("tinyllama-1.1b", "float32", cuda, b=4, s=16)
    step = build_train_step(api, tc)
    want, wm = step(init_train_state(cpu[0], tc), cpu[1])
    got, gm = step(init_train_state(card[0], tc), card[1])
    for k in ("loss", "grad_norm", "lr"):
        torch.testing.assert_close(gm[k].cpu(), wm[k], rtol=1e-5, atol=0)
    lr = float(wm["lr"])
    flips = ([(e.cpu() - w).abs() > 1e-7 for e, w in zip(tree_leaves(got.ef), tree_leaves(want.ef))]
             if want.ef is not None else None)
    if flips is not None:
        assert sum(int(f.sum()) for f in flips) <= 1e-3 * sum(f.numel() for f in flips)
    for n, (p, w, mu) in enumerate(zip(tree_leaves(got.params), tree_leaves(want.params),
                                       tree_leaves(want.opt.mu))):
        diff = (p.cpu() - w).abs()
        tiny = mu.abs() / (1 - tc.beta1) < 1e-6
        if flips is not None:
            tiny = tiny | flips[n]
        assert _max0(diff[~tiny]) <= 1e-6 and _max0(diff[tiny]) <= 2 * lr


def _max0(t) -> float:
    return float(t.max()) if t.numel() else 0.0


# -- the MoE transformer on the card -----------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "dbrx-132b"])
def test_moe_model_card_matches_cpu(cuda, arch):
    """The reduced MoE model in f32 compute (TF32 off) on the card against
    the CPU: prefill logits at 1e-4 and the same greedy token, then
    ``train_loss`` and every grad leaf at the CPU parity bar.  The router
    takes its product in f64, so the card routes as the CPU does."""
    api, cpu, card = _lm_setup(arch, "float32", cuda)
    want, _ = api.prefill(cpu[0], {"tokens": cpu[1]["tokens"]})
    got, _ = api.prefill(card[0], {"tokens": card[1]["tokens"]})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got[:, -1].argmax(-1).cpu(), want[:, -1].argmax(-1))
    wloss, wgrads = _lm_value_and_grad(api, *cpu, loss_chunk=5)
    gloss, ggrads = _lm_value_and_grad(api, *card, loss_chunk=5)
    torch.testing.assert_close(gloss.cpu(), wloss, **LM_TRAIN_F32)
    for g, w in zip(ggrads, wgrads):
        torch.testing.assert_close(g.cpu(), w, **LM_TRAIN_F32)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "dbrx-132b"])
def test_moe_captured_greedy_decode_equals_eager(cuda, arch):
    """The MoE decode step (routing, capacity, dispatch and combine of the
    B decode tokens) captured once and replayed per token gives the eager
    loop's tokens, last logits and cache bit for bit: nothing in the MoE
    layer syncs with the host."""
    from repro_torch.config import reduced_config
    from repro_torch.models import build_model
    from repro_torch.serving import GreedyDecoder, stitch_prefill_cache

    api = build_model(reduced_config(arch))
    params = api.init(torch.Generator(cuda).manual_seed(0), device=cuda)
    toks = torch.randint(0, api.cfg.vocab_size, (3, 9), generator=torch.Generator(cuda).manual_seed(1),
                         device=cuda, dtype=torch.int32)
    logits, pre = api.prefill(params, {"tokens": toks})
    first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    eager = GreedyDecoder(api, jit=False)
    captured = GreedyDecoder(api)
    want, want_cache = eager(params, stitch_prefill_cache(api, pre, 9 + 6), first, 9, 6)
    for call in range(2):
        got, got_cache = captured(params, stitch_prefill_cache(api, pre, 9 + 6), first, 9, 6)
        assert torch.equal(got, want) and torch.equal(captured.logits, eager.logits)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got_cache),
                                                     tree_leaves(want_cache)))
    assert captured.captures == 1 and captured.replays == 2 * 6 - 1


# -- RWKV-6 on the card: its WKV runs through K3 -------------------------------

def _k3_launches() -> int:
    return launch_counts()["wkv6"]


@pytest.mark.cuda
def test_rwkv_model_card_matches_cpu_with_k3_counted(cuda):
    """The reduced rwkv6-7b in f32 (TF32 off) on the card against the CPU,
    at S=70 (past one 64-step chunk): the time-mix layer, the prefill's
    logits and state, one decode step, ``train_loss`` and every grad leaf
    at the CPU parity bar.  K3 launches once a layer per forward (once
    more in the recompute) and ceil(70 / 64) - 1 = 1 a layer in the
    backward; the CPU runs its plain version and launches nothing."""
    from repro_torch.layers import rwkv as trwkv
    from repro_torch.models.transformer import _unstack

    api, cpu, card = _lm_setup("rwkv6-7b", "float32", cuda, s=70)
    nl = api.cfg.num_layers
    x = torch.randn(2, 70, api.cfg.d_model, generator=torch.Generator().manual_seed(2))
    tm_cpu, tm_card = (_unstack(p["layers"], nl)[0]["tm"] for p in (cpu[0], card[0]))
    before = _k3_launches()
    want, (_, wst) = trwkv.apply_time_mix(tm_cpu, x, api.cfg)
    got, (_, gst) = trwkv.apply_time_mix(tm_card, x.to(cuda), api.cfg)
    assert _k3_launches() == before + 1
    torch.testing.assert_close(got.cpu(), want, **LM_TRAIN_F32)
    torch.testing.assert_close(gst.cpu(), wst, **LM_TRAIN_F32)

    before = _k3_launches()
    want, wstate = api.prefill(cpu[0], {"tokens": cpu[1]["tokens"]})
    got, gstate = api.prefill(card[0], {"tokens": card[1]["tokens"]})
    assert _k3_launches() == before + nl
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for name in wstate:
        torch.testing.assert_close(gstate[name].cpu(), wstate[name], rtol=1e-4, atol=1e-4)
    token = cpu[1]["tokens"][:, :1]
    want, _ = api.decode(cpu[0], token, wstate, torch.tensor(70))
    got, _ = api.decode(card[0], token.to(cuda), gstate, torch.tensor(70, device=cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)

    before = _k3_launches()
    wloss, wgrads = _lm_value_and_grad(api, *cpu, loss_chunk=32)
    gloss, ggrads = _lm_value_and_grad(api, *card, loss_chunk=32)
    assert _k3_launches() == before + nl * (1 + 1 + 1)
    torch.testing.assert_close(gloss.cpu(), wloss, **LM_TRAIN_F32)
    for g, w in zip(ggrads, wgrads):
        torch.testing.assert_close(g.cpu(), w, **LM_TRAIN_F32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 64])
def test_rwkv_wkv6_backward_card_matches_cpu(cuda, hd, dtype):
    """``WKV6``'s grads of every input on the card (K3 forward, the chunk
    states rebuilt by K3, each chunk's adjoint in plain torch) against the
    CPU's (the plain version throughout), at T=150: 1 + 2 K3 launches."""
    from repro_torch.layers import rwkv as trwkv

    args = [t.cpu() for t in _wkv6_inputs(2, 150, 3, hd, dtype, seed=hd, rwkv_decay=True)]
    g = torch.Generator().manual_seed(hd + 1)
    dy, ds = torch.randn(2, 150, 3, hd, generator=g), torch.randn(2, 3, hd, hd, generator=g)
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).requires_grad_() for t in args]
        before = _k3_launches()
        y, s = trwkv.wkv_scan(*leaves)
        grads[str(dev)] = torch.autograd.grad(
            torch.sum(y * dy.to(dev)) + torch.sum(s * ds.to(dev)), leaves)
        assert _k3_launches() == before + (0 if dev == "cpu" else 3)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    for got, want in zip(grads[str(cuda)], grads["cpu"]):
        assert got.dtype == want.dtype
        torch.testing.assert_close(got.cpu().float(), want.float(), **tol)


@pytest.mark.cuda
def test_rwkv_captured_greedy_decode_equals_eager(cuda):
    """The RWKV decode step (K3 at T=1 in each layer, the new state written
    in place into the capture's buffers) captured once and replayed per token
    gives the eager loop's tokens, last logits and final state bit for bit:
    nothing in the step syncs with the host."""
    from repro_torch.config import reduced_config
    from repro_torch.models import build_model
    from repro_torch.serving import GreedyDecoder, stitch_prefill_cache
    from repro_torch.utils import tree_map

    api = build_model(reduced_config("rwkv6-7b"))
    params = api.init(torch.Generator(cuda).manual_seed(0), device=cuda)
    toks = torch.randint(0, api.cfg.vocab_size, (3, 9), generator=torch.Generator(cuda).manual_seed(1),
                         device=cuda, dtype=torch.int32)
    logits, pre = api.prefill(params, {"tokens": toks})
    first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    eager = GreedyDecoder(api, jit=False)
    captured = GreedyDecoder(api)
    want, want_state = eager(params, stitch_prefill_cache(api, tree_map(torch.clone, pre), 0),
                             first, 9, 6)
    for call in range(2):
        before = _k3_launches()
        got, got_state = captured(params, stitch_prefill_cache(api, tree_map(torch.clone, pre), 0),
                                  first, 9, 6)
        assert _k3_launches() == before + 6 * api.cfg.num_layers
        assert torch.equal(got, want) and torch.equal(captured.logits, eager.logits)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got_state),
                                                     tree_leaves(want_state)))
    assert captured.captures == 1 and captured.replays == 2 * 6 - 1


@pytest.mark.cuda
def test_rwkv_head_dim_outside_k3_raises(cuda):
    """A head dim K3 does not take raises on the card, naming the dims it
    takes; nothing falls back to the plain version (the CPU runs it)."""
    import dataclasses

    from repro_torch.config import reduced_config
    from repro_torch.layers import rwkv as trwkv

    cfg = reduced_config("rwkv6-7b")
    cfg = cfg.with_overrides(rwkv=dataclasses.replace(cfg.rwkv, head_dim=8))
    params = trwkv.init_time_mix(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator().manual_seed(1))
    trwkv.apply_time_mix(params, x, cfg)
    with pytest.raises(ValueError, match=r"head dims \(16, 32, 64\)"):
        trwkv.apply_time_mix({k: (v.to(cuda) if isinstance(v, torch.Tensor) else
                                  {n: t.to(cuda) for n, t in v.items()}) for k, v in params.items()},
                             x.to(cuda), cfg)


# -- Jamba on the card: Mamba's scan is plain torch, no kernel of K1-K4 --------

@pytest.mark.cuda
def test_jamba_model_card_matches_cpu(cuda):
    """The reduced jamba-v0.1-52b in f32 (TF32 off) on the card against the
    CPU: prefill logits and every state at 1e-4, one decode step from each
    side's stitched prefill states (logits and every state written), then
    ``train_loss`` and every grad leaf at the CPU parity bar; no K1-K4
    launch (the reference's Jamba reaches no Pallas kernel)."""

    api, cpu, card = _lm_setup("jamba-v0.1-52b", "float32", cuda)
    before = dict(launch_counts())
    want, wst = api.prefill(cpu[0], {"tokens": cpu[1]["tokens"]})
    got, gst = api.prefill(card[0], {"tokens": card[1]["tokens"]})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for g, w in zip(tree_leaves(gst), tree_leaves(wst)):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)
    s = cpu[1]["tokens"].shape[1]
    wst, gst = api.stitch(wst, s + 1), api.stitch(gst, s + 1)
    token = cpu[1]["tokens"][:, :1]
    want, _ = api.decode(cpu[0], token, wst, torch.tensor(s))
    got, _ = api.decode(card[0], token.to(cuda), gst, torch.tensor(s, device=cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for g, w in zip(tree_leaves(gst), tree_leaves(wst)):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)
    wloss, wgrads = _lm_value_and_grad(api, *cpu, loss_chunk=5)
    gloss, ggrads = _lm_value_and_grad(api, *card, loss_chunk=5)
    torch.testing.assert_close(gloss.cpu(), wloss, **LM_TRAIN_F32)
    for g, w in zip(ggrads, wgrads):
        torch.testing.assert_close(g.cpu(), w, **LM_TRAIN_F32)
    assert dict(launch_counts()) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_jamba_mamba_layer_card_matches_cpu(cuda, dtype):
    """One Mamba layer of the reduced config on the card against the CPU
    over S=300 (two scan chunks, the second short) from a carried state:
    y and both states (f32 at the CPU parity bar, bf16 at 6e-2), and in
    f32 the grads of every param and of x through the step-by-step scan."""
    from repro_torch.config import reduced_config
    from repro_torch.layers import mamba as tm

    cfg = reduced_config("jamba-v0.1-52b")
    params = tm.init_mamba(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 300, cfg.d_model, generator=g).to(dtype)
    state = tm.init_mamba_state(cfg, 2, dtype)
    state = {"ssm": torch.randn(state["ssm"].shape, generator=g) * 0.5,
             "conv": torch.randn(state["conv"].shape, generator=g).to(dtype)}
    tol = LM_TRAIN_F32 if dtype == torch.float32 else dict(rtol=6e-2, atol=6e-2)
    runs = {}
    for dev in ("cpu", cuda):
        p = {k: ({n: t.to(dev).requires_grad_() for n, t in v.items()} if isinstance(v, dict)
                 else v.to(dev).requires_grad_()) for k, v in params.items()}
        xd = x.to(dev).requires_grad_(dtype == torch.float32)
        y, st = tm.apply_mamba(p, xd, cfg, {k: v.to(dev) for k, v in state.items()})
        grads = None
        if dtype == torch.float32:
            leaves = tree_leaves(p) + [xd]
            grads = torch.autograd.grad(y.square().sum(), leaves)
        runs[str(dev)] = (y.detach(), {k: v.detach() for k, v in st.items()}, grads)
    (gy, gst, gg), (wy, wst, wg) = runs[str(cuda)], runs["cpu"]
    torch.testing.assert_close(gy.cpu().float(), wy.float(), **tol)
    for name in ("ssm", "conv"):
        assert gst[name].dtype == wst[name].dtype
        torch.testing.assert_close(gst[name].cpu().float(), wst[name].float(), **tol)
    if gg is not None:
        for a, b in zip(gg, wg):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_jamba_captured_greedy_decode_equals_eager(cuda):
    """The Jamba decode step (the KV cache written at the position, the
    Mamba states written in place, the MoE layers' routing of the B decode
    tokens) captured once and replayed per token gives the eager loop's
    tokens, last logits and states bit for bit: nothing syncs with the
    host."""
    from repro_torch.config import reduced_config
    from repro_torch.models import build_model
    from repro_torch.serving import GreedyDecoder, stitch_prefill_cache
    from repro_torch.utils import tree_map

    api = build_model(reduced_config("jamba-v0.1-52b"))
    params = api.init(torch.Generator(cuda).manual_seed(0), device=cuda)
    toks = torch.randint(0, api.cfg.vocab_size, (3, 9), generator=torch.Generator(cuda).manual_seed(1),
                         device=cuda, dtype=torch.int32)
    logits, pre = api.prefill(params, {"tokens": toks})
    first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    eager = GreedyDecoder(api, jit=False)
    captured = GreedyDecoder(api)
    want, want_states = eager(params, stitch_prefill_cache(api, tree_map(torch.clone, pre), 15),
                              first, 9, 6)
    before = dict(launch_counts())
    for call in range(2):
        got, got_states = captured(params, stitch_prefill_cache(api, tree_map(torch.clone, pre), 15),
                                   first, 9, 6)
        assert torch.equal(got, want) and torch.equal(captured.logits, eager.logits)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got_states),
                                                     tree_leaves(want_states)))
    assert captured.captures == 1 and captured.replays == 2 * 6 - 1
    assert dict(launch_counts()) == before


# -- Whisper on the card: attention through the blocked softmax, no kernel of K1-K4

def _whisper_prompt(batch):
    return {"tokens": batch["tokens"], "frames": batch["frames"]}


@pytest.mark.cuda
def test_whisper_model_card_matches_cpu(cuda):
    """The reduced whisper-large-v3 in f32 (TF32 off) on the card against
    the CPU: prefill logits and the cache (``k``, ``v``, ``ck``, ``cv``) at
    1e-4, one decode step from each side's stitched cache (logits and every
    leaf; ``ck``/``cv`` unwritten), then ``train_loss`` and every grad leaf
    at the CPU parity bar; no K1-K4 launch (the reference's Whisper
    reaches no Pallas kernel)."""
    api, cpu, card = _lm_setup("whisper-large-v3", "float32", cuda)
    before = dict(launch_counts())
    want, wc = api.prefill(cpu[0], _whisper_prompt(cpu[1]))
    got, gc = api.prefill(card[0], _whisper_prompt(card[1]))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for name in wc:
        torch.testing.assert_close(gc[name].cpu(), wc[name], rtol=1e-4, atol=1e-4)
    s = cpu[1]["tokens"].shape[1]
    wc, gc = api.stitch(wc, s + 1), api.stitch(gc, s + 1)
    cross = {n: gc[n].clone() for n in ("ck", "cv")}
    token = cpu[1]["tokens"][:, :1]
    want, _ = api.decode(cpu[0], token, wc, torch.tensor(s))
    got, _ = api.decode(card[0], token.to(cuda), gc, torch.tensor(s, device=cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for name in wc:
        torch.testing.assert_close(gc[name].cpu(), wc[name], rtol=1e-4, atol=1e-4)
    assert all(torch.equal(gc[n], cross[n]) for n in cross)
    wloss, wgrads = _lm_value_and_grad(api, *cpu, loss_chunk=5)
    gloss, ggrads = _lm_value_and_grad(api, *card, loss_chunk=5)
    torch.testing.assert_close(gloss.cpu(), wloss, **LM_TRAIN_F32)
    for g, w in zip(ggrads, wgrads):
        torch.testing.assert_close(g.cpu(), w, **LM_TRAIN_F32)
    assert dict(launch_counts()) == before


@pytest.mark.cuda
def test_whisper_bf16_card_no_farther_than_cpu(cuda):
    """The reduced whisper-large-v3 in bf16 on the card: its prefill logits
    lie no farther (+6e-2) from the CPU's f32 logits than the CPU's own
    bf16 logits do, and the loss is within 6e-2 of the CPU's bf16 loss."""
    api32, cpu, _ = _lm_setup("whisper-large-v3", "float32", cuda)
    api, _, card = _lm_setup("whisper-large-v3", "bfloat16", cuda)
    ref32, _ = api32.prefill(cpu[0], _whisper_prompt(cpu[1]))
    ref16, _ = api.prefill(cpu[0], _whisper_prompt(cpu[1]))
    got, _ = api.prefill(card[0], _whisper_prompt(card[1]))
    mine = float((got.float().cpu() - ref32).abs().max())
    theirs = float((ref16.float() - ref32).abs().max())
    assert mine <= theirs + 6e-2, (mine, theirs)
    wloss, _ = api.loss(cpu[0], cpu[1], loss_chunk=5)
    gloss, _ = api.loss(card[0], card[1], loss_chunk=5)
    torch.testing.assert_close(gloss.cpu(), wloss, rtol=6e-2, atol=6e-2)


@pytest.mark.cuda
def test_whisper_captured_greedy_decode_equals_eager(cuda):
    """The Whisper decode step (the self-KV written at the position, the
    cross-KV only read with the cross mask's length a Python int, ``dec_pos``
    read on the device) captured once and replayed per token gives the
    eager loop's tokens, last logits and cache bit for bit: nothing syncs
    with the host or copies from it."""
    from repro_torch.config import reduced_config
    from repro_torch.models import build_model
    from repro_torch.serving import GreedyDecoder, stitch_prefill_cache
    from repro_torch.utils import tree_map

    api = build_model(reduced_config("whisper-large-v3"))
    params = api.init(torch.Generator(cuda).manual_seed(0), device=cuda)
    g = torch.Generator(cuda).manual_seed(1)
    toks = torch.randint(0, api.cfg.vocab_size, (3, 9), generator=g, device=cuda,
                         dtype=torch.int32)
    frames = torch.randn(3, api.cfg.encoder_seq_len, api.cfg.d_model, generator=g, device=cuda)
    logits, pre = api.prefill(params, {"tokens": toks, "frames": frames})
    first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    eager = GreedyDecoder(api, jit=False)
    captured = GreedyDecoder(api)
    want, want_cache = eager(params, stitch_prefill_cache(api, tree_map(torch.clone, pre), 15),
                             first, 9, 6)
    before = dict(launch_counts())
    for call in range(2):
        got, got_cache = captured(params, stitch_prefill_cache(api, tree_map(torch.clone, pre), 15),
                                  first, 9, 6)
        assert torch.equal(got, want) and torch.equal(captured.logits, eager.logits)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got_cache),
                                                     tree_leaves(want_cache)))
    assert torch.equal(want_cache["ck"], pre["ck"]) and torch.equal(want_cache["cv"], pre["cv"])
    assert captured.captures == 1 and captured.replays == 2 * 6 - 1
    assert dict(launch_counts()) == before


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "moonshot-v1-16b-a3b", "rwkv6-7b"])
def test_sharded_step_on_one_nccl_rank_equals_unsharded(cuda, tmp_path, arch):
    """Two train steps of the reduced LM (f32, TF32 off) on a (1, 1) mesh of
    one NCCL rank, the state placed by its specs, equal the unsharded steps
    at the one-step bar (moonshot through ``ep_a2a``'s expert-parallel
    body); rwkv6-7b's K3 runs under ``local_map``: per step and layer a
    forward, a recompute and ceil(70 / 64) - 1 = 1 in the backward, on the
    mesh as unsharded."""
    import dataclasses

    from test_torch_sharded_step import hold_one_rank_mesh_steps, steps_on_one_rank_mesh

    from repro_torch.config import TrainConfig, reduced_config
    from repro_torch.data import LMDataConfig, make_lm_batch
    from repro_torch.models import build_model

    cfg = reduced_config(arch).with_overrides(compute_dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, impl="ep_a2a"))
    api = build_model(cfg)
    params = api.init(torch.Generator(cuda).manual_seed(0), device=cuda)
    batches = [{k: v.to(cuda) for k, v in make_lm_batch(
        LMDataConfig(vocab_size=cfg.vocab_size, seq_len=70, global_batch=2), i).items()}
        for i in range(2)]
    before = _k3_launches()
    plain, meshed = steps_on_one_rank_mesh(
        api, TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4, loss_chunk=32),
        params, batches, tmp_path, device="cuda")
    hold_one_rank_mesh_steps(plain, meshed)
    k3 = 2 * 2 * cfg.num_layers * 3 if cfg.family == "rwkv6" else 0
    assert _k3_launches() == before + k3
