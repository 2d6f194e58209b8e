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
    assert gw.pool._state["h"][0].device == dev
