#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Run from the root of a checkout on a machine with a CUDA GPU and the CUDA
toolkit.  It

1. reports the card (name and power limit) and turns TF32 off;
2. builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. holds K1 (the fused LSTM cell) to its plain PyTorch version at every
   layer shape of the four paper configs and the kernel-test sweep, f32 and
   bf16, with and without the PWL activations, and times it at the shapes
   of the main path (B=8192) and of the gateway's flushes (B=256) beside its
   bound, the plain version and ``torch.lstm_cell``, naming each launch's tile;
4. drives the main path: ``AnomalyService("lstm-ae-f64-d6", schedule="fused")``
   at the ``serve_64`` shape (B=8192, T=64, F=64) — calibrate, then three
   scoring requests — and checks that K1 ran 3 x 6 x 64 times, that the
   scores agree with the ``sequential`` and ``wavefront`` schedules on the
   card and with the CPU path, and times each schedule; then the same at a
   smaller batch for ``lstm-ae-f32-d2``.  Each engine captures its
   programs into CUDA graphs (``engine/capture.py``); the fused path is
   also run eagerly (``EngineConfig(jit=False)``) in the same run, and the
   two are compared: ms per request from the host and with the input on
   the card, the K1 launches inside the graph (6 x 64), and the scores
   (within 1e-5 / 1e-6, and whether bit-equal); at the end of the run
   (11.) one ``torch.profiler`` pass per request each gives the launch
   calls the host makes and the device's busy time;
5. streams a few timesteps and checks them against batch scoring;
5a. trains: ``AnomalyService("lstm-ae-f64-d6", "fused").fit`` at the
   ``stream_64`` shape (B=4096, T=64, F=64) for 20 steps on the card (ms
   per step, the loss of every step; the first step's loss must fall on
   its batch by the last), after the same fit's first 3 steps were held
   against the port's CPU training from the same init and batches (loss
   rtol 1e-5, params atol 1e-5); then
   calibrates, and checks that the captured engine, captured before the
   fit, serves the fitted params without a recapture: its scores equal an
   eager engine's bound to ``svc.params``;
6. holds K2 (the sequence-streaming LSTM layer) to its plain version at
   every paper layer shape (B in 1, 37, 8192; T=64) and the sweep up to
   (128, 256) at a smaller B*T, f32 and bf16, PWL on and off — shapes whose
   weights stay in shared memory and shapes that read them from L2 — and
   times it per layer of lstm-ae-f64-d6 at B=8192, T=64 beside its bound,
   the plain version, a one-layer cuDNN LSTM and 64 x K1, with each layer's
   tile (rows per block and per thread) and achieved TFLOP/s;
7. drives K2's path, ``ops.lstm_seq_op``, layer by layer through
   lstm-ae-f64-d6 at B=8192, T=64 (6 launches) and checks the
   reconstruction against the fused schedule's;
8. drives the gateway: ``AnomalyService("lstm-ae-f64-d6", "fused")`` at full
   width, ``open_gateway(capacity=1024, max_batch=256)``: 2048 logical
   streams churned through the pool (16 sampled streams checked against
   solo ``stream_step``), then 512 one-shot windows of lengths 8-64, twice
   (each score checked against an eager engine's ``score_masked`` of the
   window alone, and K1's launches against 6 x bucket_T per flush).  The
   pool step and the flushes are captured programs: the churn must capture
   the pool step once and never again, the first one-shot pass captures
   one graph per bucket (6 x bucket_T K1 launches inside each) and the
   second only replays, and the pool step is timed captured and eager (a
   second gateway on an eager engine);
8a. drives that gateway over the socket transport: a ``GatewayServer`` on
   its own thread with durable sessions on a temporary store and a
   ``MetricsServer``.  512 windows of T=64 over bp1 in pipelined frames
   of 64 (the first pass captures the bucket on the server's thread) and
   over JSON lines, bit-equal to each other and within 1e-5 / 1e-6 of the
   same gateway's in-process ``gw.score`` (whether bit-equal is printed),
   and single-window requests from 16 connections (p50/p99 ms as the
   client sees them); 64 streaming sessions on 64 connections from 4
   threads (16 sampled against solo ``stream_step``), a ``snapshot`` op,
   half the connections dropped (parked), the server drained (the
   handoff snapshot) and a second server on the same store resuming every
   session by its token: the finished windows must be bit-equal to an
   uninterrupted in-process run, and the restores must cause no
   recapture; 16 tickets that only the drain can flush, all answered; one
   ``GET /metrics``.  K1's launches over the phase must be 6 x 64 per
   flush, and at the end of the run (11.) one flush over the socket under
   the profiler must show the device running 6 x 64 K1 kernels, after a
   profiled repeat of the bp1 pass that gives the device's idle share
   over it and its windows per flush;
9. holds K3 (the RWKV-6 WKV recurrence) to its plain version at the
   reference sweep, f32 and bf16, chunk chaining, and rwkv6-7b's heads
   (H=64, hd=64) at train_4k's T=4096, B=32, there also with decays drawn
   as the RWKV layer makes them (near 1); times it there in f32 beside
   its bound and the plain version, and alone at B in (8, 16, 32, 64) to
   show how the grid's size sets its rate, with its tile (rows x columns
   of S a thread, threads and heads a block, resident blocks per SM) and
   the share of its FP32 issue floor (three instructions per state
   element) it reaches; drives its path, ``ops.wkv6_op``, once whole and
   once as a chained pair (3 launches);
10. holds K4 (the flash-attention forward, causal mask top-left) to its
   plain version at the reference sweep, causal and not, f32 and bf16, at
   S != Sk both ways, ragged S and Sk, and phi4-mini-3.8b's heads (H=24,
   kv heads expanded, d=128) at S=Sk=4096, B=4, causal, at limits scaled
   to the small outputs of late rows; times it there per
   dtype beside its bound, the plain version and PyTorch's
   ``scaled_dot_product_attention`` (timed only: the port never calls it),
   with the achieved TFLOP/s, the kernel instantiation that served each
   dtype (bf16: ``mma.sync`` bf16; f32: 3xTF32 on ``mma.sync`` tf32, its
   bound 3 x the FLOP at the TF32 rate, the FP32-core bound logged beside
   it) and the kernels SDPA ran (one ``torch.profiler`` pass); f32 is also
   checked on views 4 bytes off 16 (the 4-byte copy path), and each check
   logs its copy path; drives its path, ``ops.flash_attention_op``, once at
   that shape in bf16;
11. profiles one fused request of step 4 per engine, captured and eager
   (the last phase: its profiler passes follow every capture of the run):
   the K1 kernels the device ran, by name, must be 6 x 64 in each, and the
   main path's launch count must be 3 requests x that figure; then splits
   one fit step of 5a into its parts, each timed alone (the host's batch,
   its copy to the card, the train step) with one profiler pass over the
   train step; and profiles a bp1 pass and one socket flush of 8a.

The build fails if ``ptxas`` reports a spill in any of the four kernels.  Any failed
check raises and the script exits non-zero; without a GPU, or
without the rest of the repository beside it, it exits non-zero at once.
The line before the last is ``{"kernels": [...]}`` and the last line is
``{"ok": true, "device": {...}}``.  ``--json PATH`` also writes every
measurement to PATH.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM data-sheet peaks at a 700 W limit (dense, no sparsity)
PEAK_F32_FLOPS = 67e12      # FP32 outside the tensor cores
PEAK_BYTES = 3.35e12        # HBM3
PEAK_BF16_FLOPS = 989e12    # dense bf16 tensor cores
PEAK_TF32_FLOPS = 495e12    # dense TF32 tensor cores (K4's f32 path runs 3 TF32 products per product)
F32_LANES_PER_SM = 128      # FP32 instructions an SM issues per clock, in lanes
SM_CLOCK_HZ = 1.98e9        # H100 SXM boost clock

F32_TOL = 1e-5              # tests/test_kernels.py bar for f32
BF16_TOL = 2e-2             # and for bf16
SCHEDULE_RTOL = 1e-4        # 64 compounding steps of differently ordered f32 sums
SCHEDULE_ATOL = 1e-6
CAPTURE_RTOL = 1e-5         # tests/test_engine.py::test_schedule_equivalence
CAPTURE_ATOL = 1e-6
# CUDA API calls (cuda* and cu*) that put work on a stream
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")
LIBRARY_RTOL = 1e-3         # cuDNN's LSTM against the plain version, 64 steps
LIBRARY_ATOL = 1e-4
SWEEP = ((16, 16), (32, 64), (64, 128), (128, 256))
RAGGED_B = 37

K1_SOURCE = "src/repro_torch/kernels/csrc/lstm_cell.cu"
K1_REPLACES = "src/repro/kernels/lstm_cell.py:79"
K1_KERNEL = "lstm_cell_kernel"   # its __global__ function's name, as the profiler sees it
K2_SOURCE = "src/repro_torch/kernels/csrc/lstm_seq.cu"
K2_REPLACES = "src/repro/kernels/lstm_seq.py:86"
K2_T = 64                   # timesteps per K2 launch at the main path's shape
SWEEP_BT = ((1, 16), (RAGGED_B, 16), (1024, 16))   # (B, T) for the sweep shapes

K3_SOURCE = "src/repro_torch/kernels/csrc/wkv6.cu"
K3_REPLACES = "src/repro/kernels/wkv6.py:60"
K4_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
K4_REPLACES = "src/repro/kernels/flash_attention.py:101"
WKV_F32_TOL, WKV_BF16_TOL = 1e-4, 3e-2        # tests/test_kernels.py:102
ATTN_F32_TOL, ATTN_BF16_TOL = 2e-3, 3e-2      # tests/test_kernels.py:142
# At phi4-mini's full width most rows average thousands of keys, so their
# outputs are small (per-coordinate std about sqrt(e / (i + 1)): 0.026 at
# row 4096) and the reference's absolute limits above would pass a fault of
# tens of percent there.  The full-width checks hold each element to
# atol + row * rms(its row of d) + rtol * |want| with (rtol, atol, row):
# f32 1e-4 relative plus 1e-5 (the kernel's error there was 1.0e-6 at
# most); bf16 two bf16 ulps of the value (2^-6) plus 5% of the row's rms,
# since rounding P to bf16 (relative to the running maximum in the kernel,
# to the final one in the plain version) errs in proportion to the row.
ATTN_WIDE_TOL = {"f32": (1e-4, 1e-5, 0.0), "bf16": (2.0 ** -6, 0.0, 0.05)}
WKV_SWEEP = ((8, 16, 2), (32, 32, 4), (64, 64, 2))   # (T, hd, H), tests/test_kernels.py:86
ATTN_SWEEP = ((128, 64), (256, 64), (256, 128))      # (S, d), tests/test_kernels.py:124
# (S, Sk, d) beyond the sweep: S != Sk both ways, ragged S, ragged S and Sk
ATTN_EXTRA = ((128, 256, 64), (256, 128, 128), (200, 200, 64), (200, 136, 128))
# rwkv6-7b (src/repro/configs/rwkv6_7b.py): d_model 4096 in heads of 64, so
# 64 heads; train_4k's T = 4096 (src/repro/config/core.py); B cut from 256
# to 32 so that the plain version's check fits beside it.  B*H = 2048
# heads at B=32, each a team of 64 threads (wkv6_tile logs the tile and the
# resident blocks per SM); the kernel alone is also timed at RWKV_B_SWEEP
RWKV_B, RWKV_T, RWKV_H, RWKV_HD = 32, 4096, 64, 64
RWKV_B_SWEEP = (8, 16, 32, 64)
# phi4-mini-3.8b (src/repro/configs/phi4_mini_3_8b.py): 24 query heads, 8 kv
# heads (expanded to 24 as layers/attention.py::_expand_kv does), d_model
# 3072 / 24 = 128; S = Sk = 4096, B = 4
PHI_B, PHI_S, PHI_H, PHI_KV_H, PHI_HD = 4, 4096, 24, 8, 128

# kernels whose ptxas report must show no spill
NO_SPILL = ("lstm_cell", "lstm_seq", "wkv6", "flash_attention")

FIT_ARCH = "lstm-ae-f64-d6"
FIT_STEPS, FIT_HELD = 20, 3
# the card's and the CPU's f32 sums run in other orders; over 3 Adam steps
# (updates of about lr each) they stay far inside these
FIT_LOSS_RTOL, FIT_PARAM_ATOL = 1e-5, 1e-5

GATEWAY_ARCH = "lstm-ae-f64-d6"
GATEWAY_CAPACITY = 1024
GATEWAY_MAX_BATCH = 256
# K1 is held to its plain version at the gateway's flush width as well
K1_BATCHES = (1, RAGGED_B, GATEWAY_MAX_BATCH, 8192)
GATEWAY_STREAMS = 2048
GATEWAY_WINDOWS = 512
GATEWAY_SAMPLED = 16
# the socket transport in front of that gateway: streaming sessions (one
# per connection) and the client threads that drive them, samples per STEP
# frame, connections of the closed-loop latency run, tickets left for the
# drain to answer
TRANSPORT_SESSIONS = 64
TRANSPORT_THREADS = 4
TRANSPORT_STEP_FRAME = 8
TRANSPORT_LATENCY_CONNS = 16
TRANSPORT_DRAIN_TICKETS = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def k1_bound(b: int, in_dim: int, hidden: int, s: int = 4) -> tuple[float, float]:
    """(FLOP, bytes) of one K1 launch: each input read once, each output written once."""
    flops = 8.0 * b * hidden * (in_dim + hidden)
    nbytes = b * (in_dim + hidden) * s + b * hidden * (8 + s) + 16 * hidden * (in_dim + hidden) + 16 * hidden
    return flops, float(nbytes)


def k2_bound(t_len: int, b: int, in_dim: int, hidden: int, s: int = 4) -> tuple[float, float]:
    """(FLOP, bytes) of one K2 launch: xs, h0, c0, the weights and the bias
    read once; ys, h_T, c_T written once."""
    flops = 8.0 * t_len * b * hidden * (in_dim + hidden)
    nbytes = (t_len * b * (in_dim + hidden) * s + b * hidden * (2 * s + 8)
              + 16 * hidden * (in_dim + hidden) + 16 * hidden)
    return flops, float(nbytes)


def k3_bound(b: int, t_len: int, h: int, hd: int, s: int = 4) -> tuple[float, float]:
    """(FLOP, bytes) of one K3 launch: 5*hd^2 FLOP per (b, h, t) (y = r.S +
    (r.(u*k)) v, S <- w*S + k^T v); r, k, v (s bytes each), w, u, s0 read
    once; y and S_T written once, f32.  The bound stays the larger of the
    two over the card's peaks; the kernel's own floor, its FP32 issue at
    three instructions per state element and step (:func:`k3_issue_floor_ms`),
    is not a bound of the function."""
    flops = 5.0 * b * t_len * h * hd * hd
    nbytes = b * t_len * h * hd * (3 * s + 4 + 4) + h * hd * 4 + 2 * b * h * hd * hd * 4
    return flops, float(nbytes)


def k3_issue_floor_ms(b: int, t_len: int, h: int, hd: int, sms: int) -> float:
    """K3's FP32 issue floor: 3 instructions (FFMA y, FMUL k*v, FFMA S) per
    state element and step over ``sms`` SMs of F32_LANES_PER_SM lanes at
    SM_CLOCK_HZ, in ms."""
    return 3.0 * b * t_len * h * hd * hd / (sms * F32_LANES_PER_SM * SM_CLOCK_HZ) * 1e3


def k4_bound(b: int, h: int, s_len: int, sk_len: int, d: int, causal: bool,
             itemsize: int) -> tuple[float, float, int]:
    """(FLOP, bytes, visible pairs) of one K4 launch: 4*d FLOP per visible
    (query, key) pair (top-left causal mask); q, k, v read once, o written once."""
    per_head = sum(min(i + 1, sk_len) for i in range(s_len)) if causal else s_len * sk_len
    pairs = b * h * per_head
    nbytes = b * h * d * itemsize * (2 * s_len + 2 * sk_len)
    return 4.0 * d * pairs, float(nbytes), pairs


def device_ms(torch, fn, iters: int = 50, reps: int = 5) -> float:
    """Median device time of one ``fn()`` call, from CUDA events around
    ``iters`` calls queued behind a sleep kernel, so the host's launch cost
    does not open gaps on the device."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    samples = []
    for _ in range(reps):
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def clocks_under_load(torch, fn, iters: int) -> dict:
    """The SM clock (MHz) and power draw (W) that ``nvidia-smi`` reads while
    ``iters`` queued ``fn()`` calls run on the card."""
    fn()
    torch.cuda.synchronize()
    for _ in range(iters):
        fn()
    time.sleep(0.1)
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    torch.cuda.synchronize()
    mhz, watts = (float(x) for x in out.stdout.splitlines()[0].split(","))
    return {"sm_mhz": mhz, "power_w": watts}


def host_ms(torch, fn, iters: int = 200) -> float:
    """Wall time of one ``fn()`` call in a Python loop, launch cost included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def cell_inputs(torch, b, in_dim, hidden, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    x = randn(b, in_dim).to(dtype)
    h = randn(b, hidden).to(dtype)
    c = randn(b, hidden)
    wx = randn(4, in_dim, hidden, scale=in_dim ** -0.5)
    wh = randn(4, hidden, hidden, scale=hidden ** -0.5)
    bias = randn(4, hidden, scale=0.1)
    return x, h, c, wx, wh, bias


def paper_layer_shapes(get_config) -> list[tuple[int, int]]:
    shapes = []
    for arch in ("lstm-ae-f32-d2", "lstm-ae-f32-d6", "lstm-ae-f64-d2", "lstm-ae-f64-d6"):
        ae = get_config(arch).lstm_ae
        shapes += list(zip(ae.layer_input_sizes(), ae.layer_sizes()))
    return list(dict.fromkeys(shapes))


def check_k1(torch, results) -> None:
    from repro_torch.config import get_config
    from repro_torch.kernels.lstm_cell import lstm_cell_cuda, lstm_cell_plain

    shapes = list(dict.fromkeys(paper_layer_shapes(get_config) + list(SWEEP)))
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n = 0
    for in_dim, hidden in shapes:
        for b in K1_BATCHES:
            for dtype in (torch.float32, torch.bfloat16):
                for pwl in (False, True):
                    args = cell_inputs(torch, b, in_dim, hidden, dtype, seed=n)
                    hk, ck = lstm_cell_cuda(*args, pwl=pwl)
                    torch.cuda.synchronize()
                    hp, cp = lstm_cell_plain(*args, pwl=pwl)
                    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
                    if hk.dtype != dtype or ck.dtype != torch.float32:
                        raise AssertionError(f"K1 output dtypes {hk.dtype}, {ck.dtype}")
                    for got, want in ((hk, hp), (ck, cp)):
                        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
                        err[dtype] = max(err[dtype], float((got.float() - want.float()).abs().max()))
                    n += 1
    results["k1_checks"] = n
    results["k1_max_abs_err_f32"] = err[torch.float32]
    results["k1_max_abs_err_bf16"] = err[torch.bfloat16]
    log(f"[k1] {n} checks against the plain version passed over {len(shapes)} (In, H) shapes "
        f"x B in {K1_BATCHES} x (f32, bf16) x pwl: max abs err "
        f"f32 {err[torch.float32]:.3g} (tol {F32_TOL}), bf16 {err[torch.bfloat16]:.3g} (tol {BF16_TOL})")


def seq_inputs(torch, t_len, b, in_dim, hidden, dtype, seed):
    x, h, c, wx, wh, bias = cell_inputs(torch, b, in_dim, hidden, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    xs = torch.randn(t_len, b, in_dim, generator=g, device="cuda").to(dtype)
    return xs, h, c, wx, wh, bias


def check_k2(torch, results) -> None:
    from repro_torch.config import get_config
    from repro_torch.kernels.lstm_seq import lstm_seq_cuda, lstm_seq_plain, lstm_seq_plan

    cases = [(s, b, K2_T) for s in paper_layer_shapes(get_config) for b in (1, RAGGED_B, 8192)]
    cases += [(s, b, t) for s in SWEEP for b, t in SWEEP_BT]
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    paths = set()
    n = 0
    for (in_dim, hidden), b, t_len in cases:
        paths.add(lstm_seq_plan(b, in_dim, hidden)[0])
        for dtype in (torch.float32, torch.bfloat16):
            for pwl in (False, True):
                args = seq_inputs(torch, t_len, b, in_dim, hidden, dtype, seed=500 + n)
                ys, (hk, ck) = lstm_seq_cuda(*args, pwl=pwl)
                torch.cuda.synchronize()
                yp, (hp, cp) = lstm_seq_plain(*args, pwl=pwl)
                tol = F32_TOL if dtype == torch.float32 else BF16_TOL
                if ys.dtype != dtype or hk.dtype != dtype or ck.dtype != torch.float32:
                    raise AssertionError(f"K2 output dtypes {ys.dtype}, {hk.dtype}, {ck.dtype}")
                for got, want in ((ys, yp), (hk, hp), (ck, cp)):
                    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
                    err[dtype] = max(err[dtype], float((got.float() - want.float()).abs().max()))
                n += 1
    if paths != {True, False}:
        raise AssertionError(f"K2 checks covered only weights-in-shared-memory={paths}")
    results["k2_checks"] = n
    results["k2_max_abs_err_f32"] = err[torch.float32]
    results["k2_max_abs_err_bf16"] = err[torch.bfloat16]
    log(f"[k2] {n} checks against the plain version passed ({len(cases)} (In, H, B, T) cases: "
        f"paper shapes at B in (1, {RAGGED_B}, 8192), T={K2_T}; sweep {list(SWEEP)} at (B, T) in "
        f"{list(SWEEP_BT)}; weights in shared memory and from L2 both covered) x (f32, bf16) x pwl: "
        f"max abs err f32 {err[torch.float32]:.3g} (tol {F32_TOL}), "
        f"bf16 {err[torch.bfloat16]:.3g} (tol {BF16_TOL})")


def time_k2(torch, b: int, k1_rows, results, card) -> dict:
    """K2 per layer of lstm-ae-f64-d6 at batch b, T=64, f32, beside its bound,
    the plain version, a one-layer cuDNN LSTM and 64 launches of K1."""
    from repro_torch.config import get_config
    from repro_torch.kernels.lstm_seq import (
        lstm_seq_cuda,
        lstm_seq_plain,
        lstm_seq_plan,
        lstm_seq_tile,
    )

    ae = get_config("lstm-ae-f64-d6").lstm_ae
    rows = []
    for li, (in_dim, hidden) in enumerate(zip(ae.layer_input_sizes(), ae.layer_sizes())):
        xs, h0, c0, wx, wh, bias = seq_inputs(torch, K2_T, b, in_dim, hidden, torch.float32,
                                              seed=2000 + li)
        lstm = torch.nn.LSTM(in_dim, hidden).cuda()
        with torch.no_grad():
            lstm.weight_ih_l0.copy_(wx.permute(0, 2, 1).reshape(4 * hidden, in_dim))
            lstm.weight_hh_l0.copy_(wh.permute(0, 2, 1).reshape(4 * hidden, hidden))
            lstm.bias_ih_l0.copy_(bias.reshape(4 * hidden))
            lstm.bias_hh_l0.zero_()

            def library():
                return lstm(xs, (h0[None], c0[None]))

            yl, (hl, cl) = library()
            yp, (hp, cp) = lstm_seq_plain(xs, h0, c0, wx, wh, bias)
            # the same function (gate order, bias, state); the bar allows f32
            # sums of another order over 64 steps, and catches any mix-up
            for got, want in ((yl, yp), (hl[0], hp), (cl[0], cp)):
                torch.testing.assert_close(got, want, rtol=LIBRARY_RTOL, atol=LIBRARY_ATOL)
            flops, nbytes = k2_bound(K2_T, b, in_dim, hidden)
            row = {
                "in": in_dim, "hidden": hidden, "batch": b, "t": K2_T, "flop": flops,
                "bytes": nbytes, "weights_in_smem": lstm_seq_plan(b, in_dim, hidden)[0],
                "tile": lstm_seq_tile(b, in_dim, hidden),
                "kernel_ms": device_ms(torch, lambda: lstm_seq_cuda(xs, h0, c0, wx, wh, bias),
                                       iters=10, reps=5),
                "kernel_host_ms": host_ms(torch, lambda: lstm_seq_cuda(xs, h0, c0, wx, wh, bias),
                                          iters=10),
                "plain_ms": device_ms(torch, lambda: lstm_seq_plain(xs, h0, c0, wx, wh, bias),
                                      iters=3, reps=3),
                "library_ms": device_ms(torch, library, iters=10, reps=5),
                "k1_x64_ms": 64 * k1_rows[li]["kernel_ms"],
                "ops_ms": flops / PEAK_F32_FLOPS * 1e3,
                "bytes_ms": nbytes / PEAK_BYTES * 1e3,
            }
        row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
        row["tflops"] = flops / row["kernel_ms"] * 1e-9
        rows.append(row)
        log(f"[k2 time] f64-d6 layer {li} (In={in_dim}, H={hidden}, B={b}, T={K2_T}, f32, tile "
            f"{row['tile'][0]} rows per block x {row['tile'][1]} per thread, weights "
            f"{'in shared memory' if row['weights_in_smem'] else 'from L2'}): kernel "
            f"{row['kernel_ms']:.4f} ms (device), {row['tflops']:.1f} TFLOP/s, "
            f"{row['kernel_host_ms']:.4f} ms per call on the "
            f"host; bound {row['bound_ms']:.4f} ms "
            f"({'operations' if row['ops_ms'] >= row['bytes_ms'] else 'bytes'}); plain "
            f"{row['plain_ms']:.3f} ms; cuDNN LSTM {row['library_ms']:.4f} ms; 64 x K1 "
            f"{row['k1_x64_ms']:.4f} ms [{card}]")
    ops = sum(r["ops_ms"] for r in rows)
    mem = sum(r["bytes_ms"] for r in rows)
    total = {k: sum(r[k] for r in rows) for k in ("kernel_ms", "kernel_host_ms", "plain_ms",
                                                   "library_ms", "k1_x64_ms", "flop", "bytes")}
    total["bound_ms"] = max(ops, mem)
    total["bound_by"] = "operations" if ops >= mem else "bytes"
    total["tflops"] = total["flop"] / total["kernel_ms"] * 1e-9
    results["k2_layers"] = rows
    results["k2_forward"] = total
    log(f"[k2 time] one forward of lstm-ae-f64-d6 at B={b}, T={K2_T} (6 launches): kernel "
        f"{total['kernel_ms']:.4f} ms ({total['tflops']:.1f} TFLOP/s), "
        f"{total['kernel_host_ms']:.4f} ms on the host, bound "
        f"{total['bound_ms']:.4f} ms ({total['bound_by']}; {total['flop']:.4g} FLOP, "
        f"{total['bytes']:.4g} B), plain {total['plain_ms']:.3f} ms, cuDNN LSTM "
        f"{total['library_ms']:.4f} ms, 64 x K1 {total['k1_x64_ms']:.4f} ms [{card}]")
    return total


def drive_k2_path(torch, svc, series, results, card) -> int:
    """K2's path: ``ops.lstm_seq_op`` once per layer through the service's
    model; the reconstruction must equal the fused schedule's."""
    from repro_torch.kernels.ops import launch_counts, lstm_seq_op, reset_launch_counts

    xs = series.to("cuda").transpose(0, 1).contiguous()          # (T, B, F)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    ys = xs
    for layer in svc.params["layers"]:
        ys, _ = lstm_seq_op(layer, ys)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    depth = len(svc.params["layers"])
    if counts != {"lstm_cell": 0, "lstm_seq": depth, "wkv6": 0, "flash_attention": 0}:
        raise AssertionError(f"K2 path launched {counts}, expected {depth} lstm_seq launches")
    want = svc.engine.reconstruct({"series": series})
    torch.testing.assert_close(ys.transpose(0, 1), want, rtol=SCHEDULE_RTOL, atol=SCHEDULE_ATOL)
    err = float((ys.transpose(0, 1) - want).abs().max())
    results["k2_path"] = {"launches": counts["lstm_seq"], "ms": dt * 1e3, "max_abs_diff_vs_fused": err}
    log(f"[k2 path] lstm_seq_op over the {depth} layers of {svc.cfg.name} at B={series.shape[0]}, "
        f"T={series.shape[1]}: {counts['lstm_seq']} K2 launches, {dt*1e3:.2f} ms on the host clock "
        f"(input on the card); reconstruction agrees with the fused schedule (max abs diff "
        f"{err:.3g}; rtol {SCHEDULE_RTOL}, atol {SCHEDULE_ATOL}) [{card}]")
    return counts["lstm_seq"]


def churn_spans(n: int, capacity: int, t_len: int, churn_every: int = 8) -> dict:
    """{stream: (first, end) timestep} that ``drive_stream_churn`` serves."""
    resident, waiting = list(range(min(capacity, n))), list(range(min(capacity, n), n))
    start, end = dict.fromkeys(resident, 0), {}
    for t in range(t_len):
        if waiting and t and t % churn_every == 0:
            old = resident.pop(0)
            end[old] = t + 1
            nxt = waiting.pop(0)
            start[nxt] = t + 1
            resident.append(nxt)
    end.update(dict.fromkeys(resident, t_len))
    return {sid: (start[sid], end[sid]) for sid in end}


def profile_pool_step(torch, gw, windows, card) -> dict:
    """Where a full pool step's time goes: the whole ``gw.step`` (host
    assembly of every slot's sample, copy, masked step, error readback)
    against the masked step alone with its inputs already on the card, on
    the host clock and on the device (CUDA events)."""
    cap = gw.pool.capacity
    for sid in range(cap):
        gw.admit(("profile", sid))
    inputs = {("profile", sid): windows[sid, 0] for sid in range(cap)}
    steps = []
    for _ in range(20):
        t0 = time.perf_counter()
        gw.step(inputs)
        steps.append((time.perf_counter() - t0) * 1e3)
    for sid in range(cap):
        gw.evict(("profile", sid))
    x_t = torch.from_numpy(windows[:cap, 0].copy()).to("cuda")
    keep = torch.ones(cap, dtype=torch.bool, device="cuda")
    state = gw.pool._state
    engine = gw.engine
    out = {"step_ms": statistics.median(steps),
           "masked_step_host_ms": host_ms(torch, lambda: engine.stream_masked(x_t, state, keep),
                                          iters=20),
           "masked_step_device_ms": device_ms(torch, lambda: engine.stream_masked(x_t, state, keep),
                                              iters=20, reps=3)}
    out["outside_masked_step_ms"] = out["step_ms"] - out["masked_step_host_ms"]
    how = "eager" if engine._graphs is None else "captured"
    log(f"[gateway] {how}: one pool step with all {cap} slots stepping: {out['step_ms']:.3f} ms "
        f"(median of 20); the engine's masked step alone with its inputs on the card "
        f"{out['masked_step_host_ms']:.3f} ms on the host clock, "
        f"{out['masked_step_device_ms']:.3f} ms of device time; the rest (assembly of the "
        f"samples, copy, error readback) {out['outside_masked_step_ms']:.3f} ms [{card}]")
    return out


def drive_gateway(torch, results, card) -> int:
    """The gateway at full width over the fused schedule: pooled streaming
    with churn, then micro-batched one-shot scoring.  Returns K1's launches
    in the one-shot phase."""
    import numpy as np

    from repro_torch.data import TimeseriesConfig, make_batch
    from repro_torch.engine import AnomalyService, EngineConfig
    from repro_torch.gateway import drive_stream_churn
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts

    svc = AnomalyService(GATEWAY_ARCH, schedule="fused", device="cuda", seed=0)
    gw = svc.open_gateway(capacity=GATEWAY_CAPACITY, max_batch=GATEWAY_MAX_BATCH)
    feats, t_len = svc.features, 64
    data_cfg = TimeseriesConfig(features=feats, seq_len=t_len, batch=GATEWAY_STREAMS,
                                anomaly_rate=0.05, seed=7)
    windows = make_batch(data_cfg, 0)[0].numpy()                 # (N, T, F)
    out = {"arch": GATEWAY_ARCH, "capacity": GATEWAY_CAPACITY, "max_batch": GATEWAY_MAX_BATCH,
           "streams": GATEWAY_STREAMS, "seq_len": t_len}

    # --- streaming: more logical streams than slots, admit/evict churn
    gw.telemetry.reset()
    reset_launch_counts()
    t0 = time.perf_counter()
    finals, unserved = drive_stream_churn(gw, windows)
    dt = time.perf_counter() - t0
    s = gw.stats()
    # the first step captures the pool step; churn must never recapture it
    if gw.pool.captures != 1:
        raise AssertionError(f"the pool step was captured {gw.pool.captures} times over the "
                             f"churn, expected once")
    if set(finals) & set(unserved) or len(finals) + len(unserved) != GATEWAY_STREAMS:
        raise AssertionError(f"streams: {len(finals)} served + {len(unserved)} waiting "
                             f"!= {GATEWAY_STREAMS}")
    spans = churn_spans(GATEWAY_STREAMS, GATEWAY_CAPACITY, t_len)
    if set(spans) != set(finals):
        raise AssertionError("served streams differ from drive_stream_churn's schedule")
    out["stream"] = {"served": len(finals), "waiting": len(unserved), "wall_s": dt,
                     "stream_steps": s["counters"]["pool.stream_steps"],
                     "stream_steps_per_s": s["stream_steps_per_s"],
                     "pool_step_ms_p50": gw.telemetry.histograms["pool_step_ms"].percentile(50),
                     "kernel_launches": launch_counts(), "pool_captures": gw.pool.captures,
                     "recaptures": gw.pool.captures - 1,
                     "pool_replays": gw.pool._graphs.replays}
    churned = sorted(i for i, (a, e) in spans.items() if a == 0 and e < t_len)
    late = sorted(i for i, (a, _) in spans.items() if a > 0)
    sampled = (churned + late)[:GATEWAY_SAMPLED - 2] + [churned[-1] + 1, GATEWAY_CAPACITY - 1]
    worst = 0.0
    for sid in sampled:
        a, e = spans[sid]
        sess = svc.stream_start(1)
        for t in range(a, e):
            errs, sess = svc.stream_step(windows[sid:sid + 1, t], sess)
        solo = float(errs[0])
        np.testing.assert_allclose(finals[sid], solo, rtol=SCHEDULE_RTOL, atol=SCHEDULE_ATOL)
        worst = max(worst, abs(finals[sid] - solo))
    out["stream"]["sampled"] = sampled
    out["stream"]["max_abs_diff_vs_solo"] = worst
    log(f"[gateway] {GATEWAY_ARCH} [fused] capacity={GATEWAY_CAPACITY}: streamed {len(finals)} of "
        f"{GATEWAY_STREAMS} logical streams ({len(unserved)} still waiting) over T={t_len}: "
        f"{s['stream_steps_per_s']:,.0f} stream-steps/s ({s['counters']['pool.stream_steps']:.0f} "
        f"stream-steps in {dt:.3f} s), pool step p50 {out['stream']['pool_step_ms_p50']:.3f} ms; "
        f"the pool step captured once, {out['stream']['pool_replays']} replays, "
        f"{out['stream']['recaptures']} recaptures over the churn; "
        f"{len(sampled)} sampled streams agree with solo stream_step (max abs diff {worst:.3g}) "
        f"[{card}]")
    out["pool_step"] = profile_pool_step(torch, gw, windows, card)
    # the same pool step on an engine that runs eagerly
    eager = AnomalyService(GATEWAY_ARCH, schedule=EngineConfig("fused", jit=False),
                           device="cuda", seed=0)
    eager.recalibrate(params=svc.params)
    out["pool_step_eager"] = profile_pool_step(
        torch, eager.open_gateway(capacity=GATEWAY_CAPACITY, max_batch=GATEWAY_MAX_BATCH),
        windows, card)
    log(f"[gateway] pool step with all {GATEWAY_CAPACITY} slots stepping, captured against "
        f"eager: {out['pool_step']['step_ms']:.3f} against "
        f"{out['pool_step_eager']['step_ms']:.3f} ms [{card}]")

    # --- one-shot: micro-batched scoring of mixed-length windows
    rng = np.random.default_rng(12)
    lens = rng.integers(8, t_len + 1, size=GATEWAY_WINDOWS)
    requests = [windows[i % GATEWAY_STREAMS, :n] for i, n in enumerate(lens)]
    flush_t = []
    real = gw.engine.score_masked

    def recorded(batch):   # bucket_T of every flush, to predict K1's launches
        flush_t.append(batch["series"].shape[1])
        return real(batch)

    gw.engine.score_masked = recorded
    graphs = gw.engine._graphs
    depth = len(svc.params["layers"])

    def one_pass() -> dict:
        """Every request through submit/pump/flush; its flushes' K1 launches,
        captures and replays."""
        flush_t.clear()
        gw.telemetry.reset()
        captures, replays = graphs.captures, graphs.replays
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        tickets = [None] * len(requests)
        for i, w in enumerate(requests):
            tickets[i] = gw.submit(w)
            gw.pump()
        gw.flush()
        dt = time.perf_counter() - t0
        k1 = launch_counts()["lstm_cell"]
        s = gw.stats()
        if k1 != depth * sum(flush_t) or len(flush_t) != s["counters"]["batch.flushes"]:
            raise AssertionError(f"K1 launched {k1} times over {len(flush_t)} flushes "
                                 f"(telemetry {s['counters']['batch.flushes']}), expected "
                                 f"{depth * sum(flush_t)}")
        return {"wall_s": dt, "flushes": len(flush_t), "bucket_t": list(flush_t),
                "k1_launches": k1, "captures": graphs.captures - captures,
                "replays": graphs.replays - replays, "tickets": tickets,
                "requests_per_s": s["requests_per_s"], "batch_fill": s["batch_fill_ratio"],
                "p50_ms": s["latency_ms"]["p50"], "p95_ms": s["latency_ms"]["p95"],
                "compute_ms_p50": gw.telemetry.histograms["compute_ms"].percentile(50)}

    # the first pass captures one graph per bucket; the second only replays
    first, steady = one_pass(), one_pass()
    del gw.engine.score_masked
    buckets = sorted(set(steady["bucket_t"]))
    in_graph = {key[1][0][0][1]: p.launches.get("lstm_cell", 0)
                for key, p in graphs.programs.items() if key[0] == "score_masked"}
    if (first["captures"] != len(buckets) or first["captures"] + first["replays"] !=
            first["flushes"] or steady["captures"] or steady["replays"] != steady["flushes"]
            or any(in_graph[tb] != depth * tb for tb in buckets)):
        raise AssertionError(f"flushes over buckets {buckets}: first pass {first['captures']} "
                             f"captures, {first['replays']} replays; second {steady['captures']} "
                             f"captures, {steady['replays']} replays; K1 inside {in_graph}")
    worst = 0.0
    for run in (first, steady):
        for w, ticket in zip(requests, run.pop("tickets")):
            # each window alone, on the eager engine (not 57 captures of B=1)
            direct = float(eager.engine.score_masked({"series": w[None],
                                                       "lengths": np.array([w.shape[0]])})[0])
            np.testing.assert_allclose(ticket.score, direct, rtol=SCHEDULE_RTOL,
                                       atol=SCHEDULE_ATOL)
            worst = max(worst, abs(ticket.score - direct))
    out["oneshot"] = {"windows": GATEWAY_WINDOWS, "first_pass": first, **steady,
                      "k1_in_graph": in_graph, "max_abs_diff_vs_direct": worst}
    results["gateway"] = out
    for name, run in (("first pass (captures)", first), ("second pass", steady)):
        log(f"[gateway] {GATEWAY_WINDOWS} one-shot windows (T in 8..{t_len}, buckets {buckets}), "
            f"{name}: {run['flushes']} flushes of max_batch={GATEWAY_MAX_BATCH}, "
            f"{run['requests_per_s']:,.0f} requests/s over {run['wall_s']:.3f} s, batch fill "
            f"{run['batch_fill']:.3f}, p50 {run['p50_ms']:.2f} ms, p95 {run['p95_ms']:.2f} ms, "
            f"flush compute p50 {run['compute_ms_p50']:.2f} ms; K1 launches {run['k1_launches']} "
            f"= {depth} x sum of bucket_T, from {run['captures']} captures and {run['replays']} "
            f"graph replays [{card}]")
    log(f"[gateway] K1 inside each bucket's graph {in_graph}; every score of both passes agrees "
        f"with the eager engine's score_masked of its window alone (max abs diff {worst:.3g}) "
        f"[{card}]")
    return steady["k1_launches"]


def in_threads(fn, groups) -> float:
    """``fn(group)`` for each group on a thread of its own, all at once;
    returns the wall seconds and raises the first failure."""
    import threading

    errors = []

    def run(group):
        try:
            fn(group)
        except BaseException as exc:   # re-raised below, on the caller's thread
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(g,)) for g in groups]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    dt = time.perf_counter() - t0
    if any(th.is_alive() for th in threads):
        raise AssertionError("client threads did not finish within 300 s")
    if errors:
        raise errors[0]
    return dt


def percentile(values, q: float) -> float:
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(q / 100.0 * len(ordered)))]


def score_captures(svc) -> int:
    """Captures of the flush program (``score_masked``) on ``svc``'s engine."""
    return svc.engine.profile_info()["per_program"].get("score_masked", {}).get("compiles", 0)


def drive_transport(torch, results, card):
    """The gateway at full width behind the socket transport: a
    ``GatewayServer`` on its own thread with durable sessions and a
    ``MetricsServer``; one-shot windows over bp1 and JSON, socket streams,
    a snapshot, dropped connections, a restart on the same store with
    resume by token, and a drain that must answer every pending ticket.
    Returns ``(gateway, windows)`` for the profiled flush at the end of the
    run (its profiler pass must follow every capture)."""
    import tempfile
    import urllib.request

    import numpy as np

    from repro_torch.data import TimeseriesConfig, make_batch
    from repro_torch.engine import AnomalyService
    from repro_torch.gateway.client import GatewayClient
    from repro_torch.gateway.durability import enable_durability
    from repro_torch.gateway.server import GatewayServer
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.obs import Histogram, MetricsServer

    svc = AnomalyService(GATEWAY_ARCH, schedule="fused", device="cuda", seed=0)
    feats, t_len, depth = svc.features, 64, len(svc.params["layers"])
    data_cfg = TimeseriesConfig(features=feats, seq_len=t_len, batch=GATEWAY_STREAMS,
                                anomaly_rate=0.05, seed=7)
    windows = make_batch(data_cfg, 0)[0].numpy()                 # (N, T, F), as drive_gateway
    oneshot = [windows[i] for i in range(GATEWAY_WINDOWS)]
    n_sess, half = TRANSPORT_SESSIONS, TRANSPORT_SESSIONS // 2
    streams = windows[GATEWAY_WINDOWS:GATEWAY_WINDOWS + n_sess]  # (64, T, F)
    out = {"arch": GATEWAY_ARCH, "capacity": GATEWAY_CAPACITY, "max_batch": GATEWAY_MAX_BATCH,
           "windows": GATEWAY_WINDOWS, "seq_len": t_len, "sessions": n_sess}

    # the uninterrupted run of the streams, in-process on a pool of its own:
    # all sessions step together, one pool step per timestep
    oracle_gw = svc.open_gateway(capacity=GATEWAY_CAPACITY, max_batch=GATEWAY_MAX_BATCH)
    for sid in range(n_sess):
        oracle_gw.admit(sid)
    oracle_gw.step({sid: streams[sid, 0] for sid in range(n_sess)})     # its capture
    for sid in range(n_sess):
        oracle_gw.reset(sid)
    oracle = np.zeros((n_sess, t_len), np.float32)
    t0 = time.perf_counter()
    for t in range(t_len):
        errs = oracle_gw.step({sid: streams[sid, t] for sid in range(n_sess)})
        oracle[:, t] = [errs[sid] for sid in range(n_sess)]
    out["stream_steps_per_s_in_process"] = n_sess * t_len / (time.perf_counter() - t0)

    torch.cuda.synchronize()
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as store:
        gw = svc.open_gateway(capacity=GATEWAY_CAPACITY, max_batch=GATEWAY_MAX_BATCH)
        enable_durability(gw, store)
        metrics = MetricsServer(gw.stats, port=0).start()
        server = GatewayServer(gw)
        host, port = server.start_in_thread()
        clients = []
        try:
            # --- one-shot: pipelined bp1 frames (the first pass captures the
            # bucket on the server's thread), then JSON lines
            with GatewayClient(host, port, protocol="binary") as cb:
                t0 = time.perf_counter()
                first = cb.score_many(oneshot, windows_per_frame=64)
                first_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                bp1 = cb.score_many(oneshot, windows_per_frame=64)
                bp1_s = time.perf_counter() - t0
            with GatewayClient(host, port, protocol="json") as cj:
                t0 = time.perf_counter()
                js = cj.score_many(oneshot)
                json_s = time.perf_counter() - t0
            if bp1 != js or first != bp1:
                raise AssertionError("bp1 and JSON scores of the same windows differ")
            # closed loop: single-window requests from concurrent connections,
            # each traced (the server's stages, the client's serialisation,
            # the rest of the round trip as "wire")
            traced = {}

            def closed_loop(idx):
                with GatewayClient(host, port, protocol="binary") as c:
                    for i in idx:
                        traced[i] = c.traced_score(oneshot[i])

            conns = TRANSPORT_LATENCY_CONNS
            loop_s = in_threads(closed_loop, [range(k, GATEWAY_WINDOWS, conns)
                                              for k in range(conns)])
            if [traced[i]["score"] for i in range(GATEWAY_WINDOWS)] != bp1:
                raise AssertionError("closed-loop scores differ from the pipelined ones")
            latencies = [t["e2e_ms"] for t in traced.values()]
            captures_oneshot = score_captures(svc)
            out["oneshot"] = {
                "first_pass_s": first_s,
                "bp1_requests_per_s": GATEWAY_WINDOWS / bp1_s,
                "json_requests_per_s": GATEWAY_WINDOWS / json_s,
                "closed_loop_connections": conns,
                "closed_loop_requests_per_s": GATEWAY_WINDOWS / loop_s,
                "closed_loop_p50_ms": percentile(latencies, 50),
                "closed_loop_p99_ms": percentile(latencies, 99),
                "closed_loop_stage_p50_ms": {
                    name: percentile([t["stages"][name] for t in traced.values()], 50)
                    for name in traced[0]["stages"]}}

            # --- streaming: one session per connection, driven by a few threads
            clients.extend(GatewayClient(host, port, protocol="binary") for _ in range(n_sess))
            got = [[] for _ in range(n_sess)]
            groups = [range(k, n_sess, TRANSPORT_THREADS) for k in range(TRANSPORT_THREADS)]

            def stepper(lo, hi):
                def run(sids):
                    for a in range(lo, hi, TRANSPORT_STEP_FRAME):
                        for sid in sids:
                            got[sid].extend(clients[sid].step_many(streams[sid, a:a + TRANSPORT_STEP_FRAME]))
                return run

            snap_at, drop_at = t_len // 2, t_len // 2 + TRANSPORT_STEP_FRAME
            stream_s = in_threads(stepper(0, snap_at), groups)
            out["stream_steps_per_s"] = n_sess * snap_at / stream_s
            with GatewayClient(host, port, protocol="binary") as ctl:
                hist = Histogram.from_dict(ctl.stats()["histograms"]["pool_step_ms"])
                out["pool_step_ms_p50"] = hist.percentile(50)
                snap = ctl.request("snapshot")
                gauges = ctl.stats()["gauges"]
                out["snapshot"] = {"sessions": snap["sessions"], "bytes": snap["bytes"],
                                   "copy_ms": gauges["durability.snapshot_copy_ms"],
                                   "write_ms": gauges["durability.snapshot_write_ms"]}
                in_threads(stepper(snap_at, drop_at), groups)     # past the snapshot
                for sid in range(0, n_sess, 2):                   # dropped: parked
                    clients[sid].close()
                deadline = time.monotonic() + 30
                while ctl.stats()["durability"]["parked"] < half:
                    if time.monotonic() > deadline:
                        raise AssertionError("dropped connections did not park their sessions")
                    time.sleep(0.01)
                body = urllib.request.urlopen(f"http://127.0.0.1:{metrics.port}/metrics",
                                              timeout=30).read().decode()
        finally:
            server.stop_in_thread()       # the drain hands every session off to the store
            metrics.stop()
        for c in clients:
            c.close()
        handoff = gw.durability.last_handoff
        s = gw.stats()
        want_series = (f"repro_queue_completed_total {s['counters']['queue.completed']:.0f}",
                       'repro_request_ms_bucket{le="+Inf"}', 'repro_pool_step_ms_bucket{le="+Inf"}',
                       "repro_queue_depth 0", "repro_uptime_s")
        missing = [m for m in want_series if m not in body]
        if missing:
            raise AssertionError(f"/metrics lacks {missing}")
        if (handoff["sessions_migrated"], handoff["parked_carried"]) != (half, half):
            raise AssertionError(f"the drain's handoff carried {handoff}, expected {half} live "
                                 f"and {half} parked sessions")
        out["handoff"] = {"sessions": handoff["sessions"], "bytes": handoff["bytes"],
                          "copy_ms": s["gauges"]["durability.snapshot_copy_ms"],
                          "write_ms": s["gauges"]["durability.snapshot_write_ms"]}
        if gw.pool.captures != 1:
            raise AssertionError(f"the first server's pool step was captured {gw.pool.captures} times")

        # in-process one-shot on the same gateway, its server stopped
        t0 = time.perf_counter()
        direct = gw.score(oneshot)
        out["oneshot"]["in_process_requests_per_s"] = GATEWAY_WINDOWS / (time.perf_counter() - t0)
        np.testing.assert_allclose(bp1, direct, rtol=CAPTURE_RTOL, atol=CAPTURE_ATOL)
        out["oneshot"]["bit_equal_to_in_process"] = bool(np.array_equal(np.float32(bp1), direct))
        out["oneshot"]["max_abs_diff_vs_in_process"] = float(np.max(np.abs(np.float32(bp1) - direct)))

        # --- a second server on the same store: resume every session by its
        # token, replay what the client buffered past the restored position,
        # finish the window; then tickets that only the drain can flush
        gw_b = svc.open_gateway(capacity=GATEWAY_CAPACITY, max_batch=GATEWAY_MAX_BATCH,
                                max_wait_ms=3_600_000.0)
        enable_durability(gw_b, store)
        server_b = GatewayServer(gw_b)
        host, port = server_b.start_in_thread()
        replayed = []
        drain_clients = []
        try:
            def resumer(sids):
                for sid in sids:
                    old = clients[sid]
                    with GatewayClient(host, port, protocol="binary") as c:
                        res = c.resume(old.session_token, replay=old.replay_buffer())
                        if res["seq"] != drop_at:
                            raise AssertionError(f"session {sid} resumed at {res['seq']}, "
                                                 f"expected {drop_at}")
                        replayed.append(res["replayed"])
                        for a in range(drop_at, t_len, TRANSPORT_STEP_FRAME):
                            got[sid].extend(c.step_many(streams[sid, a:a + TRANSPORT_STEP_FRAME]))
                        c.end_session()

            resume_s = in_threads(resumer, groups)
            pending = []
            for protocol in ("binary", "json"):
                c = GatewayClient(host, port, protocol=protocol)
                drain_clients.append(c)
                pending.append([c.submit(w) for w in oneshot[:TRANSPORT_DRAIN_TICKETS // 2]])
                c.ping()                  # same-connection order: the submits are queued
            queued = gw_b.batcher.queue_depth
        finally:
            server_b.stop_in_thread()
        answered = [c.collect(r)["score"] for c, rids in zip(drain_clients, pending) for r in rids]
        for c in drain_clients:
            c.close()
    k1 = launch_counts()["lstm_cell"]
    flushes = int(gw.stats()["counters"]["batch.flushes"] + gw_b.stats()["counters"]["batch.flushes"])
    if k1 != depth * t_len * flushes or score_captures(svc) != captures_oneshot:
        raise AssertionError(f"K1 launched {k1} times over {flushes} flushes of bucket {t_len}, "
                             f"expected {depth * t_len * flushes}; flush captures "
                             f"{captures_oneshot} after the one-shot passes, "
                             f"{score_captures(svc)} at the end")

    if queued != TRANSPORT_DRAIN_TICKETS or len(answered) != TRANSPORT_DRAIN_TICKETS:
        raise AssertionError(f"{queued} tickets queued before the drain, {len(answered)} answered")
    np.testing.assert_allclose(answered, direct[:TRANSPORT_DRAIN_TICKETS // 2].tolist() * 2,
                               rtol=CAPTURE_RTOL, atol=CAPTURE_ATOL)
    if gw_b.pool.captures != 1:
        raise AssertionError(f"the second server's pool step was captured {gw_b.pool.captures} "
                             f"times over {n_sess} restores")
    got = np.asarray(got, np.float32)
    if not np.array_equal(got, oracle):
        raise AssertionError(f"resumed streams differ from the uninterrupted run (max abs diff "
                             f"{float(np.max(np.abs(got - oracle))):.3g})")
    worst = 0.0
    for sid in range(0, n_sess, n_sess // GATEWAY_SAMPLED):
        sess = svc.stream_start(1)
        for t in range(t_len):
            errs, sess = svc.stream_step(streams[sid:sid + 1, t], sess)
            np.testing.assert_allclose(got[sid, t], float(errs[0]), rtol=CAPTURE_RTOL,
                                       atol=CAPTURE_ATOL)
            worst = max(worst, abs(float(got[sid, t]) - float(errs[0])))
    out.update(stream_resume_s=resume_s, replayed=sum(replayed), restore_recaptures=gw_b.pool.captures - 1,
               resumed_bit_equal=True, max_abs_diff_vs_solo=worst, drain_tickets=len(answered),
               k1_launches=k1, flushes=flushes)
    results["transport"] = out
    o = out["oneshot"]
    log(f"[transport] {GATEWAY_ARCH} [fused] capacity={GATEWAY_CAPACITY}, "
        f"max_batch={GATEWAY_MAX_BATCH}, behind GatewayServer on its own thread: "
        f"{GATEWAY_WINDOWS} one-shot windows of T={t_len} over bp1 in frames of 64 "
        f"{o['bp1_requests_per_s']:,.0f} requests/s (first pass, capturing the bucket on the "
        f"server's thread, {o['first_pass_s']:.3f} s), over JSON lines "
        f"{o['json_requests_per_s']:,.0f} requests/s, bit-equal to bp1; in-process gw.score of "
        f"the same windows {o['in_process_requests_per_s']:,.0f} requests/s [{card}]")
    stages = ", ".join(f"{k} {v:.3f}" for k, v in o["closed_loop_stage_p50_ms"].items())
    log(f"[transport] closed loop, {conns} bp1 connections of single-window requests: "
        f"{o['closed_loop_requests_per_s']:,.0f} requests/s, p50 {o['closed_loop_p50_ms']:.3f} ms, "
        f"p99 {o['closed_loop_p99_ms']:.3f} ms per request as the client sees it (traced; p50 "
        f"of each stage in ms: {stages}); socket scores "
        f"within {CAPTURE_RTOL} / {CAPTURE_ATOL} of in-process, bit-equal: "
        f"{o['bit_equal_to_in_process']} (max abs diff {o['max_abs_diff_vs_in_process']:.3g}) "
        f"[{card}]")
    log(f"[transport] streams: {n_sess} sessions on {n_sess} bp1 connections from "
        f"{TRANSPORT_THREADS} threads, {TRANSPORT_STEP_FRAME} samples a STEP frame: "
        f"{out['stream_steps_per_s']:,.0f} stream-steps/s over the socket against "
        f"{out['stream_steps_per_s_in_process']:,.0f} in-process (all {n_sess} in each pool "
        f"step); one pool step on the server p50 {out['pool_step_ms_p50']:.3f} ms; "
        f"{GATEWAY_SAMPLED} sampled sessions within {CAPTURE_RTOL} / {CAPTURE_ATOL} of "
        f"solo stream_step (max abs diff {worst:.3g}) [{card}]")
    log(f"[transport] durability: snapshot op of {out['snapshot']['sessions']} sessions, "
        f"{out['snapshot']['bytes']:,} bytes: device-to-host block copy "
        f"{out['snapshot']['copy_ms']:.3f} ms, write {out['snapshot']['write_ms']:.3f} ms; "
        f"{half} connections dropped (parked), the drain's handoff of {handoff['sessions']} "
        f"sessions copy {out['handoff']['copy_ms']:.3f} ms, write "
        f"{out['handoff']['write_ms']:.3f} ms; a second server on the store resumed all "
        f"{n_sess} by token ({sum(replayed)} steps replayed) and finished T={t_len}: every "
        f"running error bit-equal to the uninterrupted run; pool captures {gw_b.pool.captures} "
        f"(recaptures caused by {n_sess} restores: 0) [{card}]")
    log(f"[transport] drain: {TRANSPORT_DRAIN_TICKETS} tickets queued (max_wait_ms 3.6e6), "
        f"all answered by stop_in_thread; /metrics served the pool_step_ms, request_ms and "
        f"queue series; K1 launches over the phase {k1} = {depth} x {t_len} x {flushes} "
        f"flushes [{card}]")
    return gw, oneshot


def device_busy_over(torch, fn) -> dict:
    """Wall time of one ``fn()`` and the time the device was busy in it (the
    union of its kernels', copies' and memsets' intervals), from one
    ``torch.profiler`` pass."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3, "device_ops": len(spans),
            "idle_share": 1.0 - busy_us / 1e3 / wall_ms}


def profile_transport_flush(torch, gw, oneshot, results, card) -> None:
    """The transport phase's gateway (its bucket captured there) behind a
    new server, under the profiler: the bp1 pass of the phase (every window
    in frames of 64) once plain and once profiled, for the device's idle
    share over the pass and the windows per flush; then one flush, a bp1
    frame of max_batch windows, and the K1 kernels the device ran for it."""
    from repro_torch.gateway.client import GatewayClient
    from repro_torch.gateway.server import GatewayServer

    server = GatewayServer(gw)
    host, port = server.start_in_thread()
    try:
        with GatewayClient(host, port, protocol="binary") as c:
            def bp1_pass():
                c.score_many(oneshot, windows_per_frame=64)

            t0 = time.perf_counter()
            bp1_pass()
            plain_s = time.perf_counter() - t0
            flushes = gw.stats()["counters"]["batch.flushes"]
            busy = device_busy_over(torch, bp1_pass)
            pass_flushes = gw.stats()["counters"]["batch.flushes"] - flushes
            c.score_many(oneshot[:GATEWAY_MAX_BATCH], windows_per_frame=GATEWAY_MAX_BATCH)  # warm
            flushes = gw.stats()["counters"]["batch.flushes"]
            prof = host_launches(torch, lambda: c.score_many(oneshot[:GATEWAY_MAX_BATCH],
                                                             windows_per_frame=GATEWAY_MAX_BATCH))
            flushed = gw.stats()["counters"]["batch.flushes"] - flushes
    finally:
        server.stop_in_thread()
    busy.update(windows=len(oneshot), flushes=int(pass_flushes),
                windows_per_flush=len(oneshot) / pass_flushes,
                requests_per_s=len(oneshot) / (busy["wall_ms"] / 1e3),
                plain_requests_per_s=len(oneshot) / plain_s)
    results["transport"]["bp1_pass_profiled"] = busy
    depth, t_len = len(gw.engine.params["layers"]), oneshot[0].shape[0]
    in_graph = [p.launches.get("lstm_cell", 0) for key, p in gw.engine._graphs.programs.items()
                if key[0] == "score_masked"]
    if flushed != 1 or prof["k1_device_events"] != depth * t_len or in_graph != [depth * t_len]:
        raise AssertionError(f"one socket flush: {flushed} flushes, {prof['k1_device_events']} K1 "
                             f"kernels on the device, {in_graph} inside the graph; expected "
                             f"{depth * t_len}")
    results["transport"]["profiled_flush"] = prof
    log(f"[transport] the bp1 pass ({busy['windows']} windows in frames of 64) under the "
        f"profiler: {busy['wall_ms']:.3f} ms, the device busy {busy['device_busy_ms']:.3f} ms "
        f"(the union of {busy['device_ops']} kernels, copies and memsets), idle share "
        f"{busy['idle_share']:.4f}; {busy['flushes']} flushes of "
        f"{busy['windows_per_flush']:.2f} windows on average; "
        f"{busy['requests_per_s']:,.0f} requests/s profiled, {busy['plain_requests_per_s']:,.0f} "
        f"in the plain pass just before [{card}]")
    log(f"[transport] one flush over the socket (a bp1 frame of {GATEWAY_MAX_BATCH} windows) "
        f"under the profiler: the device ran {prof['k1_device_events']} K1 kernels = {depth} x "
        f"{t_len}, as the flush graph records; device busy {prof['device_busy_ms']:.3f} ms "
        f"[{card}]")


def wkv_inputs(torch, b, t_len, h, hd, dtype, seed, zero_state=False, rwkv_decay=False):
    """Drawn as tests/test_kernels.py::test_wkv6_kernel_sweep draws them; with
    ``rwkv_decay`` the decays are drawn as the RWKV layer makes them
    (src/repro/layers/rwkv.py: w = exp(-exp(-6 + ...))), near 1."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    r, k, v = ((randn(b, t_len, h, hd) * 0.3).to(dtype) for _ in range(3))
    w_in = randn(b, t_len, h, hd)
    w = torch.exp(-torch.exp(-6.0 + 0.5 * w_in)) if rwkv_decay else torch.sigmoid(w_in)
    u = randn(h, hd) * 0.1
    s0 = torch.zeros(b, h, hd, hd, device="cuda") if zero_state else randn(b, h, hd, hd) * 0.1
    return r, k, v, w, u, s0


def split_time(args, t_split):
    """The (r, k, v, w) streams of ``args`` cut at ``t_split``: two contiguous halves."""
    return [tuple(t[:, sl].contiguous() for t in args[:4])
            for sl in (slice(0, t_split), slice(t_split, None))]


def check_k3(torch, results) -> None:
    from repro_torch.kernels.wkv6 import wkv6_cuda, wkv6_plain

    cases = [(2, t, h, hd) for t, hd, h in WKV_SWEEP] + [(RWKV_B, RWKV_T, RWKV_H, RWKV_HD)]
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n = 0
    for b, t_len, h, hd in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = wkv_inputs(torch, b, t_len, h, hd, dtype, seed=3000 + n)
            y, s = wkv6_cuda(*args)
            torch.cuda.synchronize()
            yp, sp = wkv6_plain(*args)
            if y.dtype != torch.float32 or s.dtype != torch.float32:
                raise AssertionError(f"K3 output dtypes {y.dtype}, {s.dtype}")
            tol = WKV_F32_TOL if dtype == torch.float32 else WKV_BF16_TOL
            for got, want in ((y, yp), (s, sp)):
                torch.testing.assert_close(got, want, rtol=tol, atol=tol)
                err[dtype] = max(err[dtype], float((got - want).abs().max()))
            n += 1
    # decays drawn as the RWKV layer makes them, near 1, at full width
    for dtype in (torch.float32, torch.bfloat16):
        args = wkv_inputs(torch, RWKV_B, RWKV_T, RWKV_H, RWKV_HD, dtype, seed=3000 + n,
                          rwkv_decay=True)
        y, s = wkv6_cuda(*args)
        torch.cuda.synchronize()
        yp, sp = wkv6_plain(*args)
        tol = WKV_F32_TOL if dtype == torch.float32 else WKV_BF16_TOL
        for got, want in ((y, yp), (s, sp)):
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
            err[dtype] = max(err[dtype], float((got - want).abs().max()))
        n += 1
    # chunk chaining: two launches with the state handed through == one launch
    for b, t_len, h, hd in ((2, 32, 2, 16), (RWKV_B, RWKV_T, RWKV_H, RWKV_HD)):
        args = wkv_inputs(torch, b, t_len, h, hd, torch.float32, seed=3100 + n, zero_state=True)
        first, second = split_time(args, t_len // 2)
        y1, s1 = wkv6_cuda(*first, *args[4:])
        y2, s2 = wkv6_cuda(*second, args[4], s1)
        y, s = wkv6_cuda(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(s2, s, rtol=1e-4, atol=1e-5)
        n += 1
    results["k3_checks"] = n
    results["k3_max_abs_err_f32"] = err[torch.float32]
    results["k3_max_abs_err_bf16"] = err[torch.bfloat16]
    log(f"[k3] {n} checks passed: the sweep {list(WKV_SWEEP)} (T, hd, H) at B=2 and rwkv6-7b's "
        f"heads (B={RWKV_B}, T={RWKV_T}, H={RWKV_H}, hd={RWKV_HD}) x (f32, bf16), there also with "
        f"the RWKV layer's decays, against the plain "
        f"version, max abs err f32 {err[torch.float32]:.3g} (tol {WKV_F32_TOL}), bf16 "
        f"{err[torch.bfloat16]:.3g} (tol {WKV_BF16_TOL}); two chained launches equal one at "
        f"(2, 32, 2, 16) and at full width")


def time_k3(torch, results, card) -> dict:
    """K3 at rwkv6-7b's heads, train_4k's T, f32: alone at each B of
    RWKV_B_SWEEP beside its bound and FP32 issue floor, then at RWKV_B
    beside the plain version too (no single PyTorch call computes WKV-6),
    with the SM clock and power under load, and with bf16 r, k, v."""
    from repro_torch.kernels.wkv6 import wkv6_cuda, wkv6_plain, wkv6_tile

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tile = {name: wkv6_tile(RWKV_HD, dtype) for name, dtype in (("f32", torch.float32),
                                                                ("bf16", torch.bfloat16))}
    results["k3_tile"] = tile
    heads_per_wave = tile["f32"]["blocks_per_sm"] * tile["f32"]["heads_per_block"] * sms
    for name, t in tile.items():
        heads_per_sm = t["blocks_per_sm"] * t["heads_per_block"]
        log(f"[k3 tile] hd={RWKV_HD} {name}: S {t['rows']} x {t['cols']} a thread, "
            f"{t['threads_per_head']} threads a head, {t['heads_per_block']} heads "
            f"({t['threads_per_block']} threads, {t['smem_bytes']} B shared) a block, "
            f"{t['blocks_per_sm']} blocks ({heads_per_sm} heads) resident per SM on {sms} SMs, "
            f"a wave {heads_per_sm * sms} heads; stages of {t['chunk']} steps, {t['stages']} deep")
    sweep = []
    for b in RWKV_B_SWEEP:
        args = wkv_inputs(torch, b, RWKV_T, RWKV_H, RWKV_HD, torch.float32, seed=3250 + b)
        flops, nbytes = k3_bound(b, RWKV_T, RWKV_H, RWKV_HD)
        ms = device_ms(torch, lambda: wkv6_cuda(*args), iters=5, reps=3)
        bound = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
        sweep.append({"batch": b, "heads": b * RWKV_H, "waves": b * RWKV_H / heads_per_wave,
                      "kernel_ms": ms, "bound_ms": bound,
                      "issue_floor_ms": k3_issue_floor_ms(b, RWKV_T, RWKV_H, RWKV_HD, sms),
                      "ns_per_step_per_head": ms * 1e6 / (b * RWKV_H * RWKV_T)})
        del args
    results["k3_batch_sweep"] = sweep
    log(f"[k3 time] B sweep at T={RWKV_T}, H={RWKV_H}, hd={RWKV_HD}, f32: " + "; ".join(
            f"B={r['batch']} ({r['heads']} heads, {r['waves']:.2f} waves) {r['kernel_ms']:.4f} ms, "
            f"{r['kernel_ms'] / r['bound_ms']:.2f}x its {r['bound_ms']:.4f} ms bound, "
            f"{r['issue_floor_ms'] / r['kernel_ms']:.2f} of the {r['issue_floor_ms']:.4f} ms "
            f"FP32 issue floor, {r['ns_per_step_per_head']:.4f} ns per (b, h, t)"
            for r in sweep) + f" [{card}]")
    args = wkv_inputs(torch, RWKV_B, RWKV_T, RWKV_H, RWKV_HD, torch.float32, seed=3200)
    flops, nbytes = k3_bound(RWKV_B, RWKV_T, RWKV_H, RWKV_HD)
    row = {"batch": RWKV_B, "t": RWKV_T, "heads": RWKV_H, "head_dim": RWKV_HD, "dtype": "f32",
           "flop": flops, "bytes": nbytes,
           "kernel_ms": device_ms(torch, lambda: wkv6_cuda(*args), iters=10, reps=5),
           "kernel_host_ms": host_ms(torch, lambda: wkv6_cuda(*args), iters=10),
           "plain_ms": device_ms(torch, lambda: wkv6_plain(*args), iters=1, reps=2),
           "library_ms": None, "tile": tile["f32"],
           "issue_floor_ms": k3_issue_floor_ms(RWKV_B, RWKV_T, RWKV_H, RWKV_HD, sms),
           "under_load": clocks_under_load(torch, lambda: wkv6_cuda(*args), iters=100),
           "ops_ms": flops / PEAK_F32_FLOPS * 1e3, "bytes_ms": nbytes / PEAK_BYTES * 1e3}
    row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
    row["bound_by"] = "operations" if row["ops_ms"] >= row["bytes_ms"] else "bytes"
    del args
    args = wkv_inputs(torch, RWKV_B, RWKV_T, RWKV_H, RWKV_HD, torch.bfloat16, seed=3201)
    row["kernel_bf16_ms"] = device_ms(torch, lambda: wkv6_cuda(*args), iters=10, reps=5)
    flops16, bytes16 = k3_bound(RWKV_B, RWKV_T, RWKV_H, RWKV_HD, s=2)
    row["bound_bf16_ms"] = max(flops16 / PEAK_F32_FLOPS, bytes16 / PEAK_BYTES) * 1e3
    results["k3_time"] = row
    log(f"[k3 time] rwkv6-7b heads, B={RWKV_B}, T={RWKV_T}, H={RWKV_H}, hd={RWKV_HD}, f32: kernel "
        f"{row['kernel_ms']:.4f} ms (device), {row['kernel_host_ms']:.4f} ms per call on the host; "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; {flops:.4g} FLOP -> "
        f"{row['ops_ms']:.4f} ms, {nbytes:.4g} B -> {row['bytes_ms']:.4f} ms); "
        f"{row['issue_floor_ms'] / row['kernel_ms']:.2f} of its {row['issue_floor_ms']:.4f} ms FP32 "
        f"issue floor (3 instructions per state element) at {SM_CLOCK_HZ / 1e6:.0f} MHz, while "
        f"nvidia-smi read {row['under_load']['sm_mhz']:.0f} MHz and {row['under_load']['power_w']:.1f} W "
        f"under load; plain {row['plain_ms']:.2f} ms; no "
        f"library call; bf16 r, k, v {row['kernel_bf16_ms']:.4f} ms (bound "
        f"{row['bound_bf16_ms']:.4f} ms) [{card}]")
    return row


def drive_k3_path(torch, results, card) -> int:
    """K3's path: ``ops.wkv6_op`` at full width, once whole and once as a
    chained pair; the pair must equal the whole, and batch row 0 the plain
    version."""
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts, wkv6_op
    from repro_torch.kernels.wkv6 import wkv6_plain

    args = wkv_inputs(torch, RWKV_B, RWKV_T, RWKV_H, RWKV_HD, torch.float32, seed=3300)
    first, second = split_time(args, RWKV_T // 2)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    y, s = wkv6_op(*args)
    y1, s1 = wkv6_op(*first, *args[4:])
    y2, s2 = wkv6_op(*second, args[4], s1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    if counts != {"lstm_cell": 0, "lstm_seq": 0, "wkv6": 3, "flash_attention": 0}:
        raise AssertionError(f"K3 path launched {counts}, expected 3 wkv6 launches")
    if not (torch.isfinite(y).all() and torch.isfinite(s).all()):
        raise AssertionError("K3 path produced non-finite values")
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(s2, s, rtol=1e-4, atol=1e-5)
    yp, sp = wkv6_plain(*(t[:1] for t in args[:4]), args[4], args[5][:1])
    torch.testing.assert_close(y[:1], yp, rtol=WKV_F32_TOL, atol=WKV_F32_TOL)
    torch.testing.assert_close(s[:1], sp, rtol=WKV_F32_TOL, atol=WKV_F32_TOL)
    err = max(float((y[:1] - yp).abs().max()), float((s[:1] - sp).abs().max()))
    results["k3_path"] = {"launches": counts["wkv6"], "ms": dt * 1e3, "max_abs_err_row0": err}
    log(f"[k3 path] wkv6_op at B={RWKV_B}, T={RWKV_T}, H={RWKV_H}, hd={RWKV_HD}, f32, whole and "
        f"as a chained pair: {counts['wkv6']} K3 launches, {dt*1e3:.2f} ms on the host clock; the "
        f"pair equals the whole, batch row 0 agrees with the plain version (max abs err "
        f"{err:.3g}, tol {WKV_F32_TOL}) [{card}]")
    return counts["wkv6"]


def attention_inputs(torch, b, h, s_len, sk_len, d, dtype, seed, kv_heads=None):
    """q (B,H,S,d), k/v (B,H,Sk,d), standard normal; with ``kv_heads`` k and
    v are drawn with that many heads and expanded to H as ``_expand_kv`` does."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, h, s_len, d, generator=g, device="cuda").to(dtype)
    hk = kv_heads or h
    k, v = (torch.randn(b, hk, sk_len, d, generator=g, device="cuda").to(dtype)
            .repeat_interleave(h // hk, dim=1) for _ in range(2))
    return q, k, v


def check_wide(torch, got, want, dtype) -> dict:
    """Hold a K4 output (..., d) to the plain version's at ATTN_WIDE_TOL;
    raises past the limit, else returns the max abs error, the largest share
    of the limit any element used and the largest error over its row's rms."""
    rtol, atol, row = ATTN_WIDE_TOL["f32" if dtype == torch.float32 else "bf16"]
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    share = float((diff / (atol + row * rms + rtol * want.abs())).max())
    if not share <= 1.0:
        raise AssertionError(f"K4 output off by {share:.3g} of the limit (rtol, atol, row) = "
                             f"{(rtol, atol, row)}; max abs err {float(diff.max()):.3g}")
    return {"max_abs_err": float(diff.max()), "limit_share": share,
            "max_err_over_row_rms": float((diff / rms).max())}


def offset_view(torch, t):
    """The same values as ``t`` (..., d), one element into rows of d + 1:
    data pointer 4 bytes off 16 for f32, row stride d + 1."""
    wide = torch.zeros(*t.shape[:-1], t.shape[-1] + 1, dtype=t.dtype, device=t.device)
    wide[..., 1:] = t
    return wide[..., 1:]


def check_k4(torch, results) -> None:
    from repro_torch.kernels.flash_attention import (
        copy_path,
        flash_attention_cuda,
        flash_attention_plain,
        kernel_name,
    )

    cases = [(2, 3, s, s, d) for s, d in ATTN_SWEEP] + [(2, 3, s, sk, d) for s, sk, d in ATTN_EXTRA]
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    paths = {}   # (dtype, copy path) -> checks
    n = 0
    for b, h, s_len, sk_len, d in cases:
        for causal in (True, False):
            for dtype, offset in ((torch.float32, False), (torch.bfloat16, False),
                                  (torch.float32, True)):
                if offset and (s_len, sk_len, d) not in ATTN_EXTRA:
                    continue
                q, k, v = attention_inputs(torch, b, h, s_len, sk_len, d, dtype, seed=4000 + n)
                out = torch.empty_like(q)
                if offset:   # f32 views 4 bytes off 16, rows of d + 1: the 4-byte copy path
                    q, k, v, out = (offset_view(torch, t) for t in (q, k, v, out))
                out = flash_attention_cuda(q, k, v, causal=causal, out=out)
                torch.cuda.synchronize()
                want = flash_attention_plain(q, k, v, causal=causal)
                if out.dtype != dtype:
                    raise AssertionError(f"K4 output dtype {out.dtype}, expected {dtype}")
                tol = ATTN_F32_TOL if dtype == torch.float32 else ATTN_BF16_TOL
                torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
                err[dtype] = max(err[dtype], float((out.float() - want.float()).abs().max()))
                key = ("f32" if dtype == torch.float32 else "bf16", copy_path(q, k, v, out))
                paths[key] = paths.get(key, 0) + 1
                n += 1
    if ("f32", "4-byte cp.async") not in paths or ("f32", "16-byte cp.async") not in paths:
        raise AssertionError(f"K4 f32 checks covered only the copy paths {sorted(paths)}")
    sweep_err = dict(err)
    # full width, causal: the plain version one batch row at a time, at
    # limits scaled to the late rows' small outputs
    wide = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = attention_inputs(torch, PHI_B, PHI_H, PHI_S, PHI_S, PHI_HD, dtype,
                                   seed=4100 + n, kv_heads=PHI_KV_H)
        out = flash_attention_cuda(q, k, v, causal=True)
        torch.cuda.synchronize()
        name = "f32" if dtype == torch.float32 else "bf16"
        w = wide[name] = {"max_abs_err": 0.0, "limit_share": 0.0, "max_err_over_row_rms": 0.0,
                          "mean_abs_out": 0.0, "rtol_atol_row": ATTN_WIDE_TOL[name],
                          "copy_path": copy_path(q, k, v, out)}
        for row in range(PHI_B):
            want = flash_attention_plain(q[row:row + 1], k[row:row + 1], v[row:row + 1], causal=True)
            got = check_wide(torch, out[row:row + 1], want, dtype)
            for key, val in got.items():
                w[key] = max(w[key], val)
            w["mean_abs_out"] += float(want.float().abs().mean()) / PHI_B
        paths[(name, w["copy_path"])] = paths.get((name, w["copy_path"]), 0) + 1
        err[dtype] = max(err[dtype], w["max_abs_err"])
        n += 1
    results["k4_checks"] = n
    results["k4_max_abs_err_f32"] = err[torch.float32]
    results["k4_max_abs_err_bf16"] = err[torch.bfloat16]
    results["k4_wide_check"] = wide
    results["k4_copy_paths"] = {f"{dt} {path}": count for (dt, path), count in sorted(paths.items())}
    results["k4_kernels"] = {
        f"{'f32' if dtype == torch.float32 else 'bf16'} d={d}": kernel_name(dtype, d, True)
        for dtype in (torch.float32, torch.bfloat16) for d in (64, 128)}
    for key, val in results["k4_kernels"].items():
        log(f"[k4] {key} (causal; the same kernel without the mask otherwise) is served by {val}")
    log("[k4] copy paths that served the checks: " + ", ".join(
        f"{key}: {count}" for key, count in results["k4_copy_paths"].items()))
    log(f"[k4] {n} checks passed against the plain version (top-left causal mask): (B, H, S, Sk, "
        f"d) in {cases} x causal on/off x (f32, bf16), and f32 on views 4 bytes off 16 at "
        f"{list(ATTN_EXTRA)}, max abs err f32 "
        f"{sweep_err[torch.float32]:.3g} (tol {ATTN_F32_TOL}), bf16 "
        f"{sweep_err[torch.bfloat16]:.3g} (tol {ATTN_BF16_TOL}); and phi4-mini-3.8b's heads "
        f"(B={PHI_B}, H={PHI_H} from {PHI_KV_H} kv heads, S=Sk={PHI_S}, d={PHI_HD}), causal: "
        + "; ".join(f"{k} ({w['copy_path']}) max abs err {w['max_abs_err']:.3g}, at most "
                    f"{w['max_err_over_row_rms']:.3g} of its row's rms and {w['limit_share']:.3f} "
                    f"of the limit (rtol, atol, row) {w['rtol_atol_row']}; mean |o| "
                    f"{w['mean_abs_out']:.4f}" for k, w in wide.items()))


def device_kernels(torch, fn) -> list[str]:
    """Names of the device kernels one ``fn()`` call runs, from one
    ``torch.profiler`` pass; raises if the pass sees none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    if not names:
        raise AssertionError("torch.profiler saw no device kernel in its pass")
    return names


def time_k4(torch, results, card) -> dict:
    """K4 at phi4-mini-3.8b's heads, S=Sk=4096, B=4, causal, per dtype,
    beside its bound, the plain version and scaled_dot_product_attention.
    The f32 path runs three TF32 tensor-core products per product, so its
    bound is 3 x the FLOP at the TF32 rate; the FP32-core bound (1 x at the
    FP32 rate) is logged beside it."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        copy_path,
        flash_attention_cuda,
        flash_attention_plain,
        kernel_name,
    )

    rows = {}
    for dtype, name, peak, passes in ((torch.bfloat16, "bf16", PEAK_BF16_FLOPS, 1),
                                      (torch.float32, "f32", PEAK_TF32_FLOPS, 3)):
        q, k, v = attention_inputs(torch, PHI_B, PHI_H, PHI_S, PHI_S, PHI_HD, dtype, seed=4200,
                                   kv_heads=PHI_KV_H)
        flops, nbytes, pairs = k4_bound(PHI_B, PHI_H, PHI_S, PHI_S, PHI_HD, True, q.element_size())

        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)

        out = flash_attention_cuda(q, k, v, causal=True)
        lib_out = library()
        torch.cuda.synchronize()
        tol = ATTN_F32_TOL if dtype == torch.float32 else ATTN_BF16_TOL
        # the same function (PyTorch's is_causal is top-left too)
        torch.testing.assert_close(lib_out.float(), out.float(), rtol=tol, atol=tol)
        row = {"batch": PHI_B, "heads": PHI_H, "s": PHI_S, "sk": PHI_S, "head_dim": PHI_HD,
               "dtype": name, "causal": True, "pairs": pairs, "flop": flops, "bytes": nbytes,
               "max_abs_diff_vs_library": float((lib_out.float() - out.float()).abs().max()),
               "copy_path": copy_path(q, k, v, out),
               "kernel_ms": device_ms(torch, lambda: flash_attention_cuda(q, k, v, causal=True),
                                      iters=3, reps=3),
               "kernel_host_ms": host_ms(torch, lambda: flash_attention_cuda(q, k, v, causal=True),
                                         iters=3),
               "plain_ms": device_ms(torch, lambda: flash_attention_plain(q, k, v, causal=True),
                                     iters=1, reps=2),
               "library_ms": device_ms(torch, library, iters=5, reps=3),
               "library_kernels": device_kernels(torch, library),
               "ops_ms": passes * flops / peak * 1e3, "bytes_ms": nbytes / PEAK_BYTES * 1e3,
               "fp32_core_ops_ms": flops / PEAK_F32_FLOPS * 1e3}
        del lib_out, out
        row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
        row["bound_by"] = "operations" if row["ops_ms"] >= row["bytes_ms"] else "bytes"
        row["kernel"] = kernel_name(dtype, PHI_HD, True)
        row["tflops"] = flops / row["kernel_ms"] * 1e-9
        row["library_tflops"] = flops / row["library_ms"] * 1e-9
        rows[name] = row
        log(f"[k4 time] phi4-mini-3.8b heads, B={PHI_B}, H={PHI_H}, S=Sk={PHI_S}, d={PHI_HD}, "
            f"causal, {name}, served by {row['kernel']} ({row['copy_path']}): kernel "
            f"{row['kernel_ms']:.4f} ms "
            f"(device), {row['tflops']:.1f} TFLOP/s, "
            f"{row['kernel_host_ms']:.4f} ms per call on the host; bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}; {pairs} visible pairs, {passes} x {flops:.4g} FLOP at "
            f"{peak/1e12:g} TFLOP/s -> {row['ops_ms']:.4f} ms, {nbytes:.4g} B -> "
            f"{row['bytes_ms']:.4f} ms; on the FP32 cores {row['fp32_core_ops_ms']:.4f} ms); "
            f"plain {row['plain_ms']:.3f} ms; scaled_dot_product_attention "
            f"{row['library_ms']:.4f} ms, {row['library_tflops']:.1f} TFLOP/s (max abs diff to the kernel "
            f"{row['max_abs_diff_vs_library']:.3g}), running {row['library_kernels']} [{card}]")
    results["k4_time"] = rows
    return rows["bf16"]


def drive_k4_path(torch, results, card) -> int:
    """K4's path: ``ops.flash_attention_op`` on (B, S, H, d) bf16 tensors at
    phi4-mini-3.8b's heads, S=4096, B=4, causal; batch row 0 must agree
    with the plain version."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.ops import flash_attention_op, launch_counts, reset_launch_counts

    q, k, v = (t.transpose(1, 2).contiguous() for t in attention_inputs(
        torch, PHI_B, PHI_H, PHI_S, PHI_S, PHI_HD, torch.bfloat16, seed=4300, kv_heads=PHI_KV_H))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = flash_attention_op(q, k, v, causal=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    if counts != {"lstm_cell": 0, "lstm_seq": 0, "wkv6": 0, "flash_attention": 1}:
        raise AssertionError(f"K4 path launched {counts}, expected 1 flash_attention launch")
    if out.shape != q.shape or out.dtype != q.dtype or not torch.isfinite(out.float()).all():
        raise AssertionError(f"K4 path gave {out.shape} {out.dtype} or non-finite values")
    if not out.is_contiguous():
        raise AssertionError("flash_attention_op returned a non-contiguous (B, S, H, d) tensor")
    want = flash_attention_plain(*(t[:1].transpose(1, 2) for t in (q, k, v)), causal=True)
    got = check_wide(torch, out[:1].transpose(1, 2), want, torch.bfloat16)
    err, share = got["max_abs_err"], got["limit_share"]
    results["k4_path"] = {"launches": counts["flash_attention"], "ms": dt * 1e3,
                          "max_abs_err_row0": err, "limit_share_row0": share}
    log(f"[k4 path] flash_attention_op on (B, S, H, d) = ({PHI_B}, {PHI_S}, {PHI_H}, {PHI_HD}) "
        f"bf16, causal: {counts['flash_attention']} K4 launch, {dt*1e3:.2f} ms on the host clock "
        f"(first call at this shape); batch row 0 agrees with the plain version (max abs err "
        f"{err:.3g}, {share:.3f} of the limit (rtol, atol, row) {ATTN_WIDE_TOL['bf16']} at "
        f"most) [{card}]")
    return counts["flash_attention"]


def time_k1(torch, b: int, results, card, tag: str = "") -> dict:
    """K1 at the main path's shapes: every layer of lstm-ae-f64-d6 at batch b,
    f32; the rows land in ``results["k1_layers" + tag]``, the sum over the
    six layers in ``results["k1_timestep" + tag]``."""
    from repro_torch.config import get_config
    from repro_torch.kernels.lstm_cell import lstm_cell_cuda, lstm_cell_plain, lstm_cell_tile

    ae = get_config("lstm-ae-f64-d6").lstm_ae
    rows = []
    for li, (in_dim, hidden) in enumerate(zip(ae.layer_input_sizes(), ae.layer_sizes())):
        x, h, c, wx, wh, bias = cell_inputs(torch, b, in_dim, hidden, torch.float32, seed=1000 + li)
        h_out, c_out = torch.empty_like(h), torch.empty_like(c)
        w_ih = wx.permute(0, 2, 1).reshape(4 * hidden, in_dim).contiguous()
        w_hh = wh.permute(0, 2, 1).reshape(4 * hidden, hidden).contiguous()
        b_ih, b_hh = bias.reshape(4 * hidden).contiguous(), torch.zeros(4 * hidden, device="cuda")
        hl, cl = torch.lstm_cell(x, (h, c), w_ih, w_hh, b_ih, b_hh)
        hp, cp = lstm_cell_plain(x, h, c, wx, wh, bias)
        torch.testing.assert_close(hl, hp, rtol=F32_TOL, atol=F32_TOL)   # same function
        torch.testing.assert_close(cl, cp, rtol=F32_TOL, atol=F32_TOL)
        flops, nbytes = k1_bound(b, in_dim, hidden)
        row = {
            "in": in_dim, "hidden": hidden, "batch": b, "flop": flops, "bytes": nbytes,
            "tile": lstm_cell_tile(b, hidden),
            "kernel_ms": device_ms(torch, lambda: lstm_cell_cuda(x, h, c, wx, wh, bias,
                                                                 h_out=h_out, c_out=c_out)),
            "kernel_host_ms": host_ms(torch, lambda: lstm_cell_cuda(x, h, c, wx, wh, bias,
                                                                    h_out=h_out, c_out=c_out)),
            "plain_ms": device_ms(torch, lambda: lstm_cell_plain(x, h, c, wx, wh, bias)),
            "library_ms": device_ms(torch, lambda: torch.lstm_cell(x, (h, c), w_ih, w_hh, b_ih, b_hh)),
            "ops_ms": flops / PEAK_F32_FLOPS * 1e3,
            "bytes_ms": nbytes / PEAK_BYTES * 1e3,
        }
        row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
        rows.append(row)
        log(f"[k1 time] f64-d6 layer {li} (In={in_dim}, H={hidden}, B={b}, f32, tile "
            f"{row['tile'][0]} rows x {row['tile'][1]} units): "
            f"kernel {row['kernel_ms']:.5f} ms (device), {row['kernel_host_ms']:.5f} ms per call "
            f"in a Python loop; plain {row['plain_ms']:.5f} ms; torch.lstm_cell "
            f"{row['library_ms']:.5f} ms; bound {row['bound_ms']:.5f} ms "
            f"({'operations' if row['ops_ms'] >= row['bytes_ms'] else 'bytes'}) [{card}]")
    ops = sum(r["ops_ms"] for r in rows)
    mem = sum(r["bytes_ms"] for r in rows)
    total = {k: sum(r[k] for r in rows) for k in ("kernel_ms", "kernel_host_ms", "plain_ms",
                                                   "library_ms", "flop", "bytes")}
    total["bound_ms"] = max(ops, mem)
    total["bound_by"] = "operations" if ops >= mem else "bytes"
    results["k1_layers" + tag] = rows
    results["k1_timestep" + tag] = total
    log(f"[k1 time] one timestep of lstm-ae-f64-d6 at B={b} (6 launches): kernel "
        f"{total['kernel_ms']:.5f} ms, {total['kernel_host_ms']:.5f} ms per 6 calls in a Python "
        f"loop, plain {total['plain_ms']:.5f} ms, torch.lstm_cell {total['library_ms']:.5f} ms, "
        f"bound {total['bound_ms']:.5f} ms ({total['bound_by']}; {total['flop']:.4g} FLOP, "
        f"{total['bytes']:.4g} B) [{card}]")
    return total


def host_launches(torch, fn) -> dict:
    """The launch calls (kernels, graphs, copies, memsets) the host makes in
    one ``fn()``, by CUDA API name, and the kernels, copies and memsets the
    device ran with their summed time (ms), K1's among them by kernel name
    (those inside a replayed graph too), from one ``torch.profiler``
    pass."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    calls: dict = {}
    device, k1, busy_us = 0, 0, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device += 1
            k1 += K1_KERNEL in e.name
            busy_us += e.time_range.elapsed_us()
        elif e.name in LAUNCH_CALLS:
            calls[e.name] = calls.get(e.name, 0) + 1
    return {"host_calls": calls, "host_total": sum(calls.values()), "device_ops": device,
            "k1_device_events": k1, "device_busy_ms": busy_us / 1e3}


def k1_in_graph(engine, name: str) -> list[int]:
    """K1 launches recorded in each captured graph of program ``name``."""
    return [p.launches.get("lstm_cell", 0) for key, p in engine._graphs.programs.items()
            if key[0] == name]


def drive_service(torch, arch: str, batch: int, seq_len: int, requests: int, results, card):
    """Serve ``arch`` on every single-GPU schedule; check the kernel path's
    launch count and its agreement with the other schedules and the CPU;
    then the fused path captured against the same path run eagerly."""
    from repro_torch.data import TimeseriesConfig, make_batch
    from repro_torch.engine import AnomalyService, EngineConfig
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.utils import params_to_numpy

    fused = AnomalyService(arch, schedule="fused", device="cuda", seed=0)
    feats, depth = fused.features, len(fused.cfg.lstm_ae.layer_sizes())
    data_cfg = TimeseriesConfig(features=feats, seq_len=seq_len, batch=batch, anomaly_rate=0.05)
    series = [make_batch(data_cfg, i)[0] for i in range(requests)]
    threshold = fused.calibrate(TimeseriesConfig(features=feats, seq_len=seq_len, batch=batch))

    torch.cuda.synchronize()
    h2d = host_ms(torch, lambda: series[0].to("cuda"), iters=5)
    out = {"arch": arch, "batch": batch, "seq_len": seq_len, "requests": requests,
           "threshold": threshold, "h2d_ms": h2d, "schedules": {}}
    scores = {}
    eager = AnomalyService(arch, schedule=EngineConfig("fused", jit=False), device="cuda", seed=0)
    services = {"fused": fused, "fused-eager": eager}
    for name in ("fused", "fused-eager", "sequential", "wavefront"):
        svc = services.get(name)
        if svc is None:
            svc = AnomalyService(arch, schedule=name, device="cuda", seed=0)
        if svc is not fused:
            svc.recalibrate(params=fused.params, threshold=threshold)
            svc.score(series[0]).cpu()   # warm-up (the capture, where it captures)
        replays = 0 if svc.engine._graphs is None else svc.engine._graphs.replays
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        scores[name] = [svc.score(s).cpu() for s in series]
        dt = time.perf_counter() - t0
        launches = launch_counts()["lstm_cell"]
        want = requests * depth * seq_len if name.startswith("fused") else 0
        if launches != want:
            raise AssertionError(f"{arch} [{name}]: K1 launched {launches} times, expected {want}")
        alerts = sum(int((s > threshold).sum()) for s in scores[name])
        ms = dt / requests * 1e3
        rate = requests * batch * seq_len / dt
        row = out["schedules"][name] = {"ms_per_request": ms, "timesteps_per_s": rate,
                                        "k1_launches": launches, "alerts": alerts}
        how = "eager"
        if svc.engine._graphs is not None:
            row["replays"] = svc.engine._graphs.replays - replays
            row["k1_in_graph"] = k1_in_graph(svc.engine, "score")
            if row["replays"] != requests:
                raise AssertionError(f"{arch} [{name}]: {row['replays']} graph replays for "
                                     f"{requests} requests")
            how = f"{row['replays']} graph replays, K1 launches inside the graph {row['k1_in_graph']}"
        log(f"[serve] {arch} [{name}] B={batch} T={seq_len}: {requests} requests, "
            f"{ms:.3f} ms/request, {rate:,.0f} timesteps/s, K1 launches {launches} ({how}), "
            f"alerts={alerts} [{card}]")
        if name == "fused":
            out["k1_launches"] = launches
    # the fused path captured against eager: the same requests with the
    # input already on the card (outside the counted run)
    on_card = [s.to("cuda") for s in series]
    for name in ("fused", "fused-eager"):
        svc = services[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in on_card:
            svc.score(s).cpu()
        row = out["schedules"][name]
        row["ms_per_request_input_on_card"] = (time.perf_counter() - t0) / requests * 1e3
        log(f"[serve] {arch} [{name}] with the input already on the card: "
            f"{row['ms_per_request_input_on_card']:.3f} ms/request [{card}]")
    out["fused_ms_per_request_input_on_card"] = out["schedules"]["fused"][
        "ms_per_request_input_on_card"]
    graph_k1 = out["schedules"]["fused"]["k1_in_graph"]
    if graph_k1 != [depth * seq_len]:
        raise AssertionError(f"{arch}: the fused score graphs hold {graph_k1} K1 launches, "
                             f"expected one graph of {depth * seq_len}")
    for name in ("sequential", "wavefront"):
        for got, want in zip(scores["fused"], scores[name]):
            torch.testing.assert_close(got, want, rtol=SCHEDULE_RTOL, atol=SCHEDULE_ATOL)
    for got, want in zip(scores["fused"], scores["fused-eager"]):
        torch.testing.assert_close(got, want, rtol=CAPTURE_RTOL, atol=CAPTURE_ATOL)
    out["captured_vs_eager"] = {
        "max_abs_diff": max(float((a - b).abs().max())
                            for a, b in zip(scores["fused"], scores["fused-eager"])),
        "bit_equal": all(torch.equal(a, b) for a, b in zip(scores["fused"], scores["fused-eager"]))}
    log(f"[serve] {arch} [fused]: captured and eager scores agree (max abs diff "
        f"{out['captured_vs_eager']['max_abs_diff']:.3g}; rtol {CAPTURE_RTOL}, atol "
        f"{CAPTURE_ATOL}), bit-equal: {out['captured_vs_eager']['bit_equal']}; {graph_k1[0]} K1 "
        f"launches inside the one score graph [{card}]")
    rows = min(batch, 256)
    cpu = AnomalyService(arch, schedule="fused", device="cpu", seed=0)
    cpu.recalibrate(params=params_to_numpy(fused.params))
    cpu_scores = cpu.score(series[0][:rows])
    torch.testing.assert_close(scores["fused"][0][:rows], cpu_scores,
                               rtol=SCHEDULE_RTOL, atol=SCHEDULE_ATOL)
    err = max(float((scores["fused"][0] - scores[n][0]).abs().max()) for n in ("sequential", "wavefront"))
    out["max_abs_score_diff_vs_other_schedules"] = err
    out["max_abs_score_diff_vs_cpu"] = float((scores["fused"][0][:rows] - cpu_scores).abs().max())
    log(f"[serve] {arch}: fused scores agree with sequential and wavefront (max abs diff "
        f"{err:.3g}) and with the CPU path on {rows} rows (max abs diff "
        f"{out['max_abs_score_diff_vs_cpu']:.3g}); rtol {SCHEDULE_RTOL}, atol {SCHEDULE_ATOL}; "
        f"host-to-device copy of one request {h2d:.3f} ms")
    results.setdefault("serve", []).append(out)
    return fused, eager, series[0]


def compare_launches(torch, arch, fused, eager, request, out, card) -> None:
    """The launch calls the host makes for one fused request with the input
    on the card, captured against eager, and the [capture] summary.  Run
    after every other phase: its profiler passes come last."""
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts

    want = len(fused.cfg.lstm_ae.layer_sizes()) * out["seq_len"]
    for name, svc in (("fused", fused), ("fused-eager", eager)):
        reset_launch_counts()
        lp = host_launches(torch, lambda: svc.score(request).cpu())
        lp["k1_counted_launches"] = launch_counts()["lstm_cell"]
        if lp["k1_device_events"] != want or lp["k1_counted_launches"] != want:
            raise AssertionError(
                f"{arch} [{name}]: one request ran {lp['k1_device_events']} K1 kernels on the "
                f"device, and the launch count says {lp['k1_counted_launches']}; expected {want}")
        out["schedules"][name]["launches_per_request"] = lp
        row = out["schedules"][name]
        lp["device_busy_share"] = lp["device_busy_ms"] / row["ms_per_request_input_on_card"]
        log(f"[serve] {arch} [{name}] one request with the input on the card: the host made "
            f"{lp['host_total']} launch calls {lp['host_calls']}, the device ran "
            f"{lp['device_ops']} kernels/copies, {lp['k1_device_events']} of them K1 (profiler "
            f"events; the launch count says {lp['k1_counted_launches']}), busy "
            f"{lp['device_busy_ms']:.3f} ms: {lp['device_busy_share']:.3f} of the "
            f"{row['ms_per_request_input_on_card']:.3f} ms request (idle "
            f"{1 - lp['device_busy_share']:.3f}) [{card}]")
    cap, eag = out["schedules"]["fused"], out["schedules"]["fused-eager"]
    log(f"[capture] {arch} [fused] B={out['batch']} T={out['seq_len']}, captured against eager: "
        f"{cap['ms_per_request']:.3f} against {eag['ms_per_request']:.3f} ms/request from the "
        f"host, {cap['ms_per_request_input_on_card']:.3f} against "
        f"{eag['ms_per_request_input_on_card']:.3f} ms/request with the input on the card; "
        f"{cap['launches_per_request']['host_total']} against "
        f"{eag['launches_per_request']['host_total']} host launch calls per request; "
        f"{cap['k1_in_graph'][0]} K1 launches inside one graph; scores bit-equal: "
        f"{out['captured_vs_eager']['bit_equal']} [{card}]")


def drive_fit(torch, results, card) -> None:
    """``AnomalyService.fit`` at full width on the card: its first FIT_HELD
    steps against the same fit on the CPU, then FIT_STEPS steps with the
    loss of every step; calibrate, and the captured engine (captured before
    the fit) against an eager one bound to the fitted params."""
    import contextlib
    import io

    from repro_torch.config import LSTMAE_SHAPES, TrainConfig
    from repro_torch.data import TimeseriesConfig, make_batch
    from repro_torch.engine import AnomalyService, EngineConfig, build_engine
    from repro_torch.utils import tree_leaves

    shape = next(s for s in LSTMAE_SHAPES if s.name == "stream_64")   # B=4096, T=64
    svc = AnomalyService(FIT_ARCH, schedule="fused", device="cuda", seed=0)
    dc = TimeseriesConfig(features=svc.features, seq_len=shape.seq_len, batch=shape.global_batch)
    # fit's default for FIT_STEPS steps, also for the held steps
    tc = TrainConfig(learning_rate=5e-3, warmup_steps=min(10, FIT_STEPS), total_steps=FIT_STEPS)
    # the first step's batch: its mean score is that step's loss, the MSE
    # over the batch, so scoring it again after the fit shows the loss fall
    # on the same data (successive steps' losses differ by batch as well)
    probe = make_batch(dc, 0)[0]
    before = svc.score(probe)                  # the capture, with the seeded init
    compiles = svc.engine.profile_info()["compiles"]

    held = {}
    for dev in ("cuda", "cpu"):
        one = AnomalyService(FIT_ARCH, schedule="fused", device=dev, seed=0)
        t0 = time.perf_counter()
        metrics = one.fit(dc, FIT_HELD, train_cfg=tc)
        held[dev] = (one.params, metrics, time.perf_counter() - t0)
    (gp, gm, gs), (cp, cm, cs) = held["cuda"], held["cpu"]
    for k in cm:
        if not abs(gm[k] - cm[k]) <= FIT_LOSS_RTOL * abs(cm[k]):
            raise AssertionError(f"fit step {FIT_HELD}: {k} {gm[k]} on the card, {cm[k]} on the CPU")
    param_err = max(float((g.cpu() - c).abs().max()) for g, c in zip(tree_leaves(gp), tree_leaves(cp)))
    if not param_err <= FIT_PARAM_ATOL:
        raise AssertionError(f"params after {FIT_HELD} fit steps: card and CPU differ by {param_err}")

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        metrics = svc.fit(dc, FIT_STEPS, log_every=1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    losses = [float(ln.split("mse=")[1]) for ln in buf.getvalue().splitlines()]
    threshold = svc.calibrate(dc)
    after = svc.score(probe)
    first_loss, refit_loss = float(before.mean()), float(after.mean())
    if len(losses) != FIT_STEPS or not refit_loss < first_loss:
        raise AssertionError(f"fit: the first step's loss {first_loss} did not fall on its batch "
                             f"({refit_loss} after {FIT_STEPS} steps); per step {losses}")
    eager = build_engine(svc.cfg, EngineConfig("fused", jit=False), params=svc.params,
                         device="cuda")
    want = eager.score({"series": probe})
    torch.testing.assert_close(after, want, rtol=SCHEDULE_RTOL, atol=SCHEDULE_ATOL)
    recaptures = svc.engine.profile_info()["compiles"] - compiles
    if recaptures or not float((after - before).abs().max()) > 0:
        raise AssertionError(f"after fit: {recaptures} recaptures; scores changed "
                             f"{float((after - before).abs().max())}")
    out = {"arch": FIT_ARCH, "batch": shape.global_batch, "seq_len": shape.seq_len,
           "steps": FIT_STEPS, "ms_per_step": dt / FIT_STEPS * 1e3, "losses": losses,
           "first_step_loss": first_loss, "first_batch_loss_after_fit": refit_loss,
           "final": metrics, "threshold": threshold,
           "held": {"steps": FIT_HELD, "card": gm, "cpu": cm, "param_max_abs_diff": param_err,
                    "card_s": gs, "cpu_s": cs},
           "captured_vs_eager_max_abs_diff": float((after - want).abs().max()),
           "recaptures_after_fit": recaptures}
    results["fit"] = out
    log(f"[fit] {FIT_ARCH} [fused] at stream_64 (B={shape.global_batch}, T={shape.seq_len}): "
        f"the first {FIT_HELD} steps on the card and on the CPU agree (loss {gm['loss']:.6f} / "
        f"{cm['loss']:.6f}, rtol {FIT_LOSS_RTOL}; params max abs diff {param_err:.3g}, atol "
        f"{FIT_PARAM_ATOL}; {gs:.2f} s on the card, {cs:.2f} s on the CPU) [{card}]")
    log(f"[fit] {FIT_STEPS} steps on the card: {out['ms_per_step']:.1f} ms per step; loss "
        f"{first_loss:.6f} at the first step, {refit_loss:.6f} on that step's batch after the "
        f"last; each step's own loss {losses[0]:.4f} first, {metrics['loss']:.6f} last (every "
        f"step: {losses}); threshold {threshold:.4f}; the engine "
        f"captured before the fit serves the fitted params without a recapture, its scores equal "
        f"an eager engine's (max abs diff {out['captured_vs_eager_max_abs_diff']:.3g}; rtol "
        f"{SCHEDULE_RTOL}, atol {SCHEDULE_ATOL}) [{card}]")


def split_fit_step(torch, results, card) -> None:
    """Where one step of the timed fit spends its wall time, each part
    timed alone on the fit's shape and fitted params: the host's batch
    (``make_batch``), its copy to the card, and the train step on the card;
    then the device's busy time and kernel count in one step, from one
    ``torch.profiler`` pass.  Run last, with the other profiler passes."""
    import functools
    import types

    from repro_torch.config import TrainConfig
    from repro_torch.data import TimeseriesConfig, make_batch
    from repro_torch.engine import AnomalyService
    from repro_torch.models.lstm_ae import train_loss
    from repro_torch.training import build_train_step, init_train_state

    fit = results["fit"]
    svc = AnomalyService(FIT_ARCH, schedule="fused", device="cuda", seed=0)
    dc = TimeseriesConfig(features=svc.features, seq_len=fit["seq_len"], batch=fit["batch"])
    tc = TrainConfig(learning_rate=5e-3, warmup_steps=min(10, FIT_STEPS), total_steps=FIT_STEPS)
    t0 = time.perf_counter()
    for i in range(3):
        series = make_batch(dc, i)[0]
    batch_ms = (time.perf_counter() - t0) / 3 * 1e3
    copy_ms = host_ms(torch, lambda: series.to("cuda"), iters=3)
    api = types.SimpleNamespace(loss=functools.partial(train_loss, cfg=svc.cfg))
    step = build_train_step(api, tc)
    state = init_train_state(svc.params, tc)
    batch = {"series": series.to("cuda")}

    def one_step():
        nonlocal state
        state, metrics = step(state, batch)
        return float(metrics["loss"])

    step_ms = host_ms(torch, one_step, iters=3)
    lp = host_launches(torch, one_step)
    split = {"make_batch_ms": batch_ms, "copy_ms": copy_ms, "train_step_ms": step_ms,
             "sum_ms": batch_ms + copy_ms + step_ms, "fit_ms_per_step": fit["ms_per_step"],
             "step_device_busy_ms": lp["device_busy_ms"], "step_device_ops": lp["device_ops"],
             "step_host_launch_calls": lp["host_total"]}
    fit["split"] = split
    log(f"[fit] one fit step of {fit['ms_per_step']:.1f} ms, its parts timed alone: "
        f"make_batch on the host {batch_ms:.1f} ms, its copy to the card {copy_ms:.1f} ms, the "
        f"train step {step_ms:.1f} ms (sum {split['sum_ms']:.1f} ms); in one train step the "
        f"host made {lp['host_total']} launch calls and the device ran {lp['device_ops']} "
        f"kernels/copies, busy {lp['device_busy_ms']:.1f} ms of its {step_ms:.1f} ms (idle "
        f"{1 - lp['device_busy_ms'] / step_ms:.3f}) [{card}]")


def check_streaming(torch, svc, series, results) -> None:
    rows, steps = series[:512, :8], 8
    sess = svc.stream_start(rows.shape[0])
    state = svc.engine.init_stream_state(rows.shape[0])
    ys = []
    for t in range(steps):
        errors, sess = svc.stream_step(rows[:, t], sess)
        y_t, state = svc.engine.stream(rows[:, t], state)
        ys.append(y_t)
    recon = svc.engine.reconstruct({"series": rows})
    torch.testing.assert_close(torch.stack(ys, dim=1), recon, rtol=SCHEDULE_RTOL, atol=SCHEDULE_ATOL)
    torch.testing.assert_close(errors, svc.score(rows), rtol=SCHEDULE_RTOL, atol=SCHEDULE_ATOL)
    results["streaming"] = {"rows": rows.shape[0], "steps": steps}
    log(f"[stream] {steps} stream_step calls on {rows.shape[0]} rows agree with reconstruct and score")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None, help="also write every measurement to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible device(s)")
    log(f"[card] allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    paths = _build.build()
    results["build_s"] = time.perf_counter() - t0
    for name, path in paths.items():
        report = [ln.strip() for ln in path.with_suffix(".log").read_text().splitlines()
                  if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: {path.name} in {results['build_s']:.1f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
        for ln in report:
            log(f"[build]   {ln}")
        spills = [ln for ln in report
                  if any(int(n) for n in re.findall(r"(\d+) bytes spill", ln))]
        if name in NO_SPILL and spills:
            raise AssertionError(f"{name}: ptxas reports spills: {spills}")

    from repro_torch.config import LSTMAE_SHAPES

    serve = next(s for s in LSTMAE_SHAPES if s.name == "serve_64")   # B=8192, T=64
    check_k1(torch, results)
    k1 = time_k1(torch, serve.global_batch, results, card)
    time_k1(torch, GATEWAY_MAX_BATCH, results, card, tag=f"_b{GATEWAY_MAX_BATCH}")

    svc, eager, first = drive_service(torch, "lstm-ae-f64-d6", serve.global_batch,
                                      serve.seq_len, 3, results, card)
    main_launches = results["serve"][0]["k1_launches"]
    small = drive_service(torch, "lstm-ae-f32-d2", 1024, 64, 3, results, card)
    check_streaming(torch, svc, first, results)
    drive_fit(torch, results, card)

    check_k2(torch, results)
    k2 = time_k2(torch, serve.global_batch, results["k1_layers"], results, card)
    k2_launches = drive_k2_path(torch, svc, first, results, card)
    drive_gateway(torch, results, card)
    transport_gw, transport_windows = drive_transport(torch, results, card)

    check_k3(torch, results)
    k3 = time_k3(torch, results, card)
    k3_launches = drive_k3_path(torch, results, card)
    check_k4(torch, results)
    k4 = time_k4(torch, results, card)
    k4_launches = drive_k4_path(torch, results, card)
    for out, (fused, eag, request) in zip(results["serve"], ((svc, eager, first), small)):
        compare_launches(torch, out["arch"], fused, eag, request.to("cuda"), out, card)
    # the main path's count (captured launches x replays) against the K1
    # kernels the profiler saw the device run for one replayed request
    split_fit_step(torch, results, card)
    profile_transport_flush(torch, transport_gw, transport_windows, results, card)
    main = results["serve"][0]
    measured = main["schedules"]["fused"]["launches_per_request"]["k1_device_events"]
    if main_launches != main["requests"] * measured:
        raise AssertionError(f"the main path counted {main_launches} K1 launches over "
                             f"{main['requests']} requests; the device ran {measured} per request")

    kernels = {"kernels": [{
        "name": "lstm_cell",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": main_launches,
        "max_abs_err": results["k1_max_abs_err_f32"],
        "ms": k1["kernel_ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
    }, {
        "name": "lstm_seq",
        "route": "cuda",
        "source": K2_SOURCE,
        "replaces": K2_REPLACES,
        "launches": k2_launches,
        "max_abs_err": results["k2_max_abs_err_f32"],
        "ms": k2["kernel_ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"],
    }, {
        "name": "wkv6",
        "route": "cuda",
        "source": K3_SOURCE,
        "replaces": K3_REPLACES,
        "launches": k3_launches,
        "max_abs_err": results["k3_max_abs_err_f32"],
        "ms": k3["kernel_ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": None,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": K4_SOURCE,
        "replaces": K4_REPLACES,
        "launches": k4_launches,
        "max_abs_err": results["k4_max_abs_err_bf16"],
        "ms": k4["kernel_ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "library_ms": k4["library_ms"],
    }]}
    results["kernels"] = kernels["kernels"]
    results["total_s"] = time.perf_counter() - t_start
    log(f"[done] {results['total_s']:.1f} s; lstm_cell: times per timestep of lstm-ae-f64-d6 at "
        f"B={serve.global_batch} (6 launches), launches from the fused serving path's 3 requests "
        f"(3 replays of one captured graph; {measured} K1 kernels per replay on the device, from "
        f"the profiler); "
        f"lstm_seq: times per forward of lstm-ae-f64-d6 at B={serve.global_batch}, T={K2_T} "
        f"(6 launches), launches from its lstm_seq_op path; wkv6: f32 at B={RWKV_B}, T={RWKV_T}, "
        f"H={RWKV_H}, hd={RWKV_HD}, launches from its wkv6_op path (whole + chained pair); "
        f"flash_attention: bf16 at B={PHI_B}, H={PHI_H}, S=Sk={PHI_S}, d={PHI_HD}, causal, "
        f"launches from its flash_attention_op path")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    print(card, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
