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
3a. holds ``lstm_stack`` (the whole stack a launch, the ``fused`` forward at
   small batches) to its plain version at lstm-ae-f64-d6 and lstm-ae-f32-d2,
   B=1 and T=64 (the latency cells), the gateway's B=256 and short and
   ragged windows, both activations, at K1's f32 bar, and times it at B=1
   and B=256, T=64 beside its bound, the plain version and the captured K1
   chain it replaces (whose output it must equal at that bar);
4. drives the main path: ``AnomalyService("lstm-ae-f64-d6", schedule="fused")``
   at the ``serve_64`` shape (B=8192, T=64, F=64) — calibrate, then three
   scoring requests — and checks that the kernels the ``fused`` dispatch
   picks ran (``fused_launches``: K1 3 x 6 x 64 times at B=8192, one
   ``lstm_stack`` a request up to ``stack_max_batch`` rows), that the
   scores agree with the ``sequential`` and ``wavefront`` schedules on the
   card and with the CPU path, and times each schedule; then the same at a
   smaller batch for ``lstm-ae-f32-d2`` (B=1024) and at the latency cells'
   shape for ``lstm-ae-f64-d6`` (B=1), both on ``lstm_stack``.  Each engine captures its
   programs into CUDA graphs (``engine/capture.py``); the fused path is
   also run eagerly (``EngineConfig(jit=False)``) in the same run, and the
   two are compared: ms per request from the host and with the input on
   the card, the launches inside the graph (6 x 64 of K1 at B=8192), and the scores
   (within 1e-5 / 1e-6, and whether bit-equal); in 11. one
   ``torch.profiler`` pass per request each gives the launch
   calls the host makes and the device's busy time;
5. streams a few timesteps and checks them against batch scoring, then
   drives the Engine's per-call params on the main path's engine (``[with]``
   lines): ``serving.build_score_step(engine)(params, batch)`` bit-equal to
   the bound ``score``, with K1's launches counted around it (6 x 64),
   ``score_with`` under other params leaving the bound scores and programs
   as they were, and each of the five ``*_with`` forms captured once,
   bit-equal to its bound form and timed beside it;
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
   window alone, and the kernel launches against the ``fused`` dispatch's
   for each flush's shape: one ``lstm_stack`` a flush of at most 256 rows).
   The pool step and the flushes are captured programs: the churn must
   capture the pool step once and never again, the first one-shot pass
   captures one graph per bucket (the dispatch's launches inside each) and the
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
   ``GET /metrics``.  The launches over the phase must be the dispatch's
   per flush (one ``lstm_stack``), and in 11. one
   flush over the socket under the profiler must show the device running
   that kernel, after a
   profiled repeat of the bp1 pass that gives the device's idle share
   over it and its windows per flush;
8b. the worker front and the launchers (``[workers]`` lines), then the
   multi-GPU slice (``[multi_gpu]`` lines) at the main path's width and
   params: the stage pipeline (``pipelined_forward``) on (1, 2), (1, 4) and
   (2, 2) (data x stage) meshes of cuda:0, a stream per cell, held to
   ``sequential`` (rtol 1e-4, atol 1e-5) and ``wavefront`` and timed beside
   them and the captured ``fused`` engine, with each mesh's stage
   assignment and pass-through stages; ``EngineConfig("pipelined",
   n_stages=2)`` with 1 and 2 data shards; ``Placement.data(2)`` over cuda:0
   named twice: engine scores bit-equal to the single placement's, K1
   launched 2 x 384 times per request (counts set to 0 just before, read
   just after), one capture per shard, host and device ms per request; and
   the gateway of 8. on that placement: 2048 streams churned against the
   single-placement gateway (bit-equality printed), ``per_device_active``,
   512 one-shot windows bit-equal, requests/s and ``queue.device_fill``.
   With two GPUs it repeats the data=2 engine and the (1, 2) pipeline over
   cuda:0 and cuda:1 and runs ``serve --mesh data=2 --http``; with one it
   says so and checks that ``Placement.data(2)`` without ``devices=``
   raises;
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
10a. serves the dense transformer LM at full width (``[lm]`` lines):
   tinyllama-1.1b with params drawn on the card from seed 0, held to the
   CPU on one prompt (B=1, S=32) in bf16 (rtol = atol = 6e-2, the
   reference's bf16 bar) and, cut to 2 layers, in f32 (1e-4); one decode
   step from a stitched prefix cache against the teacher-forced logits
   (B=2, S=64); then prefill at B=8, S=2048 and 128 greedy tokens eager
   and with the decode step captured (``serving.GreedyDecoder``): tokens
   identical, whether the last logits and the caches are bit-equal, prefill
   ms and decode ms per token and tokens/s beside their bounds, the host's
   launch calls per token each way and the device's busy share over the
   captured decode (``torch.profiler``), peak memory, and no K1-K4 launch
   on the path (the reference's transformer reaches no Pallas kernel);
   the launcher ``serve --arch tinyllama-1.1b --full-config`` once as a
   subprocess; phi-3-vision-4.2b's vision-stub prefill at full width, cut
   to 2 layers, card against CPU, its decode cache sized to S + 576;
11. profiles one fused request of step 4 per engine, captured and eager
   (before 10a: after the LM phase the profiler's trace of a pass drops
   its first three device events, which on ``lstm_stack`` hold the kernel):
   the kernels the ``fused`` dispatch picks, by name, must run on the
   device as often as counted in each (6 x 64 of K1 at B=8192, one
   ``lstm_stack`` for lstm-ae-f32-d2 at B=1024 and lstm-ae-f64-d6 at B=1),
   and the main path's launch count must be 3 requests x that figure;
   profiles a bp1 pass and one socket flush of 8a (also before 10a); then,
   after 10a, scores a request no graph has scored through each captured
   ``lstm_stack`` graph of step 4 against the sequential schedule, and
   profiles it behind sleep kernels, where the stack kernel must show; then
   splits one fit step of 5a into its parts, each timed alone (the host's
   batch, its copy to the card, the train step) with one profiler pass over
   the train step.
12. trains the dense LM at full width, last (``[lm-train]`` lines; its
   profiled train step records over 10,000 kernels, and 11's K1 counts
   are not to follow it): one
   value_and_grad of ``train_loss`` at 2 layers, B=1, S=32, card against
   CPU in f32 (TF32 off) and bf16, every grad leaf by relative Frobenius
   error; remat against no remat at 2 layers, B=4, S=2048 (losses
   bit-equal, peak memory of each); then tinyllama-1.1b with 22 layers
   for 8 AdamW steps at B=4, S=2048 from ``LMIterator``: ms a step and
   tokens/s beside the bound, peak memory, one profiled step's device
   kernels and idle share, every loss finite, and no K1-K4 launch and no
   ``scaled_dot_product_attention`` call over the phase; the launcher
   ``train --arch tinyllama-1.1b --full-config`` for 6 steps with a
   checkpoint every 3 and again for 8 over the same directory, which
   resumes from step 6;
13. drives the MoE transformer at full width, after ``[lm-train]`` (``[moe]``
   lines): moonshot-v1-16b-a3b cut to 2 layers, card against CPU on one
   prompt (B=1, S=32) in f32 (TF32 off, 1e-4) and bf16 (6e-2) at every
   position's logits and greedy token (ties within two ulps counted, not
   held), each layer's routing agreement, and one value_and_grad of
   ``train_loss`` (the [lm-train] bars); one decode step against the
   prefill (B=2, S=64, f32, capacity_factor 16) by greedy token; moonshot
   served at 24 of its 48 layers and dbrx-132b at 2 of its 40: prefill at
   B=8, S=2048 (drop share and aux per layer), 128 (dbrx: 32) greedy
   tokens eager and captured with identical tokens, ms beside the bounds
   (the experts the run routed to, and every expert), launch calls and
   device kernels per token, peak memory; moonshot at 2 layers trained 6
   AdamW steps at B=4, S=2048 (ms a step beside the bound, xent and aux
   per step, peak memory); ``serve`` and ``train --steps 4`` for
   moonshot at their reduced default as subprocesses; no K1-K4 launch and
   no ``scaled_dot_product_attention`` call over the phase;
14. drives RWKV-6 at full width, last (``[rwkv]`` lines), whose WKV
   recurrence runs through K3 (``layers/rwkv.py``): rwkv6-7b cut to 2
   layers, card against CPU on one prompt (B=1, S=32) in f32 (TF32 off,
   logits and state at 1e-4) and bf16 (logits at 6e-2), then one decode
   step from each side's prefill state (the same bars), one value_and_grad
   of ``train_loss`` in each (the [lm-train] bars; bf16's gap at B=1,
   S=32 also logged beside the CPU's own bf16-vs-f32 gap), decode against
   prefill (B=2, S=64, f32 and bf16, the reference's 3e-2); served at all 32 layers
   (30.1 GB of f32 params): prefill at B=8, S=2048 beside its bound, K3's
   device time a layer from one profiled prefill, 64 greedy tokens eager
   and captured (tokens identical) beside the decode bound, launch calls
   and device kernels per token, peak memory; trained at 2 layers for 6
   AdamW steps at B=4, S=2048 (ms a step beside the bound, xent per step,
   peak memory, the share of the last step in ``WKV6``'s backward from
   CUDA events at its entry and exit); ``serve`` and ``train --steps 4``
   at their reduced default as subprocesses.  K3 is then held against its
   plain version on the inputs the path gave it, recorded at the first
   layer's call: the served prefill (B=8, T=2048) and decode (B=8, T=1)
   and the training forward (B=4, T=2048) and one backward chunk
   (B=4, T=64), bf16 r, k, v with the layer's own decays and states, at
   f32's bar scaled by the result's rms.  Every K3 launch of the phase
   is counted by segment against the count the code predicts (a layer per
   prefill, decode token and training forward, one more in the recompute,
   ceil(S / 64) - 1 a layer in the backward), and K1, K2, K4 and
   ``scaled_dot_product_attention`` must not run.  The ``wkv6`` entry's
   launches on the kernels line add this phase's count to its
   ``wkv6_op`` path's 3.
15. drives Jamba at full width, last (``[jamba]`` lines): the reduced
   jamba-v0.1-52b card against CPU (f32 prefill logits, every state, one
   decode step from stitched states, routing, ``train_loss`` and every
   grad leaf; bf16 logits no farther from the CPU's f32 than the CPU's own
   bf16); jamba-v0.1-52b cut to one period of four (8 of 32 layers, 53.2 GB
   of f32 params: 7 Mamba, 1 attention without RoPE, 4 MoE of 16 experts
   top-2, 4 SwiGLU MLPs), each position kind on its own card against CPU at
   B=1, S=32 in f32 and bf16 (the Mamba layer with its state and a decode
   step, attention with a decode step, an MLP, a MoE layer with its
   routing), decode against prefill (B=2, S=64, f32, the reference's bar),
   served at B=8, S=2048 (prefill ms beside its bound, drop share per MoE
   layer, one profiled prefill's host launch calls and idle share) with 64
   greedy tokens eager and captured (tokens identical, one capture; ms a
   token beside the bound, launch calls a token, the captured decode's idle
   share, peak memory); one full-width Mamba layer forward and backward at
   B=4, S=2048 (ms, peak memory); ``serve`` and ``train`` at the reduced
   config as subprocesses, the second train run resuming, the first step's
   loss held to the CPU's.  The reference's Jamba reaches no Pallas kernel,
   so K1-K4 must not launch over the phase (predicted 0) and no library
   attention may run.
16. drives Whisper at full width and depth, last (``[whisper]`` lines):
   the reduced whisper-large-v3 card against CPU (f32 prefill logits and
   cache ``k``/``v``/``ck``/``cv``, one decode step from stitched caches,
   ``train_loss`` and every grad leaf; bf16 logits no farther from the
   CPU's f32 than the CPU's own bf16); whisper-large-v3 uncut (32 encoder
   + 32 decoder layers, 1,577,530,880 f32 params, 1,500 frames), each
   layer kind on its own card against CPU at B=1, S=32 over the 1,500
   frames in f32 and bf16 (an encoder layer, a decoder layer, its decode
   step against its caches), decode against prefill (B=2, S=64, f32, the
   reference's bar), served at B=8, S=2048 over bf16 frames (prefill ms
   beside a bound that counts the encoder, the cross K/V and the decoder;
   one profiled prefill's host launch calls and idle share) with 64 greedy
   tokens eager and captured (tokens identical, one capture; ms a token
   beside the byte bound, launch calls and device kernels a token, the
   captured decode's idle share, peak memory), trained 6 AdamW steps at
   B=4, S=2048 with per-layer recompute (ms a step beside the bound, xent
   per step finite, peak memory); ``serve`` and ``train`` at the reduced
   config as subprocesses, the second train run resuming.  The reference's
   Whisper attends through jnp, no Pallas kernel, so K1-K4 must not launch
   over the phase (predicted 0) and no library attention may run.
17. holds the sharding specs to the models, last (``[specs]`` lines, one
   per registered arch, each at full width and depth): ``param_struct``
   (the family's own ``init`` on the meta device: nothing is allocated,
   dbrx-132b's 40 layers and jamba-v0.1-52b's four periods included)
   against ``param_specs`` (the same tree, each spec's length the tensor's
   rank, every axis name one ``ShardingRules`` knows), ``cache_struct``
   against ``cache_specs`` at each decode cell of ``shapes_for``, and
   ``input_specs`` for every cell of ``shapes_for``; then the specs
   against the params the model phases above drew on the card
   (tinyllama-1.1b, moonshot-v1-16b-a3b at 24 layers, dbrx-132b at 2,
   rwkv6-7b, one Jamba period, whisper-large-v3): the same paths, shapes
   and dtypes as ``param_struct`` of the same depth, and the phase's own
   param count.  The card's allocated bytes must not move over the phase.
18. drives the sharded step, after ``[specs]`` (``[sharded]`` lines): a
   process group of this process alone over NCCL (a file store in a
   temporary directory), where ``make_production_mesh`` must raise naming
   the 256 ranks it needs; then a (1, 1) ``("data", "model")`` mesh on
   cuda:0.  One card cannot show a collective across ranks (NCCL refuses
   two ranks on one GPU); it runs the real DTensor dispatch, the
   ``constrain`` sites, the expert-parallel body and K3 under
   ``local_map``.  tinyllama-1.1b at full width and all 22 layers, B=4,
   S=2048: SHARDED_LM_STEPS AdamW steps on the state placed by its specs
   against as many unsharded steps from the same state (losses rtol 1e-5,
   params atol 1e-6 but where AdamW's second moment is below 100 eps, as
   the CPU tests hold it; whether bit-equal is printed), ms a step for
   both and their ratio (the dispatch's cost), peak memory;
   moonshot-v1-16b-a3b at full width and MOE_TRAIN_LAYERS layers in f32,
   ``ep_a2a`` under the mesh: one value_and_grad against the unsharded
   scatter path; rwkv6-7b at RWKV_TRAIN_LAYERS layers: one train step
   under the mesh against the unsharded one, K3's launches over it equal
   to the code's prediction (per layer a forward, a recompute and
   ceil(S/64) - 1 in the backward), and K3 held to its plain version on
   the inputs that step gave it; then that state's params saved from the
   mesh (gathered) and restored onto it (``restore_checkpoint(mesh=,
   spec_tree=)``), every leaf equal and placed by its spec.
19. the dry run, last (``[dryrun]`` lines; no GPU: everything on the meta
   device, and the card's allocated bytes must not move): the cells
   ``python -m repro_torch.launch.dryrun --mesh single`` traces over a
   fake process group of 256 ranks (DRYRUN_CELLS, each in a subprocess
   of its own with ``CUDA_VISIBLE_DEVICES=""``, run side by side), each
   ``ok`` with its per-chip FLOPs, bytes, collective bytes, dominant term
   and trace seconds; then, without a mesh, three steps at the shapes the
   card ran above traced on meta tensors (``roofline/trace.py``): the
   main path's fused forward (lstm-ae-f64-d6, B=8192, T=64, K1 counted
   by its meta op), tinyllama-1.1b's prefill and rwkv6-7b's prefill at
   B=8, S=2048 (K3 counted by its meta op): the counted FLOPs by dtype
   and bytes, the roofline's compute and memory ms at the H100's
   datasheet peaks, beside the FLOPs of this script's own hand bounds
   (the K1 launches x ``k1_bound``, ``lm_prefill_bound``,
   ``rwkv_serve_bound``) and the ms the phases above measured.

The build fails if ``ptxas`` reports a spill in any of the five kernels.  Any failed
check raises and the script exits non-zero; without a GPU, or
without the rest of the repository beside it, it exits non-zero at once.
The line before the last is ``{"kernels": [...]}`` and the last line is
``{"ok": true, "device": {...}}``.  ``--json PATH`` also writes every
measurement to PATH.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
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
STACK_KERNEL = "lstm_stack_kernel"   # the whole stack's, the fused forward at small batches
STACK_SOURCE = "src/repro_torch/kernels/csrc/lstm_stack.cu"
STACK_REPLACES = ("none: the fused schedule's D x T launches of src/repro/kernels/lstm_cell.py:79 "
                  "at a small batch, on the wavefront of src/repro/core/temporal.py")
STACK_ARCHS = ("lstm-ae-f64-d6", "lstm-ae-f32-d2")   # the latency cells' configurations
STACK_T = 64                 # the latency cells' window
# sleep kernels queued ahead of a profiled request after the LM phase, where
# the profiler's trace of a pass drops its first three device events (step 11)
PROFILE_LEAD = 8
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
NO_SPILL = ("lstm_cell", "lstm_seq", "wkv6", "flash_attention", "lstm_stack")

FIT_ARCH = "lstm-ae-f64-d6"
FIT_STEPS, FIT_HELD = 20, 3
# the card's and the CPU's f32 sums run in other orders; over 3 Adam steps
# (updates of about lr each) they stay far inside these
FIT_LOSS_RTOL, FIT_PARAM_ATOL = 1e-5, 1e-5

GATEWAY_ARCH = "lstm-ae-f64-d6"
GATEWAY_CAPACITY = 1024
GATEWAY_MAX_BATCH = 256
# the latency cells' shape, the gateway's flush, and short and ragged windows
STACK_CASES = ((1, 64), (GATEWAY_MAX_BATCH, 64), (1, 1), (2, 7), (5, 64), (RAGGED_B, 16))
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
# the multi-worker front of that gateway: queue bound per worker (its
# priority-2 limit, a third of it, is reachable inside one bucket of 256
# lanes), bp1 connections and timed passes per fleet size, the SLO the
# control loop is given, fit steps of each worker of `serve --workers 2`
WORKERS_MAX_QUEUE = 384
WORKERS_CONNS = 8
WORKERS_PASSES = 3
WORKERS_SLO_MS = 4.0
WORKERS_FIT_STEPS = 2

# the dense transformer LM served at full width (src/repro_torch/configs/
# tinyllama_1_1b.py: 22 layers, d_model 2048, 32 heads / 4 kv heads of 64,
# d_ff 5632, vocab 32000), params drawn on the card from seed 0.  The card
# is held to the CPU on one prompt (B=1, S=32) in bf16 at the reference's
# bf16 bar (tests/test_serving_consistency.py:53) and, at 2 layers, in f32
# (TF32 off) at LM_F32_TOL; decode against prefill at B=2, S=64; then served
# at B=8, S=2048 (kv_chunk 1024) with 128 greedy tokens, eager and captured
LM_ARCH = "tinyllama-1.1b"
LM_BF16_TOL = 6e-2
LM_F32_TOL = 1e-4
LM_CPU_B, LM_CPU_S = 1, 32
LM_CONSISTENCY_B, LM_CONSISTENCY_S = 2, 64
LM_SERVE_B, LM_SERVE_S, LM_DECODE, LM_KV_CHUNK = 8, 2048, 128, 1024
LM_PROFILE_TOKENS = 4       # decode tokens per profiler pass (each token runs ~2,150 kernels)
LM_BUSY_TOKENS = 16
# phi-3-vision-4.2b's backbone at full width, cut to 2 layers: its prefill
# covers S + 576 patch positions, and the decode cache is sized from that
LM_VISION_ARCH, LM_VISION_LAYERS, LM_VISION_DECODE = "phi-3-vision-4.2b", 2, 4
# LM training at full width (``[lm-train]`` lines): one value_and_grad of
# train_loss at 2 layers, B=1, S=32, card against CPU; in f32 (TF32 off)
# the loss at rtol = atol = LM_F32_TOL and each grad leaf by its relative
# Frobenius error at LM_TRAIN_F32_GRAD_REL; in bf16 the loss at the
# reference's bf16 bar and each grad leaf at LM_TRAIN_BF16_GRAD_REL
# (1.3e-2 to 1.5e-2 between the JAX package and the port on the CPU,
# tests/test_torch_lm_training.py; 1.06e-2 card against CPU on an H100,
# PERF.md section 6).  Remat against no remat at 2 layers,
# B=4, S=2048: the same loss bit for bit, grads within LM_TRAIN_REMAT_REL
# (the table's gather backward accumulates in an order of its own).  Then
# 22 layers at B=4, S=2048 from LMIterator, AdamW in f32, and the launcher
# twice over one checkpoint directory.
LM_TRAIN_LAYERS = 2
LM_TRAIN_F32_GRAD_REL = 1e-4
LM_TRAIN_BF16_GRAD_REL = 5e-2
LM_TRAIN_REMAT_REL = 1e-5
LM_TRAIN_B, LM_TRAIN_S, LM_TRAIN_STEPS = 4, 2048, 8
LM_TRAIN_LAUNCH_STEPS, LM_TRAIN_CKPT_EVERY = (6, 8), 3
# the MoE transformer at full width (``[moe]`` lines): moonshot-v1-16b-a3b
# (src/repro_torch/configs/moonshot_v1_16b_a3b.py: 48 layers, d_model 2048,
# 16 heads of 128, 64 experts of d_ff 1408, top-6, vocab 163,840; one layer
# is 570.6e6 f32 params, 2.28 GB) and dbrx-132b (40 layers, d_model 6144,
# 48 heads / 8 kv heads of 128, 16 experts of d_ff 10,752, top-4, vocab
# 100,352; one layer 13.04 GB), params in f32 drawn on the card from seed 0.
# Widths are never cut; depth is: card against CPU (B=1, S=32, the [lm]
# bars) and decode against prefill (B=2, S=64, capacity_factor 16) at
# MOE_CHECK_LAYERS layers; moonshot served at MOE_SERVE_LAYERS of its 48
# (57.45 GB of params; with the prefill's transients or the captured decode's
# two caches the reckoned peak is about 66 GB) and dbrx at MOE_DBRX_LAYERS of
# its 40 (31.0 GB); moonshot trained at MOE_TRAIN_LAYERS layers (29 GB of
# params, grads and AdamW moments).
MOE_ARCH, MOE_DBRX_ARCH = "moonshot-v1-16b-a3b", "dbrx-132b"
MOE_CHECK_LAYERS, MOE_SERVE_LAYERS, MOE_DBRX_LAYERS, MOE_TRAIN_LAYERS = 2, 24, 2, 2
MOE_CONSISTENCY_CF = 16.0
MOE_SERVE_B, MOE_SERVE_S, MOE_DECODE, MOE_DBRX_DECODE = 8, 2048, 128, 32
MOE_PROFILE_TOKENS = 2      # decode tokens per profiler pass
MOE_TOP_KERNELS = 6         # kernel names logged per profiled pass
MOE_TRAIN_B, MOE_TRAIN_S, MOE_TRAIN_STEPS = 4, 2048, 6
MOE_LAUNCH_TRAIN_STEPS = 4
# RWKV-6 at full width (``[rwkv]`` lines): rwkv6-7b (src/repro_torch/configs/
# rwkv6_7b.py: 32 layers, d_model 4096 in 64 heads of 64, d_ff 14,336, decay
# LoRA rank 64, vocab 65,536; one layer 218.7e6 f32 params, all of it
# 7.53e9, 30.1 GB), params in f32 drawn on the card from seed 0, bf16
# compute.  Its WKV recurrence is K3's function and runs through K3: one
# launch a layer per prefill, decode step and training forward (and one
# more in the recompute), ceil(S / 64) - 1 a layer in the backward (the
# chunk states it rebuilds, ``layers/rwkv.py::WKV6``).  Card against CPU
# (B=1, S=32, the [lm] and [lm-train] bars) and decode against prefill
# (B=2, S=64, the reference's bar, tests/test_layers.py:231-249) at
# RWKV_CHECK_LAYERS layers; served at all 32 layers (30.1 GB of params) at
# B=8, S=2048 with RWKV_DECODE greedy tokens eager and captured; trained at
# RWKV_TRAIN_LAYERS layers (0.97e9 params, 15.6 GB with grads and AdamW
# moments).
RWKV_ARCH = "rwkv6-7b"
RWKV_K3_KERNEL = "wkv6_kernel"     # K3's __global__ function, as the profiler names it
RWKV_CHECK_LAYERS, RWKV_TRAIN_LAYERS = 2, 2
# The bf16 train_loss card against CPU runs at B=4, S=64: at B=1, S=32 the
# bonus u's grad (per element a sum over the 32 positions that cancels) was
# 8.2e-2 apart on an H100 (PERF.md section 6), with the CPU's own bf16 grad
# 0.18 from its f32 one; at B=4, S=64 every leaf was within 2.7e-2 of the
# CPU's.  f32 (2.1e-5 at B=1, S=32) is where the card shows its function.
# The B=1, S=32 bf16 gap is still read and logged, not held, beside the
# CPU's own bf16-vs-f32 gap there, so a change that widens it shows.
RWKV_BF16_GRAD_B, RWKV_BF16_GRAD_S = 4, 64
RWKV_CONSISTENCY_TOL = 3e-2
RWKV_SERVE_B, RWKV_SERVE_S, RWKV_DECODE = 8, 2048, 64
RWKV_PROFILE_TOKENS = 4
RWKV_TRAIN_B, RWKV_TRAIN_S, RWKV_TRAIN_STEPS = 4, 2048, 6
RWKV_LAUNCH_TRAIN_STEPS = 4
# Jamba at full width (``[jamba]`` lines): jamba-v0.1-52b (src/repro_torch/
# configs/jamba_v0_1_52b.py: 32 layers in 4 periods of 8; in a period 7
# Mamba mixers (d_inner 8192, d_state 16, dt_rank 256, d_conv 4) and
# attention without RoPE at position 4 (32 heads / 8 kv heads of 128), the
# MoE layer of 16 experts top-2 (d_ff 14,336) at positions 1, 3, 5, 7 and
# the SwiGLU MLP elsewhere; vocab 65,536), params in f32 drawn on the card
# from seed 0, bf16 compute.  Widths are never cut; depth is, once: one
# period of four (8 of 32 layers, 13.30e9 params, 53.2 GB; two periods
# need 106 GB).  Each position kind is held card against CPU at B=1, S=32
# in f32 and bf16 (the Mamba layer at the reference's Mamba bar, the
# others at the [lm] bars); the whole period is not run on the CPU (53 GB
# of host memory).  Served at B=8, S=2048 with JAMBA_DECODE greedy tokens
# eager and captured; decode against prefill at B=2, S=64 (f32,
# capacity_factor 16, the reference's bar, tests/test_serving_consistency.py:80-107).
# A full-width train step of one period needs 13.3e9 x 16 bytes (213 GB)
# and is not run; one full-width Mamba layer runs forward and backward at
# B=4, S=2048, and the launcher trains the reduced config.
JAMBA_ARCH = "jamba-v0.1-52b"
JAMBA_PERIODS = 1
JAMBA_MAMBA_TOL = (2e-4, 2e-5)     # tests/test_layers.py:210-229
JAMBA_CONSISTENCY_TOL = 5e-2
JAMBA_SERVE_B, JAMBA_SERVE_S, JAMBA_DECODE = 8, 2048, 64
JAMBA_PROFILE_TOKENS = 4
JAMBA_TRAIN_B, JAMBA_TRAIN_S = 4, 2048
JAMBA_LAUNCH_B, JAMBA_LAUNCH_S, JAMBA_LAUNCH_STEPS, JAMBA_CKPT_EVERY = 2, 64, (4, 6), 2
# Whisper at full width (``[whisper]`` lines): whisper-large-v3
# (src/repro_torch/configs/whisper_large_v3.py: 32 encoder and 32 decoder
# layers, d_model 1280 in 20 heads of 64 (kv heads 20), d_ff 5120 GELU,
# LayerNorm, biased projections, vocab 51,866 tied, 1,500 frames from the
# stubbed audio frontend, 32,768 learned decoder positions; 1,577,530,880
# params, 6.3 GB in f32), params drawn on the card from seed 0, bf16
# compute.  No cut, width or depth: served at B=8, S=2048 over 1,500 frames
# with WHISPER_DECODE greedy tokens eager and captured, and trained at B=4,
# S=2048 for WHISPER_TRAIN_STEPS AdamW steps with per-layer recompute (25.2
# GB of params, grads and moments).  Card against CPU: the reduced config
# whole (f32 and bf16), and each layer kind at full width on its own at
# B=1, S=32 over the 1,500 frames in f32 and bf16 (an encoder layer, a
# decoder layer, a decoder layer's decode step against its caches); decode
# against prefill at B=2, S=64 in f32 at the reference's bar
# (tests/test_serving_consistency.py:110-131).  The launchers train the
# reduced config twice over one checkpoint directory.
WHISPER_ARCH = "whisper-large-v3"
WHISPER_CONSISTENCY_TOL = 5e-2
WHISPER_SERVE_B, WHISPER_SERVE_S, WHISPER_DECODE = 8, 2048, 64
WHISPER_PROFILE_TOKENS = 4
WHISPER_TRAIN_B, WHISPER_TRAIN_S, WHISPER_TRAIN_STEPS = 4, 2048, 6
WHISPER_LAUNCH_B, WHISPER_LAUNCH_S, WHISPER_LAUNCH_STEPS, WHISPER_CKPT_EVERY = 2, 64, (4, 6), 2


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



def meta_layers(torch, cfg) -> list:
    """An LSTM-AE configuration's layers {wx, wh, b} on the meta device."""
    return [{"wx": torch.empty(i, 4 * h, device="meta"), "wh": torch.empty(h, 4 * h, device="meta"),
             "b": torch.empty(4 * h, device="meta")}
            for i, h in zip(cfg.lstm_ae.layer_input_sizes(), cfg.lstm_ae.layer_sizes())]


def fused_launches(torch, layers, t_len: int, bsz: int) -> dict:
    """The kernel launches of one ``fused`` forward of ``layers`` at (T, B),
    as the schedule's dispatch picks them (``schedules.fused_launches``): one
    ``lstm_stack`` at a small batch, depth x T of K1 above the crossover."""
    from repro_torch.engine.schedules import fused_launches as dispatch

    meta = [{k: v.to("meta") for k, v in layer.items()} for layer in layers]
    return dispatch(meta, torch.empty(t_len, bsz, meta[0]["wx"].shape[0], device="meta"))


def add_counts(total: dict, counts: dict, times: int = 1) -> dict:
    """``total`` plus ``times`` x ``counts``, by kernel."""
    for k, n in counts.items():
        total[k] = total.get(k, 0) + times * n
    return total


def launched(counts: dict) -> dict:
    """``launch_counts()`` without the kernels that did not launch."""
    return {k: n for k, n in counts.items() if n}


# the profiler's name of each kernel of the fused forward
DEVICE_KERNEL = {"lstm_cell": K1_KERNEL, "lstm_stack": STACK_KERNEL}

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
    if counts != {"lstm_cell": 0, "lstm_seq": depth, "wkv6": 0, "flash_attention": 0,
                  "lstm_stack": 0}:
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
    state = gw.pool._blocks[0].state
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
    with churn, then micro-batched one-shot scoring.  Returns the kernel
    launches of the one-shot phase."""
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
                     "pool_replays": gw.pool._blocks[0].graphs.replays}
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
    flush_t, flush_b = [], []
    real = gw.engine.score_masked

    def recorded(batch):   # bucket_T and rows of every flush, to predict the launches
        flush_t.append(batch["series"].shape[1])
        flush_b.append(batch["series"].shape[0])
        return real(batch)

    gw.engine.score_masked = recorded
    graphs = gw.engine._graphs

    def one_pass() -> dict:
        """Every request through submit/pump/flush; its flushes' kernel
        launches, captures and replays."""
        flush_t.clear()
        flush_b.clear()
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
        got = launched(launch_counts())
        want: dict = {}
        for tb, rows in zip(flush_t, flush_b):
            add_counts(want, fused_launches(torch, svc.params["layers"], tb, rows))
        s = gw.stats()
        if got != want or len(flush_t) != s["counters"]["batch.flushes"]:
            raise AssertionError(f"kernels launched {got} over {len(flush_t)} flushes "
                                 f"(telemetry {s['counters']['batch.flushes']}), expected "
                                 f"{want} by the fused dispatch")
        return {"wall_s": dt, "flushes": len(flush_t), "bucket_t": list(flush_t),
                "kernel_launches": got, "captures": graphs.captures - captures,
                "replays": graphs.replays - replays, "tickets": tickets,
                "requests_per_s": s["requests_per_s"], "batch_fill": s["batch_fill_ratio"],
                "p50_ms": s["latency_ms"]["p50"], "p95_ms": s["latency_ms"]["p95"],
                "compute_ms_p50": gw.telemetry.histograms["compute_ms"].percentile(50)}

    # the first pass captures one graph per bucket; the second only replays
    first, steady = one_pass(), one_pass()
    del gw.engine.score_masked
    buckets = sorted(set(steady["bucket_t"]))
    in_graph = {key[1][0][0][:2]: p.launches
                for key, p in graphs.programs.items() if key[0] == "score_masked"}
    if (first["captures"] != len(buckets) or first["captures"] + first["replays"] !=
            first["flushes"] or steady["captures"] or steady["replays"] != steady["flushes"]
            or sorted(t for _, t in in_graph) != buckets
            or any(n != fused_launches(torch, svc.params["layers"], t, b)
                   for (b, t), n in in_graph.items())):
        raise AssertionError(f"flushes over buckets {buckets}: first pass {first['captures']} "
                             f"captures, {first['replays']} replays; second {steady['captures']} "
                             f"captures, {steady['replays']} replays; kernels inside {in_graph}")
    worst = 0.0
    for run in (first, steady):
        for w, ticket in zip(requests, run.pop("tickets")):
            # each window alone, on the eager engine (not 57 captures of B=1)
            direct = float(eager.engine.score_masked({"series": w[None],
                                                       "lengths": np.array([w.shape[0]])})[0])
            np.testing.assert_allclose(ticket.score, direct, rtol=SCHEDULE_RTOL,
                                       atol=SCHEDULE_ATOL)
            worst = max(worst, abs(ticket.score - direct))
    in_graph = {f"{b}x{t}": n for (b, t), n in in_graph.items()}
    out["oneshot"] = {"windows": GATEWAY_WINDOWS, "first_pass": first, **steady,
                      "kernels_in_graph": in_graph, "max_abs_diff_vs_direct": worst}
    results["gateway"] = out
    for name, run in (("first pass (captures)", first), ("second pass", steady)):
        log(f"[gateway] {GATEWAY_WINDOWS} one-shot windows (T in 8..{t_len}, buckets {buckets}), "
            f"{name}: {run['flushes']} flushes of max_batch={GATEWAY_MAX_BATCH}, "
            f"{run['requests_per_s']:,.0f} requests/s over {run['wall_s']:.3f} s, batch fill "
            f"{run['batch_fill']:.3f}, p50 {run['p50_ms']:.2f} ms, p95 {run['p95_ms']:.2f} ms, "
            f"flush compute p50 {run['compute_ms_p50']:.2f} ms; kernel launches "
            f"{run['kernel_launches']}, the fused dispatch's by flush shape, from "
            f"{run['captures']} captures and {run['replays']} graph replays [{card}]")
    log(f"[gateway] kernels inside each (rows x bucket_T) graph {in_graph}; every score of both passes agrees "
        f"with the eager engine's score_masked of its window alone (max abs diff {worst:.3g}) "
        f"[{card}]")
    return sum(steady["kernel_launches"].values())


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
    Returns ``(gateway, windows)`` for the profiled flush after the LSTM-AE
    phases (its profiler pass must follow their captures)."""
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
    feats, t_len = svc.features, 64
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
    kernels = launched(launch_counts())
    flushes = int(gw.stats()["counters"]["batch.flushes"] + gw_b.stats()["counters"]["batch.flushes"])
    # every flush holds 1 to max_batch windows of bucket t_len, one kernel choice for all
    per_flush = fused_launches(torch, svc.params["layers"], t_len, GATEWAY_MAX_BATCH)
    if per_flush != fused_launches(torch, svc.params["layers"], t_len, 1):
        raise AssertionError(f"the fused dispatch changes kernel between 1 and "
                             f"{GATEWAY_MAX_BATCH} rows; count the flushes by size")
    want = add_counts({}, per_flush, flushes)
    if kernels != want or score_captures(svc) != captures_oneshot:
        raise AssertionError(f"kernels launched {kernels} over {flushes} flushes of bucket {t_len}, "
                             f"expected {want}; flush captures {captures_oneshot} after the "
                             f"one-shot passes, {score_captures(svc)} at the end")

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
               kernel_launches=kernels, flushes=flushes)
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
        f"queue series; kernel launches over the phase {kernels} = {flushes} flushes x {per_flush} "
        f"[{card}]")
    return gw, oneshot


def worker_gateway(report_dir: str, **kw):
    """The worker factory of the smoke's worker phase: the package's
    ``default_gateway_factory`` (spawn imports this script as
    ``__mp_main__`` in every worker), whose K1 launch count starts after
    the warm-up flush and is written to ``report_dir/<pid>.json`` when the
    worker exits cleanly, so each worker's K1 launches can be held to its
    flushes."""
    import atexit

    from repro_torch.gateway.workers import default_gateway_factory
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts

    gw = default_gateway_factory(**kw)
    reset_launch_counts()          # traffic only: the warm-up flush is not counted

    def report():
        with open(os.path.join(report_dir, f"{os.getpid()}.json"), "w") as f:
            json.dump({"pid": os.getpid(), "launches": launch_counts()}, f)

    atexit.register(report)
    return gw


def per_worker(front) -> dict:
    """pid -> that worker's stats, over the control pipes."""
    return {w["pid"]: w for w in front.stats()["per_worker"]}


def wait_for(predicate, what: str, timeout: float = 240.0) -> None:
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout:.0f} s waiting for {what}")
        time.sleep(0.05)


def drive_workers(torch, results, card) -> None:
    """The gateway at full width behind the multi-worker front: worker
    processes on the one card, each with its own CUDA context and captured
    bucket graph, clients in this process.  Scores bit-equal to an
    in-process gateway, kernel launches per worker, throughput at 1 and 2 workers, a
    SIGKILL with durable resume, a recalibration fan-out, priority
    shedding, the control loop (knobs and a scale-down, no new capture),
    the shutdown; then ``serve --workers 2`` from a cold kernel build with
    a fit in each worker, the training launcher with a resume, and
    ``run_with_recovery`` on the card."""
    import functools
    import signal
    import tempfile
    import urllib.request

    import numpy as np

    from repro_torch.config import get_config
    from repro_torch.control import ControlConfig, ControlLoop
    from repro_torch.data import TimeseriesConfig, make_batch
    from repro_torch.engine import AnomalyService
    from repro_torch.gateway.client import GatewayClient, GatewayClientError
    from repro_torch.gateway.workers import WorkerFront
    from repro_torch.obs import Histogram

    t_phase = time.perf_counter()
    cfg = get_config(GATEWAY_ARCH)
    svc = AnomalyService(GATEWAY_ARCH, schedule="fused", device="cuda", seed=0)
    feats, t_len = svc.features, 64
    # a worker's flushes hold 1 to max_batch windows of bucket t_len
    per_flush = fused_launches(torch, svc.params["layers"], t_len, GATEWAY_MAX_BATCH)
    if per_flush != fused_launches(torch, svc.params["layers"], t_len, 1):
        raise AssertionError(f"the fused dispatch changes kernel between 1 and "
                             f"{GATEWAY_MAX_BATCH} rows; count the flushes by size")
    data_cfg = TimeseriesConfig(features=feats, seq_len=t_len, batch=GATEWAY_STREAMS,
                                anomaly_rate=0.05, seed=7)
    windows = make_batch(data_cfg, 0)[0].numpy()                 # (N, T, F), as drive_gateway
    oneshot = [windows[i] for i in range(GATEWAY_WINDOWS)]
    n_sess = TRANSPORT_SESSIONS
    streams = windows[GATEWAY_WINDOWS:GATEWAY_WINDOWS + n_sess]  # (64, T, F)
    local_gw = svc.open_gateway(capacity=GATEWAY_CAPACITY, max_batch=GATEWAY_MAX_BATCH)
    local = local_gw.score(oneshot)                              # the in-process reference
    oracle_gw = svc.open_gateway(capacity=GATEWAY_CAPACITY, max_batch=GATEWAY_MAX_BATCH)
    for sid in range(n_sess):
        oracle_gw.admit(sid)
    oracle = np.zeros((n_sess, t_len), np.float32)
    for t in range(t_len):
        errs = oracle_gw.step({sid: streams[sid, t] for sid in range(n_sess)})
        oracle[:, t] = [errs[sid] for sid in range(n_sess)]
    out = {"arch": GATEWAY_ARCH, "capacity": GATEWAY_CAPACITY, "max_batch": GATEWAY_MAX_BATCH,
           "max_queue": WORKERS_MAX_QUEUE, "windows": GATEWAY_WINDOWS, "seq_len": t_len}
    flushes_at_exit: dict = {}      # pid -> batch.flushes when it last reported

    def note_flushes(front):
        for pid, w in per_worker(front).items():
            flushes_at_exit[pid] = int(w["counters"].get("batch.flushes", 0))

    def bp1_pass(host, port, conns):
        """Every connection pipelines all 512 windows in frames of 64 at
        once; returns requests/s over the pass."""
        got = {}

        def run(k):
            with GatewayClient(host, port, protocol="binary") as c:
                got[k] = c.score_many(oneshot, windows_per_frame=64)

        dt = in_threads(run, range(conns))
        for k in range(conns):
            if not np.array_equal(np.float32(got[k]), local):
                raise AssertionError("a worker's bp1 scores differ from the in-process gateway")
        return conns * GATEWAY_WINDOWS / dt

    with tempfile.TemporaryDirectory() as tmp:
        store, events, reports = (os.path.join(tmp, d) for d in ("store", "events", "reports"))
        os.makedirs(reports)
        factory = functools.partial(
            worker_gateway, reports, arch=GATEWAY_ARCH, schedule="fused",
            capacity=GATEWAY_CAPACITY, max_batch=GATEWAY_MAX_BATCH,
            max_queue=WORKERS_MAX_QUEUE, warm_seq_len=t_len, priority_classes=3)
        front = WorkerFront(factory, n_workers=1, store_dir=store, metrics_port=0,
                            event_dir=events)
        t0 = time.perf_counter()
        host, port = front.start(ready_timeout=600.0)
        out["start_1_s"] = time.perf_counter() - t0
        traced = {}
        conns = TRANSPORT_LATENCY_CONNS

        def closed_loop(idx):
            with GatewayClient(host, port, protocol="binary") as c:
                for i in idx:
                    traced[i] = c.traced_score(oneshot[i])

        def closed_loop_pass():
            """Single windows from 16 connections, traced: p50/p99 as the
            client sees them."""
            traced.clear()
            loop_s = in_threads(closed_loop, [range(k, GATEWAY_WINDOWS, conns)
                                              for k in range(conns)])
            if not np.array_equal(np.float32([traced[i]["score"]
                                              for i in range(GATEWAY_WINDOWS)]), local):
                raise AssertionError("closed-loop scores differ from in-process")
            latencies = [t["e2e_ms"] for t in traced.values()]
            return {"connections": conns, "requests_per_s": GATEWAY_WINDOWS / loop_s,
                    "p50_ms": percentile(latencies, 50), "p99_ms": percentile(latencies, 99)}

        try:
            # --- 1 worker: warm the connection path, then the timed passes
            bp1_pass(host, port, 1)
            out["bp1_requests_per_s_1"] = [bp1_pass(host, port, WORKERS_CONNS)
                                           for _ in range(WORKERS_PASSES)]
            out["closed_loop_1"] = closed_loop_pass()
            t0 = time.perf_counter()
            front.scale_up(ready_timeout=600.0)
            out["scale_up_s"] = time.perf_counter() - t0

            # --- 2 workers: bp1 and JSON scores from each bit-equal to in-process
            for attempt in range(32):
                with GatewayClient(host, port, protocol="binary") as cb, \
                        GatewayClient(host, port, protocol="json") as cj:
                    if not np.array_equal(np.float32(cb.score_many(oneshot[:64], windows_per_frame=64)),
                                          local[:64]):
                        raise AssertionError("bp1 scores of a worker differ from in-process")
                    if not np.array_equal(np.float32(cj.score_many(oneshot[:8])), local[:8]):
                        raise AssertionError("JSON scores of a worker differ from in-process")
                served = [int(w["counters"].get("queue.completed", 0))
                          for w in per_worker(front).values()]
                if len(served) == 2 and min(served) > 0:
                    break
            else:
                raise AssertionError(f"connections never reached both workers: {served}")
            out["bit_equal_connections"] = attempt + 1
            out["bp1_requests_per_s_2"] = [bp1_pass(host, port, WORKERS_CONNS)
                                           for _ in range(WORKERS_PASSES)]
            out["served_per_worker_after_passes"] = [
                int(w["counters"].get("queue.completed", 0)) for w in per_worker(front).values()]

            out["closed_loop"] = closed_loop_pass()
            body = urllib.request.urlopen(f"http://127.0.0.1:{front.metrics.port}/metrics",
                                          timeout=30).read().decode()
            agg = front.stats()
            want = ('repro_workers_count{scope="front"} 2',
                    f'repro_queue_completed_total{{scope="front"}} '
                    f'{agg["counters"]["queue.completed"]:.0f}')
            missing = [m for m in want if m not in body]
            if missing:
                raise AssertionError(f"the front's /metrics lacks {missing}")
            out["metrics_lines"] = [ln for ln in body.splitlines()
                                    if ln.startswith(("repro_workers_", "repro_queue_completed",
                                                      "repro_request_ms_count", "repro_batch_"))]
            out["metrics_bytes"] = len(body)

            # --- 64 durable streams, SIGKILL the busier worker, resume by token
            clients = [GatewayClient(host, port, protocol="binary") for _ in range(n_sess)]
            got = [[] for _ in range(n_sess)]
            groups = [range(k, n_sess, TRANSPORT_THREADS) for k in range(TRANSPORT_THREADS)]
            snap_at, kill_at = t_len // 2, t_len // 2 + TRANSPORT_STEP_FRAME

            def stepper(lo, hi):
                def run(sids):
                    for a in range(lo, hi, TRANSPORT_STEP_FRAME):
                        for sid in sids:
                            got[sid].extend(clients[sid].step_many(
                                streams[sid, a:a + TRANSPORT_STEP_FRAME]))
                return run

            in_threads(stepper(0, snap_at), groups)
            for c in clients:                    # one snapshot op on every worker
                c.request("snapshot")
            in_threads(stepper(snap_at, kill_at), groups)
            resident = {pid: int(w["active_streams"]) for pid, w in per_worker(front).items()}
            victim = max(resident, key=resident.get)
            note_flushes(front)
            os.kill(victim, signal.SIGKILL)
            wait_for(lambda: front.restarts == 1, "the monitor to see the crash")
            t0 = time.perf_counter()
            resumed = []

            def finish(sids):
                for sid in sids:
                    c = clients[sid]
                    try:
                        got[sid].extend(c.step_many(streams[sid, kill_at:kill_at + 1]))
                    except (ConnectionError, OSError):
                        c.close()
                        c2 = GatewayClient(host, port, protocol="binary")
                        res = c2.resume(c.session_token, replay=c.replay_buffer())
                        if res["seq"] != kill_at:
                            raise AssertionError(f"session {sid} resumed at {res['seq']}, "
                                                 f"expected {kill_at}")
                        resumed.append(res["replayed"])
                        clients[sid] = c = c2
                        got[sid].extend(c.step_many(streams[sid, kill_at:kill_at + 1]))
                    for a in range(kill_at + 1, t_len, TRANSPORT_STEP_FRAME):
                        got[sid].extend(c.step_many(streams[sid, a:a + TRANSPORT_STEP_FRAME]))
                    c.end_session()

            in_threads(finish, groups)
            out["resume_s"] = time.perf_counter() - t0
            for c in clients:
                c.close()
            gotarr = np.asarray(got, np.float32)
            if not np.array_equal(gotarr, oracle):
                raise AssertionError(f"resumed streams differ from the uninterrupted run (max abs "
                                     f"diff {float(np.max(np.abs(gotarr - oracle))):.3g})")
            if len(resumed) != resident[victim]:
                raise AssertionError(f"{len(resumed)} sessions resumed, the killed worker held "
                                     f"{resident[victim]}")
            wait_for(lambda: front.stats()["workers"]["count"] == 2, "the respawned worker")
            out["crash"] = {"sessions": n_sess, "on_killed_worker": resident[victim],
                            "resumed": len(resumed), "replayed": sum(resumed),
                            "restarts": front.restarts, "sessions_lost": front.sessions_lost,
                            "respawn_ready_s": time.perf_counter() - t0}
            if front.sessions_lost != 0:
                raise AssertionError(f"sessions_lost={front.sessions_lost} with the store")

            # --- recalibrate(params=...): fanned out, the card's tensors
            # converted to numpy on this (the supervisor's) side
            scaled = {"layers": tuple({k: v * 1.25 for k, v in layer.items()}
                                      for layer in svc.params["layers"])}
            svc.recalibrate(params=scaled)
            local2 = local_gw.score(oneshot[:64])
            if np.array_equal(local2, local[:64]):
                raise AssertionError("the param swap changed no score")
            t0 = time.perf_counter()
            rec = front.recalibrate(params=scaled)
            out["recalibrate_ms"] = (time.perf_counter() - t0) * 1e3
            if rec["workers"] != 2 or not rec["params_swapped"]:
                raise AssertionError(f"recalibrate reached {rec}")
            before = {p: int(w["counters"].get("queue.completed", 0))
                      for p, w in per_worker(front).items()}
            for attempt in range(32):
                with GatewayClient(host, port, protocol="binary") as c:
                    if not np.array_equal(np.float32(c.score_many(oneshot[:64])), local2):
                        raise AssertionError("a worker's scores after recalibrate differ")
                now = {p: int(w["counters"].get("queue.completed", 0))
                       for p, w in per_worker(front).items()}
                if all(now[p] > before.get(p, 0) for p in now):
                    break
            else:
                raise AssertionError("connections never reached both workers after recalibrate")

            # --- priority classes: the highest class sheds first.  Knobs
            # (never captures) hold the flushes back; one connection, one worker
            captures = {p: w["engine"]["compiles"] for p, w in per_worker(front).items()}
            front.set_batching(max_wait_ms=3_600_000.0)
            limits = [int(WORKERS_MAX_QUEUE * (1 - k / 3)) if k else WORKERS_MAX_QUEUE
                      for k in range(3)]
            with GatewayClient(host, port, protocol="binary") as c:
                rids = [c.submit(oneshot[i % GATEWAY_WINDOWS], priority=0)
                        for i in range(limits[2])]
                shed = c.submit(oneshot[0], priority=2)
                kept = [c.submit(oneshot[1], priority=1), c.submit(oneshot[2], priority=0)]
                c.ping()
                queued = front.stats()["queue_depth"]
                front.set_batching(max_wait_ms=5.0)
                try:
                    c.collect(shed)
                except GatewayClientError as exc:      # the typed error frame
                    if exc.error != "GatewayOverloadedError":
                        raise
                else:
                    raise AssertionError("a priority-2 request was admitted past its limit")
                answered = [c.collect(r) for r in rids + kept]
            counters = front.stats()["counters"]
            out["priority"] = {"classes": 3, "depth_limits": limits, "queued": queued,
                               "shed_p2": counters.get("admission.shed_p2", 0.0),
                               "shed_p1": counters.get("admission.shed_p1", 0.0),
                               "shed_p0": counters.get("admission.shed_p0", 0.0),
                               "answered": len(answered)}
            if (queued != limits[2] + 2 or out["priority"]["shed_p2"] != 1
                    or out["priority"]["shed_p1"] or out["priority"]["shed_p0"]
                    or not all(r["ok"] for r in answered)):
                raise AssertionError(f"priority shedding: {out['priority']}")

            # --- the control loop: SLO-driven knobs and the autoscaler,
            # ticked between closed-loop bursts
            loop = ControlLoop(front, ControlConfig(
                slo_p95_ms=WORKERS_SLO_MS, autoscale_min=1, autoscale_max=2, patience=1,
                cooldown_ticks=0, arch=GATEWAY_ARCH, floor_timesteps=t_len,
                extra={"max_wait_ms": 5.0}), lanes=GATEWAY_MAX_BATCH,
                max_queue=WORKERS_MAX_QUEUE, model_cfg=cfg.lstm_ae, event_dir=events)
            decisions = []
            for _ in range(3):
                in_threads(closed_loop, [range(k, GATEWAY_WINDOWS // 4, conns)
                                         for k in range(conns)])
                note_flushes(front)            # a scale-down may retire a worker now
                decisions.append(loop.tick())
            hist = Histogram.from_dict(front.stats()["histograms"].get("compute_ms"))
            scale = [d["scale"] for d in decisions]
            drains = [s["drain"] for s in scale if "drain" in s]
            now_captures = {p: w["engine"]["compiles"] for p, w in per_worker(front).items()}
            out["control"] = {
                "slo_p95_ms": WORKERS_SLO_MS, "eq1_floor_ms": loop.floor_ms,
                "flush_compute_p50_ms": hist.percentile(50), "flushes": hist.count,
                "actions": [d["action"] for d in decisions],
                "p95_ms": [d["p95_ms"] for d in decisions],
                "knobs": loop.describe()["knobs"],
                "scale": [(s["delta"], s["reason"]) for s in scale],
                "scale_down": drains,
                "new_captures": sum(now_captures[p] - captures[p] for p in now_captures)}
            if not loop.describe()["knobs"] or out["control"]["new_captures"]:
                raise AssertionError(f"the control loop: {out['control']}")
            if len(drains) != 1 or drains[0]["dropped_tickets"] or not drains[0]["clean"]:
                raise AssertionError(f"the scale-down: {drains}")
            loop.stop()
            front.control = None
            note_flushes(front)
        finally:
            summary = front.shutdown()
        out["shutdown"] = {k: summary[k] for k in ("workers", "clean_exits", "dropped_tickets",
                                                   "restarts", "sessions_migrated",
                                                   "sessions_lost")}
        if summary["dropped_tickets"] or summary["clean_exits"] != summary["workers"]:
            raise AssertionError(f"shutdown: {out['shutdown']}")
        launches_by_pid = {}
        for name in os.listdir(reports):
            with open(os.path.join(reports, name)) as f:
                rep = json.load(f)
            launches_by_pid[rep["pid"]] = launched(rep["launches"])
        out["launches_per_worker"] = [{"pid": pid, "launches": n, "flushes": flushes_at_exit[pid]}
                                      for pid, n in sorted(launches_by_pid.items())]
        clean = len(out["control"]["scale_down"]) + summary["clean_exits"]
    out["phase_s"] = time.perf_counter() - t_phase
    results["workers"] = out
    w1, w2 = max(out["bp1_requests_per_s_1"]), max(out["bp1_requests_per_s_2"])
    c = out["control"]
    log(f"[workers] {GATEWAY_ARCH} [fused] capacity={GATEWAY_CAPACITY}, "
        f"max_batch={GATEWAY_MAX_BATCH}, max_queue={WORKERS_MAX_QUEUE} per worker, every worker "
        f"on cuda:0 with its own CUDA context, clients in this process: front of 1 worker up in "
        f"{out['start_1_s']:.1f} s, scale-up to 2 in {out['scale_up_s']:.1f} s; bp1 and JSON "
        f"scores of both workers bit-equal to an in-process gateway on the same seed "
        f"({out['bit_equal_connections']} connection pair(s) to reach both) [{card}]")
    log(f"[workers] one-shot over bp1, {WORKERS_CONNS} connections each pipelining "
        f"{GATEWAY_WINDOWS} windows of T={t_len} in frames of 64: 1 worker "
        f"{', '.join(f'{r:,.0f}' for r in out['bp1_requests_per_s_1'])} requests/s, 2 workers "
        f"{', '.join(f'{r:,.0f}' for r in out['bp1_requests_per_s_2'])} requests/s (best "
        f"{w2 / w1:.2f}x; windows served per worker {out['served_per_worker_after_passes']}); "
        f"the single-process server thread earlier in this run "
        f"{results['transport']['oneshot']['bp1_requests_per_s']:,.0f} (18,456 in PERF.md §5) "
        f"[{card}]")
    cl, cl1 = out["closed_loop"], out["closed_loop_1"]
    log(f"[workers] closed loop, {cl['connections']} bp1 connections of single windows: 1 worker "
        f"{cl1['requests_per_s']:,.0f} requests/s, p50 {cl1['p50_ms']:.3f} ms, p99 "
        f"{cl1['p99_ms']:.3f} ms; 2 workers {cl['requests_per_s']:,.0f} requests/s, p50 "
        f"{cl['p50_ms']:.3f} ms, p99 {cl['p99_ms']:.3f} ms, as the client sees them [{card}]")
    log(f"[workers] the front's /metrics ({out['metrics_bytes']:,} bytes, aggregated over the "
        f"workers): " + "; ".join(out["metrics_lines"][:12]) + f" [{card}]")
    cr = out["crash"]
    log(f"[workers] {cr['sessions']} durable streams, SIGKILL of the worker holding "
        f"{cr['on_killed_worker']}: restarts={cr['restarts']}, sessions_lost="
        f"{cr['sessions_lost']}; {cr['resumed']} resumed by token on a live worker "
        f"({cr['replayed']} steps replayed), every running error of all {cr['sessions']} "
        f"bit-equal to the uninterrupted in-process run; respawned worker ready "
        f"{cr['respawn_ready_s']:.1f} s after the kill [{card}]")
    p = out["priority"]
    log(f"[workers] recalibrate(params=x1.25) fanned out to 2 workers in "
        f"{out['recalibrate_ms']:.1f} ms, both then bit-equal to the in-process gateway on the "
        f"new params; priority_classes=3 (depth limits {p['depth_limits']}): at depth "
        f"{p['queued'] - 2} a priority-2 request shed, priority 1 and 0 admitted (shed p2/p1/p0 "
        f"= {p['shed_p2']:.0f}/{p['shed_p1']:.0f}/{p['shed_p0']:.0f}), all {p['answered']} "
        f"admitted answered [{card}]")
    log(f"[workers] ControlLoop slo_p95_ms={c['slo_p95_ms']} autoscale 1:2: actions "
        f"{c['actions']} at window p95 {[round(x, 3) for x in c['p95_ms']]} ms, knobs "
        f"{c['knobs']}, scale {c['scale']}, scale-down dropped "
        f"{c['scale_down'][0]['dropped_tickets']} tickets (clean {c['scale_down'][0]['clean']}); "
        f"new flush captures 0; Eq-1 prior floor {c['eq1_floor_ms']:.3f} ms (the paper's FPGA "
        f"model) against the flush compute p50 measured here {c['flush_compute_p50_ms']:.3f} ms "
        f"over {c['flushes']} flushes [{card}]")
    s = out["shutdown"]
    log(f"[workers] shutdown: {s['clean_exits']}/{s['workers']} workers exited cleanly, "
        f"{s['dropped_tickets']} dropped tickets, restarts={s['restarts']}, sessions_lost="
        f"{s['sessions_lost']}; kernel launches per worker (pid: launches = flushes x "
        f"{per_flush}, the fused dispatch's at bucket {t_len}): "
        + ", ".join(f"{r['pid']}: {r['launches']} = {r['flushes']} x {per_flush}"
                    for r in out["launches_per_worker"]) + f"; phase {out['phase_s']:.1f} s [{card}]")
    if len(out["launches_per_worker"]) != clean or any(
            r["launches"] != add_counts({}, per_flush, r["flushes"]) or not r["flushes"]
            for r in out["launches_per_worker"]):
        raise AssertionError(f"launches per worker ({clean} clean exits): "
                             f"{out['launches_per_worker']}")


def drive_worker_launchers(torch, results, card) -> None:
    """``serve --workers 2`` in a subprocess from a cold kernel build (both
    workers build it at once) with a fit in each worker, and its SIGTERM
    drain; while its workers boot, the training launcher twice (the second
    run resumes) and ``run_with_recovery`` on the card with two injected
    failures against a clean run."""
    import functools
    import glob
    import queue
    import signal
    import tempfile
    import threading
    import types

    import numpy as np

    from repro_torch.config import TrainConfig, get_config
    from repro_torch.core.lstm import init_lstm_ae
    from repro_torch.data import TimeseriesConfig, TimeseriesIterator
    from repro_torch.distributed import FailureInjector, run_with_recovery
    from repro_torch.gateway.client import GatewayClient
    from repro_torch.kernels import _build
    from repro_torch.models.lstm_ae import train_loss
    from repro_torch.training import build_train_step, init_train_state

    out = {}
    cfg = get_config(GATEWAY_ARCH)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    # a cold start: the workers find no library of the fused forward's kernels
    # and build the one their flushes (at most 64 rows of T=64) take together
    (kernel,) = fused_launches(torch, meta_layers(torch, cfg), 64, 64)
    for name in ("lstm_cell", "lstm_stack"):
        for path in glob.glob(str(_build.library_path(name).with_suffix("")) + "*"):
            os.remove(path)
    t_serve = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--workers", "2", "--arch",
         GATEWAY_ARCH, "--full-config", "--schedule", "fused", "--capacity", "64",
         "--max-batch", "64", "--port", "0", "--train-steps", str(WORKERS_FIT_STEPS)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue" = queue.Queue()
    collected: list = []

    def pump():
        for line in proc.stdout:
            collected.append(line)
            lines.put(line)

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    try:
        with tempfile.TemporaryDirectory() as ckpt:
            train = [sys.executable, "-m", "repro_torch.launch.train", "--arch", GATEWAY_ARCH,
                     "--full-config", "--ckpt-dir", ckpt, "--ckpt-every", "3", "--batch", "8",
                     "--seq-len", "64"]
            runs = []
            for steps in (6, 9):
                t0 = time.perf_counter()
                r = subprocess.run(train + ["--steps", str(steps)], cwd=ROOT, env=env,
                                   capture_output=True, text=True, timeout=600)
                runs.append((r, time.perf_counter() - t0))
                if r.returncode != 0:
                    raise AssertionError(f"launch.train --steps {steps}: {r.stdout}{r.stderr}")
            if "resumed from step 6" not in runs[1][0].stdout or "resumed" in runs[0][0].stdout:
                raise AssertionError(f"launch.train did not resume: {runs[1][0].stdout}")
            out["train_runs"] = [{"s": dt, "lines": r.stdout.strip().splitlines()}
                                 for r, dt in runs]

        tc = TrainConfig(learning_rate=5e-3, warmup_steps=3, total_steps=12)
        step = build_train_step(types.SimpleNamespace(
            loss=functools.partial(train_loss, cfg=cfg)), tc)
        losses = []
        with tempfile.TemporaryDirectory() as ckpt:
            for name, inj in (("clean", None), ("faulty", FailureInjector((3, 8)))):
                state = init_train_state(
                    init_lstm_ae(torch.Generator().manual_seed(0), cfg, "cuda"), tc)
                it = TimeseriesIterator(TimeseriesConfig(features=cfg.lstm_ae.input_features,
                                                         seq_len=16, batch=8))
                t0 = time.perf_counter()
                _, ls = run_with_recovery(
                    state=state, train_step=lambda s, b: step(s, {"series": b[0].to("cuda")}),
                    iterator=it, total_steps=12, ckpt_dir=os.path.join(ckpt, name),
                    ckpt_every=5, injector=inj)
                losses.append((ls, time.perf_counter() - t0))
        np.testing.assert_allclose(losses[1][0], losses[0][0], rtol=1e-5)
        out["recovery"] = {"clean": losses[0][0], "faulty": losses[1][0],
                           "bit_equal": losses[0][0] == losses[1][0]}

        deadline = time.monotonic() + 600
        ready = ""
        while "listening on" not in ready:
            ready = lines.get(timeout=max(1.0, deadline - time.monotonic()))
        out["serve_ready_s"] = time.perf_counter() - t_serve
        port = int(ready.split("listening on ")[1].split()[0].rsplit(":", 1)[1])
        rng = np.random.default_rng(5)
        window = rng.standard_normal((64, cfg.lstm_ae.input_features)).astype(np.float32)
        scores = set()
        for _ in range(8):
            with GatewayClient("127.0.0.1", port, protocol="binary") as c:
                scores.add(c.score(window))
                agg = c.stats()
        thresholds = [w["threshold"] for w in agg["per_worker"]]
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=300)
        reader.join(30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    rest = "".join(collected)
    drained = [ln for ln in rest.splitlines() if ln.startswith("[workers] drained")]
    if proc.returncode != 0 or not drained or \
            "2/2 workers exited cleanly, 0 dropped tickets" not in drained[0]:
        raise AssertionError(f"serve --workers 2 drain (rc {proc.returncode}): {rest[-2000:]}")
    if not _build.library_path(kernel).is_file():
        raise AssertionError(f"the workers' cold build left no {kernel} library")
    out.update(serve_ready_line=ready.strip(), serve_drained_line=drained[0],
               fit_thresholds=thresholds, fit_thresholds_bit_equal=len(set(thresholds)) == 1,
               fit_distinct_scores=len(scores))
    results["worker_launchers"] = out
    log(f"[workers] serve: {ready.strip()} (cold {kernel} build in both workers, a "
        f"{WORKERS_FIT_STEPS}-step fit on the card in each; ready after "
        f"{out['serve_ready_s']:.1f} s, the runs below beside it) [{card}]")
    log(f"[workers] the workers' fits from one seed: thresholds {thresholds} (bit-equal: "
        f"{out['fit_thresholds_bit_equal']}), {len(scores)} distinct score(s) of one window "
        f"over 8 connections; SIGTERM: {drained[0]} [{card}]")
    log(f"[workers] launch.train {GATEWAY_ARCH} --full-config on the card, B=8, T=64, "
        f"checkpoints every 3: a 6-step run ({runs[0][1]:.1f} s), then a 9-step run "
        f"({runs[1][1]:.1f} s): " + " | ".join(runs[1][0].stdout.strip().splitlines())
        + f" [{card}]")
    log(f"[workers] run_with_recovery on the card ({GATEWAY_ARCH}, B=8, T=16, 12 steps, "
        f"checkpoints every 5), failures injected at steps 3 and 8: losses within rtol 1e-5 of "
        f"the clean run (bit-equal: {out['recovery']['bit_equal']}; last "
        f"{losses[1][0][-1]:.6f}) in {losses[1][1]:.1f} s against {losses[0][1]:.1f} s [{card}]")

MULTI_ARCH = "lstm-ae-f64-d6"
PIPELINE_MESHES = ((1, 2), (1, 4), (2, 2))     # (data, stage) over cuda:0, a stream a cell
MULTI_REQUESTS = 3
PIPELINE_RTOL, PIPELINE_ATOL = 1e-4, 1e-5      # tests/test_temporal.py's pipeline bar


def emulated(n: int) -> tuple:
    """``n`` names of the first GPU: one card standing in for n devices."""
    return ("cuda:0",) * n


def drive_multi_gpu(torch, main_svc, results, card) -> None:
    """The multi-GPU slice at the main path's width (f64-d6, B=8192, T=64,
    the main path's params): the stage pipeline on (1, 2), (1, 4) and (2, 2)
    meshes over cuda:0 (a stream per cell) against ``sequential`` and
    ``wavefront``, timed beside them and the captured ``fused`` engine;
    the same through ``EngineConfig("pipelined")``; then ``Placement.data(2)``
    over cuda:0 twice: engine scores bit-equal to the single placement with
    K1 launched 2 x 384 times per request, and the gateway (pool churn and
    one-shot windows) against the single-placement gateway.  With two GPUs
    or more, the data=2 engine, the (1, 2) pipeline and ``serve --mesh
    data=2 --http`` run on cuda:0 and cuda:1; with one, ``Placement.data(2)``
    without ``devices=`` must raise."""
    import functools

    import numpy as np

    from repro_torch.core.lstm import lstm_ae_sequential
    from repro_torch.core.temporal import (build_stage_params, pipelined_forward,
                                           wavefront_forward)
    from repro_torch.data import TimeseriesConfig, make_batch
    from repro_torch.engine import AnomalyService, EngineConfig, Placement
    from repro_torch.gateway import drive_stream_churn
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh

    t_phase = time.perf_counter()
    cfg, params = main_svc.cfg, main_svc.params
    depth, feats = len(params["layers"]), main_svc.features
    batch, t_len = 8192, 64
    data_cfg = TimeseriesConfig(features=feats, seq_len=t_len, batch=batch, anomaly_rate=0.05)
    requests = [make_batch(data_cfg, i)[0] for i in range(MULTI_REQUESTS)]
    on_card = [r.to("cuda") for r in requests]
    xs = on_card[0].transpose(0, 1).contiguous()                      # (T, B, F)
    out = {"arch": MULTI_ARCH, "batch": batch, "seq_len": t_len,
           "gpus": torch.cuda.device_count(), "pipeline": {}}

    # --- the stage pipeline over meshes of cuda:0
    ref = lstm_ae_sequential(params, xs)
    wave_ms = host_ms(torch, lambda: wavefront_forward(params, xs), iters=3)
    wave = wavefront_forward(params, xs)
    torch.testing.assert_close(wave, ref, rtol=PIPELINE_RTOL, atol=PIPELINE_ATOL)
    fused = main_svc.engine
    fused_ms = host_ms(torch, lambda: fused.reconstruct({"series": on_card[0]}), iters=5)
    out["wavefront_ms"], out["fused_captured_ms"] = wave_ms, fused_ms
    for shape in PIPELINE_MESHES:
        mesh = make_host_mesh(shape, ("data", "model"), devices=emulated(shape[0] * shape[1]))
        sp, counts, assignment = build_stage_params(params, cfg, shape[1])
        run = functools.partial(pipelined_forward, sp, counts, xs, mesh=mesh, cfg=cfg)
        ys = run()
        torch.testing.assert_close(ys, ref, rtol=PIPELINE_RTOL, atol=PIPELINE_ATOL)
        torch.testing.assert_close(ys, wave, rtol=PIPELINE_RTOL, atol=PIPELINE_ATOL)
        row = {"assignment": assignment, "counts": counts.tolist(),
               "pass_through_stages": int((counts == 0).sum()),
               "ms_per_forward": host_ms(torch, run, iters=3),
               "max_abs_err_vs_sequential": float((ys - ref).abs().max())}
        out["pipeline"][f"{shape[0]}x{shape[1]}"] = row
        log(f"[multi_gpu] pipeline {shape[0]}x{shape[1]} (data x stage) over cuda:0, a stream a "
            f"cell: {MULTI_ARCH} B={batch} T={t_len}, assignment {assignment}, layers per stage "
            f"{row['counts']} ({row['pass_through_stages']} pass-through), "
            f"{row['ms_per_forward']:.2f} ms/forward against wavefront {wave_ms:.2f} and fused "
            f"(captured) {fused_ms:.2f}; agrees with sequential (max abs err "
            f"{row['max_abs_err_vs_sequential']:.3g}; rtol {PIPELINE_RTOL}, atol "
            f"{PIPELINE_ATOL}) and wavefront [{card}]")
    for name, ecfg in (
            ("pipelined n_stages=2", EngineConfig("pipelined", n_stages=2,
                                                  placement=Placement(devices=emulated(2)))),
            ("pipelined n_stages=2, data=2", EngineConfig("pipelined", n_stages=2,
                                                          placement=Placement.data(
                                                              2, devices=emulated(4))))):
        psvc = AnomalyService(MULTI_ARCH, schedule=ecfg, device="cuda")
        psvc.recalibrate(params=params)
        if psvc.engine.schedule.tag != "pipelined":
            raise AssertionError(f"{name} resolved to {psvc.engine.schedule.tag}")
        recon = psvc.engine.reconstruct({"series": on_card[0]})
        torch.testing.assert_close(recon.transpose(0, 1), ref, rtol=PIPELINE_RTOL,
                                   atol=PIPELINE_ATOL)
        ms = host_ms(torch, lambda: psvc.engine.reconstruct({"series": on_card[0]}), iters=3)
        out["pipeline"][f"engine {name}"] = {"ms_per_forward": ms}
        log(f"[multi_gpu] Engine({name}) over cuda:0: reconstruct agrees with sequential, "
            f"{ms:.2f} ms/request with the input on the card [{card}]")

    # --- data-parallel serving: Placement.data(2) over cuda:0 twice
    pl = Placement.data(2, devices=emulated(2))
    dsvc = AnomalyService(MULTI_ARCH, schedule=EngineConfig("fused", placement=pl), device="cuda")
    dsvc.recalibrate(params=params)
    dsvc.score(requests[0]).cpu()      # the captures, one per shard
    single = [main_svc.score(r).cpu() for r in requests]
    torch.cuda.synchronize()
    reset_launch_counts()
    sharded = [dsvc.score(r).cpu() for r in requests]
    k1 = launch_counts()["lstm_cell"]
    if k1 != MULTI_REQUESTS * 2 * depth * t_len:
        raise AssertionError(f"data=2: K1 launched {k1} times over {MULTI_REQUESTS} requests, "
                             f"expected {MULTI_REQUESTS} x 2 x {depth * t_len}")
    for a, b in zip(sharded, single):
        if not torch.equal(a, b):
            raise AssertionError(f"data=2 scores differ from the single placement's "
                                 f"(max abs diff {float((a - b).abs().max()):.3g})")
    per = dsvc.engine.profile_info()["per_program"]
    captures = {k: v["compiles"] for k, v in per.items() if k.startswith("score@")}
    if captures != {"score@shard0": 1, "score@shard1": 1}:
        raise AssertionError(f"data=2 captures per shard: {captures}")
    d_ms = host_ms(torch, lambda: dsvc.engine.score({"series": on_card[0]}), iters=5)
    s_ms = host_ms(torch, lambda: fused.score({"series": on_card[0]}), iters=5)
    # device time of a request, queued behind a sleep kernel: whether the
    # layout's cost is the card's or the host's
    d_dev = device_ms(torch, lambda: dsvc.engine.score({"series": on_card[0]}), iters=5, reps=3)
    s_dev = device_ms(torch, lambda: fused.score({"series": on_card[0]}), iters=5, reps=3)
    out["data2_engine"] = {"k1_launches": k1, "k1_per_request": k1 // MULTI_REQUESTS,
                           "captures": captures, "ms_per_request_input_on_card": d_ms,
                           "single_ms_per_request_input_on_card": s_ms,
                           "device_ms_per_request": d_dev, "single_device_ms_per_request": s_dev}
    log(f"[multi_gpu] Engine(fused, {pl!r}): {MULTI_REQUESTS} requests at B={batch}, scores "
        f"bit-equal to the single placement; K1 launches {k1} = {MULTI_REQUESTS} x 2 x "
        f"{depth * t_len} (one captured graph per shard: {captures}); {d_ms:.3f} against "
        f"{s_ms:.3f} ms/request single, input on the card; device time {d_dev:.3f} against "
        f"{s_dev:.3f} ms [{card}]")

    gws = main_svc.open_gateway(capacity=GATEWAY_CAPACITY, max_batch=GATEWAY_MAX_BATCH,
                                placement=pl)
    gwu = main_svc.open_gateway(capacity=GATEWAY_CAPACITY, max_batch=GATEWAY_MAX_BATCH)
    windows = make_batch(TimeseriesConfig(features=feats, seq_len=t_len, batch=GATEWAY_STREAMS,
                                          anomaly_rate=0.05, seed=7), 0)[0].numpy()
    churn = {}
    for name, gw in (("data2", gws), ("single", gwu)):
        gw.telemetry.reset()
        t0 = time.perf_counter()
        finals, _ = drive_stream_churn(gw, windows)
        churn[name] = (finals, time.perf_counter() - t0, gw.stats()["stream_steps_per_s"])
    f2, f1 = churn["data2"][0], churn["single"][0]
    if set(f2) != set(f1):
        raise AssertionError("data=2 and single gateways served different streams")
    diff = max(abs(f2[i] - f1[i]) for i in f1)
    for i in f1:
        np.testing.assert_allclose(f2[i], f1[i], rtol=CAPTURE_RTOL, atol=CAPTURE_ATOL)
    stream_bit_equal = all(f2[i] == f1[i] for i in f1)
    if gws.pool.captures != 2:
        raise AssertionError(f"the data=2 pool captured {gws.pool.captures} steps, expected "
                             f"one per shard")
    for i in range(GATEWAY_CAPACITY):
        gws.admit(("resident", i))
    active = gws.pool.per_device_active()
    if active != [GATEWAY_CAPACITY // 2] * 2:
        raise AssertionError(f"per_device_active {active} after {GATEWAY_CAPACITY} admissions")
    for i in range(GATEWAY_CAPACITY):
        gws.evict(("resident", i))
    rng = np.random.default_rng(12)
    lens = rng.integers(8, t_len + 1, size=GATEWAY_WINDOWS)
    oneshot = [windows[i % GATEWAY_STREAMS, :n] for i, n in enumerate(lens)]
    rates, fills, scores = {}, {}, {}
    for name, gw in (("data2", gws), ("single", gwu)):
        gw.score(oneshot)                 # the first pass captures each bucket
        gw.telemetry.reset()
        t0 = time.perf_counter()
        scores[name] = gw.score(oneshot)
        rates[name] = GATEWAY_WINDOWS / (time.perf_counter() - t0)
        fills[name] = gw.stats()["gauge_vecs"].get("queue.device_fill")
    if not np.array_equal(scores["data2"], scores["single"]):
        raise AssertionError("data=2 one-shot scores differ from the single placement's")
    out["data2_gateway"] = {
        "stream_max_abs_diff": diff, "stream_bit_equal": stream_bit_equal,
        "stream_steps_per_s": churn["data2"][2], "single_stream_steps_per_s": churn["single"][2],
        "per_device_active": active, "oneshot_requests_per_s": rates["data2"],
        "single_oneshot_requests_per_s": rates["single"], "queue_device_fill": fills["data2"],
        "pool_captures": gws.pool.captures}
    log(f"[multi_gpu] gateway on {pl!r}, capacity={GATEWAY_CAPACITY}, "
        f"max_batch={GATEWAY_MAX_BATCH}: {len(f1)} of {GATEWAY_STREAMS} streams churned, their "
        f"running errors within {CAPTURE_RTOL}/{CAPTURE_ATOL} of the single placement's (max abs "
        f"diff {diff:.3g}, bit-equal: {stream_bit_equal}), {churn['data2'][2]:,.0f} against "
        f"{churn['single'][2]:,.0f} stream-steps/s; pool captures {gws.pool.captures} (one per "
        f"shard); per_device_active {active} at capacity; {GATEWAY_WINDOWS} one-shot windows "
        f"bit-equal to the single placement, {rates['data2']:,.0f} against "
        f"{rates['single']:,.0f} requests/s, last flush's queue.device_fill {fills['data2']} "
        f"[{card}]")

    # --- distinct GPUs
    gpus = torch.cuda.device_count()
    if gpus >= 2:
        two = AnomalyService(MULTI_ARCH, schedule=EngineConfig("fused", placement=Placement.data(2)),
                             device="cuda:0")
        two.recalibrate(params=params)
        if two.engine.shard_devices != [torch.device("cuda:0"), torch.device("cuda:1")]:
            raise AssertionError(f"Placement.data(2) took {two.engine.shard_devices}")
        for r, want in zip(requests, single):
            if not torch.equal(two.score(r).cpu(), want):
                raise AssertionError("data=2 over cuda:0 and cuda:1 differs from one GPU")
        mesh = make_host_mesh((1, 2), ("data", "model"))
        sp, counts, _ = build_stage_params(params, cfg, 2)
        ys = pipelined_forward(sp, counts, xs, mesh=mesh, cfg=cfg)
        torch.testing.assert_close(ys, ref, rtol=PIPELINE_RTOL, atol=PIPELINE_ATOL)
        out["two_gpus"] = {"data2_bit_equal": True, "pipeline_1x2_max_abs_err":
                           float((ys - ref).abs().max()),
                           "serve_ready_line": serve_mesh_http(torch)}
        log(f"[multi_gpu] {gpus} GPUs: data=2 over cuda:0 and cuda:1 bit-equal to one GPU, the "
            f"1x2 pipeline over them agrees with sequential, serve --mesh data=2 --http: "
            f"{out['two_gpus']['serve_ready_line']} [{card}]")
    else:
        try:
            AnomalyService(MULTI_ARCH, schedule=EngineConfig("fused", placement=Placement.data(2)),
                           device="cuda")
        except ValueError as exc:
            refusal = str(exc)
        else:
            raise AssertionError("Placement.data(2) without devices= built on one GPU")
        out["two_gpus"] = None
        log(f"[multi_gpu] {gpus} GPU visible: the distinct-GPU runs (data=2, the 1x2 pipeline, "
            f"serve --mesh data=2 --http) need two; every figure above is emulated on cuda:0. "
            f"Placement.data(2) without devices= raises: {refusal}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[multi_gpu] phase {out['phase_s']:.1f} s [{card}]")
    results["multi_gpu"] = out


def serve_mesh_http(torch) -> str:
    """``serve --mesh data=2 --http`` over the first two GPUs: one score
    over the socket, then the SIGTERM drain; returns the ready line."""
    import signal

    import numpy as np

    from repro_torch.gateway.client import GatewayClient

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", MULTI_ARCH, "--full-config",
         "--schedule", "fused", "--http", "--mesh", "data=2", "--port", "0", "--max-batch", "8"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ready = proc.stdout.readline()
        if "listening on" not in ready or "mesh=2xdata" not in ready:
            raise AssertionError(f"serve --mesh data=2 --http: {ready}")
        port = int(ready.split("listening on ")[1].split()[0].rsplit(":", 1)[1])
        with GatewayClient("127.0.0.1", port) as c:
            if not np.isfinite(c.score(np.zeros((64, 64), np.float32))):
                raise AssertionError("serve --mesh data=2 --http: a score is not finite")
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    if proc.returncode != 0:
        raise AssertionError(f"serve --mesh data=2 --http drain (rc {proc.returncode}): {rest}")
    return ready.strip()


def device_busy_over(torch, fn, names: bool = False) -> dict:
    """Wall time of one ``fn()``, the time the device was busy in it (the
    union of its kernels', copies' and memsets' intervals) and the launch
    calls the host made, from one ``torch.profiler`` pass; with ``names``
    also every event's name seen
    (host operators and device kernels) and the device time (ms) summed
    per device kernel name."""
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
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3, "device_ops": len(spans),
           "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
           "host_calls": sum(e.name in LAUNCH_CALLS for e in prof.events())}
    if names:
        out["names"] = sorted({e.name for e in prof.events()})
        by_name: dict = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        out["device_ms_by_name"] = dict(sorted(by_name.items(), key=lambda kv: -kv[1]))
    return out


def profile_transport_flush(torch, gw, oneshot, results, card) -> None:
    """The transport phase's gateway (its bucket captured there) behind a
    new server, under the profiler: the bp1 pass of the phase (every window
    in frames of 64) once plain and once profiled, for the device's idle
    share over the pass and the windows per flush; then one flush, a bp1
    frame of max_batch windows, and the kernels of the fused forward the
    device ran for it (one ``lstm_stack`` under the crossover)."""
    from repro_torch.gateway.client import GatewayClient
    from repro_torch.gateway.server import GatewayServer

    t_len = oneshot[0].shape[0]
    want = fused_launches(torch, gw.engine.params["layers"], t_len, GATEWAY_MAX_BATCH)
    ((kernel, per_flush),) = want.items()
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
            # each profiled pass is one flush
            prof = host_launches(torch, lambda: c.score_many(oneshot[:GATEWAY_MAX_BATCH],
                                                             windows_per_frame=GATEWAY_MAX_BATCH),
                                 per_flush, kernel=DEVICE_KERNEL[kernel])
            flushed = (gw.stats()["counters"]["batch.flushes"] - flushes) / prof["profile_attempts"]
    finally:
        server.stop_in_thread()
    busy.update(windows=len(oneshot), flushes=int(pass_flushes),
                windows_per_flush=len(oneshot) / pass_flushes,
                requests_per_s=len(oneshot) / (busy["wall_ms"] / 1e3),
                plain_requests_per_s=len(oneshot) / plain_s)
    results["transport"]["bp1_pass_profiled"] = busy
    in_graph = launches_in_graph(gw.engine, "score_masked")
    if flushed != 1 or prof["kernel_device_events"] != per_flush or in_graph != [want]:
        raise AssertionError(f"one socket flush: {flushed} flushes, "
                             f"{prof['kernel_device_events']} {kernel} kernels on the device, "
                             f"{in_graph} inside the graph; expected {want}")
    results["transport"]["profiled_flush"] = prof
    log(f"[transport] the bp1 pass ({busy['windows']} windows in frames of 64) under the "
        f"profiler: {busy['wall_ms']:.3f} ms, the device busy {busy['device_busy_ms']:.3f} ms "
        f"(the union of {busy['device_ops']} kernels, copies and memsets), idle share "
        f"{busy['idle_share']:.4f}; {busy['flushes']} flushes of "
        f"{busy['windows_per_flush']:.2f} windows on average; "
        f"{busy['requests_per_s']:,.0f} requests/s profiled, {busy['plain_requests_per_s']:,.0f} "
        f"in the plain pass just before [{card}]")
    log(f"[transport] one flush over the socket (a bp1 frame of {GATEWAY_MAX_BATCH} windows) "
        f"under the profiler: the device ran {prof['kernel_device_events']} {kernel} kernel(s), "
        f"as the flush graph records ({want}); device busy {prof['device_busy_ms']:.3f} ms "
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
    if counts != {"lstm_cell": 0, "lstm_seq": 0, "wkv6": 3, "flash_attention": 0,
                  "lstm_stack": 0}:
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


def device_kernels(torch, fn, calls: int = 3, passes: int = 3) -> list[str]:
    """Names of the device kernels ``fn()`` runs, from a ``torch.profiler``
    pass over ``calls`` calls of it.  ``fn`` always launches work, so a pass
    that records no device event at all lost its trace; such a pass is
    logged and run again, at most ``passes`` times in all, and the check
    fails if none of them sees a kernel."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, passes + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = sorted({e.name for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA})
        if names:
            return names
        log(f"[profiler] pass {attempt} of {passes} over {calls} calls recorded no device event")
        time.sleep(0.5)
    raise AssertionError(f"torch.profiler saw no device kernel in {passes} passes")


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
    if counts != {"lstm_cell": 0, "lstm_seq": 0, "wkv6": 0, "flash_attention": 1,
                  "lstm_stack": 0}:
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


def stack_case(torch, arch: str, seed: int) -> list:
    """An LSTM-AE configuration's layers {wx, wh, b} on the card, drawn as
    the service draws them."""
    from repro_torch.config import get_config
    from repro_torch.core.lstm import init_lstm_ae

    params = init_lstm_ae(torch.Generator().manual_seed(seed), get_config(arch), device="cuda")
    return [dict(layer) for layer in params["layers"]]


def k1_chain(torch, layers, xs):
    """The ``fused`` forward's K1 path: one ``lstm_cell_op`` a (layer,
    timestep), layer by layer, from zero state."""
    from repro_torch.kernels.lstm_cell import pack_weights
    from repro_torch.kernels.ops import lstm_cell_op

    ys = xs
    t_len, bsz, _ = xs.shape
    for layer in layers:
        packed = pack_weights(layer)
        hidden = packed[1].shape[1]
        out = torch.empty((t_len, bsz, hidden), dtype=xs.dtype, device=xs.device)
        h = torch.zeros((bsz, hidden), dtype=xs.dtype, device=xs.device)
        c = torch.zeros((bsz, hidden), dtype=torch.float32, device=xs.device)
        for t in range(t_len):
            h, c = lstm_cell_op(packed, ys[t], h, c, h_out=out[t], c_out=c)
        ys = out
    return ys


def captured(torch, fn):
    """``fn`` captured into a CUDA graph after one warm-up call on a side
    stream; returns (the graph, its output)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def check_stack(torch, results) -> None:
    """The whole-stack kernel against its plain version (the K1 chain's
    function) at the latency cells' configurations and shape (B=1, T=64),
    the gateway's flush (B=256) and short and ragged windows, both
    activations, at K1's f32 bar; one counted launch and a synchronize
    each."""
    from repro_torch.kernels.lstm_stack import lstm_stack_cuda, lstm_stack_plain
    from repro_torch.kernels.ops import launch_counts

    err, n = 0.0, 0
    for arch in STACK_ARCHS:
        layers = stack_case(torch, arch, seed=10)
        feats = layers[0]["wx"].shape[0]
        for b, t_len in STACK_CASES:
            for pwl in (False, True):
                xs = torch.randn(t_len, b, feats, device="cuda",
                                 generator=torch.Generator(device="cuda").manual_seed(n))
                before = launch_counts()["lstm_stack"]
                got = lstm_stack_cuda(xs, layers, pwl=pwl)
                torch.cuda.synchronize()
                if launch_counts()["lstm_stack"] != before + 1:
                    raise AssertionError(f"[stack] {arch} B={b} T={t_len}: not one counted launch")
                want = lstm_stack_plain(xs, layers, pwl=pwl)
                if got.shape != want.shape or got.dtype != torch.float32:
                    raise AssertionError(f"[stack] {arch} B={b} T={t_len}: {got.shape} "
                                         f"{got.dtype}, expected {want.shape} float32")
                torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
                err = max(err, float((got - want).abs().max()))
                n += 1
    results["stack_checks"] = n
    results["stack_max_abs_err_f32"] = err
    log(f"[stack] {n} checks against the plain version passed: {', '.join(STACK_ARCHS)} x "
        f"(B, T) in {list(STACK_CASES)} x pwl, f32: max abs err {err:.3g} (tol {F32_TOL})")


def time_stack(torch, results, card) -> dict:
    """The whole-stack kernel at the latency cells' configurations, B=1 and
    the gateway's B=256, T=64, f32: device time a launch beside its bound
    (the operations at the FP32 peak; the chain is T + D - 1 wavefront
    steps), the host's time a call, the plain version, and the captured K1
    chain it replaces at the same shape (D x T launches), whose output it
    must equal within K1's f32 bar.  Rows land in ``results["stack_time"]``;
    returns the lstm-ae-f64-d6 B=1 row (``f64d6.latency``'s shape)."""
    from repro_torch.kernels.lstm_stack import (
        layer_dims,
        lstm_stack_cuda,
        lstm_stack_plain,
        lstm_stack_rows,
    )

    rows = []
    for arch in STACK_ARCHS:
        layers = stack_case(torch, arch, seed=11)
        dims = layer_dims(layers)
        for b in (1, GATEWAY_MAX_BATCH):
            xs = torch.randn(STACK_T, b, dims[0][0], device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(b))
            graph, chain_out = captured(torch, lambda: k1_chain(torch, layers, xs))
            graph.replay()
            stack_out = lstm_stack_cuda(xs, layers)
            torch.cuda.synchronize()
            torch.testing.assert_close(stack_out, chain_out, rtol=F32_TOL, atol=F32_TOL)
            flops = sum(8.0 * b * STACK_T * h * (i + h) for i, h in dims)
            row = {
                "arch": arch, "batch": b, "seq_len": STACK_T, "depth": len(dims),
                "steps": STACK_T + len(dims) - 1, "k1_launches": len(dims) * STACK_T,
                "rows_per_cluster": lstm_stack_rows(dims, STACK_T, b), "flop": flops,
                "kernel_ms": device_ms(torch, lambda: lstm_stack_cuda(xs, layers)),
                "kernel_host_ms": host_ms(torch, lambda: lstm_stack_cuda(xs, layers)),
                "plain_ms": device_ms(torch, lambda: lstm_stack_plain(xs, layers), iters=2, reps=3),
                "k1_chain_ms": device_ms(torch, graph.replay, iters=10, reps=3),
                "max_abs_diff_vs_k1_chain": float((stack_out - chain_out).abs().max()),
                "bound_ms": flops / PEAK_F32_FLOPS * 1e3, "bound_by": "operations",
            }
            row["library_ms"] = None   # cuDNN's multi-layer LSTM takes one width for every layer
            row["step_us"] = row["kernel_ms"] * 1e3 / row["steps"]
            rows.append(row)
            del graph
            log(f"[stack time] {arch} B={b} T={STACK_T} ({row['rows_per_cluster']} row(s) a "
                f"cluster of {len(dims)} CTAs): kernel {row['kernel_ms']:.5f} ms (device; "
                f"{row['step_us']:.3f} us a step of {row['steps']}), {row['kernel_host_ms']:.5f} ms "
                f"a call in a Python loop; plain {row['plain_ms']:.3f} ms; the captured K1 chain "
                f"({row['k1_launches']} launches) {row['k1_chain_ms']:.5f} ms, its output within "
                f"{row['max_abs_diff_vs_k1_chain']:.3g}; bound {row['bound_ms']:.6f} ms "
                f"(operations, {flops:.4g} FLOP at the FP32 peak) [{card}]")
    results["stack_time"] = rows
    return rows[0]


def host_launches(torch, fn, want: int | None = None, passes: int = 3,
                  kernel: str = K1_KERNEL) -> dict:
    """The launch calls (kernels, graphs, copies, memsets) the host makes in
    one ``fn()``, by CUDA API name, and the kernels, copies and memsets the
    device ran with their summed time (ms), those of ``kernel`` (a device
    function's name: K1's by default) among them (those inside a replayed
    graph too), from one ``torch.profiler`` pass.

    The trace is lossy: passes that agree with the launch count miss a few
    other device events (418 of a request's 421), and one pass recorded
    none of a request's 128 K1 kernels.  So where ``want`` is given, a
    pass that does not see that many of ``kernel`` is logged and run again,
    ``fn`` included, at most ``passes`` times in all, as ``device_kernels``
    does.  The result is the last pass's, with ``profile_attempts`` and each
    missed pass's (device events, kernel events) in ``lost_passes``; the
    caller's check reads it, so a kernel that never runs still fails."""
    from torch.profiler import ProfilerActivity, profile

    lost = []
    for attempt in range(1, passes + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        calls: dict = {}
        device, seen, busy_us = 0, 0, 0.0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                device += 1
                seen += kernel in e.name
                busy_us += e.time_range.elapsed_us()
            elif e.name in LAUNCH_CALLS:
                calls[e.name] = calls.get(e.name, 0) + 1
        if want is None or seen == want:
            break
        lost.append((device, seen))
        log(f"[profiler] pass {attempt} of {passes} recorded {seen} {kernel} kernels of {want} "
            f"({device} device events in all)")
        time.sleep(0.5)
    return {"host_calls": calls, "host_total": sum(calls.values()), "device_ops": device,
            "kernel": kernel, "kernel_device_events": seen, "device_busy_ms": busy_us / 1e3,
            "profile_attempts": attempt, "lost_passes": lost}


def launches_in_graph(engine, name: str) -> list[dict]:
    """Kernel launches recorded in each captured graph of program ``name``."""
    return [p.launches for key, p in engine._graphs.programs.items() if key[0] == name]


def drive_service(torch, arch: str, batch: int, seq_len: int, requests: int, results, card):
    """Serve ``arch`` on every single-GPU schedule; check the kernel path's
    launch count and its agreement with the other schedules and the CPU;
    then the fused path captured against the same path run eagerly."""
    from repro_torch.data import TimeseriesConfig, make_batch
    from repro_torch.engine import AnomalyService, EngineConfig
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.utils import params_to_numpy

    fused = AnomalyService(arch, schedule="fused", device="cuda", seed=0)
    feats = fused.features
    per_request = fused_launches(torch, fused.params["layers"], seq_len, batch)
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
        launches = launched(launch_counts())
        want = add_counts({}, per_request, requests) if name.startswith("fused") else {}
        if launches != want:
            raise AssertionError(f"{arch} [{name}]: kernels launched {launches}, expected {want}")
        alerts = sum(int((s > threshold).sum()) for s in scores[name])
        ms = dt / requests * 1e3
        rate = requests * batch * seq_len / dt
        row = out["schedules"][name] = {"ms_per_request": ms, "timesteps_per_s": rate,
                                        "kernel_launches": launches, "alerts": alerts}
        how = "eager"
        if svc.engine._graphs is not None:
            row["replays"] = svc.engine._graphs.replays - replays
            row["in_graph"] = launches_in_graph(svc.engine, "score")
            if row["replays"] != requests:
                raise AssertionError(f"{arch} [{name}]: {row['replays']} graph replays for "
                                     f"{requests} requests")
            how = f"{row['replays']} graph replays, launches inside the graph {row['in_graph']}"
        log(f"[serve] {arch} [{name}] B={batch} T={seq_len}: {requests} requests, "
            f"{ms:.3f} ms/request, {rate:,.0f} timesteps/s, kernel launches {launches} ({how}), "
            f"alerts={alerts} [{card}]")
        if name == "fused":
            out["kernel_launches"] = launches
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
    in_graph = out["schedules"]["fused"]["in_graph"]
    if in_graph != [per_request]:
        raise AssertionError(f"{arch}: the fused score graphs hold {in_graph} launches, "
                             f"expected one graph of {per_request}")
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
        f"{CAPTURE_ATOL}), bit-equal: {out['captured_vs_eager']['bit_equal']}; {in_graph[0]} "
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
    after the LSTM-AE phases and before the LM ones: its profiler passes
    follow every LSTM-AE capture."""
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts

    ((kernel, want),) = fused_launches(torch, fused.params["layers"], out["seq_len"],
                                       out["batch"]).items()
    for name, svc in (("fused", fused), ("fused-eager", eager)):
        # the count is reset inside each profiled pass: it reads the last pass
        lp = host_launches(torch, lambda: (reset_launch_counts(), svc.score(request).cpu()), want,
                           kernel=DEVICE_KERNEL[kernel])
        lp["wrapper"], lp["counted_launches"] = kernel, launch_counts()[kernel]
        if lp["kernel_device_events"] != want or lp["counted_launches"] != want:
            raise AssertionError(
                f"{arch} [{name}]: one request ran {lp['kernel_device_events']} {kernel} kernels "
                f"on the device ({lp['device_ops']} device events in all, pass "
                f"{lp['profile_attempts']}; earlier passes {lp['lost_passes']}), and the launch "
                f"count says {lp['counted_launches']}; expected {want}")
        out["schedules"][name]["launches_per_request"] = lp
        row = out["schedules"][name]
        lp["device_busy_share"] = lp["device_busy_ms"] / row["ms_per_request_input_on_card"]
        log(f"[serve] {arch} [{name}] one request with the input on the card: the host made "
            f"{lp['host_total']} launch calls {lp['host_calls']}, the device ran "
            f"{lp['device_ops']} kernels/copies, {lp['kernel_device_events']} of them {kernel} "
            f"(profiler events; the launch count says {lp['counted_launches']}), busy "
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
        f"{cap['in_graph'][0]} launches inside one graph; scores bit-equal: "
        f"{out['captured_vs_eager']['bit_equal']} [{card}]")



def stack_after_lm(torch, cases, results, card) -> None:
    """After the LM phase, a second witness that each captured fused score
    graph holding ``lstm_stack`` still runs it (``cases``: step 4's
    (result row, fused service) pairs).  One request no graph has scored,
    through the graph (a replay, no capture), against the sequential
    schedule's scores of it at the schedule bar: a replay whose kernel did
    not run would hand back the last request's scores.  The synchronize
    after it raises on any error the device raised.  Then one profiled
    replay of it behind PROFILE_LEAD sleep kernels, its device events in
    order: after the LM phase the profiler's trace of a pass drops its
    first three device events, whatever they are (for this graph the
    copy-in, the stack kernel and, at B=1024, the kernel between them;
    for an eager request the stack kernel and the two after it), so behind
    the lead the stack kernel must be seen once."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import TimeseriesConfig, make_batch
    from repro_torch.engine import AnomalyService
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts

    rows = results["stack_after_lm"] = []
    for out, fused in cases:
        arch, b, t_len = out["arch"], out["batch"], out["seq_len"]
        if out["schedules"]["fused"]["in_graph"] != [{"lstm_stack": 1}]:
            raise AssertionError(f"[stack after lm] {arch} B={b}: the score graph holds "
                                 f"{out['schedules']['fused']['in_graph']}, not one lstm_stack")
        data_cfg = TimeseriesConfig(features=fused.features, seq_len=t_len, batch=b,
                                    anomaly_rate=0.05)
        series = make_batch(data_cfg, 10_000 + b)[0]   # an index no earlier request drew
        graphs = fused.engine._graphs
        captures, replays = graphs.captures, graphs.replays
        torch.cuda.synchronize()
        reset_launch_counts()
        got = fused.score(series).cpu()
        torch.cuda.synchronize()
        counted = launched(launch_counts())
        if counted != {"lstm_stack": 1} or graphs.captures != captures or \
                graphs.replays != replays + 1:
            raise AssertionError(f"[stack after lm] {arch} B={b}: launches {counted}, "
                                 f"{graphs.captures - captures} captures and "
                                 f"{graphs.replays - replays} replays for one request")
        seq = AnomalyService(arch, schedule="sequential", device="cuda", seed=0)
        seq.recalibrate(params=fused.params, threshold=out["threshold"])
        want = seq.score(series).cpu()
        torch.testing.assert_close(got, want, rtol=SCHEDULE_RTOL, atol=SCHEDULE_ATOL)
        on_card = series.to("cuda")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_LEAD):
                torch.cuda._sleep(1_000)
            again = fused.score(on_card).cpu()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        names = [e.name for e in events]
        row = {"arch": arch, "batch": b, "seq_len": t_len,
               "max_abs_diff_vs_sequential": float((got - want).abs().max()),
               "bit_equal_again": bool(torch.equal(again, got)),
               "lead_seen": sum("spin_kernel" in n for n in names),
               "stack_seen": sum(STACK_KERNEL in n for n in names),
               "device_events": [n[:48] for n in names]}
        rows.append(row)
        log(f"[stack after lm] {arch} B={b} T={t_len}: a request no graph had scored, replayed "
            f"(0 captures, 1 lstm_stack launch counted), within {row['max_abs_diff_vs_sequential']:.3g} "
            f"of the sequential schedule's scores (rtol {SCHEDULE_RTOL}, atol {SCHEDULE_ATOL}); "
            f"profiled behind {PROFILE_LEAD} sleep kernels: {len(names)} device events, "
            f"{row['lead_seen']} of the sleeps and {row['stack_seen']} {STACK_KERNEL}, in order "
            f"{row['device_events']} [{card}]")
        if row["stack_seen"] != 1 or not row["bit_equal_again"]:
            raise AssertionError(f"[stack after lm] {arch} B={b}: the profiled replay showed "
                                 f"{row['stack_seen']} {STACK_KERNEL} kernels (bit-equal scores: "
                                 f"{row['bit_equal_again']})")


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

def drive_with_forms(torch, svc, series, results, card) -> None:
    """The Engine's per-call params on the main path (f64-d6, fused, B=8192,
    T=64): ``build_score_step`` bit-equal to the bound ``score`` with K1's
    launches counted around it; ``score_with`` under other params leaves
    the bound program's scores and capture as they were; each ``*_with``
    captured once and bit-equal to its bound form, timed beside it."""
    from repro_torch.core.lstm import init_lstm_ae
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.serving import build_score_step
    from repro_torch.utils import tree_leaves

    engine = svc.engine
    depth, t_len = len(svc.cfg.lstm_ae.layer_sizes()), series.shape[1]
    x = series.to("cuda")
    batch = {"series": x}
    bound = engine.score(batch)
    bound_programs = {k: v for k, v in engine._graphs.programs.items() if k[0] == "score"}
    torch.cuda.synchronize()
    reset_launch_counts()
    got = build_score_step(engine)(svc.params, batch)
    torch.cuda.synchronize()
    launches = launch_counts()
    if launches["lstm_cell"] != depth * t_len or sum(launches.values()) != depth * t_len:
        raise AssertionError(f"build_score_step launched {launches}, expected "
                             f"{depth * t_len} K1 launches")
    if not torch.equal(got, bound):
        raise AssertionError("build_score_step's scores differ from the bound score's")
    captures = engine._graphs.captures
    other = init_lstm_ae(torch.Generator().manual_seed(1), svc.cfg, "cuda")
    moved = float((engine.score_with(other, batch) - bound).abs().max())
    after = {k: v for k, v in engine._graphs.programs.items() if k[0] == "score"}
    if not torch.equal(engine.score(batch), bound) or moved == 0.0:
        raise AssertionError("score_with under other params changed the bound score, "
                             "or computed the bound params' scores")
    if after != bound_programs or engine._graphs.captures != captures:
        raise AssertionError("score_with under other params recaptured a program")
    b = x.shape[0]
    lengths = torch.full((b,), t_len, dtype=torch.int32, device="cuda")
    lengths[::2] = t_len // 2
    state = engine.init_stream_state(b)
    mask = torch.arange(b, device="cuda") % 2 == 0
    forms = {"reconstruct": ("reconstruct", (batch,)), "score": ("score", (batch,)),
             "score_masked": ("score_masked", ({"series": x, "lengths": lengths},)),
             "stream": ("step", (x[:, 0], state)),
             "stream_masked": ("mstep", (x[:, 0], state, mask))}
    rows = {}
    for form, (program, args) in forms.items():
        bound_out = getattr(engine, form)(*args)
        with_out = getattr(engine, f"{form}_with")(svc.params, *args)
        if not all(torch.equal(a, c) for a, c in zip(tree_leaves(with_out),
                                                     tree_leaves(bound_out))):
            raise AssertionError(f"{form}_with differs from the bound {form}")
        rows[form] = {
            "bound_ms": host_ms(torch, lambda: getattr(engine, form)(*args), iters=10),
            "with_ms": host_ms(torch, lambda: getattr(engine, f"{form}_with")(svc.params, *args),
                               iters=10),
            "captures": sum(1 for key in engine._graphs.programs if key[0] == f"{program}_with")}
        if rows[form]["captures"] != 1:
            raise AssertionError(f"{form}_with: {rows[form]['captures']} captured programs, "
                                 f"expected 1")
    results["with_forms"] = {"k1_launches": launches["lstm_cell"],
                             "max_abs_diff_other_params": moved, "forms": rows}
    log(f"[with] {svc.cfg.name} [fused] B={b} T={t_len}: build_score_step(engine)(params, "
        f"batch) bit-equal to the bound score, {launches['lstm_cell']} K1 launches (counts "
        f"set to 0 just before); score_with(other params) moved the scores by up to "
        f"{moved:.3g}, and the bound score after it is bit-equal, no program recaptured "
        f"[{card}]")
    for form, row in rows.items():
        log(f"[with] {form}_with: {row['captures']} capture, bit-equal to {form}; "
            f"{row['with_ms']:.3f} ms/call against the bound form's {row['bound_ms']:.3f} "
            f"(input on the card) [{card}]")


def lm_layer_params(cfg) -> int:
    """Params of one dense transformer layer (attention, SwiGLU MLP, norms)."""
    hd = cfg.resolved_head_dim()
    attn = 2 * cfg.d_model * cfg.num_heads * hd + 2 * cfg.d_model * cfg.num_kv_heads * hd
    norms = 2 * cfg.d_model if cfg.norm == "rmsnorm" else 0
    return attn + 3 * cfg.d_model * cfg.d_ff + norms


def lm_prefill_bound(cfg, b: int, s: int) -> tuple[float, float]:
    """(FLOP, bytes) of one prefill: the layers' products over b*s tokens,
    causal attention over the visible (query, key) pairs (QK^T and PV), the
    last position's unembed; the f32 weights read once, the tokens read and
    the bf16 K/V cache and bf16 logits written once."""
    hd = cfg.resolved_head_dim()
    linear = 2.0 * b * s * cfg.num_layers * (lm_layer_params(cfg) - 2 * cfg.d_model)
    attn = 4.0 * hd * cfg.num_heads * cfg.num_layers * b * s * (s + 1) / 2
    unembed = 2.0 * b * cfg.d_model * cfg.vocab_size
    weights = 4.0 * (cfg.num_layers * lm_layer_params(cfg) + cfg.d_model * cfg.vocab_size
                     + cfg.d_model)
    nbytes = (weights + 4.0 * b * s * cfg.d_model          # the embedding rows gathered
              + 2.0 * 2 * cfg.num_layers * b * s * cfg.num_kv_heads * hd + 2.0 * b * cfg.vocab_size)
    return linear + attn + unembed, nbytes


def lm_decode_bound(cfg, b: int, cache_len: int) -> tuple[float, float]:
    """(FLOP, bytes) of one decode token at ``cache_len`` cached positions:
    the f32 weights read once (layers, final norm, unembed; B rows of the
    table), the bf16 cache read up to the new position and the new K/V rows
    and the logits written once."""
    hd = cfg.resolved_head_dim()
    n_w = cfg.num_layers * lm_layer_params(cfg) + cfg.d_model * cfg.vocab_size + cfg.d_model
    flops = 2.0 * b * (n_w - cfg.d_model) + 4.0 * b * cfg.num_heads * hd * (cache_len + 1) \
        * cfg.num_layers
    kv = 2.0 * 2 * cfg.num_layers * b * cfg.num_kv_heads * hd
    nbytes = 4.0 * n_w + 4.0 * b * cfg.d_model + kv * (cache_len + 1) + 2.0 * b * cfg.vocab_size
    return flops, nbytes


def bound_of(flops: float, nbytes: float, peak_flops: float) -> tuple[float, str]:
    """(ms, what bounds it): the larger of the operations over ``peak_flops``
    and the bytes over HBM bandwidth."""
    ops_ms, bytes_ms = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def drive_lm(torch, results, card) -> None:
    """The dense transformer LM served end to end at full width on the card
    (``[lm]`` lines): card against CPU, decode against prefill, the serving
    flow eager and captured with its times beside their bounds, launch
    calls per token, the device's busy share, peak memory; the launcher
    once as a subprocess; the vision stub's prefill.  The LM path launches
    none of K1-K4: the reference's transformer reaches no Pallas kernel."""
    import gc

    from repro_torch.config import get_config
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.serving import GreedyDecoder, build_prefill_step, stitch_prefill_cache
    from repro_torch.utils import tree_leaves, tree_map

    out = results["lm"] = {"arch": LM_ARCH}
    cfg = get_config(LM_ARCH)
    api = build_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = api.init(torch.Generator("cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["params"] = sum(t.numel() for t in tree_leaves(params))
    out["card_tree"] = card_tree(cfg, params)
    log(f"[lm] {cfg.name}: {out['params']:,} params in f32 drawn on the card from seed 0 in "
        f"{out['init_s']:.2f} s; compute {cfg.compute_dtype}, decode cache bf16 [{card}]")

    # 1. card against CPU on one prompt, bf16 at full depth, f32 at 2 layers
    cpu_params = tree_map(lambda t: t.cpu(), params)
    toks = torch.randint(0, cfg.vocab_size, (LM_CPU_B, LM_CPU_S), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    for tag, c, tol in (("bf16", cfg, LM_BF16_TOL),
                        ("f32", cfg.with_overrides(num_layers=2, compute_dtype="float32"),
                         LM_F32_TOL)):
        a = build_model(c)
        # the first c.num_layers layers' stacked params (views)
        p_card, p_cpu = (dict(p, layers=tree_map(lambda t: t[:c.num_layers], p["layers"]))
                         for p in (params, cpu_params))
        t0 = time.perf_counter()
        want, _ = a.prefill(p_cpu, {"tokens": toks})
        cpu_s = time.perf_counter() - t0
        got, _ = a.prefill(p_card, {"tokens": toks.cuda()})
        got = got.float().cpu()
        err = float((got - want.float()).abs().max())
        torch.testing.assert_close(got, want.float(), rtol=tol, atol=tol)
        out[f"card_vs_cpu_{tag}"] = {"max_abs_err": err, "tol": tol, "cpu_s": cpu_s}
        log(f"[lm] card against CPU, prefill B={LM_CPU_B} S={LM_CPU_S} {tag} (layers "
            f"{c.num_layers}, widths of {cfg.name}): logits max abs err {err:.3g} within rtol = "
            f"atol = {tol} (CPU prefill {cpu_s:.1f} s) [{card}]")
    del cpu_params

    # 2. decode consistent with prefill on the card at full width
    toks = torch.randint(0, cfg.vocab_size, (LM_CONSISTENCY_B, LM_CONSISTENCY_S + 1),
                         dtype=torch.int32, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(2))
    full, _ = api.prefill(params, {"tokens": toks})
    _, pre = api.prefill(params, {"tokens": toks[:, :-1]})
    cache = stitch_prefill_cache(api, pre, LM_CONSISTENCY_S + 1)
    dec, _ = api.decode(params, toks[:, -1:], cache,
                        torch.tensor(LM_CONSISTENCY_S, dtype=torch.int32, device="cuda"))
    err = float((dec.float() - full.float()).abs().max())
    torch.testing.assert_close(dec.float(), full.float(), rtol=LM_BF16_TOL, atol=LM_BF16_TOL)
    out["decode_vs_prefill_max_abs_err"] = err
    log(f"[lm] decode against prefill at B={LM_CONSISTENCY_B} S={LM_CONSISTENCY_S}: the "
        f"stitched prefix cache and one decode step give the teacher-forced logits (max abs "
        f"err {err:.3g}, rtol = atol = {LM_BF16_TOL}) [{card}]")
    del full, pre, cache, dec

    # 3. serve: prefill at B=8, S=2048, then 128 greedy tokens eager and captured
    b, s, n = LM_SERVE_B, LM_SERVE_S, LM_DECODE
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), dtype=torch.int32, device="cuda",
                                     generator=torch.Generator("cuda").manual_seed(3))}
    step = build_prefill_step(api, kv_chunk=LM_KV_CHUNK)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    prefill_ms = []
    for _ in range(2):          # the first call also loads cuBLAS's kernels
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, pre = step(params, batch)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    first = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
    covered = pre["k"].shape[2]
    caches = {}
    decoders = {"eager": GreedyDecoder(api, jit=False), "captured": GreedyDecoder(api)}
    runs = {}
    for name, decoder in decoders.items():
        # captured: the capture and 127 replays, then 128 replays
        for call in range(2 if name == "captured" else 1):
            caches[name] = stitch_prefill_cache(api, pre, covered + n)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tokens, _ = decoder(params, caches[name], first, covered, n)
            torch.cuda.synchronize()
            runs.setdefault(name, []).append(((time.perf_counter() - t0) * 1e3, tokens))
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"the LM path launched port kernels {counts}; it runs none")
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    eager_tokens, captured_tokens = runs["eager"][-1][1], runs["captured"][-1][1]
    if not (torch.equal(eager_tokens, captured_tokens) and
            torch.equal(runs["captured"][0][1], captured_tokens)):
        raise AssertionError("captured greedy tokens differ from the eager loop's")
    logits_equal = torch.equal(decoders["eager"].logits, decoders["captured"].logits)
    cache_equal = all(torch.equal(x, y) for x, y in zip(tree_leaves(caches["eager"]),
                                                        tree_leaves(caches["captured"])))
    if decoders["captured"].captures != 1:
        raise AssertionError(f"{decoders['captured'].captures} decode captures, expected 1")
    pf_flops, pf_bytes = lm_prefill_bound(cfg, b, s)
    pf_bound, pf_by = bound_of(pf_flops, pf_bytes, PEAK_BF16_FLOPS)
    mid = covered + n // 2
    dc_flops, dc_bytes = lm_decode_bound(cfg, b, mid)
    dc_bound, dc_by = bound_of(dc_flops, dc_bytes, PEAK_BF16_FLOPS)
    # what the plain path adds per token: apply_linear casts every f32
    # weight to bf16 at use (read 4 bytes, write 2, read 2 again), and
    # decode_attention upcasts the bf16 cache to f32 (write 4, read 4)
    weights = 4.0 * (cfg.num_layers * lm_layer_params(cfg) + cfg.d_model * cfg.vocab_size)
    kv = dc_bytes - 4.0 * (cfg.num_layers * lm_layer_params(cfg) + cfg.d_model * cfg.vocab_size)
    cast_ms = (weights * 2.0 + kv * 4.0) / PEAK_BYTES * 1e3
    out.update({
        "prefill_ms": prefill_ms[1], "prefill_first_ms": prefill_ms[0],
        "prefill_bound_ms": pf_bound, "prefill_bound_by": pf_by, "prefill_flops": pf_flops,
        "decode_bound_ms_per_token": dc_bound, "decode_bound_by": dc_by,
        "decode_cast_floor_ms_per_token": cast_ms,
        "logits_bit_equal": logits_equal, "cache_bit_equal": cache_equal,
        "captures": decoders["captured"].captures, "replays": decoders["captured"].replays})
    log(f"[lm] prefill B={b} S={s} (kv_chunk {LM_KV_CHUNK}, eager): {prefill_ms[1]:.1f} ms "
        f"(first call {prefill_ms[0]:.1f} ms); bound {pf_bound:.2f} ms by {pf_by} "
        f"({pf_flops/1e12:.2f} TFLOP of products at the bf16 dense peak), "
        f"{pf_flops / (prefill_ms[1] / 1e3) / 1e12:.1f} TFLOP/s achieved [{card}]")
    for name in ("eager", "captured"):
        ms = runs[name][-1][0]
        out[name] = {"decode_ms_per_token": ms / n, "tokens_per_s": b * n / (ms / 1e3)}
        capture = ""
        if name == "captured":
            out[name]["capture_call_ms_per_token"] = runs[name][0][0] / n
            capture = f" (the call that captured: {runs[name][0][0] / n:.3f} ms/token)"
        log(f"[lm] decode {name} B={b}, {n} tokens from position {covered}: "
            f"{ms / n:.3f} ms/token, {b * n / (ms / 1e3):,.0f} tokens/s{capture}; "
            f"bound {dc_bound:.3f} ms/token by {dc_by} (the f32 weights and the cache read once "
            f"per token) [{card}]")
    log(f"[lm] captured tokens equal the eager loop's ({n} tokens x {b} rows, both captured "
        f"calls); last "
        f"logits bit-equal: {logits_equal}, caches bit-equal: {cache_equal}; "
        f"{decoders['captured'].captures} capture, {decoders['captured'].replays} replays; port "
        f"kernel launches over the LM path {counts} (none, as the reference's transformer "
        f"reaches no Pallas kernel) [{card}]")
    log(f"[lm] what separates decode from its bound: the per-call f32->bf16 weight casts of "
        f"apply_linear and the f32 upcast of the bf16 cache in decode_attention move "
        f"{(weights * 2.0 + kv * 4.0) / 1e9:.2f} GB more per token, {cast_ms:.3f} ms at HBM "
        f"bandwidth; peak memory {out['peak_memory_gb']:.2f} GB "
        f"(torch.cuda.max_memory_allocated) [{card}]")

    # launch calls the host makes per token, and the device's busy share
    for name, decoder in decoders.items():
        cache = stitch_prefill_cache(api, pre, covered + n)
        torch.cuda.synchronize()
        lp = host_launches(torch, lambda: decoder(params, cache, first, covered,
                                                  LM_PROFILE_TOKENS))
        out[name]["host_calls_per_token"] = lp["host_total"] / LM_PROFILE_TOKENS
        out[name]["device_ops_per_token"] = lp["device_ops"] / LM_PROFILE_TOKENS
        log(f"[lm] decode {name}: {lp['host_total'] / LM_PROFILE_TOKENS:.1f} launch calls per "
            f"token on the host ({lp['host_calls']} over {LM_PROFILE_TOKENS} tokens, the loop's "
            f"copies in and out included), {lp['device_ops'] / LM_PROFILE_TOKENS:.1f} device "
            f"kernels/copies per token (one torch.profiler pass) [{card}]")
    cache = stitch_prefill_cache(api, pre, covered + n)
    busy = device_busy_over(torch, lambda: decoders["captured"](params, cache, first, covered,
                                                                LM_BUSY_TOKENS))
    out["captured"]["busy"] = busy
    log(f"[lm] captured decode of {LM_BUSY_TOKENS} tokens (the cache's copies in and out "
        f"included) under the profiler: {busy['wall_ms']:.1f} ms, the "
        f"device busy {busy['device_busy_ms']:.1f} ms (idle share {busy['idle_share']:.3f}) "
        f"[{card}]")
    del logits, pre, cache, caches, decoders, params, step
    gc.collect()
    torch.cuda.empty_cache()

    # 4. the entry point, once, in a process of its own
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", LM_ARCH, "--full-config",
           "--batch", str(b), "--seq-len", str(s), "--decode-tokens", str(n)]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[serve]")]
    m = re.search(r"prefill\((\d+)x(\d+)\)=([\d.]+)ms, (\d+) tokens decoded in ([\d.]+)ms "
                  r"\(([\d,]+) tok/s\)", proc.stdout)
    if proc.returncode != 0 or m is None or not any("sample continuation" in ln for ln in lines):
        raise AssertionError(f"serve --arch {LM_ARCH} (rc {proc.returncode}): "
                             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    out["launcher"] = {"prefill_ms": float(m.group(3)), "decode_ms": float(m.group(5)),
                       "tokens_per_s": float(m.group(6).replace(",", "")),
                       "wall_s": time.perf_counter() - t0, "lines": lines}
    for ln in lines:
        log(f"[lm] launcher: {ln} [{card}]")
    log(f"[lm] launcher {' '.join(cmd[2:])}: rc 0 in {out['launcher']['wall_s']:.1f} s "
        f"(its decode time includes the capture) [{card}]")

    # 5. the vision stub's prefill at full width, cut to 2 layers
    vcfg = get_config(LM_VISION_ARCH).with_overrides(num_layers=LM_VISION_LAYERS)
    vapi = build_model(vcfg)
    vparams = vapi.init(torch.Generator("cuda").manual_seed(4), device="cuda")
    gen = torch.Generator().manual_seed(5)
    vbatch = {"tokens": torch.randint(0, vcfg.vocab_size, (LM_CPU_B, LM_CPU_S),
                                      dtype=torch.int32, generator=gen),
              "image_embeds": torch.randn((LM_CPU_B, vcfg.vision_patches, vcfg.d_model),
                                          generator=gen).to(torch.bfloat16)}
    want, wcache = vapi.prefill(tree_map(lambda t: t.cpu(), vparams), vbatch)
    got, gcache = vapi.prefill(vparams, {k: v.cuda() for k, v in vbatch.items()})
    err = float((got.float().cpu() - want.float()).abs().max())
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=LM_BF16_TOL, atol=LM_BF16_TOL)
    covered = gcache["k"].shape[2]
    if covered != LM_CPU_S + vcfg.vision_patches or wcache["k"].shape != gcache["k"].shape:
        raise AssertionError(f"the vision-stub prefill covered {covered} positions")
    vcache = stitch_prefill_cache(vapi, gcache, covered + LM_VISION_DECODE)
    vfirst = torch.argmax(got[:, -1], dim=-1).to(torch.int32)[:, None]
    vtokens, _ = GreedyDecoder(vapi)(vparams, vcache, vfirst, covered, LM_VISION_DECODE)
    ecache = stitch_prefill_cache(vapi, gcache, covered + LM_VISION_DECODE)
    etokens, _ = GreedyDecoder(vapi, jit=False)(vparams, ecache, vfirst, covered,
                                                 LM_VISION_DECODE)
    if not torch.equal(vtokens, etokens):
        raise AssertionError("vision stub: captured tokens differ from eager ones")
    out["vision"] = {"max_abs_err": err, "covered": covered}
    log(f"[lm] {LM_VISION_ARCH} at full width, {LM_VISION_LAYERS} layers: prefill of "
        f"{LM_CPU_S} tokens + {vcfg.vision_patches} patches covers {covered} positions, card "
        f"against CPU max abs err {err:.3g} (rtol = atol = {LM_BF16_TOL}); decode cache sized "
        f"{covered} + {LM_VISION_DECODE}, captured tokens equal eager {vtokens[0].tolist()} "
        f"[{card}]")
    del vparams, gcache, vcache, ecache
    gc.collect()
    torch.cuda.empty_cache()


def lm_train_bound(cfg, b: int, s: int, n_params: int) -> tuple[float, float]:
    """(FLOP, bytes) of one train step at b x s tokens: 6 FLOP per product
    weight per token (the forward's product and the backward's two: the
    layers' matrices and the unembedding; the table's gather has none),
    causal attention's QK^T and PV over the visible (query, key) pairs
    three times over (forward, and the backward's two); the f32 params and
    AdamW's two moments read once and written once (24 bytes a param) and
    the tokens and labels read once.  The recompute of remat is the
    implementation's choice and is not counted."""
    hd = cfg.resolved_head_dim()
    product = cfg.num_layers * (lm_layer_params(cfg) - 2 * cfg.d_model) \
        + cfg.d_model * cfg.vocab_size
    linear = 6.0 * product * b * s
    attn = 3 * 4.0 * hd * cfg.num_heads * cfg.num_layers * b * s * (s + 1) / 2
    return linear + attn, 24.0 * n_params + 2 * 8.0 * b * s


def lm_value_and_grad(torch, api, params, batch, **kw):
    """(loss, grads in ``tree_leaves`` order) of ``api.loss``."""
    from repro_torch.utils import tree_leaves, tree_map

    tracked = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, _ = api.loss(tracked, batch, **kw)
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(tracked))


def rel_fro(torch, got, want) -> float:
    """||got - want|| / ||want|| (Frobenius), in f32."""
    want = want.float()
    return float(torch.linalg.vector_norm(got.float() - want)
                 / torch.clamp(torch.linalg.vector_norm(want), min=1e-30))


def drive_lm_train(torch, results, card) -> None:
    """LM training at full width on the card (``[lm-train]`` lines): card
    against CPU for one value_and_grad of ``train_loss`` at 2 layers in f32
    and bf16; remat against no remat at 2 layers; 22 layers trained for
    LM_TRAIN_STEPS steps at B=4, S=2048 from ``LMIterator`` with ms per
    step, tokens/s, the bound, peak memory, device kernels per step and the
    idle share over one profiled step; the launcher twice over one
    checkpoint directory (the second run resumes).  Like serving, the path
    launches none of K1-K4 and calls no library attention (both counted)."""
    import gc
    import math
    import tempfile
    from pathlib import Path

    import torch.nn.functional as F

    from repro_torch.config import TrainConfig, get_config
    from repro_torch.data import LMDataConfig, LMIterator, host_slice, make_lm_batch
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.training import build_train_step, init_train_state
    from repro_torch.utils import tree_leaves, tree_map

    out = results["lm_train"] = {"arch": LM_ARCH}
    cfg = get_config(LM_ARCH)
    t_phase = time.perf_counter()
    sdpa = F.scaled_dot_product_attention
    sdpa_calls = [0]

    def counted_sdpa(*args, **kw):
        sdpa_calls[0] += 1
        return sdpa(*args, **kw)

    F.scaled_dot_product_attention = counted_sdpa
    reset_launch_counts()
    try:
        # 1. card against CPU: one value_and_grad at 2 layers, full width
        cfg2 = cfg.with_overrides(num_layers=LM_TRAIN_LAYERS)
        params = build_model(cfg2).init(torch.Generator("cuda").manual_seed(0), device="cuda")
        cpu_params = tree_map(lambda t: t.cpu(), params)
        batch = make_lm_batch(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=LM_CPU_S,
                                           global_batch=LM_CPU_B), 0)
        card_batch = {k: v.cuda() for k, v in batch.items()}
        for tag, dtype, loss_tol, grad_tol in (
                ("f32", "float32", LM_F32_TOL, LM_TRAIN_F32_GRAD_REL),
                ("bf16", "bfloat16", LM_BF16_TOL, LM_TRAIN_BF16_GRAD_REL)):
            a = build_model(cfg2.with_overrides(compute_dtype=dtype))
            t0 = time.perf_counter()
            want, wgrads = lm_value_and_grad(torch, a, cpu_params, batch, loss_chunk=LM_CPU_S)
            cpu_s = time.perf_counter() - t0
            got, ggrads = lm_value_and_grad(torch, a, params, card_batch, loss_chunk=LM_CPU_S)
            errs = [rel_fro(torch, g.cpu(), w) for g, w in zip(ggrads, wgrads)]
            loss_err = abs(float(got) - float(want))
            torch.testing.assert_close(got.cpu(), want, rtol=loss_tol, atol=loss_tol)
            if max(errs) > grad_tol:
                raise AssertionError(f"[lm-train] {tag} grads card vs CPU: relative errors "
                                     f"{errs} past {grad_tol}")
            out[f"card_vs_cpu_{tag}"] = {"loss_abs_err": loss_err, "loss": float(want),
                                         "grad_rel_fro_max": max(errs), "grad_rel_fro": errs,
                                         "loss_tol": loss_tol, "grad_tol": grad_tol,
                                         "cpu_s": cpu_s}
            log(f"[lm-train] card against CPU, value_and_grad of train_loss B={LM_CPU_B} "
                f"S={LM_CPU_S} {tag} (layers {LM_TRAIN_LAYERS}, widths of {cfg.name}, TF32 off): "
                f"loss {float(want):.6f}, abs err {loss_err:.3g} (rtol = atol = {loss_tol}); "
                f"{len(errs)} grad leaves, relative Frobenius error max {max(errs):.3g} (bar "
                f"{grad_tol}) (CPU {cpu_s:.1f} s) [{card}]")
        del cpu_params, wgrads, ggrads

        # 2. remat against no remat, 2 layers at the training shape
        a = build_model(cfg2)
        big = {k: v.cuda() for k, v in make_lm_batch(LMDataConfig(
            vocab_size=cfg.vocab_size, seq_len=LM_TRAIN_S, global_batch=LM_TRAIN_B), 0).items()}
        runs = {}
        for remat in (True, False):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            loss, grads = lm_value_and_grad(torch, a, params, big, remat=remat,
                                            loss_chunk=min(2048, LM_TRAIN_S))
            torch.cuda.synchronize()
            runs[remat] = (loss, grads, (torch.cuda.max_memory_allocated() - base) / 1e9)
        errs = [rel_fro(torch, g, w) for g, w in zip(runs[True][1], runs[False][1])]
        if not torch.equal(runs[True][0], runs[False][0]) or max(errs) > LM_TRAIN_REMAT_REL:
            raise AssertionError(f"[lm-train] remat changed the numbers: losses "
                                 f"{float(runs[True][0])} / {float(runs[False][0])}, grads {errs}")
        out["remat"] = {"loss": float(runs[True][0]), "grad_rel_fro_max": max(errs),
                        "extra_peak_gb_remat": runs[True][2],
                        "extra_peak_gb_no_remat": runs[False][2]}
        log(f"[lm-train] remat against no remat at {LM_TRAIN_LAYERS} layers, B={LM_TRAIN_B} "
            f"S={LM_TRAIN_S} bf16: losses bit-equal ({float(runs[True][0]):.6f}), grads "
            f"relative Frobenius error max {max(errs):.3g} (bar {LM_TRAIN_REMAT_REL}); peak "
            f"memory above the params {runs[True][2]:.2f} GB with remat, {runs[False][2]:.2f} GB "
            f"without [{card}]")
        del params, big, runs, grads, loss

        # 3. full width, 22 layers: LM_TRAIN_STEPS AdamW steps from LMIterator
        gc.collect()
        torch.cuda.empty_cache()
        b, s = LM_TRAIN_B, LM_TRAIN_S
        api = build_model(cfg)
        tc = TrainConfig(learning_rate=1e-3, total_steps=LM_TRAIN_STEPS, loss_chunk=min(2048, s))
        state = init_train_state(api.init(torch.Generator("cuda").manual_seed(0), device="cuda"),
                                 tc)
        n_params = sum(t.numel() for t in tree_leaves(state.params))
        step = build_train_step(api, tc)
        it = LMIterator(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b))
        t0 = time.perf_counter()
        host_batches = [host_slice(next(it)) for _ in range(LM_TRAIN_STEPS + 1)]
        data_ms = (time.perf_counter() - t0) * 1e3 / len(host_batches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, losses = [], []
        for hb in host_batches[:LM_TRAIN_STEPS]:
            batch = {k: v.to("cuda") for k, v in hb.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"[lm-train] a loss is not finite: {losses}")
        steady = ms[1:]
        mean_ms, median_ms = statistics.mean(steady), statistics.median(steady)
        flops, nbytes = lm_train_bound(cfg, b, s, n_params)
        bound_ms, bound_by = bound_of(flops, nbytes, PEAK_BF16_FLOPS)
        last = {k: v.to("cuda") for k, v in host_batches[-1].items()}
        holder = {"state": state}
        del state

        def one_step():
            holder["state"], _ = step(holder["state"], last)

        busy = device_busy_over(torch, one_step, names=True)
        library = [n for n in busy.pop("names")
                   if any(k in n for k in ("scaled_dot_product", "fmha", "flash"))]
        out.update({
            "params": n_params, "batch": b, "seq_len": s, "steps": LM_TRAIN_STEPS,
            "ms": ms, "losses": losses, "ms_per_step_mean": mean_ms,
            "ms_per_step_median": median_ms, "tokens_per_s": b * s / (mean_ms / 1e3),
            "data_ms_per_batch": data_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "flops": flops, "bytes": nbytes, "peak_memory_gb": peak_gb,
            "profiled_step": busy, "library_attention_names": library})
        log(f"[lm-train] {cfg.name} at full width ({n_params:,} params, f32 master weights, "
            f"bf16 compute, remat={tc.remat}, AdamW f32), B={b} S={s}, loss_chunk "
            f"{tc.loss_chunk}: {LM_TRAIN_STEPS} steps from LMIterator, losses "
            f"{', '.join(f'{x:.4f}' for x in losses)} (all finite); first step {ms[0]:.1f} ms, "
            f"steps 2-{LM_TRAIN_STEPS} mean {mean_ms:.1f} ms, median {median_ms:.1f} ms, "
            f"{b * s / (mean_ms / 1e3):,.0f} tokens/s; LMIterator on the host "
            f"{data_ms:.1f} ms a batch (outside the timed step) [{card}]")
        log(f"[lm-train] bound {bound_ms:.2f} ms a step by {bound_by} ({flops / 1e12:.2f} TFLOP "
            f"at the bf16 dense peak against {nbytes / 1e9:.1f} GB of state at HBM bandwidth, "
            f"{nbytes / PEAK_BYTES * 1e3:.2f} ms); {mean_ms / bound_ms:.1f}x the bound, "
            f"{flops / (mean_ms / 1e3) / 1e12:.1f} TFLOP/s achieved; peak memory {peak_gb:.2f} "
            f"GB (torch.cuda.max_memory_allocated) [{card}]")
        log(f"[lm-train] one profiled step: {busy['wall_ms']:.1f} ms, {busy['device_ops']} device "
            f"kernels/copies/memsets, the device busy {busy['device_busy_ms']:.1f} ms (idle share "
            f"{busy['idle_share']:.3f}); library attention ops or kernels seen: "
            f"{library or 'none'} [{card}]")
        top = list(busy["device_ms_by_name"].items())[:8]
        log(f"[lm-train] the profiled step's device time by kernel, the largest 8 of "
            f"{len(busy['device_ms_by_name'])} names: " + "; ".join(
                f"{name[:72]} {t:.1f} ms ({t / busy['device_busy_ms']:.1%})" for name, t in top)
            + f" [{card}]")
        del holder, last, host_batches, step, batch, metrics
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        F.scaled_dot_product_attention = sdpa
    counts = launch_counts()
    if any(counts.values()) or sdpa_calls[0] or library:
        raise AssertionError(f"[lm-train] the LM training path launched port kernels {counts} "
                             f"or library attention ({sdpa_calls[0]} SDPA calls, {library}); "
                             f"it runs neither")
    out["port_kernel_launches"], out["sdpa_calls"] = dict(counts), sdpa_calls[0]
    log(f"[lm-train] port kernel launches over the phase {dict(counts)}, "
        f"scaled_dot_product_attention calls {sdpa_calls[0]}: none, as the reference's "
        f"transformer trains through plain jnp [{card}]")

    # 4. the launcher twice over one checkpoint directory
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out["launcher"] = []
    with tempfile.TemporaryDirectory() as ckpt:
        for steps in LM_TRAIN_LAUNCH_STEPS:
            cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", LM_ARCH,
                   "--full-config", "--steps", str(steps), "--batch", str(b), "--seq-len",
                   str(s), "--ckpt-every", str(LM_TRAIN_CKPT_EVERY), "--ckpt-dir", ckpt]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900, env=env,
                                  cwd=ROOT)
            wall = time.perf_counter() - t0
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[train]")]
            done = re.search(r"done: ([\d.]+)s, ([\d,]+) tok/s", proc.stdout)
            if proc.returncode != 0 or done is None or "nan" in proc.stdout:
                raise AssertionError(f"launch.train --steps {steps} (rc {proc.returncode}): "
                                     f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
            ckpt_gb = sum(f.stat().st_size for f in Path(ckpt).rglob("*") if f.is_file()) / 1e9
            out["launcher"].append({"steps": steps, "wall_s": wall, "lines": lines,
                                    "loop_s": float(done.group(1)),
                                    "tokens_per_s": float(done.group(2).replace(",", "")),
                                    "ckpt_dir_gb": ckpt_gb})
            for ln in lines:
                log(f"[lm-train] launcher: {ln} [{card}]")
            log(f"[lm-train] launcher {' '.join(cmd[3:-2])}: rc 0 in {wall:.1f} s; checkpoint "
                f"directory {ckpt_gb:.1f} GB [{card}]")
    first, second = (r["lines"] for r in out["launcher"])
    resumed = f"[train] resumed from step {LM_TRAIN_LAUNCH_STEPS[0]}"
    if any("resumed" in ln for ln in first) or resumed not in second:
        raise AssertionError(f"[lm-train] the launcher did not resume: {first} {second}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[lm-train] the second launcher run printed '{resumed}'; phase {out['phase_s']:.1f} s "
        f"[{card}]")


def moe_layer_params(cfg) -> tuple[int, int]:
    """(params of one MoE transformer layer, those of its experts):
    attention, norms, router and the experts' gate, up and down."""
    hd = cfg.resolved_head_dim()
    attn = 2 * cfg.d_model * cfg.num_heads * hd + 2 * cfg.d_model * cfg.num_kv_heads * hd
    norms = {"rmsnorm": 2, "layernorm": 4}.get(cfg.norm, 0) * cfg.d_model
    experts = 3 * cfg.moe.num_experts * cfg.d_model * cfg.d_ff
    return attn + norms + cfg.d_model * cfg.moe.num_experts + experts, experts


def moe_serve_bound(cfg, b: int, s: int, past: int, kept_pairs: float,
                    touched: float) -> tuple[float, float]:
    """(FLOP, bytes) of one forward of b x s new tokens after ``past``
    cached positions with the logits of the last position (a prefill: past
    0; a decode step: s 1).  FLOP: the attention, router and unembed
    products, the expert products of the ``kept_pairs`` (token, choice)
    pairs routed and not dropped (summed over the layers), causal attention
    over the visible (query, key) pairs.  Bytes: the f32 weights read once,
    of the experts only the ``touched`` ones (summed over the layers) that
    received a token, the embedding rows gathered, the bf16 K/V of the past
    positions read and of the new ones written, the bf16 logits written."""
    hd, nl, d = cfg.resolved_head_dim(), cfg.num_layers, cfg.d_model
    layer, experts = moe_layer_params(cfg)
    one_expert = experts // cfg.moe.num_experts
    dense = layer - experts                      # attention, norms, router
    flops = (2.0 * b * s * nl * dense + 2.0 * one_expert * kept_pairs
             + 4.0 * hd * cfg.num_heads * nl * b * (s * past + s * (s + 1) / 2)
             + 2.0 * b * d * cfg.vocab_size)
    nbytes = (4.0 * (nl * dense + one_expert * touched + d * cfg.vocab_size + d)
              + 4.0 * b * s * d + 2.0 * 2 * nl * b * cfg.num_kv_heads * hd * (past + s)
              + 2.0 * b * cfg.vocab_size)
    return flops, nbytes


def moe_train_bound(cfg, b: int, s: int, n_params: int, kept_pairs: float) -> tuple[float, float]:
    """(FLOP, bytes) of one train step: 6 FLOP per product weight per token
    for the attention, router and unembed products and per expert weight per
    kept (token, choice) pair, causal attention three times over (forward
    and the backward's two); the f32 params and AdamW's moments read and
    written once (24 bytes a param), tokens and labels read once."""
    hd, nl = cfg.resolved_head_dim(), cfg.num_layers
    layer, experts = moe_layer_params(cfg)
    flops = (6.0 * b * s * (nl * (layer - experts) + cfg.d_model * cfg.vocab_size)
             + 6.0 * (experts // cfg.moe.num_experts) * kept_pairs
             + 3 * 4.0 * hd * cfg.num_heads * nl * b * s * (s + 1) / 2)
    return flops, 24.0 * n_params + 2 * 8.0 * b * s


@contextlib.contextmanager
def recorded_routing():
    """Every (weights, indices, probs) that ``layers.moe._router`` returns
    while open, one entry per call (a layer), kept on the device."""
    from repro_torch.layers import moe as moe_m

    real, calls = moe_m._router, []

    def recorded(params, x, top_k):
        out = real(params, x, top_k)
        calls.append(tuple(t.detach() for t in out))
        return out

    moe_m._router = recorded
    try:
        yield calls
    finally:
        moe_m._router = real


def routing_stats(torch, cfg, calls) -> dict:
    """Per layer (one router call each): the share of (token, choice) pairs
    over capacity (dropped), the pairs kept, the distinct experts that
    received a token, and the layer's aux loss."""
    from repro_torch.layers.moe import _aux_loss, capacity

    e = cfg.moe.num_experts
    drop, kept, touched, aux = [], [], [], []
    for _, idx, probs in calls:
        counts = torch.bincount(idx.reshape(-1), minlength=e)
        dropped = int(torch.clamp(counts - capacity(idx.shape[0], cfg), min=0).sum())
        drop.append(dropped / idx.numel())
        kept.append(idx.numel() - dropped)
        touched.append(int((counts > 0).sum()))
        aux.append(float(_aux_loss(probs, idx, e)))
    return {"drop_share": drop, "kept_pairs": kept, "touched_experts": touched, "aux": aux}


def greedy_decided(torch, logits, ulp_bits: int):
    """Rows whose top two logits lie more than two ulps of ``ulp_bits``
    mantissa bits apart (else a tie no order of arithmetic decides)."""
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    ulp = torch.exp2(torch.floor(torch.log2(top2[..., 0].abs().clamp(min=1e-30))) - ulp_bits)
    return (top2[..., 0] - top2[..., 1]) > 2 * ulp


def moe_all_logits(torch, api, params, tokens):
    """The model's logits at every position (B, S, V): the prefill's forward,
    unembedded at each position."""
    from repro_torch.layers.embeddings import unembed_logits
    from repro_torch.models import transformer as tf_m

    cfg = api.cfg
    h = tf_m.embed_inputs(params, {"tokens": tokens}, cfg, getattr(torch, cfg.compute_dtype))
    h, _ = tf_m.forward(params, h, cfg, remat=False)
    return unembed_logits(params["unembed"]["w"], h)


def moe_check_cpu(torch, cfg, params, out, card) -> None:
    """Card against CPU at MOE_CHECK_LAYERS layers: the logits at every
    position of one prompt in f32 (TF32 off) and bf16, the routing of each
    layer, and one value_and_grad of ``train_loss`` in f32 and bf16."""
    from repro_torch.data import LMDataConfig, make_lm_batch
    from repro_torch.models import build_model
    from repro_torch.utils import tree_map

    cpu_params = tree_map(lambda t: t.cpu(), params)
    toks = torch.randint(0, cfg.vocab_size, (LM_CPU_B, LM_CPU_S), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    batch = make_lm_batch(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=LM_CPU_S,
                                       global_batch=LM_CPU_B), 0)
    for tag, dtype, tol, bits, grad_tol in (
            ("f32", "float32", LM_F32_TOL, 23, LM_TRAIN_F32_GRAD_REL),
            ("bf16", "bfloat16", LM_BF16_TOL, 7, LM_TRAIN_BF16_GRAD_REL)):
        a = build_model(cfg.with_overrides(compute_dtype=dtype))
        t0 = time.perf_counter()
        with recorded_routing() as want_routes:
            want = moe_all_logits(torch, a, cpu_params, toks).float()
        with recorded_routing() as got_routes:
            got = moe_all_logits(torch, a, params, toks.cuda()).float().cpu()
        agree = [float((torch.sort(w[1], -1).values == torch.sort(g[1].cpu(), -1).values)
                       .all(-1).float().mean()) for w, g in zip(want_routes, got_routes)]
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        decided = greedy_decided(torch, want, bits)
        if not decided.any() or not torch.equal(got.argmax(-1)[decided], want.argmax(-1)[decided]):
            raise AssertionError(f"[moe] {tag} greedy tokens card vs CPU differ: "
                                 f"{got.argmax(-1).tolist()} / {want.argmax(-1).tolist()}")
        want_loss, wgrads = lm_value_and_grad(torch, a, cpu_params, batch, loss_chunk=LM_CPU_S)
        got_loss, ggrads = lm_value_and_grad(torch, a, params, {k: v.cuda() for k, v in batch.items()},
                                             loss_chunk=LM_CPU_S)
        cpu_s = time.perf_counter() - t0
        errs = [rel_fro(torch, g.cpu(), w) for g, w in zip(ggrads, wgrads)]
        loss_err = abs(float(got_loss) - float(want_loss))
        torch.testing.assert_close(got_loss.cpu(), want_loss, rtol=tol, atol=tol)
        if max(errs) > grad_tol:
            raise AssertionError(f"[moe] {tag} grads card vs CPU: relative errors {errs} past "
                                 f"{grad_tol}")
        out[f"card_vs_cpu_{tag}"] = {
            "logits_max_abs_err": err, "tol": tol, "greedy_positions": LM_CPU_S,
            "greedy_ties": int((~decided).sum()), "routing_agree_per_layer": agree,
            "loss": float(want_loss), "loss_abs_err": loss_err, "grad_rel_fro_max": max(errs),
            "grad_tol": grad_tol, "s": cpu_s}
        log(f"[moe] card against CPU, {cfg.name} at {cfg.num_layers} layers (full width) {tag}, "
            f"B={LM_CPU_B} S={LM_CPU_S}: logits at every position max abs err {err:.3g} (rtol = "
            f"atol = {tol}); greedy tokens equal at {int(decided.sum())} of {LM_CPU_S} positions, "
            f"{int((~decided).sum())} within two ulps (ties, not held); routing agreement per "
            f"layer {', '.join(f'{x:.4f}' for x in agree)}; train_loss {float(want_loss):.6f}, "
            f"abs err {loss_err:.3g}, {len(errs)} grad leaves, relative Frobenius error max "
            f"{max(errs):.3g} (bar {grad_tol}) ({cpu_s:.1f} s) [{card}]")
    del cpu_params, wgrads, ggrads


def moe_decode_vs_prefill(torch, cfg, params, out, card) -> None:
    """Decode against prefill at MOE_CHECK_LAYERS layers, f32 compute, the
    prefix's K/V stitched into an f32 decode cache, capacity_factor 16:
    the greedy token of one decode step equals the teacher-forced one."""
    import dataclasses

    from repro_torch.models import build_model
    from repro_torch.models.transformer import init_decode_cache

    c = cfg.with_overrides(compute_dtype="float32",
                           moe=dataclasses.replace(cfg.moe, capacity_factor=MOE_CONSISTENCY_CF))
    api = build_model(c)
    b, s = LM_CONSISTENCY_B, LM_CONSISTENCY_S
    toks = torch.randint(0, c.vocab_size, (b, s + 1), dtype=torch.int32, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(2))
    full, _ = api.prefill(params, {"tokens": toks})
    _, pre = api.prefill(params, {"tokens": toks[:, :-1]})
    cache = init_decode_cache(c, b, s + 1, dtype=torch.float32, device="cuda")
    for name in ("k", "v"):
        cache[name][:, :, :s].copy_(pre[name])
    dec, _ = api.decode(params, toks[:, -1:], cache, torch.tensor(s, dtype=torch.int32,
                                                                  device="cuda"))
    want, got = full[:, -1].float(), dec[:, -1].float()
    decided = greedy_decided(torch, want, 23)
    if not decided.all() or not torch.equal(got.argmax(-1), want.argmax(-1)):
        raise AssertionError(f"[moe] decode against prefill: greedy {got.argmax(-1).tolist()} "
                             f"against {want.argmax(-1).tolist()}")
    err = float((got - want).abs().max())
    out["decode_vs_prefill"] = {"max_abs_err": err, "tokens": want.argmax(-1).tolist()}
    log(f"[moe] decode against prefill at B={b} S={s}, {c.num_layers} layers f32 (TF32 off), "
        f"capacity_factor {MOE_CONSISTENCY_CF:g}, the prefix's K/V stitched into an f32 cache: "
        f"greedy tokens {want.argmax(-1).tolist()} equal, logits max abs err {err:.3g} [{card}]")


def moe_serve(torch, cfg, n: int, out: dict, card) -> None:
    """``cfg`` served at full width: params drawn on the card, prefill at
    MOE_SERVE_B x MOE_SERVE_S (routing recorded: drop share and aux per
    layer), then ``n`` greedy tokens eager and captured from one stitched
    cache (the decode rewrites only the positions past the prefix): tokens
    identical; ms beside the bounds, launch calls and device kernels per
    token, peak memory."""
    import gc

    from repro_torch.layers.moe import capacity
    from repro_torch.models import build_model
    from repro_torch.serving import GreedyDecoder, build_prefill_step, stitch_prefill_cache
    from repro_torch.utils import tree_leaves

    api = build_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = api.init(torch.Generator("cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    out.update({"layers": cfg.num_layers, "params": n_params, "init_s": time.perf_counter() - t0,
                "card_tree": card_tree(cfg, params)})
    log(f"[moe] {cfg.name} at full width, {cfg.num_layers} of its layers: {n_params:,} params "
        f"in f32 ({4 * n_params / 1e9:.2f} GB) drawn on the card from seed 0 in "
        f"{out['init_s']:.2f} s; compute {cfg.compute_dtype}, decode cache bf16 [{card}]")
    b, s = MOE_SERVE_B, MOE_SERVE_S
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), dtype=torch.int32, device="cuda",
                                     generator=torch.Generator("cuda").manual_seed(3))}
    step = build_prefill_step(api, kv_chunk=LM_KV_CHUNK)
    prefill_ms = []
    for call in range(2):       # the first call also loads cuBLAS's kernels
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if call == 0:
            with recorded_routing() as calls:
                logits, pre = step(params, batch)
        else:
            logits, pre = step(params, batch)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    routes = routing_stats(torch, cfg, calls)
    del calls, logits, pre
    held = {}
    busy = {"prefill": device_busy_over(torch, lambda: held.update(out=step(params, batch)),
                                        names=True)}
    logits, pre = held.pop("out")
    first = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
    covered = pre["k"].shape[2]
    cache = stitch_prefill_cache(api, pre, covered + n)
    del pre
    runs, decoders = {}, {"eager": GreedyDecoder(api, jit=False), "captured": GreedyDecoder(api)}
    for name, decoder in decoders.items():
        for call in range(2 if name == "captured" else 1):   # captured: capture, then replays
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "eager":
                with recorded_routing() as calls:
                    tokens, _ = decoder(params, cache, first, covered, n)
            else:
                tokens, _ = decoder(params, cache, first, covered, n)
            torch.cuda.synchronize()
            runs.setdefault(name, []).append(((time.perf_counter() - t0) * 1e3, tokens))
    decode_routes = routing_stats(torch, cfg, calls)
    del calls
    if not all(torch.equal(t, runs["eager"][0][1]) for _, t in runs["captured"]):
        raise AssertionError(f"[moe] {cfg.name}: captured greedy tokens differ from the eager "
                             f"loop's")
    if decoders["captured"].captures != 1:
        raise AssertionError(f"[moe] {decoders['captured'].captures} decode captures, expected 1")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    pf_flops, pf_bytes = moe_serve_bound(cfg, b, s, 0, sum(routes["kept_pairs"]),
                                         sum(routes["touched_experts"]))
    pf_bound, pf_by = bound_of(pf_flops, pf_bytes, PEAK_BF16_FLOPS)
    mid = covered + n // 2
    pairs = b * cfg.moe.top_k * cfg.num_layers
    touched = sum(decode_routes["touched_experts"]) / n          # a token's, over the layers
    dc_flops, dc_bytes = moe_serve_bound(cfg, b, 1, mid, pairs, touched)
    dc_bound, dc_by = bound_of(dc_flops, dc_bytes, PEAK_BF16_FLOPS)
    all_flops, all_bytes = moe_serve_bound(cfg, b, 1, mid, pairs,
                                           cfg.moe.num_experts * cfg.num_layers)
    all_bound, _ = bound_of(all_flops, all_bytes, PEAK_BF16_FLOPS)
    out.update({
        "prefill_ms": prefill_ms[1], "prefill_first_ms": prefill_ms[0],
        "prefill_bound_ms": pf_bound, "prefill_bound_by": pf_by, "prefill_flops": pf_flops,
        "prefill_routing": routes, "decode_touched_experts_per_layer": touched / cfg.num_layers,
        "decode_bound_ms_per_token": dc_bound, "decode_bound_by": dc_by,
        "decode_bound_all_experts_ms_per_token": all_bound, "peak_memory_gb": peak_gb,
        "captures": decoders["captured"].captures, "replays": decoders["captured"].replays})
    log(f"[moe] {cfg.name} prefill B={b} S={s} (kv_chunk {LM_KV_CHUNK}, eager): "
        f"{prefill_ms[1]:.1f} ms (first call {prefill_ms[0]:.1f} ms); bound {pf_bound:.2f} ms by "
        f"{pf_by} ({pf_flops / 1e12:.2f} TFLOP of products at the bf16 dense peak, experts "
        f"counted for the (token, choice) pairs kept), "
        f"{pf_flops / (prefill_ms[1] / 1e3) / 1e12:.1f} TFLOP/s achieved [{card}]")
    drops = ", ".join(f"{x:.4f}" for x in routes["drop_share"])
    auxes = ", ".join(f"{x:.4f}" for x in routes["aux"])
    log(f"[moe] {cfg.name} prefill routing per layer, {b * s} tokens top-{cfg.moe.top_k} of "
        f"{cfg.moe.num_experts} experts, capacity {capacity(b * s, cfg)} a expert: drop share "
        f"{drops}; aux {auxes} (sum {sum(routes['aux']):.4f}) [{card}]")
    for name in ("eager", "captured"):
        ms = runs[name][-1][0]
        out[name] = {"decode_ms_per_token": ms / n, "tokens_per_s": b * n / (ms / 1e3)}
        capture = ""
        if name == "captured":
            out[name]["capture_call_ms_per_token"] = runs[name][0][0] / n
            capture = f" (the call that captured: {runs[name][0][0] / n:.3f} ms/token)"
        log(f"[moe] {cfg.name} decode {name} B={b}, {n} tokens from position {covered}: "
            f"{ms / n:.3f} ms/token, {b * n / (ms / 1e3):,.0f} tokens/s{capture}; bound "
            f"{dc_bound:.3f} ms/token by {dc_by} (the f32 weights of the {touched / cfg.num_layers:.1f} "
            f"experts a layer this run routed a token to, of {cfg.moe.num_experts}, and the rest "
            f"read once), {all_bound:.3f} ms reading every expert [{card}]")
    for name, decoder in decoders.items():
        lp = host_launches(torch, lambda: decoder(params, cache, first, covered, MOE_PROFILE_TOKENS))
        out[name]["host_calls_per_token"] = lp["host_total"] / MOE_PROFILE_TOKENS
        out[name]["device_ops_per_token"] = lp["device_ops"] / MOE_PROFILE_TOKENS
        log(f"[moe] {cfg.name} decode {name}: {lp['host_total'] / MOE_PROFILE_TOKENS:.1f} launch "
            f"calls per token on the host, {lp['device_ops'] / MOE_PROFILE_TOKENS:.1f} device "
            f"kernels/copies per token (one torch.profiler pass over {MOE_PROFILE_TOKENS} tokens, "
            f"the cache's copies in and out included) [{card}]")
    log(f"[moe] {cfg.name} captured tokens equal the eager loop's ({n} tokens x {b} rows, both "
        f"captured calls); {decoders['captured'].captures} capture, "
        f"{decoders['captured'].replays} replays; peak memory {peak_gb:.2f} GB "
        f"(torch.cuda.max_memory_allocated) [{card}]")
    busy["captured decode"] = device_busy_over(
        torch, lambda: decoders["captured"](params, cache, first, covered, MOE_PROFILE_TOKENS),
        names=True)
    for tag, run in busy.items():
        run.pop("names")
        top = list(run["device_ms_by_name"].items())[:MOE_TOP_KERNELS]
        out[f"profiled_{tag.replace(' ', '_')}"] = dict(run, device_ms_by_name=dict(top))
        log(f"[moe] {cfg.name} one profiled {tag}"
            f"{f' of {MOE_PROFILE_TOKENS} tokens' if 'decode' in tag else ''}: "
            f"{run['wall_ms']:.1f} ms, {run['device_ops']} device kernels/copies, the device busy "
            f"{run['device_busy_ms']:.1f} ms (idle share {run['idle_share']:.3f}); the largest "
            f"{len(top)} of {len(run['device_ms_by_name'])} kernel names by device time: "
            + "; ".join(f"{name[:64]} {t:.1f} ms" for name, t in top) + f" [{card}]")
    del params, logits, cache, decoders, step, runs
    gc.collect()
    torch.cuda.empty_cache()


def drive_moe(torch, results, card) -> None:
    """The MoE transformer at full width on the card (``[moe]`` lines):
    card against CPU and decode against prefill at MOE_CHECK_LAYERS layers
    of moonshot-v1-16b-a3b; moonshot served at MOE_SERVE_LAYERS layers and
    dbrx-132b at MOE_DBRX_LAYERS, eager and captured; moonshot trained at
    MOE_TRAIN_LAYERS layers; both launchers at their reduced default.  Like
    the dense LM, the path launches none of K1-K4 and calls no library
    attention (both counted): the reference's MoE is plain jnp."""
    import gc
    import math
    import tempfile

    import torch.nn.functional as F

    from repro_torch.config import TrainConfig, get_config
    from repro_torch.data import LMDataConfig, LMIterator, host_slice
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.training import build_train_step, init_train_state
    from repro_torch.utils import tree_leaves

    out = results["moe"] = {"arch": MOE_ARCH, "dbrx": {"arch": MOE_DBRX_ARCH}}
    cfg = get_config(MOE_ARCH)
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[moe] at the phase's start {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved on the card [{card}]")
    sdpa = F.scaled_dot_product_attention
    sdpa_calls = [0]

    def counted_sdpa(*args, **kw):
        sdpa_calls[0] += 1
        return sdpa(*args, **kw)

    F.scaled_dot_product_attention = counted_sdpa
    reset_launch_counts()
    try:
        # 1-2. card against CPU, decode against prefill: 2 layers, full width
        cfg2 = cfg.with_overrides(num_layers=MOE_CHECK_LAYERS)
        params = build_model(cfg2).init(torch.Generator("cuda").manual_seed(0), device="cuda")
        moe_check_cpu(torch, cfg2, params, out, card)
        moe_decode_vs_prefill(torch, cfg2, params, out, card)
        del params

        # 3-4. serving, moonshot deep and dbrx at 2 layers
        moe_serve(torch, cfg.with_overrides(num_layers=MOE_SERVE_LAYERS), MOE_DECODE,
                  out.setdefault("serve", {}), card)
        moe_serve(torch, get_config(MOE_DBRX_ARCH).with_overrides(num_layers=MOE_DBRX_LAYERS),
                  MOE_DBRX_DECODE, out["dbrx"], card)

        # 5. training, moonshot at 2 layers, full width
        gc.collect()
        torch.cuda.empty_cache()
        b, s = MOE_TRAIN_B, MOE_TRAIN_S
        api = build_model(cfg2)
        tc = TrainConfig(learning_rate=1e-3, total_steps=MOE_TRAIN_STEPS, loss_chunk=min(2048, s))
        state = init_train_state(api.init(torch.Generator("cuda").manual_seed(0), device="cuda"),
                                 tc)
        n_params = sum(t.numel() for t in tree_leaves(state.params))
        step = build_train_step(api, tc)
        it = LMIterator(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b))
        batches = [{k: v.to("cuda") for k, v in host_slice(next(it)).items()}
                   for _ in range(MOE_TRAIN_STEPS)]
        with torch.no_grad(), recorded_routing() as calls:
            api.prefill(state.params, {"tokens": batches[0]["tokens"]})
        kept = sum(routing_stats(torch, cfg2, calls)["kept_pairs"])
        del calls
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, metrics_seen = [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics_seen.append({k: float(metrics[k]) for k in ("loss", "xent", "aux")})
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if not all(math.isfinite(v) for m in metrics_seen for v in m.values()):
            raise AssertionError(f"[moe] a training metric is not finite: {metrics_seen}")
        steady = ms[1:]
        mean_ms = statistics.mean(steady)
        flops, nbytes = moe_train_bound(cfg2, b, s, n_params, kept)
        bound_ms, bound_by = bound_of(flops, nbytes, PEAK_BF16_FLOPS)
        out["train"] = {"layers": MOE_TRAIN_LAYERS, "params": n_params, "batch": b, "seq_len": s,
                        "ms": ms, "metrics": metrics_seen, "ms_per_step_mean": mean_ms,
                        "tokens_per_s": b * s / (mean_ms / 1e3), "bound_ms": bound_ms,
                        "bound_by": bound_by, "flops": flops, "peak_memory_gb": peak_gb}
        xents = ", ".join(f"{m['xent']:.4f}" for m in metrics_seen)
        auxes = ", ".join(f"{m['aux']:.4f}" for m in metrics_seen)
        log(f"[moe] train {cfg2.name} at full width, {MOE_TRAIN_LAYERS} layers ({n_params:,} "
            f"params, f32 master weights, bf16 compute, remat={tc.remat}, AdamW f32), B={b} "
            f"S={s}: {MOE_TRAIN_STEPS} steps from LMIterator, xent {xents}, aux {auxes} (all "
            f"finite); first step "
            f"{ms[0]:.1f} ms, steps 2-{MOE_TRAIN_STEPS} mean {mean_ms:.1f} ms, "
            f"{b * s / (mean_ms / 1e3):,.0f} tokens/s; bound {bound_ms:.2f} ms by {bound_by} "
            f"({flops / 1e12:.2f} TFLOP at the bf16 dense peak, experts counted for the pairs "
            f"kept; {nbytes / 1e9:.1f} GB of state at HBM bandwidth, "
            f"{nbytes / PEAK_BYTES * 1e3:.2f} ms), {mean_ms / bound_ms:.1f}x the bound; peak "
            f"memory {peak_gb:.2f} GB [{card}]")
        del state, step, batches, metrics, api
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        F.scaled_dot_product_attention = sdpa
    counts = launch_counts()
    if any(counts.values()) or sdpa_calls[0]:
        raise AssertionError(f"[moe] the MoE path launched port kernels {counts} or library "
                             f"attention ({sdpa_calls[0]} SDPA calls); it runs neither")
    out["port_kernel_launches"], out["sdpa_calls"] = dict(counts), sdpa_calls[0]
    log(f"[moe] port kernel launches over the phase {dict(counts)}, scaled_dot_product_attention "
        f"calls {sdpa_calls[0]}: none, as the reference's MoE transformer is plain jnp [{card}]")

    # 6. the launchers, once each, at their reduced default
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out["launchers"] = {}
    with tempfile.TemporaryDirectory() as ckpt:
        for name, cmd in (
                ("serve", ["repro_torch.launch.serve", "--arch", MOE_ARCH]),
                ("train", ["repro_torch.launch.train", "--arch", MOE_ARCH, "--steps",
                           str(MOE_LAUNCH_TRAIN_STEPS), "--ckpt-dir", ckpt])):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", *cmd], capture_output=True, text=True,
                                  timeout=300, env=env, cwd=ROOT)
            wall = time.perf_counter() - t0
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(f"[{name}]")]
            done = ("sample continuation" if name == "serve" else "[train] done")
            if proc.returncode != 0 or done not in proc.stdout or "nan" in proc.stdout:
                raise AssertionError(f"[moe] {' '.join(cmd)} (rc {proc.returncode}): "
                                     f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
            out["launchers"][name] = {"rc": proc.returncode, "wall_s": wall, "lines": lines}
            for ln in lines:
                log(f"[moe] launcher: {ln} [{card}]")
            log(f"[moe] launcher {' '.join(cmd[:3 if name == 'serve' else 5])}: rc 0 in "
                f"{wall:.1f} s [{card}]")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[moe] phase {out['phase_s']:.1f} s [{card}]")


def rwkv_product_params(cfg) -> tuple[int, int]:
    """(weights of one RWKV-6 layer's products in the compute dtype: r, k, v,
    g, o and the channel-mix's up, down and receptance; those of its f32
    decay LoRA)."""
    d = cfg.d_model
    return 6 * d * d + 2 * d * cfg.d_ff, 2 * d * cfg.rwkv.decay_lora


def rwkv_serve_bound(cfg, b: int, s: int, n_params: int, state_io: int) -> tuple[float, float, float]:
    """(bf16 FLOP, f32 FLOP, bytes) of one forward of b x s new tokens with
    the last position's logits: a prefill (``state_io`` 1, the state
    written) or a decode step (s 1, ``state_io`` 2, the state read and
    written).  bf16: the layers' products and the unembed; f32 (TF32 off):
    the decay LoRA and the WKV recurrence, 5 hd^2 FLOP per (b, t, head) as
    K3 counts it.  Bytes: the f32 weights read once (of the table only the
    b*s rows gathered), the bf16 logits, the state (token shifts bf16, WKV
    f32)."""
    d, nl, hd = cfg.d_model, cfg.num_layers, cfg.rwkv.head_dim
    prod, lora = rwkv_product_params(cfg)
    bf16 = 2.0 * b * s * nl * prod + 2.0 * b * d * cfg.vocab_size
    f32 = 2.0 * b * s * nl * lora + 5.0 * b * s * nl * d * hd
    state = nl * b * (2 * 2 * d + 4 * d * hd)
    nbytes = (4.0 * (n_params - cfg.vocab_size * d) + 4.0 * b * s * d
              + 2.0 * b * cfg.vocab_size + state_io * state)
    return bf16, f32, nbytes


def rwkv_train_bound(cfg, b: int, s: int, n_params: int) -> tuple[float, float, float]:
    """(bf16 FLOP, f32 FLOP, bytes) of one train step: 6 FLOP per product
    weight per token (the layers' and the unembed's), the decay LoRA's 6 in
    f32, the WKV recurrence three times over (forward and a backward of
    twice its work); the f32 params and AdamW's two moments read and
    written once (24 bytes a param), tokens and labels read once."""
    d, nl, hd = cfg.d_model, cfg.num_layers, cfg.rwkv.head_dim
    prod, lora = rwkv_product_params(cfg)
    bf16 = 6.0 * b * s * (nl * prod + d * cfg.vocab_size)
    f32 = 6.0 * b * s * nl * lora + 3 * 5.0 * b * s * nl * d * hd
    return bf16, f32, 24.0 * n_params + 2 * 8.0 * b * s


def mixed_bound(bf16: float, f32: float, nbytes: float) -> tuple[float, str]:
    """(ms, what bounds it): the largest of the bf16 operations at the
    tensor cores' peak, the f32 ones at the FP32 cores' and the bytes over
    HBM bandwidth.  The tensor cores and the FP32 cores run at once, so
    the floor is the larger of their times, not their sum."""
    ops_ms = max(bf16 / PEAK_BF16_FLOPS, f32 / PEAK_F32_FLOPS) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


class K3Segments:
    """K3 launches (``launch_counts()``) over each named segment of the
    ``[rwkv]`` phase beside the count the code predicts for it."""

    def __init__(self):
        self.seen: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str, predicted: int):
        from repro_torch.kernels.ops import launch_counts

        before = launch_counts()["wkv6"]
        yield
        self.seen[name] = {"launches": launch_counts()["wkv6"] - before, "predicted": predicted}

    def total(self) -> tuple[int, int]:
        return (sum(v["launches"] for v in self.seen.values()),
                sum(v["predicted"] for v in self.seen.values()))


class K3Inputs:
    """The arguments of K3's calls on the RWKV path, recorded so that the
    kernel can be held against its plain version on exactly the inputs the
    path gave it.  While ``with rec({tag: T, ...})`` is active, the last
    ``wkv6_op`` call through the RWKV layer (``layers/rwkv.py`` reaches K3
    only through its module's ``wkv6_op``) whose streams have T steps is
    kept, cloned, under its tag."""

    def __init__(self):
        self.seen: dict = {}

    @contextlib.contextmanager
    def __call__(self, lengths: dict):
        from repro_torch.layers import rwkv as rwkv_layer

        real = rwkv_layer.wkv6_op

        def recording(*args):
            for tag, t_len in lengths.items():
                if args[0].shape[1] == t_len:
                    self.seen[tag] = tuple(t.detach().clone() for t in args)
            return real(*args)

        rwkv_layer.wkv6_op = recording
        try:
            yield
        finally:
            rwkv_layer.wkv6_op = real


def rwkv_k3_vs_plain(torch, rec, out, card, tag="rwkv",
                     expected=("prefill", "decode", "train_forward", "train_chunk")) -> None:
    """K3 (``wkv6_op`` on the card) against ``wkv6_plain`` on the inputs
    ``rec`` kept from the RWKV path (one set per name in ``expected``;
    lines tagged ``[tag]``).  Both compute in f32 from the same bf16 r, k,
    v and f32 w, u, S0; only the order of f32 sums differs, so the bar is
    f32's, WKV_F32_TOL relative plus WKV_F32_TOL times the plain result's
    rms absolute (y and S are unnormalised sums over up to T steps of
    decays near 1).  These launches check the kernel and are not the
    path's: they come after the phase's counts are read."""
    from repro_torch.kernels.ops import wkv6_op
    from repro_torch.kernels.wkv6 import wkv6_plain

    rows = out["k3_vs_plain"] = {}
    for key, args in rec.seen.items():
        got = wkv6_op(*args)
        want = wkv6_plain(*args)
        row = rows[key] = {"shape": list(args[0].shape), "dtype": str(args[0].dtype),
                           "s0_rms": float(args[5].pow(2).mean().sqrt())}
        for name, g, w in zip(("y", "state"), got, want):
            rms = float(w.pow(2).mean().sqrt())
            row[name] = {"max_abs_err": float((g - w).abs().max()), "rms": rms,
                         "max_abs": float(w.abs().max())}
            torch.testing.assert_close(g, w, rtol=WKV_F32_TOL, atol=WKV_F32_TOL * max(1.0, rms))
        log(f"[{tag}] K3 against its plain version on the {key} inputs the path gave it "
            f"(B, T, H, hd = {tuple(args[0].shape)}, {args[0].dtype} r/k/v, the layer's decays, "
            f"S0 rms {row['s0_rms']:.3g}): y max abs err {row['y']['max_abs_err']:.3g} (rms "
            f"{row['y']['rms']:.3g}), state max abs err {row['state']['max_abs_err']:.3g} (rms "
            f"{row['state']['rms']:.3g}); bar rtol {WKV_F32_TOL}, atol {WKV_F32_TOL} x max(1, rms) "
            f"[{card}]")
        del got, want
    if set(rows) != set(expected):
        raise AssertionError(f"[{tag}] K3 inputs recorded for {sorted(rows)}, expected "
                             f"{sorted(expected)}")
    rec.seen.clear()


def rwkv_bwd_launches(s: int, layers: int) -> int:
    """K3 launches of ``WKV6``'s backward over ``layers`` layers at S=s: the
    states at the start of every 64-step chunk after the first."""
    return layers * (-(-s // 64) - 1)


def rwkv_check_cpu(torch, cfg, params, out, k3, card) -> None:
    """Card against CPU at RWKV_CHECK_LAYERS layers on one prompt (B=1,
    S=32): f32 (TF32 off) logits and state at LM_F32_TOL, bf16 logits at
    LM_BF16_TOL; one decode step from each side's prefill state (the
    served decode's K3 launch at T=1) at the same bars, its new state too
    in f32; and one value_and_grad of ``train_loss`` in each (the
    [lm-train] bars; bf16's at RWKV_BF16_GRAD_B x RWKV_BF16_GRAD_S, and
    its gap at B=1, S=32 logged beside the CPU's own bf16-vs-f32 gap)."""
    from repro_torch.data import LMDataConfig, make_lm_batch
    from repro_torch.models import build_model
    from repro_torch.utils import tree_map

    cpu_params = tree_map(lambda t: t.cpu(), params)
    toks = torch.randint(0, cfg.vocab_size, (LM_CPU_B, LM_CPU_S), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    small = make_lm_batch(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=LM_CPU_S,
                                       global_batch=LM_CPU_B), 0)
    pos = torch.tensor(LM_CPU_S, dtype=torch.int32)
    nl = cfg.num_layers
    f32_grads = None
    for tag, dtype, tol, grad_tol, (b, s) in (
            ("f32", "float32", LM_F32_TOL, LM_TRAIN_F32_GRAD_REL, (LM_CPU_B, LM_CPU_S)),
            ("bf16", "bfloat16", LM_BF16_TOL, LM_TRAIN_BF16_GRAD_REL,
             (RWKV_BF16_GRAD_B, RWKV_BF16_GRAD_S))):
        a = build_model(cfg.with_overrides(compute_dtype=dtype))
        batch = make_lm_batch(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b), 0)
        t0 = time.perf_counter()
        want, wstate = a.prefill(cpu_params, {"tokens": toks})
        nxt = want[:, -1].argmax(-1).to(torch.int32)[:, None]
        predicted = nl * (1 + 1 + 2) + rwkv_bwd_launches(s, nl) + (2 * nl if tag == "bf16" else 0)
        with k3(f"card_vs_cpu_{tag}", predicted):
            got, gstate = a.prefill(params, {"tokens": toks.cuda()})
            gpre = tree_map(torch.clone, gstate)
            gdec, _ = a.decode(params, nxt.cuda(), gstate, pos.cuda())   # writes gstate
            got_loss, ggrads = lm_value_and_grad(torch, a, params,
                                                 {k: v.cuda() for k, v in batch.items()},
                                                 loss_chunk=s)
            if tag == "bf16":
                _, gsmall = lm_value_and_grad(torch, a, params,
                                              {k: v.cuda() for k, v in small.items()},
                                              loss_chunk=LM_CPU_S)
        wpre = tree_map(torch.clone, wstate)
        wdec, _ = a.decode(cpu_params, nxt, wstate, pos)                   # writes wstate
        want_loss, wgrads = lm_value_and_grad(torch, a, cpu_params, batch, loss_chunk=s)
        cpu_s = time.perf_counter() - t0
        err = float((got.float().cpu() - want.float()).abs().max())
        torch.testing.assert_close(got.float().cpu(), want.float(), rtol=tol, atol=tol)
        dec_err = float((gdec.float().cpu() - wdec.float()).abs().max())
        torch.testing.assert_close(gdec.float().cpu(), wdec.float(), rtol=tol, atol=tol)
        state_err = dec_state_err = None
        if tag == "f32":
            for name in ("tm_x", "wkv", "cm_x"):
                torch.testing.assert_close(gpre[name].cpu(), wpre[name], rtol=tol, atol=tol)
                torch.testing.assert_close(gstate[name].cpu(), wstate[name], rtol=tol, atol=tol)
            state_err = max(float((gpre[n].cpu() - wpre[n]).abs().max()) for n in wpre)
            dec_state_err = max(float((gstate[n].cpu() - wstate[n]).abs().max()) for n in wstate)
            f32_grads = wgrads
        errs = [rel_fro(torch, g.cpu(), w) for g, w in zip(ggrads, wgrads)]
        loss_err = abs(float(got_loss) - float(want_loss))
        torch.testing.assert_close(got_loss.cpu(), want_loss, rtol=tol, atol=tol)
        if max(errs) > grad_tol:
            raise AssertionError(f"[rwkv] {tag} grads card vs CPU: relative errors {errs} past "
                                 f"{grad_tol}")
        out[f"card_vs_cpu_{tag}"] = {
            "logits_max_abs_err": err, "state_max_abs_err": state_err, "tol": tol,
            "decode_logits_max_abs_err": dec_err, "decode_state_max_abs_err": dec_state_err,
            "loss": float(want_loss), "loss_abs_err": loss_err, "grad_rel_fro": errs,
            "grad_tol": grad_tol, "grad_batch": [b, s], "s": cpu_s}
        state_txt = (f", state (token shifts and f32 WKV) {state_err:.3g}, after the decode step "
                     f"{dec_state_err:.3g}") if state_err is not None else ""
        log(f"[rwkv] card against CPU, {cfg.name} at {nl} layers (full width) {tag}, B={LM_CPU_B} "
            f"S={LM_CPU_S}: prefill logits max abs err {err:.3g}; one decode step from each side's "
            f"prefill state (K3 at T=1) logits max abs err {dec_err:.3g}{state_txt} (rtol = atol = "
            f"{tol}); train_loss at B={b} S={s} {float(want_loss):.6f}, abs err {loss_err:.3g}, "
            f"{len(errs)} grad leaves, relative Frobenius error max {max(errs):.3g} (bar "
            f"{grad_tol}) ({cpu_s:.1f} s) [{card}]")
        if tag == "bf16":
            _, wsmall = lm_value_and_grad(torch, a, cpu_params, small, loss_chunk=LM_CPU_S)
            card_gap = [rel_fro(torch, g.cpu(), w) for g, w in zip(gsmall, wsmall)]
            cpu_gap = [rel_fro(torch, w, w32) for w, w32 in zip(wsmall, f32_grads)]
            worst = max(range(len(card_gap)), key=card_gap.__getitem__)
            out["card_vs_cpu_bf16"]["grad_rel_fro_b1_s32"] = card_gap
            out["card_vs_cpu_bf16"]["cpu_bf16_vs_f32_rel_fro_b1_s32"] = cpu_gap
            log(f"[rwkv] bf16 train_loss grads at B={LM_CPU_B} S={LM_CPU_S} (read, not held): card "
                f"against CPU relative Frobenius error max {max(card_gap):.3g} (leaf {worst}), the "
                f"CPU's own bf16 grads against its f32 ones max {max(cpu_gap):.3g} (leaf {worst}: "
                f"{cpu_gap[worst]:.3g}) [{card}]")
            del gsmall, wsmall
    del cpu_params, wgrads, ggrads, f32_grads


def rwkv_decode_vs_prefill(torch, cfg, params, out, k3, card) -> None:
    """Decode against prefill at RWKV_CHECK_LAYERS layers, B=2, S=64, in f32
    and bf16: the prefill's state of S tokens decodes token S+1 to the last
    position of a prefill of S+1, at the reference's bar."""
    from repro_torch.models import build_model
    from repro_torch.serving import stitch_prefill_cache

    b, s = LM_CONSISTENCY_B, LM_CONSISTENCY_S
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), dtype=torch.int32, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(2))
    for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        api = build_model(cfg.with_overrides(compute_dtype=dtype))
        with k3(f"decode_vs_prefill_{tag}", 3 * cfg.num_layers):
            full, _ = api.prefill(params, {"tokens": toks})
            _, pre = api.prefill(params, {"tokens": toks[:, :-1]})
            dec, _ = api.decode(params, toks[:, -1:], stitch_prefill_cache(api, pre, s + 1),
                                torch.tensor(s, dtype=torch.int32, device="cuda"))
        err = float((dec.float() - full.float()).abs().max())
        torch.testing.assert_close(dec.float(), full.float(), rtol=RWKV_CONSISTENCY_TOL,
                                   atol=RWKV_CONSISTENCY_TOL)
        same = torch.equal(dec[:, -1].argmax(-1), full[:, -1].argmax(-1))
        out[f"decode_vs_prefill_{tag}"] = {"max_abs_err": err, "greedy_equal": same}
        log(f"[rwkv] decode against prefill, {cfg.num_layers} layers {tag}, B={b}: the state of a "
            f"{s}-token prefill decodes token {s + 1}: logits max abs err {err:.3g} against a "
            f"{s + 1}-token prefill's last position (bar {RWKV_CONSISTENCY_TOL}, the reference's); "
            f"greedy tokens equal: {same} [{card}]")


def rwkv_serve(torch, cfg, out, k3, rec, card) -> None:
    """``cfg`` served at full width and depth: params drawn on the card,
    prefill at RWKV_SERVE_B x RWKV_SERVE_S (timed, then once profiled for
    K3's device time a layer), then RWKV_DECODE greedy tokens eager and
    captured, each from its own copy of the prefill's state: tokens
    identical; ms beside the bounds, launch calls and device kernels per
    token, peak memory.  ``rec`` keeps K3's inputs from the first prefill
    (the call reported only as the first) and from one more decode step."""
    import gc

    from repro_torch.models import build_model
    from repro_torch.serving import GreedyDecoder, build_prefill_step, stitch_prefill_cache
    from repro_torch.utils import tree_leaves, tree_map

    api = build_model(cfg)
    nl, n = cfg.num_layers, RWKV_DECODE
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = api.init(torch.Generator("cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    out.update({"layers": nl, "params": n_params, "init_s": time.perf_counter() - t0,
                "card_tree": card_tree(cfg, params)})
    log(f"[rwkv] {cfg.name} at full width and all {nl} layers: {n_params:,} params in f32 "
        f"({4 * n_params / 1e9:.2f} GB) drawn on the card from seed 0 in {out['init_s']:.2f} s; "
        f"compute {cfg.compute_dtype}, WKV state f32 [{card}]")
    b, s = RWKV_SERVE_B, RWKV_SERVE_S
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), dtype=torch.int32, device="cuda",
                                     generator=torch.Generator("cuda").manual_seed(3))}
    step = build_prefill_step(api)
    prefill_ms, held = [], {}
    with k3("prefill", 3 * nl):
        for i in range(2):       # the first call also loads cuBLAS's kernels
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with rec({"prefill": s} if i == 0 else {}):
                logits, pre = step(params, batch)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
        del logits, pre
        prof = device_busy_over(torch, lambda: held.update(out=step(params, batch)), names=True)
    logits, pre = held.pop("out")
    k3_ms = sum(t for name, t in prof["device_ms_by_name"].items() if RWKV_K3_KERNEL in name) / nl
    k3_flops, k3_bytes = k3_bound(b, s, cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim, s=2)
    k3_bound_ms, k3_by = bound_of(k3_flops, k3_bytes, PEAK_F32_FLOPS)
    first = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
    if not torch.isfinite(logits).all() or not all(torch.isfinite(t).all() for t in pre.values()):
        raise AssertionError(f"[rwkv] {cfg.name} prefill: non-finite logits or state")
    runs, decoders = {}, {"eager": GreedyDecoder(api, jit=False), "captured": GreedyDecoder(api)}
    for name, decoder in decoders.items():
        calls = 2 if name == "captured" else 1                   # captured: capture, then replays
        with k3(f"decode_{name}", calls * n * nl):
            for _ in range(calls):
                cache = stitch_prefill_cache(api, tree_map(torch.clone, pre), s + n)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tokens, _ = decoder(params, cache, first, s, n)
                torch.cuda.synchronize()
                runs.setdefault(name, []).append(((time.perf_counter() - t0) * 1e3, tokens,
                                                  decoder.logits))
    want_tokens, want_logits = runs["eager"][0][1], runs["eager"][0][2]
    if not all(torch.equal(t, want_tokens) for _, t, _ in runs["captured"]):
        raise AssertionError(f"[rwkv] {cfg.name}: captured greedy tokens differ from the eager "
                             f"loop's")
    if decoders["captured"].captures != 1:
        raise AssertionError(f"[rwkv] {decoders['captured'].captures} decode captures, expected 1")
    logits_equal = all(torch.equal(lg, want_logits) for _, _, lg in runs["captured"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with k3("decode_inputs", nl), rec({"decode": 1}):
        api.decode(params, first, stitch_prefill_cache(api, tree_map(torch.clone, pre), s + 1),
                   torch.tensor(s, dtype=torch.int32, device="cuda"))

    pf_bf16, pf_f32, pf_bytes = rwkv_serve_bound(cfg, b, s, n_params, 1)
    pf_bound, pf_by = mixed_bound(pf_bf16, pf_f32, pf_bytes)
    pf_bf16_ms, pf_f32_ms = pf_bf16 / PEAK_BF16_FLOPS * 1e3, pf_f32 / PEAK_F32_FLOPS * 1e3
    dc_bound, dc_by = mixed_bound(*rwkv_serve_bound(cfg, b, 1, n_params, 2))
    out.update({
        "prefill_ms": prefill_ms[1], "prefill_first_ms": prefill_ms[0],
        "prefill_bound_ms": pf_bound, "prefill_bound_by": pf_by, "prefill_bf16_flops": pf_bf16,
        "prefill_f32_flops": pf_f32, "prefill_bytes": pf_bytes, "prefill_bf16_ms": pf_bf16_ms,
        "prefill_f32_ms": pf_f32_ms,
        "k3_device_ms_per_layer": k3_ms, "k3_bound_ms_per_layer": k3_bound_ms, "k3_bound_by": k3_by,
        "profiled_prefill": {k: v for k, v in prof.items() if k not in ("names", "device_ms_by_name")},
        "decode_bound_ms_per_token": dc_bound, "decode_bound_by": dc_by, "peak_memory_gb": peak_gb,
        "captures": decoders["captured"].captures, "replays": decoders["captured"].replays,
        "last_logits_bit_equal": logits_equal, "tokens_row0": want_tokens[0, :16].tolist()})
    log(f"[rwkv] {cfg.name} prefill B={b} S={s} (eager): {prefill_ms[1]:.1f} ms (first call "
        f"{prefill_ms[0]:.1f} ms, K3's inputs recorded in it); bound {pf_bound:.2f} ms by {pf_by}, "
        f"the largest of: {pf_bf16 / 1e12:.2f} TFLOP of products at the bf16 dense peak "
        f"{pf_bf16_ms:.2f} ms, {pf_f32 / 1e12:.3f} TFLOP of WKV and decay LoRA at the FP32 peak "
        f"{pf_f32_ms:.2f} ms (the two units run at once), {pf_bytes / 1e9:.2f} GB at HBM bandwidth "
        f"{pf_bytes / PEAK_BYTES * 1e3:.2f} ms; {prefill_ms[1] / pf_bound:.2f}x the bound [{card}]")
    log(f"[rwkv] {cfg.name} K3 on the prefill's path: {k3_ms:.3f} ms device time a layer (one "
        f"profiled prefill, {RWKV_K3_KERNEL} summed over its {nl} layers), bound {k3_bound_ms:.3f} "
        f"ms by {k3_by} (B={b}, T={s}, H={cfg.d_model // cfg.rwkv.head_dim}, "
        f"hd={cfg.rwkv.head_dim}, bf16 r/k/v); the profiled prefill {prof['wall_ms']:.1f} ms, "
        f"{prof['device_ops']} device kernels/copies, idle share {prof['idle_share']:.3f} [{card}]")
    for name in ("eager", "captured"):
        ms = runs[name][-1][0]
        out[name] = {"decode_ms_per_token": ms / n, "tokens_per_s": b * n / (ms / 1e3)}
        capture = ""
        if name == "captured":
            out[name]["capture_call_ms_per_token"] = runs[name][0][0] / n
            capture = f" (the call that captured: {runs[name][0][0] / n:.3f} ms/token)"
        log(f"[rwkv] {cfg.name} decode {name} B={b}, {n} tokens after the prefill: {ms / n:.3f} "
            f"ms/token, {b * n / (ms / 1e3):,.0f} tokens/s{capture}; bound {dc_bound:.3f} ms/token "
            f"by {dc_by} (the f32 weights read once, the state read and written) [{card}]")
    cache = stitch_prefill_cache(api, tree_map(torch.clone, pre), s)
    with k3("profiled_decode", 3 * RWKV_PROFILE_TOKENS * nl):
        for name, decoder in decoders.items():
            lp = host_launches(torch, lambda: decoder(params, cache, first, s, RWKV_PROFILE_TOKENS))
            out[name]["host_calls_per_token"] = lp["host_total"] / RWKV_PROFILE_TOKENS
            out[name]["device_ops_per_token"] = lp["device_ops"] / RWKV_PROFILE_TOKENS
            log(f"[rwkv] {cfg.name} decode {name}: {lp['host_total'] / RWKV_PROFILE_TOKENS:.1f} "
                f"launch calls per token on the host, "
                f"{lp['device_ops'] / RWKV_PROFILE_TOKENS:.1f} device kernels/copies per token "
                f"(one torch.profiler pass over {RWKV_PROFILE_TOKENS} tokens, the state's copies "
                f"in and out included) [{card}]")
        busy = device_busy_over(
            torch, lambda: decoders["captured"](params, cache, first, s, RWKV_PROFILE_TOKENS))
    out["profiled_captured_decode"] = busy
    log(f"[rwkv] {cfg.name} captured tokens equal the eager loop's ({n} tokens x {b} rows, both "
        f"captured calls; last logits bit-equal: {logits_equal}); "
        f"{decoders['captured'].captures} capture, {decoders['captured'].replays} replays; a "
        f"profiled captured decode of {RWKV_PROFILE_TOKENS} tokens: the device busy "
        f"{busy['device_busy_ms']:.1f} of {busy['wall_ms']:.1f} ms (idle share "
        f"{busy['idle_share']:.3f}); peak memory {peak_gb:.2f} GB "
        f"(torch.cuda.max_memory_allocated) [{card}]")
    del params, logits, pre, cache, decoders, step, runs
    gc.collect()
    torch.cuda.empty_cache()


def rwkv_train(torch, cfg, out, k3, rec, card) -> None:
    """``cfg`` trained at full width for RWKV_TRAIN_STEPS AdamW steps at
    RWKV_TRAIN_B x RWKV_TRAIN_S from ``LMIterator``: ms a step beside the
    bound, xent per step, peak memory, and on the last step the share of
    its wall time spent in ``WKV6``'s backward (CUDA events recorded at the
    backward's entry and exit, one pair a layer).  ``rec`` keeps K3's
    inputs from the first step (reported only as the first): a forward
    over the sequence and a 64-step chunk of the backward."""
    import gc
    import math

    from repro_torch.config import TrainConfig
    from repro_torch.data import LMDataConfig, LMIterator, host_slice
    from repro_torch.layers import rwkv as rwkv_layer
    from repro_torch.models import build_model
    from repro_torch.training import build_train_step, init_train_state
    from repro_torch.utils import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    b, s, nl = RWKV_TRAIN_B, RWKV_TRAIN_S, cfg.num_layers
    api = build_model(cfg)
    tc = TrainConfig(learning_rate=1e-3, total_steps=RWKV_TRAIN_STEPS, loss_chunk=min(2048, s))
    state = init_train_state(api.init(torch.Generator("cuda").manual_seed(0), device="cuda"), tc)
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    step = build_train_step(api, tc)
    it = LMIterator(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b))
    batches = [{k: v.to("cuda") for k, v in host_slice(next(it)).items()}
               for _ in range(RWKV_TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    real_bwd, spans = rwkv_layer.WKV6.backward, []

    def timed_bwd(ctx, *grads):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        got = real_bwd(ctx, *grads)
        end.record()
        spans.append((start, end))
        return got

    ms, xents = [], []
    per_step = nl * 2 + rwkv_bwd_launches(s, nl)        # forward, recompute, backward's chunks
    with k3("train", RWKV_TRAIN_STEPS * per_step):
        for i, batch in enumerate(batches):
            if i == len(batches) - 1:
                rwkv_layer.WKV6.backward = staticmethod(timed_bwd)
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with rec({"train_forward": s, "train_chunk": 64} if i == 0 else {}):
                    state, metrics = step(state, batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            finally:
                rwkv_layer.WKV6.backward = staticmethod(real_bwd)
            xents.append(float(metrics["xent"]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in xents):
        raise AssertionError(f"[rwkv] a training loss is not finite: {xents}")
    if len(spans) != nl:
        raise AssertionError(f"[rwkv] {len(spans)} WKV6 backward calls in a step, expected {nl}")
    bwd_ms = sum(a.elapsed_time(e) for a, e in spans)
    steady = ms[1:]
    mean_ms = statistics.mean(steady)
    bf16, f32, nbytes = rwkv_train_bound(cfg, b, s, n_params)
    bound_ms, bound_by = mixed_bound(bf16, f32, nbytes)
    bf16_ms, f32_ms = bf16 / PEAK_BF16_FLOPS * 1e3, f32 / PEAK_F32_FLOPS * 1e3
    out.update({"layers": nl, "params": n_params, "batch": b, "seq_len": s, "ms": ms,
                "bf16_ms": bf16_ms, "f32_ms": f32_ms,
                "xent": xents, "ms_per_step_mean": mean_ms, "tokens_per_s": b * s / (mean_ms / 1e3),
                "bound_ms": bound_ms, "bound_by": bound_by, "bf16_flops": bf16, "f32_flops": f32,
                "peak_memory_gb": peak_gb, "wkv_backward_ms": bwd_ms,
                "wkv_backward_share": bwd_ms / ms[-1]})
    log(f"[rwkv] train {cfg.name} at full width, {nl} layers ({n_params:,} params, f32 master "
        f"weights, bf16 compute, remat={tc.remat}, AdamW f32), B={b} S={s}: {RWKV_TRAIN_STEPS} "
        f"steps from LMIterator, xent {', '.join(f'{x:.4f}' for x in xents)} (all finite); first "
        f"step {ms[0]:.1f} ms (K3's inputs recorded in it), steps 2-{RWKV_TRAIN_STEPS} mean "
        f"{mean_ms:.1f} ms, {b * s / (mean_ms / 1e3):,.0f} tokens/s; bound {bound_ms:.2f} ms by "
        f"{bound_by}, the largest of: {bf16 / 1e12:.2f} TFLOP at the bf16 dense peak "
        f"{bf16_ms:.2f} ms, {f32 / 1e12:.3f} TFLOP of WKV and decay LoRA at the FP32 peak "
        f"{f32_ms:.2f} ms (the two units run at once), {nbytes / 1e9:.1f} GB of state at HBM "
        f"bandwidth {nbytes / PEAK_BYTES * 1e3:.2f} ms; {mean_ms / bound_ms:.1f}x the bound; peak "
        f"memory {peak_gb:.2f} GB [{card}]")
    log(f"[rwkv] train step {RWKV_TRAIN_STEPS} ({ms[-1]:.1f} ms): WKV6's backward (the chunk "
        f"states rebuilt by K3, then each 64-step chunk's adjoint in plain PyTorch, two "
        f"step-by-step state recurrences and batched terms) took {bwd_ms:.1f} ms over its {nl} "
        f"layers, {bwd_ms / ms[-1]:.3f} of the step (CUDA events at the backward's entry and "
        f"exit) [{card}]")
    del state, step, batches, metrics, api
    gc.collect()
    torch.cuda.empty_cache()


def drive_rwkv(torch, results, card) -> None:
    """RWKV-6 at full width on the card (``[rwkv]`` lines): card against CPU
    and decode against prefill at RWKV_CHECK_LAYERS layers; rwkv6-7b served
    at all its layers, eager and captured; trained at RWKV_TRAIN_LAYERS
    layers; both launchers at their reduced default.  Its WKV runs through
    K3: every K3 launch of the phase is counted against the count the code
    predicts, segment by segment, and none of K1, K2, K4 nor a library
    attention may run.  Then K3 is held against its plain version on the
    inputs the served and trained paths gave it."""
    import tempfile

    import torch.nn.functional as F

    from repro_torch.config import get_config
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models import build_model

    out = results["rwkv"] = {"arch": RWKV_ARCH}
    cfg = get_config(RWKV_ARCH)
    t_phase = time.perf_counter()
    sdpa = F.scaled_dot_product_attention
    sdpa_calls = [0]

    def counted_sdpa(*args, **kw):
        sdpa_calls[0] += 1
        return sdpa(*args, **kw)

    k3, rec = K3Segments(), K3Inputs()
    F.scaled_dot_product_attention = counted_sdpa
    reset_launch_counts()
    try:
        # 1-2. card against CPU, decode against prefill: 2 layers, full width
        cfg2 = cfg.with_overrides(num_layers=RWKV_CHECK_LAYERS)
        params = build_model(cfg2).init(torch.Generator("cuda").manual_seed(0), device="cuda")
        rwkv_check_cpu(torch, cfg2, params, out, k3, card)
        rwkv_decode_vs_prefill(torch, cfg2, params, out, k3, card)
        del params
        # 3. served at full depth; 4. trained at 2 layers
        rwkv_serve(torch, cfg, out.setdefault("serve", {}), k3, rec, card)
        rwkv_train(torch, cfg.with_overrides(num_layers=RWKV_TRAIN_LAYERS),
                   out.setdefault("train", {}), k3, rec, card)
    finally:
        F.scaled_dot_product_attention = sdpa
    counts = launch_counts()
    launches, predicted = k3.total()
    out.update({"k3_segments": k3.seen, "k3_launches": launches, "k3_predicted": predicted,
                "port_kernel_launches": dict(counts), "sdpa_calls": sdpa_calls[0]})
    log(f"[rwkv] K3 launches by segment (counted / predicted): "
        + "; ".join(f"{name} {v['launches']}/{v['predicted']}" for name, v in k3.seen.items())
        + f"; total {launches}/{predicted} [{card}]")
    wrong = {name: v for name, v in k3.seen.items() if v["launches"] != v["predicted"]}
    others = {k: v for k, v in counts.items() if k != "wkv6" and v}
    if wrong or counts["wkv6"] != launches or others or sdpa_calls[0]:
        raise AssertionError(f"[rwkv] K3 launches off their prediction {wrong}, other port "
                             f"kernels launched {others} or library attention called "
                             f"({sdpa_calls[0]} SDPA calls); launch counts {dict(counts)}")
    log(f"[rwkv] port kernel launches over the phase {dict(counts)}: K3 only, as predicted; "
        f"scaled_dot_product_attention calls 0 [{card}]")
    rwkv_k3_vs_plain(torch, rec, out, card)

    # 5. the launchers, once each, at their reduced default
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out["launchers"] = {}
    with tempfile.TemporaryDirectory() as ckpt:
        for name, cmd in (
                ("serve", ["repro_torch.launch.serve", "--arch", RWKV_ARCH]),
                ("train", ["repro_torch.launch.train", "--arch", RWKV_ARCH, "--steps",
                           str(RWKV_LAUNCH_TRAIN_STEPS), "--ckpt-dir", ckpt])):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", *cmd], capture_output=True, text=True,
                                  timeout=300, env=env, cwd=ROOT)
            wall = time.perf_counter() - t0
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(f"[{name}]")]
            done = ("sample continuation" if name == "serve" else "[train] done")
            if proc.returncode != 0 or done not in proc.stdout or "nan" in proc.stdout:
                raise AssertionError(f"[rwkv] {' '.join(cmd)} (rc {proc.returncode}): "
                                     f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
            out["launchers"][name] = {"rc": proc.returncode, "wall_s": wall, "lines": lines}
            for ln in lines:
                log(f"[rwkv] launcher: {ln} [{card}]")
            log(f"[rwkv] launcher {' '.join(cmd[:3 if name == 'serve' else 5])}: rc 0 in "
                f"{wall:.1f} s [{card}]")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[rwkv] phase {out['phase_s']:.1f} s [{card}]")


def jamba_kinds(cfg) -> dict:
    """How many layers of each kind a Jamba period holds."""
    from repro_torch.models.jamba import PERIOD, _layer_kind

    kinds = [_layer_kind(cfg, j) for j in range(PERIOD)]
    return {"mamba": sum(m == "mamba" for m, _ in kinds),
            "attn": sum(m == "attn" for m, _ in kinds),
            "mlp": sum(f == "mlp" for _, f in kinds), "moe": sum(f == "moe" for _, f in kinds)}


def jamba_layer_params(cfg) -> dict:
    """Params of each position part at full width: the Mamba mixer's
    product weights and its other leaves, attention, the MLP, one expert,
    the router, a layer's two norms."""
    from repro_torch.layers.mamba import mamba_dims

    d, hd = cfg.d_model, cfg.resolved_head_dim()
    di, ds, r = mamba_dims(cfg)
    return {"mamba_prod": 3 * d * di + di * (r + 2 * ds) + r * di,
            "mamba_other": cfg.ssm.d_conv * di + 3 * di + di * ds,
            "attn": 2 * d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd,
            "mlp": 3 * d * cfg.d_ff, "expert": 3 * d * cfg.d_ff,
            "router": d * cfg.moe.num_experts, "norms": 2 * d}


def jamba_serve_bound(cfg, b: int, s: int, past: int, kept_pairs: float,
                      touched: float) -> tuple[float, float, float]:
    """(bf16 FLOP, f32 FLOP, bytes) of one forward of b x s new tokens after
    ``past`` cached positions with the last position's logits (a prefill:
    past 0; a decode step: s 1).  bf16: the Mamba, attention and MLP
    products, the experts' of the ``kept_pairs`` (token, choice) pairs
    routed and not dropped (summed over the layers) and the unembed; f32
    (TF32 off, FP32 cores): causal attention over the visible (query, key)
    pairs, the selective scan at 8 FLOP per (token, channel, state) (dt·A,
    exp, dt·B, ·x, da·h + dbx, C·h), the router (f64, counted here).
    Bytes: the f32 weights read once, of the experts only the ``touched``
    ones (summed over the layers), of the table only the b*s rows; the
    bf16 K/V read for the past and written for the new positions; the
    Mamba states written (a prefill) or read and written (a decode: ssm
    f32, conv bf16); the bf16 logits."""
    from repro_torch.layers.mamba import mamba_dims

    k, p, n_p = jamba_kinds(cfg), jamba_layer_params(cfg), cfg.num_layers // 8
    d, hd, v = cfg.d_model, cfg.resolved_head_dim(), cfg.vocab_size
    di, ds, _ = mamba_dims(cfg)
    bf16 = (2.0 * b * s * n_p * (k["mamba"] * p["mamba_prod"] + k["attn"] * p["attn"]
                                 + k["mlp"] * p["mlp"])
            + 2.0 * p["expert"] * kept_pairs + 2.0 * b * d * v)
    f32 = (4.0 * hd * cfg.num_heads * k["attn"] * n_p * b * (s * past + s * (s + 1) / 2)
           + 8.0 * b * s * di * ds * k["mamba"] * n_p + 2.0 * b * s * p["router"] * k["moe"] * n_p)
    dense = n_p * (k["mamba"] * (p["mamba_prod"] + p["mamba_other"]) + k["attn"] * p["attn"]
                   + k["mlp"] * p["mlp"] + k["moe"] * p["router"] + 8 * p["norms"]) + d * v + d
    state = k["mamba"] * n_p * b * (4 * di * ds + 2 * (cfg.ssm.d_conv - 1) * di)
    nbytes = (4.0 * (dense + p["expert"] * touched) + 4.0 * b * s * d
              + 2.0 * 2 * k["attn"] * n_p * b * cfg.num_kv_heads * hd * (past + s)
              + (1 if past == 0 else 2) * state + 2.0 * b * v)
    return bf16, f32, nbytes


def jamba_routes_agree(torch, want, got) -> tuple[list, int]:
    """Per MoE call, the share of tokens routed to the same experts by two
    recorded runs (``recorded_routing``), and the tokens that differ where
    the first run's k-th and (k+1)-th probabilities lie within 1e-5 (ties,
    counted); a difference elsewhere raises."""
    agree, ties = [], 0
    for (_, wi, wp), (_, gi, _) in zip(want, got):
        same = (torch.sort(wi.cpu(), -1).values == torch.sort(gi.cpu(), -1).values).all(-1)
        top = torch.topk(wp.cpu(), wi.shape[-1] + 1, dim=-1).values
        tie = (top[:, -2] - top[:, -1]) <= 1e-5
        if (~same & ~tie).any():
            raise AssertionError(f"[jamba] routing differs away from a tie at tokens "
                                 f"{torch.nonzero(~same & ~tie).flatten().tolist()}")
        agree.append(float(same.float().mean()))
        ties += int((~same).sum())
    return agree, ties


def jamba_check_reduced(torch, out, card) -> None:
    """The whole reduced config, card against CPU: in f32 (TF32 off) the
    prefill's logits and every state, one decode step from each side's
    stitched states (logits and every state written) at LM_F32_TOL, the
    routing equal away from ties, ``train_loss`` and every grad leaf at
    the [lm-train] f32 bars; in bf16 the prefill's logits no farther from
    the CPU's f32 ones than the CPU's own bf16 logits are, plus the bf16
    bar (the bf16 chains of two devices drift apart through 8 layers, as
    the port's and the JAX package's do, tests/test_torch_jamba.py)."""
    from repro_torch.config import reduced_config
    from repro_torch.data import LMDataConfig, make_lm_batch
    from repro_torch.models import build_model
    from repro_torch.utils import tree_leaves, tree_map

    cfg = reduced_config(JAMBA_ARCH)
    b, s = 2, 12
    cpu_params = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    params = tree_map(lambda t: t.cuda(), cpu_params)
    batch = make_lm_batch(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b), 0)
    pos = torch.tensor(s, dtype=torch.int32)
    logits = {}
    for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        api = build_model(cfg.with_overrides(compute_dtype=dtype))
        with recorded_routing() as want_routes:
            want, wst = api.prefill(cpu_params, {"tokens": batch["tokens"]})
        with recorded_routing() as got_routes:
            got, gst = api.prefill(params, {"tokens": batch["tokens"].cuda()})
        logits[tag] = (got.float().cpu(), want.float())
        if tag == "bf16":
            err = float((got.float().cpu() - want.float()).abs().max())
            mine = float((got.float().cpu() - logits["f32"][1]).abs().max())
            theirs = float((want.float() - logits["f32"][1]).abs().max())
            if mine > theirs + LM_BF16_TOL:
                raise AssertionError(f"[jamba] reduced bf16 logits: the card {mine:.4g} from the "
                                     f"CPU's f32, the CPU's bf16 {theirs:.4g}")
            out["reduced_bf16"] = {"logits_max_abs_err": err, "card_from_cpu_f32": mine,
                                   "cpu_bf16_from_cpu_f32": theirs}
            log(f"[jamba] card against CPU, {cfg.name} (one period, d_model {cfg.d_model}) bf16, "
                f"B={b} S={s}: prefill logits max abs err {err:.3g}; the card's {mine:.3g} and the "
                f"CPU's own {theirs:.3g} from the CPU's f32 logits (held: the card no farther, "
                f"+{LM_BF16_TOL}) [{card}]")
            continue
        agree, ties = jamba_routes_agree(torch, want_routes, got_routes)
        torch.testing.assert_close(got.cpu(), want, rtol=LM_F32_TOL, atol=LM_F32_TOL)
        st_err = max(float((g.cpu() - w).abs().max()) for g, w in zip(tree_leaves(gst),
                                                                       tree_leaves(wst)))
        for g, w in zip(tree_leaves(gst), tree_leaves(wst)):
            torch.testing.assert_close(g.cpu(), w, rtol=LM_F32_TOL, atol=LM_F32_TOL)
        wst, gst = api.stitch(wst, s + 1), api.stitch(gst, s + 1)
        token = batch["tokens"][:, :1]
        wdec, _ = api.decode(cpu_params, token, wst, pos)
        gdec, _ = api.decode(params, token.cuda(), gst, pos.cuda())
        torch.testing.assert_close(gdec.cpu(), wdec, rtol=LM_F32_TOL, atol=LM_F32_TOL)
        for g, w in zip(tree_leaves(gst), tree_leaves(wst)):
            torch.testing.assert_close(g.cpu(), w, rtol=LM_F32_TOL, atol=LM_F32_TOL)
        want_loss, wgrads = lm_value_and_grad(torch, api, cpu_params, batch, loss_chunk=s)
        got_loss, ggrads = lm_value_and_grad(torch, api, params,
                                             {k: v.cuda() for k, v in batch.items()}, loss_chunk=s)
        torch.testing.assert_close(got_loss.cpu(), want_loss, rtol=LM_F32_TOL, atol=LM_F32_TOL)
        errs = [rel_fro(torch, g.cpu(), w) for g, w in zip(ggrads, wgrads)]
        if max(errs) > LM_TRAIN_F32_GRAD_REL:
            raise AssertionError(f"[jamba] reduced f32 grads card vs CPU: {errs}")
        out["reduced_f32"] = {
            "logits_max_abs_err": float((got.cpu() - want).abs().max()),
            "state_max_abs_err": st_err,
            "decode_max_abs_err": float((gdec.cpu() - wdec).abs().max()), "routing_agree": agree,
            "routing_ties": ties, "loss": float(want_loss),
            "loss_abs_err": abs(float(got_loss) - float(want_loss)), "grad_rel_fro_max": max(errs)}
        r = out["reduced_f32"]
        log(f"[jamba] card against CPU, {cfg.name} (one period: 7 Mamba, 1 attention, 4 MoE of "
            f"{cfg.moe.num_experts} experts) f32, B={b} S={s}: prefill logits max abs err "
            f"{r['logits_max_abs_err']:.3g}, every state {st_err:.3g}, one decode step from each "
            f"side's stitched states {r['decode_max_abs_err']:.3g} (rtol = atol = {LM_F32_TOL}); "
            f"routing agreement per MoE layer {', '.join(f'{x:.4f}' for x in agree)} ({ties} "
            f"ties); train_loss {r['loss']:.6f}, abs err {r['loss_abs_err']:.3g}, {len(errs)} grad "
            f"leaves, relative Frobenius error max {max(errs):.3g} (bar {LM_TRAIN_F32_GRAD_REL}) "
            f"[{card}]")


def jamba_check_kinds(torch, cfg, params, out, card) -> None:
    """Each position kind of the full-width period on its own, card against
    CPU at B=1, S=32 in f32 (TF32 off) and bf16: the Mamba mixer of position
    0 (y, ``ssm`` and ``conv``, then one decode step from that state), the
    attention of position 4 (y and the unrotated K/V, then one decode step
    against them), position 0's MLP and position 1's MoE layer (routing
    equal away from ties).  Bars: the Mamba
    layer's the reference's own in f32, the others LM_F32_TOL; bf16
    LM_BF16_TOL."""
    from repro_torch.layers import attention as attn_m
    from repro_torch.layers import mamba as mamba_m
    from repro_torch.layers.mlp import apply_mlp
    from repro_torch.layers.moe import apply_moe
    from repro_torch.utils import tree_map

    parts = {name: tree_map(lambda t: t[0], params["positions"][j][part])
             for name, j, part in (("mamba", 0, "mixer"), ("attn", 4, "mixer"), ("mlp", 0, "ffn"),
                                   ("moe", 1, "ffn"))}
    t0 = time.perf_counter()
    on_cpu = tree_map(lambda t: t.cpu(), parts)
    log(f"[jamba] the four position parts copied to the host in {time.perf_counter() - t0:.1f} s "
        f"[{card}]")
    rows = out["kinds"] = {}
    b, s = LM_CPU_B, LM_CPU_S
    for tag, dtype, bf16 in (("f32", torch.float32, False), ("bf16", torch.bfloat16, True)):
        x = torch.randn(b, s, cfg.d_model, generator=torch.Generator().manual_seed(5)).to(dtype)
        tol = (dict(rtol=LM_BF16_TOL, atol=LM_BF16_TOL) if bf16 else
               dict(rtol=LM_F32_TOL, atol=LM_F32_TOL))
        mtol = tol if bf16 else dict(rtol=JAMBA_MAMBA_TOL[0], atol=JAMBA_MAMBA_TOL[1])
        t0 = time.perf_counter()
        errs = {}

        def held(name, got, want, bar):
            errs[name] = float((got.float().cpu() - want.float()).abs().max())
            torch.testing.assert_close(got.float().cpu(), want.float(), **bar)

        lp, cpu = parts["mamba"], on_cpu["mamba"]
        y, st = mamba_m.apply_mamba(lp, x.cuda(), cfg)
        wy, wst = mamba_m.apply_mamba(cpu, x, cfg)
        held("mamba_y", y, wy, mtol)
        held("mamba_ssm", st["ssm"], wst["ssm"], mtol)
        held("mamba_conv", st["conv"], wst["conv"], mtol)
        y1, _ = mamba_m.apply_mamba_step(lp, x[:, -1].cuda(), cfg, st)
        wy1, _ = mamba_m.apply_mamba_step(cpu, x[:, -1], cfg, wst)
        held("mamba_step_y", y1, wy1, mtol)
        held("mamba_step_ssm", st["ssm"], wst["ssm"], mtol)

        lp, cpu = parts["attn"], on_cpu["attn"]
        y, (k, v) = attn_m.apply_attention(lp, x.cuda(), cfg=cfg, causal=True, use_rope=False,
                                           return_kv=True)
        wy, (wk, wv) = attn_m.apply_attention(cpu, x, cfg=cfg, causal=True, use_rope=False,
                                              return_kv=True)
        held("attn_y", y, wy, tol)
        held("attn_kv", torch.cat([k, v]), torch.cat([wk, wv]), tol)
        caches = []
        for kk, vv in ((k, v), (wk, wv)):
            pad = torch.zeros_like(kk[:, :1])
            caches.append({"k": torch.cat([kk, pad], 1), "v": torch.cat([vv, pad], 1)})
        y1, _ = attn_m.decode_attention(lp, x[:, -1:].cuda(), caches[0],
                                        torch.tensor(s, device="cuda"), cfg=cfg, use_rope=False)
        wy1, _ = attn_m.decode_attention(cpu, x[:, -1:], caches[1], torch.tensor(s), cfg=cfg,
                                         use_rope=False)
        held("attn_step_y", y1, wy1, tol)

        held("mlp_y", apply_mlp(parts["mlp"], x.cuda(), cfg), apply_mlp(on_cpu["mlp"], x, cfg), tol)

        lp, cpu = parts["moe"], on_cpu["moe"]
        with recorded_routing() as got_routes:
            y, aux = apply_moe(lp, x.cuda(), cfg)
        with recorded_routing() as want_routes:
            wy, waux = apply_moe(cpu, x, cfg)
        agree, ties = jamba_routes_agree(torch, want_routes, got_routes)
        held("moe_y", y, wy, tol)
        held("moe_aux", aux, waux, tol)
        rows[tag] = dict(errs, routing_agree=agree[0], routing_ties=ties,
                         s=time.perf_counter() - t0)
        log(f"[jamba] card against CPU, each position kind of {cfg.name} at full width on its "
            f"own, {tag}, B={b} S={s}: " + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
            + f" (max abs err; Mamba at rtol {mtol['rtol']} atol {mtol['atol']}, the others at "
            f"{tol['rtol']}); the MoE layer's routing agreement {agree[0]:.4f} ({ties} ties) "
            f"({rows[tag]['s']:.1f} s) [{card}]")


def jamba_decode_vs_prefill(torch, cfg, params, out, card) -> None:
    """Decode against prefill with the full-width period, f32 compute,
    capacity_factor 16, B=2, S=64: the prefill's states of S tokens,
    stitched, decode token S+1 to the last position of a prefill of S+1,
    at the reference's bar; greedy tokens equal away from ties."""
    import dataclasses

    from repro_torch.models import build_model

    c = cfg.with_overrides(compute_dtype="float32",
                           moe=dataclasses.replace(cfg.moe, capacity_factor=MOE_CONSISTENCY_CF))
    api = build_model(c)
    b, s = LM_CONSISTENCY_B, LM_CONSISTENCY_S
    toks = torch.randint(0, c.vocab_size, (b, s + 1), dtype=torch.int32, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(2))
    full, _ = api.prefill(params, {"tokens": toks})
    _, pre = api.prefill(params, {"tokens": toks[:, :-1]})
    dec, _ = api.decode(params, toks[:, -1:], api.stitch(pre, s + 1),
                        torch.tensor(s, dtype=torch.int32, device="cuda"))
    want, got = full[:, -1].float(), dec[:, -1].float()
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=JAMBA_CONSISTENCY_TOL, atol=JAMBA_CONSISTENCY_TOL)
    decided = greedy_decided(torch, want, 23)
    if not torch.equal(got.argmax(-1)[decided], want.argmax(-1)[decided]):
        raise AssertionError(f"[jamba] decode against prefill: greedy {got.argmax(-1).tolist()} "
                             f"against {want.argmax(-1).tolist()}")
    out["decode_vs_prefill"] = {"max_abs_err": err, "tokens": want.argmax(-1).tolist(),
                                "ties": int((~decided).sum())}
    log(f"[jamba] decode against prefill, {c.name} at full width ({c.num_layers} layers) f32 "
        f"(TF32 off), capacity_factor {MOE_CONSISTENCY_CF:g}, B={b}: the stitched states of a "
        f"{s}-token prefill decode token {s + 1}: logits max abs err {err:.3g} against a "
        f"{s + 1}-token prefill's last position (bar {JAMBA_CONSISTENCY_TOL}, the reference's); "
        f"greedy tokens {want.argmax(-1).tolist()} equal ({int((~decided).sum())} ties) [{card}]")


def jamba_serve(torch, cfg, params, out, card) -> None:
    """The full-width period served: prefill at JAMBA_SERVE_B x JAMBA_SERVE_S
    (routing recorded: drop share and aux per MoE layer) beside its bound,
    one prefill profiled for the host's launch calls, the device's idle
    share and its largest kernels; then JAMBA_DECODE greedy
    tokens eager and captured (twice), each from its own stitched states:
    tokens identical, one capture; ms a token beside the bound, launch calls
    and device kernels a token, the captured decode's idle share; peak
    memory."""
    from repro_torch.layers.moe import capacity
    from repro_torch.models import build_model
    from repro_torch.serving import GreedyDecoder, build_prefill_step
    from repro_torch.utils import tree_map

    api = build_model(cfg)
    b, s, n = JAMBA_SERVE_B, JAMBA_SERVE_S, JAMBA_DECODE
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), dtype=torch.int32, device="cuda",
                                     generator=torch.Generator("cuda").manual_seed(3))}
    step = build_prefill_step(api, kv_chunk=LM_KV_CHUNK)
    torch.cuda.reset_peak_memory_stats()
    prefill_ms = []
    for call in range(2):       # the first call also loads cuBLAS's kernels
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recorded_routing() as calls:
            logits, pre = step(params, batch)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        routes = routing_stats(torch, cfg, calls)
        del calls
    if not torch.isfinite(logits).all() or not all(torch.isfinite(t).all()
                                                   for st in pre for t in st.values()):
        raise AssertionError(f"[jamba] {cfg.name} prefill: non-finite logits or states")
    del logits, pre
    held = {}
    prof = device_busy_over(torch, lambda: held.update(out=step(params, batch)), names=True)
    logits, pre = held.pop("out")
    prof.pop("names")
    top = list(prof["device_ms_by_name"].items())[:MOE_TOP_KERNELS]
    first = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
    runs, decoders = {}, {"eager": GreedyDecoder(api, jit=False), "captured": GreedyDecoder(api)}
    for name, decoder in decoders.items():
        for call in range(2 if name == "captured" else 1):   # captured: capture, then replays
            cache = api.stitch(tree_map(torch.clone, pre), s + n)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "eager":
                with recorded_routing() as calls:
                    tokens, _ = decoder(params, cache, first, s, n)
                decode_routes = routing_stats(torch, cfg, calls)
                del calls
            else:
                tokens, _ = decoder(params, cache, first, s, n)
            torch.cuda.synchronize()
            runs.setdefault(name, []).append(((time.perf_counter() - t0) * 1e3, tokens,
                                              decoder.logits))
    want_tokens = runs["eager"][0][1]
    if not all(torch.equal(t, want_tokens) for _, t, _ in runs["captured"]):
        raise AssertionError(f"[jamba] {cfg.name}: captured greedy tokens differ from the eager "
                             f"loop's")
    if decoders["captured"].captures != 1:
        raise AssertionError(f"[jamba] {decoders['captured'].captures} decode captures, expected 1")
    logits_equal = all(torch.equal(lg, runs["eager"][0][2]) for _, _, lg in runs["captured"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    k = jamba_kinds(cfg)
    n_moe = k["moe"] * cfg.num_layers // 8
    pf = jamba_serve_bound(cfg, b, s, 0, sum(routes["kept_pairs"]), sum(routes["touched_experts"]))
    pf_bound, pf_by = mixed_bound(*pf)
    touched = sum(decode_routes["touched_experts"]) / n                # a token's, over the layers
    dc = jamba_serve_bound(cfg, b, 1, s + n // 2, b * cfg.moe.top_k * n_moe, touched)
    dc_bound, dc_by = mixed_bound(*dc)
    out.update({
        "prefill_ms": prefill_ms[1], "prefill_first_ms": prefill_ms[0],
        "prefill_bound_ms": pf_bound, "prefill_bound_by": pf_by, "prefill_bf16_flops": pf[0],
        "prefill_f32_flops": pf[1], "prefill_bytes": pf[2], "prefill_routing": routes,
        "profiled_prefill": dict(prof, device_ms_by_name=dict(top)),
        "decode_touched_experts_per_layer": touched / n_moe,
        "decode_bound_ms_per_token": dc_bound, "decode_bound_by": dc_by, "peak_memory_gb": peak_gb,
        "captures": decoders["captured"].captures, "replays": decoders["captured"].replays,
        "last_logits_bit_equal": logits_equal, "tokens_row0": want_tokens[0, :16].tolist()})
    log(f"[jamba] {cfg.name} prefill B={b} S={s} (kv_chunk {LM_KV_CHUNK}, eager): "
        f"{prefill_ms[1]:.1f} ms (first call {prefill_ms[0]:.1f} ms); bound {pf_bound:.2f} ms by "
        f"{pf_by}, the largest of: {pf[0] / 1e12:.2f} TFLOP of products at the bf16 dense peak "
        f"{pf[0] / PEAK_BF16_FLOPS * 1e3:.2f} ms (experts counted for the pairs kept), "
        f"{pf[1] / 1e12:.3f} TFLOP of f32 attention, scan and router at the FP32 peak "
        f"{pf[1] / PEAK_F32_FLOPS * 1e3:.2f} ms, {pf[2] / 1e9:.2f} GB at HBM bandwidth "
        f"{pf[2] / PEAK_BYTES * 1e3:.2f} ms; {prefill_ms[1] / pf_bound:.2f}x the bound [{card}]")
    log(f"[jamba] {cfg.name} one profiled prefill: {prof['host_calls']:,} launch calls on the "
        f"host, {prof['device_ops']:,} device kernels/copies, {prof['wall_ms']:.1f} ms, the device "
        f"busy {prof['device_busy_ms']:.1f} ms (idle share {prof['idle_share']:.3f}); the largest "
        f"{len(top)} kernel names by device time: "
        + "; ".join(f"{name[:64]} {t:.1f} ms" for name, t in top) + f" [{card}]")
    drops = ", ".join(f"{x:.4f}" for x in routes["drop_share"])
    auxes = ", ".join(f"{x:.4f}" for x in routes["aux"])
    log(f"[jamba] {cfg.name} prefill routing per MoE layer (positions 1, 3, 5, 7), {b * s} tokens "
        f"top-{cfg.moe.top_k} of {cfg.moe.num_experts} experts, capacity {capacity(b * s, cfg)} a "
        f"expert: drop share {drops}; aux {auxes} [{card}]")
    for name in ("eager", "captured"):
        ms = runs[name][-1][0]
        out[name] = {"decode_ms_per_token": ms / n, "tokens_per_s": b * n / (ms / 1e3)}
        capture = ""
        if name == "captured":
            out[name]["capture_call_ms_per_token"] = runs[name][0][0] / n
            capture = f" (the call that captured: {runs[name][0][0] / n:.3f} ms/token)"
        log(f"[jamba] {cfg.name} decode {name} B={b}, {n} tokens after the prefill: {ms / n:.3f} "
            f"ms/token, {b * n / (ms / 1e3):,.0f} tokens/s{capture}; bound {dc_bound:.3f} ms/token "
            f"by {dc_by} (the f32 weights read once, of the experts the {touched / n_moe:.1f} a "
            f"layer this run routed a token to, the states read and written) [{card}]")
    cache = api.stitch(tree_map(torch.clone, pre), s + n)     # the captured graph's signature
    for name, decoder in decoders.items():
        lpd = host_launches(torch, lambda: decoder(params, cache, first, s, JAMBA_PROFILE_TOKENS))
        out[name]["host_calls_per_token"] = lpd["host_total"] / JAMBA_PROFILE_TOKENS
        out[name]["device_ops_per_token"] = lpd["device_ops"] / JAMBA_PROFILE_TOKENS
        log(f"[jamba] {cfg.name} decode {name}: {lpd['host_total'] / JAMBA_PROFILE_TOKENS:.1f} "
            f"launch calls per token on the host, {lpd['device_ops'] / JAMBA_PROFILE_TOKENS:.1f} "
            f"device kernels/copies per token (one torch.profiler pass over "
            f"{JAMBA_PROFILE_TOKENS} tokens, the states' copies in and out included) [{card}]")
    busy = device_busy_over(
        torch, lambda: decoders["captured"](params, cache, first, s, JAMBA_PROFILE_TOKENS))
    if decoders["captured"].captures != 1:
        raise AssertionError(f"[jamba] the profiled decodes captured again "
                             f"({decoders['captured'].captures} captures)")
    out["profiled_captured_decode"] = busy
    log(f"[jamba] {cfg.name} captured tokens equal the eager loop's ({n} tokens x {b} rows, both "
        f"captured calls; last logits bit-equal: {logits_equal}); "
        f"{decoders['captured'].captures} capture, {decoders['captured'].replays} replays; a "
        f"profiled captured decode of {JAMBA_PROFILE_TOKENS} tokens: the device busy "
        f"{busy['device_busy_ms']:.1f} of {busy['wall_ms']:.1f} ms (idle share "
        f"{busy['idle_share']:.3f}); peak memory {peak_gb:.2f} GB "
        f"(torch.cuda.max_memory_allocated) [{card}]")


def jamba_train_mamba_layer(torch, cfg, lp, out, card) -> None:
    """One full-width Mamba mixer (``lp``, f32 params) forward and backward
    at JAMBA_TRAIN_B x JAMBA_TRAIN_S, x in bf16, as a train step runs it
    (autograd through the step-by-step scan): ms of the steady calls beside
    the bound, and peak memory above the params."""
    from repro_torch.layers.mamba import apply_mamba, mamba_dims
    from repro_torch.utils import tree_leaves, tree_map

    b, s = JAMBA_TRAIN_B, JAMBA_TRAIN_S
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), lp)
    leaves = tree_leaves(p)
    n_params = sum(t.numel() for t in leaves)
    g = torch.Generator("cuda").manual_seed(6)
    x = torch.randn(b, s, cfg.d_model, generator=g, device="cuda").to(torch.bfloat16)
    dy = torch.randn(b, s, cfg.d_model, generator=g, device="cuda").to(torch.bfloat16)
    x.requires_grad_(True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, _ = apply_mamba(p, x, cfg)
        grads = torch.autograd.grad(y, leaves + [x], dy)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if not all(torch.isfinite(t).all() for t in grads):
            raise AssertionError("[jamba] a Mamba layer grad is not finite")
        del y, grads
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    di, ds, _ = mamba_dims(cfg)
    prod = jamba_layer_params(cfg)["mamba_prod"]
    bf16, f32 = 6.0 * b * s * prod, 3 * 8.0 * b * s * di * ds
    nbytes = 8.0 * n_params + 3 * 2.0 * b * s * cfg.d_model
    bound_ms, bound_by = mixed_bound(bf16, f32, nbytes)
    out["mamba_layer_train"] = {"batch": b, "seq_len": s, "params": n_params, "ms": ms,
                                "bound_ms": bound_ms, "bound_by": bound_by,
                                "peak_memory_gb_above_params": peak_gb}
    log(f"[jamba] one full-width Mamba layer ({n_params:,} f32 params) forward and backward, "
        f"B={b} S={s}, bf16 x: {', '.join(f'{t:.1f}' for t in ms)} ms (the first loads kernels); "
        f"bound {bound_ms:.3f} ms by {bound_by} ({bf16 / 1e12:.2f} TFLOP of products at the bf16 "
        f"peak, {f32 / 1e12:.3f} TFLOP of scan forward and backward at the FP32 peak); "
        f"{min(ms[1:]) / bound_ms:.1f}x the bound; peak memory {peak_gb:.2f} GB above the params "
        f"and inputs (torch.cuda.max_memory_allocated) [{card}]")


def reduced_launchers(torch, arch, tag, b, s, steps, ckpt_every, out, card) -> None:
    """``serve --arch <arch> --reduced`` once, and ``train`` at the reduced
    config twice over one checkpoint directory (``steps`` = (first, second),
    a checkpoint every ``ckpt_every``, B=``b``, S=``s``), the second
    resuming; every loss printed finite, and the first step's loss held to
    the CPU's: the launcher's params are drawn on the card from seed 0, so
    the same draw here, copied to the CPU, gives the CPU's loss on the
    launcher's first batch (bf16 compute: LM_BF16_TOL, the print's 4
    decimals on top)."""
    import argparse
    import math
    import tempfile

    from repro_torch.config import reduced_config
    from repro_torch.data import host_slice
    from repro_torch.launch.train import make_iterator
    from repro_torch.models import build_model
    from repro_torch.utils import tree_map

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = out["launchers"] = {}
    args = ["--batch", str(b), "--seq-len", str(s)]
    with tempfile.TemporaryDirectory() as ckpt:
        for name, cmd in (
                ("serve", ["repro_torch.launch.serve", "--arch", arch, "--reduced"]),
                ("train", ["repro_torch.launch.train", "--arch", arch, "--steps",
                           str(steps[0]), "--ckpt-every", str(ckpt_every),
                           "--ckpt-dir", ckpt, *args]),
                ("train_resumed", ["repro_torch.launch.train", "--arch", arch, "--steps",
                                   str(steps[1]), "--ckpt-every",
                                   str(ckpt_every), "--ckpt-dir", ckpt, *args])):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", *cmd], capture_output=True, text=True,
                                  timeout=300, env=env, cwd=ROOT)
            wall = time.perf_counter() - t0
            prefix = "[serve]" if name == "serve" else "[train]"
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(prefix)]
            done = "sample continuation" if name == "serve" else "[train] done"
            losses = [float(x) for x in re.findall(r"loss=(\S+)", proc.stdout)]
            if (proc.returncode != 0 or done not in proc.stdout
                    or not all(math.isfinite(x) for x in losses)):
                raise AssertionError(f"[{tag}] {' '.join(cmd)} (rc {proc.returncode}): "
                                     f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
            runs[name] = {"rc": proc.returncode, "wall_s": wall, "lines": lines, "losses": losses}
            for ln in lines:
                log(f"[{tag}] launcher: {ln} [{card}]")
            log(f"[{tag}] launcher {' '.join(cmd[:3])} ({name}): rc 0 in {wall:.1f} s [{card}]")
    resumed = f"[train] resumed from step {steps[0]}"
    if resumed not in "\n".join(runs["train_resumed"]["lines"]) or \
            "resumed" in "\n".join(runs["train"]["lines"]):
        raise AssertionError(f"[{tag}] the second train run did not resume from step "
                             f"{steps[0]}: {runs['train_resumed']['lines']}")
    cfg = reduced_config(arch)
    api = build_model(cfg)
    params = tree_map(lambda t: t.cpu(), api.init(torch.Generator("cuda").manual_seed(0),
                                                  device="cuda"))
    it, to_batch = make_iterator(cfg, argparse.Namespace(batch=b, seq_len=s))
    with torch.no_grad():
        want, _ = api.loss(params, host_slice(to_batch(next(it))), loss_chunk=min(2048, s))
    got = runs["train"]["losses"][0]
    if abs(got - float(want)) > LM_BF16_TOL + 5e-5:
        raise AssertionError(f"[{tag}] the launcher's first loss {got} on the card, the CPU's "
                             f"{float(want):.6f}")
    out["launcher_first_loss"] = {"card": got, "cpu": float(want)}
    log(f"[{tag}] the launcher's first step on the card: loss {got:.4f}; the CPU on the same "
        f"params and batch {float(want):.6f} (bar {LM_BF16_TOL}, bf16 compute); every printed "
        f"loss finite; the second run {resumed.split('] ')[1]} [{card}]")


def jamba_launchers(torch, out, card) -> None:
    """The launchers at jamba-v0.1-52b's reduced config (``reduced_launchers``)."""
    reduced_launchers(torch, JAMBA_ARCH, "jamba", JAMBA_LAUNCH_B, JAMBA_LAUNCH_S,
                      JAMBA_LAUNCH_STEPS, JAMBA_CKPT_EVERY, out, card)


def drive_jamba(torch, results, card) -> None:
    """Jamba at full width on the card (``[jamba]`` lines), last: the reduced
    config card against CPU; jamba-v0.1-52b cut to JAMBA_PERIODS period of 4
    (8 of 32 layers, every layer kind): each position kind card against
    CPU, decode against prefill, served at B=8, S=2048 eager and captured;
    one full-width Mamba layer trained forward and backward; the launchers
    at the reduced config.  The reference's Jamba reaches no Pallas kernel
    (its scan is a ``lax.scan``), so the code predicts 0 launches of K1-K4
    over the phase, and no library attention (both counted)."""
    import gc

    import torch.nn.functional as F

    from repro_torch.config import get_config
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.utils import tree_leaves, tree_map

    out = results["jamba"] = {"arch": JAMBA_ARCH, "periods": JAMBA_PERIODS}
    full = get_config(JAMBA_ARCH)
    cfg = full.with_overrides(num_layers=8 * JAMBA_PERIODS)
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[jamba] at the phase's start {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved on the card [{card}]")
    sdpa = F.scaled_dot_product_attention
    sdpa_calls = [0]

    def counted_sdpa(*args, **kw):
        sdpa_calls[0] += 1
        return sdpa(*args, **kw)

    F.scaled_dot_product_attention = counted_sdpa
    reset_launch_counts()
    try:
        jamba_check_reduced(torch, out, card)
        t0 = time.perf_counter()
        params = build_model(cfg).init(torch.Generator("cuda").manual_seed(0), device="cuda")
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in tree_leaves(params))
        out.update({"layers": cfg.num_layers, "params": n_params,
                    "init_s": time.perf_counter() - t0, "card_tree": card_tree(cfg, params)})
        log(f"[jamba] {cfg.name} at full width, cut to {JAMBA_PERIODS} period of "
            f"{full.num_layers // 8} ({cfg.num_layers} of {full.num_layers} layers: "
            f"{jamba_kinds(cfg)}): {n_params:,} params in f32 ({4 * n_params / 1e9:.2f} GB) drawn "
            f"on the card from seed 0 in {out['init_s']:.2f} s; compute {cfg.compute_dtype}, KV "
            f"cache and conv state bf16, SSM state f32 [{card}]")
        jamba_check_kinds(torch, cfg, params, out, card)
        jamba_decode_vs_prefill(torch, cfg, params, out, card)
        jamba_serve(torch, cfg, params, out.setdefault("serve", {}), card)
        mamba0 = tree_map(lambda t: t[0].clone(), params["positions"][0]["mixer"])
        del params
        gc.collect()
        torch.cuda.empty_cache()
        jamba_train_mamba_layer(torch, cfg, mamba0, out, card)
        del mamba0
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        F.scaled_dot_product_attention = sdpa
    counts = launch_counts()
    out["port_kernel_launches"], out["sdpa_calls"] = dict(counts), sdpa_calls[0]
    if any(counts.values()) or sdpa_calls[0]:
        raise AssertionError(f"[jamba] the Jamba path launched port kernels {dict(counts)} or "
                             f"library attention ({sdpa_calls[0]} SDPA calls); the code predicts "
                             f"none")
    log(f"[jamba] port kernel launches over the phase {dict(counts)} (K1-K4), predicted 0 each: "
        f"held; scaled_dot_product_attention calls 0 [{card}]")
    jamba_launchers(torch, out, card)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[jamba] phase {out['phase_s']:.1f} s [{card}]")


def whisper_layer_params(cfg) -> dict:
    """Params of each part of a Whisper layer at full width: an attention
    block (q, k, v, o and their biases), its K/V projections alone (what
    the decode's cross step does not run), the MLP with its biases, one
    LayerNorm; and the product weights a token meets in attention's q and o
    (``qo``), its k and v (``kv``) and the MLP (``mlp_prod``)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    return {"attn": 2 * d * q + 2 * d * kv + q + kv + d, "cross_kv": 2 * d * kv + kv,
            "mlp": 2 * d * cfg.d_ff + cfg.d_ff + d, "norm": 2 * d,
            "qo": 2 * d * q, "kv": 2 * d * kv, "mlp_prod": 2 * d * cfg.d_ff}


def whisper_params(cfg) -> int:
    """Every param of the model: both stacks, the tied table, ``dec_pos``
    and the two final norms (1,577,530,880 for whisper-large-v3)."""
    from repro_torch.models.whisper import MAX_DECODER_LEN

    p = whisper_layer_params(cfg)
    return (cfg.encoder_layers * (p["attn"] + p["mlp"] + 2 * p["norm"])
            + cfg.num_layers * (2 * p["attn"] + p["mlp"] + 3 * p["norm"])
            + (cfg.vocab_size + MAX_DECODER_LEN) * cfg.d_model + 2 * p["norm"])


def whisper_forward_ops(cfg, b: int, s: int, t: int, unembed_rows: int) -> tuple[float, float]:
    """(bf16 FLOP, f32 FLOP) of one forward of b x s decoder tokens over t
    frames: bf16 the products (the encoder's over b*t frames; the decoder's
    self q/k/v/o, cross q/o and MLP over b*s tokens; the cross K/V over the
    memory's b*t rows; the unembed of ``unembed_rows`` rows); f32 (TF32 off:
    the FP32 cores) attention's QK^T and PV over the visible (query, key)
    pairs: the encoder's t x t, the decoder's causal s(s+1)/2 and cross
    s x t."""
    p, hd, h = whisper_layer_params(cfg), cfg.resolved_head_dim(), cfg.num_heads
    le, ld = cfg.encoder_layers, cfg.num_layers
    bf16 = (2.0 * b * t * le * (p["qo"] + p["kv"] + p["mlp_prod"])
            + 2.0 * b * s * ld * (2 * p["qo"] + p["kv"] + p["mlp_prod"])
            + 2.0 * b * t * ld * p["kv"] + 2.0 * unembed_rows * cfg.d_model * cfg.vocab_size)
    f32 = 4.0 * hd * h * b * (le * t * t + ld * s * (s + 1) / 2 + ld * s * t)
    return bf16, f32


def whisper_prefill_bound(cfg, b: int, s: int, t: int) -> tuple[float, float, float]:
    """(bf16 FLOP, f32 FLOP, bytes) of one prefill of b x s tokens over t
    frames with the last position's logits (``whisper_forward_ops``).
    Bytes: the f32 params read once (of ``dec_pos`` only the s rows), the
    bf16 frames read, the bf16 cache written (self K/V of s positions,
    cross K/V of t frames) and the bf16 logits."""
    from repro_torch.models.whisper import MAX_DECODER_LEN

    bf16, f32 = whisper_forward_ops(cfg, b, s, t, b)
    kvw, d = cfg.num_kv_heads * cfg.resolved_head_dim(), cfg.d_model
    nbytes = (4.0 * (whisper_params(cfg) - (MAX_DECODER_LEN - s) * d) + 2.0 * b * t * d
              + 2.0 * 2 * cfg.num_layers * b * (s + t) * kvw + 2.0 * b * cfg.vocab_size)
    return bf16, f32, nbytes


def whisper_decode_bound(cfg, b: int, past: int, t: int) -> tuple[float, float, float]:
    """(bf16 FLOP, f32 FLOP, bytes) of one decode token after ``past``
    cached positions over t frames: bf16 the decoder's self q/k/v/o, cross
    q/o and MLP products of b tokens and the unembed; f32 attention over
    past + 1 self positions and the t frames.  Bytes: the f32 params the
    step reads once (the decoder's without the cross K/V projections it
    does not run, the table, one ``dec_pos`` row, the final norm), the bf16
    self K/V read up to the new position (its row written), the bf16 cross
    K/V read whole and the bf16 logits written."""
    p, hd, h, d = whisper_layer_params(cfg), cfg.resolved_head_dim(), cfg.num_heads, cfg.d_model
    ld, v, kvw = cfg.num_layers, cfg.vocab_size, cfg.num_kv_heads * hd
    bf16 = 2.0 * b * ld * (2 * p["qo"] + p["kv"] + p["mlp_prod"]) + 2.0 * b * d * v
    f32 = 4.0 * hd * h * b * ld * (past + 1 + t)
    weights = ld * (2 * p["attn"] + p["mlp"] + 3 * p["norm"] - p["cross_kv"]) + v * d + d \
        + p["norm"]
    nbytes = 4.0 * weights + 2.0 * 2 * ld * b * kvw * (past + 1 + t) + 2.0 * b * v
    return bf16, f32, nbytes


def whisper_train_bound(cfg, b: int, s: int, t: int, n_params: int) -> tuple[float, float, float]:
    """(bf16 FLOP, f32 FLOP, bytes) of one train step: 3 x the forward's
    products and attention (``whisper_forward_ops`` with the unembed at
    every one of the b*s positions: the forward, and the backward's two);
    the f32 params and AdamW's two moments read and written once (24 bytes
    a param, as ``lm_train_bound``), the tokens and labels and the f32
    frames read once.  Remat's recompute is the implementation's choice
    and is not counted."""
    bf16, f32 = whisper_forward_ops(cfg, b, s, t, b * s)
    return 3 * bf16, 3 * f32, 24.0 * n_params + 2 * 8.0 * b * s + 4.0 * b * t * cfg.d_model


def whisper_check_reduced(torch, out, card) -> None:
    """The reduced config whole (2 + 2 layers, d_model 64, 12 frames), card
    against CPU: in f32 (TF32 off) the prefill's logits and its cache
    (``k``, ``v``, ``ck``, ``cv``), one decode step from each side's
    stitched cache (logits and every cache leaf), ``train_loss`` and every
    grad leaf at the [lm-train] f32 bars; in bf16 the prefill's logits no
    farther from the CPU's f32 ones than the CPU's own bf16 logits are,
    plus the bf16 bar."""
    from repro_torch.config import reduced_config
    from repro_torch.data import LMDataConfig, make_lm_batch
    from repro_torch.models import build_model
    from repro_torch.utils import tree_map

    cfg = reduced_config(WHISPER_ARCH)
    b, s = 2, 12
    cpu_params = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    params = tree_map(lambda t: t.cuda(), cpu_params)
    batch = make_lm_batch(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b), 0)
    batch["frames"] = torch.randn(b, cfg.encoder_seq_len, cfg.d_model,
                                  generator=torch.Generator().manual_seed(1))
    card_batch = {k: v.cuda() for k, v in batch.items()}
    prompt = ("tokens", "frames")
    pos = torch.tensor(s, dtype=torch.int32)
    f32_logits = None
    for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        api = build_model(cfg.with_overrides(compute_dtype=dtype))
        want, wc = api.prefill(cpu_params, {k: batch[k] for k in prompt})
        got, gc = api.prefill(params, {k: card_batch[k] for k in prompt})
        err = float((got.float().cpu() - want.float()).abs().max())
        if tag == "bf16":
            mine = float((got.float().cpu() - f32_logits).abs().max())
            theirs = float((want.float() - f32_logits).abs().max())
            if mine > theirs + LM_BF16_TOL:
                raise AssertionError(f"[whisper] reduced bf16 logits: the card {mine:.4g} from "
                                     f"the CPU's f32, the CPU's bf16 {theirs:.4g}")
            out["reduced_bf16"] = {"logits_max_abs_err": err, "card_from_cpu_f32": mine,
                                   "cpu_bf16_from_cpu_f32": theirs}
            log(f"[whisper] card against CPU, {cfg.name} (d_model {cfg.d_model}) bf16, B={b} "
                f"S={s}: prefill logits max abs err {err:.3g}; the card's {mine:.3g} and the CPU's "
                f"own {theirs:.3g} from the CPU's f32 logits (held: the card no farther, "
                f"+{LM_BF16_TOL}) [{card}]")
            continue
        f32_logits = want.float()
        torch.testing.assert_close(got.cpu(), want, rtol=LM_F32_TOL, atol=LM_F32_TOL)
        cache_err = {}
        for name in wc:
            cache_err[name] = float((gc[name].cpu() - wc[name]).abs().max())
            torch.testing.assert_close(gc[name].cpu(), wc[name], rtol=LM_F32_TOL, atol=LM_F32_TOL)
        wc, gc = api.stitch(wc, s + 1), api.stitch(gc, s + 1)
        token = batch["tokens"][:, :1]
        wdec, _ = api.decode(cpu_params, token, wc, pos)
        gdec, _ = api.decode(params, token.cuda(), gc, pos.cuda())
        torch.testing.assert_close(gdec.cpu(), wdec, rtol=LM_F32_TOL, atol=LM_F32_TOL)
        for name in wc:
            torch.testing.assert_close(gc[name].cpu(), wc[name], rtol=LM_F32_TOL, atol=LM_F32_TOL)
        want_loss, wgrads = lm_value_and_grad(torch, api, cpu_params, batch, loss_chunk=s)
        got_loss, ggrads = lm_value_and_grad(torch, api, params, card_batch, loss_chunk=s)
        torch.testing.assert_close(got_loss.cpu(), want_loss, rtol=LM_F32_TOL, atol=LM_F32_TOL)
        errs = [rel_fro(torch, g.cpu(), w) for g, w in zip(ggrads, wgrads)]
        if max(errs) > LM_TRAIN_F32_GRAD_REL:
            raise AssertionError(f"[whisper] reduced f32 grads card vs CPU: {errs}")
        out["reduced_f32"] = {
            "logits_max_abs_err": err, "cache_max_abs_err": cache_err,
            "decode_max_abs_err": float((gdec.cpu() - wdec).abs().max()),
            "loss": float(want_loss), "loss_abs_err": abs(float(got_loss) - float(want_loss)),
            "grad_rel_fro_max": max(errs)}
        r = out["reduced_f32"]
        log(f"[whisper] card against CPU, {cfg.name} ({cfg.encoder_layers} + {cfg.num_layers} "
            f"layers, {cfg.encoder_seq_len} frames) f32, B={b} S={s}: prefill logits max abs err "
            f"{err:.3g}, cache " + ", ".join(f"{n} {e:.3g}" for n, e in cache_err.items())
            + f"; one decode step from each side's stitched cache {r['decode_max_abs_err']:.3g} "
            f"(rtol = atol = {LM_F32_TOL}); train_loss {r['loss']:.6f}, abs err "
            f"{r['loss_abs_err']:.3g}, {len(errs)} grad leaves, relative Frobenius error max "
            f"{max(errs):.3g} (bar {LM_TRAIN_F32_GRAD_REL}) [{card}]")


def whisper_check_kinds(torch, cfg, params, out, card) -> None:
    """Each layer kind of the full-width model on its own, card against CPU
    at B=1, S=32 over the 1,500 frames in f32 (TF32 off) and bf16, on equal
    inputs: encoder layer 0 on the frames; decoder layer 0 on a prompt
    against the CPU encoder layer's output as the memory (its output, self
    K/V and cross K/V); that layer's decode step for one more token against
    caches built from the CPU's K/V (its output and the self K/V row it
    writes; ``ck``/``cv`` bit-unchanged).  Bars: LM_F32_TOL, LM_BF16_TOL."""
    from repro_torch.models import whisper as whisper_m
    from repro_torch.utils import tree_map

    parts = {"enc": tree_map(lambda t: t[0], params["enc_layers"]),
             "dec": tree_map(lambda t: t[0], params["dec_layers"])}
    on_cpu = tree_map(lambda t: t.cpu(), parts)
    rows = out["kinds"] = {}
    b, s, t = LM_CPU_B, LM_CPU_S, cfg.encoder_seq_len
    for tag, dtype, bf16 in (("f32", torch.float32, False), ("bf16", torch.bfloat16, True)):
        g = torch.Generator().manual_seed(5)
        frames = torch.randn(b, t, cfg.d_model, generator=g).to(dtype)
        x = torch.randn(b, s + 1, cfg.d_model, generator=g).to(dtype)
        tol = (dict(rtol=LM_BF16_TOL, atol=LM_BF16_TOL) if bf16 else
               dict(rtol=LM_F32_TOL, atol=LM_F32_TOL))
        t0 = time.perf_counter()
        errs = {}

        def held(name, got, want):
            errs[name] = float((got.float().cpu() - want.float()).abs().max())
            torch.testing.assert_close(got.float().cpu(), want.float(), **tol)

        memory = whisper_m._enc_layer(on_cpu["enc"], frames, cfg)
        held("enc_y", whisper_m._enc_layer(parts["enc"], frames.cuda(), cfg), memory)
        prompt = x[:, :s]
        wy, (wk, wv), (wck, wcv) = whisper_m._dec_layer(on_cpu["dec"], prompt, memory, cfg,
                                                        LM_KV_CHUNK, 1)
        y, (k, v), (ck, cv) = whisper_m._dec_layer(parts["dec"], prompt.cuda(), memory.cuda(), cfg,
                                                   LM_KV_CHUNK, 1)
        held("dec_y", y, wy)
        held("dec_kv", torch.cat([k, v]), torch.cat([wk, wv]))
        held("dec_cross_kv", torch.cat([ck, cv]), torch.cat([wck, wcv]))
        pad = torch.zeros_like(wk[:, :1])
        want_cache = {"k": torch.cat([wk, pad], 1), "v": torch.cat([wv, pad], 1), "ck": wck,
                      "cv": wcv}
        cache = {n: c.cuda() for n, c in want_cache.items()}
        cross = {n: cache[n].clone() for n in ("ck", "cv")}
        y1 = whisper_m._decode_layer(parts["dec"], cache, x[:, s:].cuda(),
                                     torch.tensor(s, device="cuda"), cfg)
        wy1 = whisper_m._decode_layer(on_cpu["dec"], want_cache, x[:, s:], torch.tensor(s), cfg)
        held("step_y", y1, wy1)
        held("step_kv_row", torch.cat([cache["k"][:, s], cache["v"][:, s]]),
             torch.cat([want_cache["k"][:, s], want_cache["v"][:, s]]))
        if not all(torch.equal(cache[n], cross[n]) for n in cross):
            raise AssertionError("[whisper] the decode step wrote the cross-KV")
        rows[tag] = dict(errs, s=time.perf_counter() - t0)
        log(f"[whisper] card against CPU, each layer kind of {cfg.name} at full width on its "
            f"own, {tag}, B={b} S={s} over {t} frames: " + ", ".join(
                f"{n} {e:.3g}" for n, e in errs.items())
            + f" (max abs err, rtol = atol = {tol['rtol']}); the decode step left ck/cv "
            f"bit-unchanged ({rows[tag]['s']:.1f} s) [{card}]")


def whisper_decode_vs_prefill(torch, cfg, params, out, card) -> None:
    """Decode against prefill with the whole full-width model, f32 compute,
    B=2, S=64 over 1,500 frames: the prefill's cache of S tokens, stitched,
    decodes token S+1 to the last position of a prefill of S+1, at the
    reference's bar; greedy tokens equal away from ties."""
    from repro_torch.models import build_model

    c = cfg.with_overrides(compute_dtype="float32")
    api = build_model(c)
    b, s = LM_CONSISTENCY_B, LM_CONSISTENCY_S
    g = torch.Generator("cuda").manual_seed(2)
    toks = torch.randint(0, c.vocab_size, (b, s + 1), dtype=torch.int32, device="cuda",
                         generator=g)
    frames = torch.randn(b, c.encoder_seq_len, c.d_model, generator=g, device="cuda")
    full, _ = api.prefill(params, {"tokens": toks, "frames": frames})
    _, pre = api.prefill(params, {"tokens": toks[:, :-1], "frames": frames})
    dec, _ = api.decode(params, toks[:, -1:], api.stitch(pre, s + 1),
                        torch.tensor(s, dtype=torch.int32, device="cuda"))
    want, got = full[:, -1].float(), dec[:, -1].float()
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=WHISPER_CONSISTENCY_TOL,
                               atol=WHISPER_CONSISTENCY_TOL)
    decided = greedy_decided(torch, want, 23)
    if not torch.equal(got.argmax(-1)[decided], want.argmax(-1)[decided]):
        raise AssertionError(f"[whisper] decode against prefill: greedy {got.argmax(-1).tolist()} "
                             f"against {want.argmax(-1).tolist()}")
    out["decode_vs_prefill"] = {"max_abs_err": err, "tokens": want.argmax(-1).tolist(),
                                "ties": int((~decided).sum())}
    log(f"[whisper] decode against prefill, {c.name} at full width ({c.encoder_layers} + "
        f"{c.num_layers} layers) f32 (TF32 off), B={b} over {c.encoder_seq_len} frames: the "
        f"stitched cache of a {s}-token prefill decodes token {s + 1}: logits max abs err "
        f"{err:.3g} against a {s + 1}-token prefill's last position (bar "
        f"{WHISPER_CONSISTENCY_TOL}, the reference's); greedy tokens {want.argmax(-1).tolist()} "
        f"equal ({int((~decided).sum())} ties) [{card}]")


def whisper_serve(torch, cfg, params, out, card) -> None:
    """The full model served: prefill at WHISPER_SERVE_B x WHISPER_SERVE_S
    over 1,500 bf16 frames beside its bound, one prefill profiled for the
    host's launch calls, the device's idle share and its largest kernels;
    then WHISPER_DECODE greedy tokens eager and captured (twice), each from
    its own stitched cache: tokens identical, one capture; ms a token beside
    the bound, launch calls and device kernels a token, the captured
    decode's idle share; peak memory."""
    from repro_torch.models import build_model
    from repro_torch.serving import GreedyDecoder, build_prefill_step
    from repro_torch.utils import tree_map

    api = build_model(cfg)
    b, s, n, t = WHISPER_SERVE_B, WHISPER_SERVE_S, WHISPER_DECODE, cfg.encoder_seq_len
    g = torch.Generator("cuda").manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), dtype=torch.int32, device="cuda",
                                     generator=g),
             "frames": torch.randn(b, t, cfg.d_model, generator=g,
                                   device="cuda").to(torch.bfloat16)}
    step = build_prefill_step(api, kv_chunk=LM_KV_CHUNK)
    torch.cuda.reset_peak_memory_stats()
    prefill_ms = []
    for call in range(2):       # the first call also loads cuBLAS's kernels
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, pre = step(params, batch)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    if not torch.isfinite(logits).all() or not all(torch.isfinite(c).all() for c in pre.values()):
        raise AssertionError(f"[whisper] {cfg.name} prefill: non-finite logits or cache")
    del logits, pre
    held = {}
    prof = device_busy_over(torch, lambda: held.update(out=step(params, batch)), names=True)
    logits, pre = held.pop("out")
    prof.pop("names")
    top = list(prof["device_ms_by_name"].items())[:MOE_TOP_KERNELS]
    first = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
    runs, decoders = {}, {"eager": GreedyDecoder(api, jit=False), "captured": GreedyDecoder(api)}
    for name, decoder in decoders.items():
        for call in range(2 if name == "captured" else 1):   # captured: capture, then replays
            cache = api.stitch(tree_map(torch.clone, pre), s + n)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tokens, _ = decoder(params, cache, first, s, n)
            torch.cuda.synchronize()
            runs.setdefault(name, []).append(((time.perf_counter() - t0) * 1e3, tokens,
                                              decoder.logits))
            del cache
    want_tokens = runs["eager"][0][1]
    if not all(torch.equal(tk, want_tokens) for _, tk, _ in runs["captured"]):
        raise AssertionError(f"[whisper] {cfg.name}: captured greedy tokens differ from the "
                             f"eager loop's")
    if decoders["captured"].captures != 1:
        raise AssertionError(f"[whisper] {decoders['captured'].captures} decode captures, "
                             f"expected 1")
    logits_equal = all(torch.equal(lg, runs["eager"][0][2]) for _, _, lg in runs["captured"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    pf = whisper_prefill_bound(cfg, b, s, t)
    pf_bound, pf_by = mixed_bound(*pf)
    dc = whisper_decode_bound(cfg, b, s + n // 2, t)
    dc_bound, dc_by = mixed_bound(*dc)
    out.update({
        "prefill_ms": prefill_ms[1], "prefill_first_ms": prefill_ms[0],
        "prefill_bound_ms": pf_bound, "prefill_bound_by": pf_by, "prefill_bf16_flops": pf[0],
        "prefill_f32_flops": pf[1], "prefill_bytes": pf[2],
        "profiled_prefill": dict(prof, device_ms_by_name=dict(top)),
        "decode_bound_ms_per_token": dc_bound, "decode_bound_by": dc_by,
        "decode_bytes_per_token": dc[2], "peak_memory_gb": peak_gb,
        "captures": decoders["captured"].captures, "replays": decoders["captured"].replays,
        "last_logits_bit_equal": logits_equal, "tokens_row0": want_tokens[0, :16].tolist()})
    log(f"[whisper] {cfg.name} prefill B={b} S={s} over {t} bf16 frames (kv_chunk {LM_KV_CHUNK}, "
        f"eager): {prefill_ms[1]:.1f} ms (first call {prefill_ms[0]:.1f} ms); bound "
        f"{pf_bound:.2f} ms by {pf_by}, the largest of: {pf[0] / 1e12:.2f} TFLOP of products at "
        f"the bf16 dense peak {pf[0] / PEAK_BF16_FLOPS * 1e3:.2f} ms (the encoder, the decoder, "
        f"the cross K/V), {pf[1] / 1e12:.3f} TFLOP of f32 attention (encoder, causal self, "
        f"cross) at the FP32 peak {pf[1] / PEAK_F32_FLOPS * 1e3:.2f} ms, {pf[2] / 1e9:.2f} GB at "
        f"HBM bandwidth {pf[2] / PEAK_BYTES * 1e3:.2f} ms; {prefill_ms[1] / pf_bound:.2f}x the "
        f"bound [{card}]")
    log(f"[whisper] {cfg.name} one profiled prefill: {prof['host_calls']:,} launch calls on the "
        f"host, {prof['device_ops']:,} device kernels/copies, {prof['wall_ms']:.1f} ms, the device "
        f"busy {prof['device_busy_ms']:.1f} ms (idle share {prof['idle_share']:.3f}); the largest "
        f"{len(top)} kernel names by device time: "
        + "; ".join(f"{name[:64]} {ms:.1f} ms" for name, ms in top) + f" [{card}]")
    for name in ("eager", "captured"):
        ms = runs[name][-1][0]
        out[name] = {"decode_ms_per_token": ms / n, "tokens_per_s": b * n / (ms / 1e3)}
        capture = ""
        if name == "captured":
            out[name]["capture_call_ms_per_token"] = runs[name][0][0] / n
            capture = f" (the call that captured: {runs[name][0][0] / n:.3f} ms/token)"
        log(f"[whisper] {cfg.name} decode {name} B={b}, {n} tokens after the prefill: "
            f"{ms / n:.3f} ms/token, {b * n / (ms / 1e3):,.0f} tokens/s{capture}; bound "
            f"{dc_bound:.3f} ms/token by {dc_by} ({dc[2] / 1e9:.2f} GB a token: the decoder's f32 "
            f"weights, the self-KV up to the position and the cross-KV of {t} frames) [{card}]")
    cache = api.stitch(tree_map(torch.clone, pre), s + n)     # the captured graph's signature
    for name, decoder in decoders.items():
        lpd = host_launches(torch, lambda: decoder(params, cache, first, s, WHISPER_PROFILE_TOKENS))
        out[name]["host_calls_per_token"] = lpd["host_total"] / WHISPER_PROFILE_TOKENS
        out[name]["device_ops_per_token"] = lpd["device_ops"] / WHISPER_PROFILE_TOKENS
        log(f"[whisper] {cfg.name} decode {name}: "
            f"{lpd['host_total'] / WHISPER_PROFILE_TOKENS:.1f} launch calls per token on the host, "
            f"{lpd['device_ops'] / WHISPER_PROFILE_TOKENS:.1f} device kernels/copies per token "
            f"(one torch.profiler pass over {WHISPER_PROFILE_TOKENS} tokens, the cache's copies "
            f"in and out included) [{card}]")
    busy = device_busy_over(
        torch, lambda: decoders["captured"](params, cache, first, s, WHISPER_PROFILE_TOKENS))
    if decoders["captured"].captures != 1:
        raise AssertionError(f"[whisper] the profiled decodes captured again "
                             f"({decoders['captured'].captures} captures)")
    out["profiled_captured_decode"] = busy
    log(f"[whisper] {cfg.name} captured tokens equal the eager loop's ({n} tokens x {b} rows, "
        f"both captured calls; last logits bit-equal: {logits_equal}); "
        f"{decoders['captured'].captures} capture, {decoders['captured'].replays} replays; a "
        f"profiled captured decode of {WHISPER_PROFILE_TOKENS} tokens: the device busy "
        f"{busy['device_busy_ms']:.1f} of {busy['wall_ms']:.1f} ms (idle share "
        f"{busy['idle_share']:.3f}); peak memory serving {peak_gb:.2f} GB "
        f"(torch.cuda.max_memory_allocated) [{card}]")


def whisper_train(torch, cfg, params, out, card) -> None:
    """The full model trained: WHISPER_TRAIN_STEPS AdamW steps at
    WHISPER_TRAIN_B x WHISPER_TRAIN_S from the launcher's iterator (tokens
    from ``LMIterator``, f32 frames drawn per batch index), remat per
    layer: ms a step beside the bound, xent per step (all finite), peak
    memory."""
    import argparse
    import math

    from repro_torch.config import TrainConfig
    from repro_torch.launch.train import make_iterator
    from repro_torch.models import build_model
    from repro_torch.training import build_train_step, init_train_state
    from repro_torch.utils import tree_leaves

    b, s, t = WHISPER_TRAIN_B, WHISPER_TRAIN_S, cfg.encoder_seq_len
    api = build_model(cfg)
    tc = TrainConfig(learning_rate=1e-4, total_steps=WHISPER_TRAIN_STEPS, loss_chunk=min(2048, s))
    state = init_train_state(params, tc)
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    step = build_train_step(api, tc)
    it, to_batch = make_iterator(cfg, argparse.Namespace(batch=b, seq_len=s))
    t0 = time.perf_counter()
    host_batches = [to_batch(next(it)) for _ in range(WHISPER_TRAIN_STEPS)]
    data_ms = (time.perf_counter() - t0) * 1e3 / len(host_batches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, xents = [], []
    for hb in host_batches:
        batch = {k: v.to("cuda") for k, v in hb.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        xents.append(float(metrics["xent"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in xents):
        raise AssertionError(f"[whisper] a training xent is not finite: {xents}")
    if peak_gb > 80.0:
        raise AssertionError(f"[whisper] training peaked at {peak_gb:.2f} GB, past 80 GB")
    steady = ms[1:]
    bf16, f32, nbytes = whisper_train_bound(cfg, b, s, t, n_params)
    bound_ms, bound_by = mixed_bound(bf16, f32, nbytes)
    mean_ms = statistics.mean(steady)
    out["train"] = {"params": n_params, "batch": b, "seq_len": s, "steps": WHISPER_TRAIN_STEPS,
                    "ms": ms, "xent": xents, "ms_per_step_mean": mean_ms,
                    "tokens_per_s": b * s / (mean_ms / 1e3), "data_ms_per_batch": data_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "bf16_flops": bf16,
                    "f32_flops": f32, "bytes": nbytes, "peak_memory_gb": peak_gb}
    log(f"[whisper] {cfg.name} trained at full width and depth ({n_params:,} params, f32 master "
        f"weights, bf16 compute, remat={tc.remat}, AdamW f32), B={b} S={s} over {t} frames: "
        f"{WHISPER_TRAIN_STEPS} steps, xent {', '.join(f'{x:.4f}' for x in xents)} (all finite); "
        f"first step {ms[0]:.1f} ms, steps 2-{WHISPER_TRAIN_STEPS} "
        f"{', '.join(f'{x:.1f}' for x in steady)} ms (mean {mean_ms:.1f}), "
        f"{b * s / (mean_ms / 1e3):,.0f} tokens/s; the host's batch {data_ms:.1f} ms (outside "
        f"the timed step) [{card}]")
    log(f"[whisper] train bound {bound_ms:.2f} ms a step by {bound_by} ({bf16 / 1e12:.2f} TFLOP "
        f"of products at the bf16 peak {bf16 / PEAK_BF16_FLOPS * 1e3:.2f} ms, {f32 / 1e12:.2f} "
        f"TFLOP of f32 attention at the FP32 peak {f32 / PEAK_F32_FLOPS * 1e3:.2f} ms, "
        f"{nbytes / 1e9:.1f} GB of state at HBM bandwidth {nbytes / PEAK_BYTES * 1e3:.2f} ms); "
        f"{mean_ms / bound_ms:.1f}x the bound; peak memory training {peak_gb:.2f} GB "
        f"(torch.cuda.max_memory_allocated) [{card}]")


def drive_whisper(torch, results, card) -> None:
    """Whisper at full width and depth on the card (``[whisper]`` lines),
    last: the reduced config card against CPU; whisper-large-v3 uncut, each
    layer kind card against CPU, decode against prefill, served at B=8,
    S=2048 over 1,500 frames eager and captured, trained 6 AdamW steps at
    B=4, S=2048; the launchers at the reduced config.  The reference's
    Whisper attends through jnp (``blocked_attention``, ``decode_attention``),
    no Pallas kernel, so the code predicts 0 launches of K1-K4 over the
    phase, and no library attention (both counted)."""
    import gc

    import torch.nn.functional as F

    from repro_torch.config import get_config
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.utils import tree_leaves

    out = results["whisper"] = {"arch": WHISPER_ARCH}
    cfg = get_config(WHISPER_ARCH)
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[whisper] at the phase's start {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved on the card [{card}]")
    sdpa = F.scaled_dot_product_attention
    sdpa_calls = [0]

    def counted_sdpa(*args, **kw):
        sdpa_calls[0] += 1
        return sdpa(*args, **kw)

    F.scaled_dot_product_attention = counted_sdpa
    reset_launch_counts()
    try:
        whisper_check_reduced(torch, out, card)
        t0 = time.perf_counter()
        params = build_model(cfg).init(torch.Generator("cuda").manual_seed(0), device="cuda")
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in tree_leaves(params))
        if n_params != whisper_params(cfg):
            raise AssertionError(f"[whisper] {n_params:,} params drawn, the count predicts "
                                 f"{whisper_params(cfg):,}")
        out.update({"params": n_params, "init_s": time.perf_counter() - t0,
                    "card_tree": card_tree(cfg, params)})
        log(f"[whisper] {cfg.name} at full width and depth, no cut ({cfg.encoder_layers} encoder "
            f"+ {cfg.num_layers} decoder layers, d_model {cfg.d_model}, {cfg.encoder_seq_len} "
            f"frames): {n_params:,} params in f32 ({4 * n_params / 1e9:.2f} GB) drawn on the card "
            f"from seed 0 in {out['init_s']:.2f} s; compute {cfg.compute_dtype}, caches bf16 "
            f"[{card}]")
        whisper_check_kinds(torch, cfg, params, out, card)
        whisper_decode_vs_prefill(torch, cfg, params, out, card)
        whisper_serve(torch, cfg, params, out.setdefault("serve", {}), card)
        gc.collect()
        torch.cuda.empty_cache()
        whisper_train(torch, cfg, params, out, card)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        F.scaled_dot_product_attention = sdpa
    counts = launch_counts()
    out["port_kernel_launches"], out["sdpa_calls"] = dict(counts), sdpa_calls[0]
    if any(counts.values()) or sdpa_calls[0]:
        raise AssertionError(f"[whisper] the Whisper path launched port kernels {dict(counts)} or "
                             f"library attention ({sdpa_calls[0]} SDPA calls); the code predicts "
                             f"none")
    log(f"[whisper] port kernel launches over the phase {dict(counts)} (K1-K4), predicted 0 "
        f"each: held; scaled_dot_product_attention calls 0 [{card}]")
    reduced_launchers(torch, WHISPER_ARCH, "whisper", WHISPER_LAUNCH_B, WHISPER_LAUNCH_S,
                      WHISPER_LAUNCH_STEPS, WHISPER_CKPT_EVERY, out, card)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[whisper] phase {out['phase_s']:.1f} s [{card}]")


# where the model phases keep the tree of the params they drew on the card
CARD_TREES = (("lm",), ("moe", "serve"), ("moe", "dbrx"), ("rwkv", "serve"), ("jamba",),
              ("whisper",))
SHARDED_AXES = ("tp", "fsdp", "expert")


def tree_paths(tree, is_leaf=lambda v: False, path: str = "") -> dict:
    """path -> leaf of a tree of dicts and sequences (``is_leaf`` keeps a
    spec tuple whole)."""
    if is_leaf(tree):
        return {path: tree}
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in tree_paths(tree[key], is_leaf, f"{path}/{key}").items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, x in enumerate(tree)
                for k, v in tree_paths(x, is_leaf, f"{path}[{i}]").items()}
    return {path: tree}


def card_tree(cfg, params) -> dict:
    """What the [specs] phase reads of params a model phase drew on the card:
    the config's depth and every leaf's shape and dtype."""
    return {"arch": cfg.name, "num_layers": cfg.num_layers,
            "leaves": {p: (tuple(t.shape), str(t.dtype), t.device.type)
                       for p, t in tree_paths(params).items()}}


def specs_match(what: str, specs, struct, rules, is_spec_leaf) -> dict:
    """Hold a spec tree to a tree of tensors: the same paths, each spec's
    length the tensor's rank, every axis name known to ``rules``."""
    spec_leaves, leaves = tree_paths(specs, is_spec_leaf), tree_paths(struct)
    if spec_leaves.keys() != leaves.keys():
        raise AssertionError(f"[specs] {what}: the spec tree and the tensors differ: "
                             f"{sorted(spec_leaves.keys() ^ leaves.keys())[:6]}")
    for path, t in leaves.items():
        spec = spec_leaves[path]
        if len(spec) != t.ndim:
            raise AssertionError(f"[specs] {what}{path}: spec {spec} for a rank-{t.ndim} tensor")
        rules.spec(spec)     # raises KeyError on an unknown axis name
    return spec_leaves


def drive_specs(torch, results, card) -> None:
    """The sharding specs held to every registered arch at full width and
    depth (``[specs]`` lines), last: param and cache structs on the meta
    device against the spec trees, input structs for every dry-run cell,
    then the specs against the params the model phases drew on the card."""
    from repro_torch.config import get_config, list_archs, shapes_for
    from repro_torch.distributed.sharding import ShardingRules, is_spec_leaf
    from repro_torch.models import build_model
    from repro_torch.models.api import cache_struct, input_specs, param_struct
    from repro_torch.utils import tree_leaves

    out = results["specs"] = {}
    rules = ShardingRules()
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    on_card = {}
    for keys in CARD_TREES:
        rec = results
        for k in keys:
            rec = rec.get(k, {})
        if "card_tree" not in rec:
            raise AssertionError(f"[specs] no params tree kept by the {'/'.join(keys)} phase")
        on_card.setdefault(rec["card_tree"]["arch"], []).append((keys, rec))
    for arch in list_archs():
        t0 = time.perf_counter()
        cfg = get_config(arch)
        api = build_model(cfg)
        params = param_struct(api)
        if not all(t.is_meta for t in tree_leaves(params)):
            raise AssertionError(f"[specs] {arch}: param_struct left the meta device")
        specs = specs_match(arch, api.param_specs(), params, rules, is_spec_leaf)
        n_params = sum(t.numel() for t in tree_leaves(params))
        sharded = sum(1 for spec in specs.values() if set(spec) & set(SHARDED_AXES))
        rec = {"params": n_params, "leaves": len(specs), "sharded_leaves": sharded,
               "cells": [], "caches": [], "on_card": []}
        for shape in shapes_for(cfg):
            inputs = input_specs(cfg, shape)
            if not inputs or not all(t.is_meta for t in inputs.values()):
                raise AssertionError(f"[specs] {arch} {shape.name}: inputs {inputs}")
            rec["cells"].append({shape.name: {k: list(t.shape) for k, t in inputs.items()}})
            if shape.kind != "decode":
                continue
            cache = cache_struct(api, shape.global_batch, shape.seq_len)
            if not all(t.is_meta for t in tree_leaves(cache)):
                raise AssertionError(f"[specs] {arch}: cache_struct left the meta device")
            specs_match(f"{arch} {shape.name} cache", api.cache_specs(), cache, rules,
                        is_spec_leaf)
            rec["caches"].append({shape.name: sum(t.numel() * t.element_size()
                                                  for t in tree_leaves(cache))})
        for keys, phase in on_card.get(arch, ()):
            kept = phase["card_tree"]
            cut = build_model(cfg.with_overrides(num_layers=kept["num_layers"]))
            want = {p: (tuple(t.shape), str(t.dtype))
                    for p, t in tree_paths(param_struct(cut)).items()}
            got = {p: leaf[:2] for p, leaf in kept["leaves"].items()}
            if got != want or {leaf[2] for leaf in kept["leaves"].values()} != {"cuda"}:
                raise AssertionError(f"[specs] {arch}: the params the {'/'.join(keys)} phase "
                                     f"drew on the card differ from param_struct at "
                                     f"{kept['num_layers']} layers")
            cut_specs = tree_paths(cut.param_specs(), is_spec_leaf)
            if cut_specs.keys() != got.keys() or any(
                    len(cut_specs[p]) != len(shape) for p, (shape, _) in got.items()):
                raise AssertionError(f"[specs] {arch}: param_specs do not fit the card's params")
            cut_n = sum(math.prod(shape) for shape, _ in got.values())
            if cut_n != phase["params"]:
                raise AssertionError(f"[specs] {arch}: {cut_n:,} params in the card's tree, the "
                                     f"{'/'.join(keys)} phase counted {phase['params']:,}")
            rec["on_card"].append({"phase": "/".join(keys), "layers": kept["num_layers"],
                                   "params": cut_n})
        rec["s"] = time.perf_counter() - t0
        out[arch] = rec
        card_note = "; ".join(
            f"on the card ({c['phase']} phase): {c['layers']} of {cfg.num_layers} layers, "
            f"{c['params']:,} params, every leaf's path, shape, dtype and spec rank agree"
            for c in rec["on_card"]) or "not drawn on the card"
        caches = ", ".join(f"{name} {nbytes / 1e9:.2f} GB" for c in rec["caches"]
                           for name, nbytes in c.items()) or "none"
        log(f"[specs] {arch}: {n_params:,} params from param_struct (meta) in {len(specs)} "
            f"leaves, {sharded} sharded on {'/'.join(SHARDED_AXES)}; spec tree, ranks and axis "
            f"names match; caches at the decode cells: {caches}; input_specs for "
            f"{len(rec['cells'])} cells ({', '.join(s.name for s in shapes_for(cfg))}); "
            f"{card_note}; {rec['s']:.2f} s [{card}]")
    torch.cuda.synchronize()
    if torch.cuda.memory_allocated() != allocated:
        raise AssertionError(f"[specs] the phase moved the card's allocated bytes: {allocated:,} "
                             f"-> {torch.cuda.memory_allocated():,}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[specs] {len(list_archs())} archs, {sum(len(v) for v in on_card.values())} card "
        f"param trees held; 0 bytes allocated on the card; phase {out['phase_s']:.1f} s [{card}]")


SHARDED_LM_STEPS = 3
SHARDED_MOE_B, SHARDED_MOE_S = 2, 512
SHARDED_GRAD_REL = 1e-5     # f32 grads on a (1, 1) mesh against the unsharded path
TINY_SECOND_MOMENT = 1e-6   # 100 AdamW eps: tests/test_torch_sharded_step.py


def whole(t):
    """A DTensor gathered whole; a plain tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def hold_sharded_state(torch, got, want, lr: float, steps: int, tag: str) -> dict:
    """The sharded state (gathered) against the unsharded one after
    ``steps`` steps: params at atol 1e-6, except where the unsharded
    bias-corrected second moment is below TINY_SECOND_MOMENT (AdamW's
    update turns on the grads' last bits there), held to 2 lr a step."""
    from repro_torch.utils import tree_leaves

    worst, exempt, equal = 0.0, 0, True
    beta2 = 0.999
    for p, q, nu in zip(tree_leaves(got.params), tree_leaves(want.params),
                        tree_leaves(want.opt.nu)):
        p = whole(p)
        diff = (p.float() - q.float()).abs()
        tiny = torch.sqrt(nu / (1 - beta2 ** steps)) < TINY_SECOND_MOMENT
        equal &= bool(torch.equal(p, q))
        worst = max(worst, float(diff[~tiny].max()) if bool((~tiny).any()) else 0.0)
        exempt += int(tiny.sum())
        if bool(tiny.any()) and float(diff[tiny].max()) > 2 * lr * steps:
            raise AssertionError(f"[sharded] {tag}: a param with a tiny second moment moved "
                                 f"{float(diff[tiny].max())} from the unsharded step's")
    if worst > 1e-6:
        raise AssertionError(f"[sharded] {tag}: params {worst} from the unsharded step's (atol 1e-6)")
    return {"param_max_abs_err": worst, "tiny_second_moment_elements": exempt,
            "bit_equal": equal}


def drive_sharded(torch, results, card) -> None:
    """The sharded step on a (1, 1) mesh of one NCCL rank (``[sharded]``
    lines; item 18 of the docstring)."""
    import dataclasses
    import gc
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.config import TrainConfig, get_config
    from repro_torch.data import LMDataConfig, make_lm_batch
    from repro_torch.distributed import sharding
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build_model
    from repro_torch.training import build_train_step, init_train_state, train_state_specs
    from repro_torch.utils import tree_leaves, tree_map

    out = results["sharded"] = {}
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1)
        try:
            raised = None
            try:
                make_production_mesh(device="cuda")
            except RuntimeError as e:      # the check: one rank is not 256
                raised = str(e)
            if raised is None or "needs 256 ranks but the process group has 1" not in raised:
                raise AssertionError(f"[sharded] make_production_mesh on one rank: {raised!r}")
            mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
            rules = sharding.rules_for_mesh(mesh)
            out["production_mesh_refusal"] = raised
            log(f"[sharded] NCCL process group of 1 rank; make_production_mesh raised: {raised}; "
                f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} on cuda:0, rules {rules} "
                f"[{card}]")

            def place(tree, specs):
                return sharding.device_put(tree, mesh, sharding.spec_tree_to_shardings(
                    mesh, rules, specs))

            # 1. tinyllama at full width: steps on the mesh against plain steps
            cfg = get_config(LM_ARCH)
            api = build_model(cfg)
            tc = TrainConfig(learning_rate=1e-3, total_steps=SHARDED_LM_STEPS,
                             loss_chunk=min(2048, LM_TRAIN_S))
            batches = [{k: v.cuda() for k, v in make_lm_batch(LMDataConfig(
                vocab_size=cfg.vocab_size, seq_len=LM_TRAIN_S, global_batch=LM_TRAIN_B),
                i).items()} for i in range(SHARDED_LM_STEPS)]
            runs = {}
            for tag, m in (("plain", None), ("mesh", mesh)):
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                state = init_train_state(api.init(torch.Generator("cuda").manual_seed(0),
                                                  device="cuda"), tc)
                if m is not None:
                    state = place(state, train_state_specs(api, tc))
                step = build_train_step(api, tc, m)
                ms, losses = [], []
                for batch in batches:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, metrics = step(state, batch)
                    losses.append(float(metrics["loss"]))
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                runs[tag] = {"state": state, "ms": ms, "losses": losses,
                             "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
                del step
            plain, meshed = runs["plain"], runs["mesh"]
            for a, b in zip(meshed["losses"], plain["losses"]):
                if not math.isclose(a, b, rel_tol=1e-5):
                    raise AssertionError(f"[sharded] tinyllama losses {meshed['losses']} on the "
                                         f"mesh, {plain['losses']} unsharded (rtol 1e-5)")
            placed_ok = all(hasattr(t, "placements") for t in tree_leaves(meshed["state"].params))
            if not placed_ok:
                raise AssertionError("[sharded] the mesh step returned plain params")
            held = hold_sharded_state(torch, meshed["state"], plain["state"], tc.learning_rate,
                                      SHARDED_LM_STEPS, "tinyllama")
            n_params = sum(t.numel() for t in tree_leaves(plain["state"].params))
            steady = {k: statistics.mean(r["ms"][1:]) for k, r in runs.items()}
            out["lm"] = {"arch": LM_ARCH, "params": n_params, "batch": LM_TRAIN_B,
                         "seq_len": LM_TRAIN_S, "steps": SHARDED_LM_STEPS,
                         **{f"{k}_{f}": r[f] for k, r in runs.items()
                            for f in ("ms", "losses", "peak_gb")},
                         "plain_ms_per_step": steady["plain"], "mesh_ms_per_step": steady["mesh"],
                         "ratio": steady["mesh"] / steady["plain"], **held}
            log(f"[sharded] {LM_ARCH} at full width ({n_params:,} params, {cfg.num_layers} "
                f"layers, bf16 compute), B={LM_TRAIN_B} S={LM_TRAIN_S}: {SHARDED_LM_STEPS} AdamW "
                f"steps on the (1, 1) mesh against as many unsharded from the same state: losses "
                f"{', '.join(f'{x:.6f}' for x in meshed['losses'])} against "
                f"{', '.join(f'{x:.6f}' for x in plain['losses'])}; params max abs err "
                f"{held['param_max_abs_err']:.3g} ({held['tiny_second_moment_elements']} elements "
                f"with a tiny second moment), bit-equal {held['bit_equal']} [{card}]")
            log(f"[sharded] ms a step (steps 2-{SHARDED_LM_STEPS} mean; first step "
                f"{meshed['ms'][0]:.1f} on the mesh, {plain['ms'][0]:.1f} unsharded): mesh "
                f"{steady['mesh']:.1f}, unsharded {steady['plain']:.1f}, ratio "
                f"{steady['mesh'] / steady['plain']:.3f} (the DTensor dispatch's cost); peak "
                f"memory {meshed['peak_gb']:.2f} GB on the mesh, {plain['peak_gb']:.2f} GB "
                f"unsharded [{card}]")
            del runs, plain, meshed, batches, api

            # 2. moonshot, ep_a2a under the mesh against the unsharded scatter path
            gc.collect()
            torch.cuda.empty_cache()
            mcfg = get_config(MOE_ARCH).with_overrides(num_layers=MOE_TRAIN_LAYERS,
                                                       compute_dtype="float32")
            ep = build_model(mcfg.with_overrides(moe=dataclasses.replace(mcfg.moe,
                                                                         impl="ep_a2a")))
            scatter = build_model(mcfg)
            params = ep.init(torch.Generator("cuda").manual_seed(0), device="cuda")
            batch = {k: v.cuda() for k, v in make_lm_batch(LMDataConfig(
                vocab_size=mcfg.vocab_size, seq_len=SHARDED_MOE_S,
                global_batch=SHARDED_MOE_B), 0).items()}
            want, wgrads = lm_value_and_grad(torch, scatter, params, batch,
                                             loss_chunk=SHARDED_MOE_S)
            placed = place(params, ep.param_specs())
            with sharding.mesh_context(mesh, rules):
                tracked = tree_map(lambda t: t.detach().requires_grad_(True), placed)
                loss, _ = ep.loss(tracked, batch, loss_chunk=SHARDED_MOE_S)
                got = whole(loss)
                ggrads = [whole(g) for g in torch.autograd.grad(got, tree_leaves(tracked))]
            errs = [rel_fro(torch, g, w) for g, w in zip(ggrads, wgrads)]
            if not math.isclose(float(got), float(want), rel_tol=1e-5) or max(errs) > SHARDED_GRAD_REL:
                raise AssertionError(f"[sharded] moonshot ep_a2a on the mesh: loss {float(got)} "
                                     f"against {float(want)}, grads {errs}")
            out["moe"] = {"arch": MOE_ARCH, "layers": MOE_TRAIN_LAYERS, "batch": SHARDED_MOE_B,
                          "seq_len": SHARDED_MOE_S, "loss": float(got),
                          "loss_abs_err": abs(float(got) - float(want)),
                          "grad_rel_fro_max": max(errs)}
            log(f"[sharded] {MOE_ARCH} at full width, {MOE_TRAIN_LAYERS} layers, f32 (TF32 off), "
                f"B={SHARDED_MOE_B} S={SHARDED_MOE_S}: value_and_grad with ep_a2a on the mesh "
                f"(local_map, all_to_all and all_gather over one rank) against the unsharded "
                f"scatter path: loss {float(got):.6f}, abs err {abs(float(got) - float(want)):.3g} "
                f"(rtol 1e-5); {len(errs)} grad leaves, relative Frobenius error max "
                f"{max(errs):.3g} (bar {SHARDED_GRAD_REL}) [{card}]")
            del params, placed, tracked, loss, got, ggrads, wgrads, want, ep, scatter

            # 3. rwkv6: a train step on the mesh, K3 through local_map
            gc.collect()
            torch.cuda.empty_cache()
            rcfg = get_config(RWKV_ARCH).with_overrides(num_layers=RWKV_TRAIN_LAYERS)
            rapi = build_model(rcfg)
            rtc = TrainConfig(learning_rate=1e-3, total_steps=1, loss_chunk=min(2048, RWKV_TRAIN_S))
            rbatch = {k: v.cuda() for k, v in make_lm_batch(LMDataConfig(
                vocab_size=rcfg.vocab_size, seq_len=RWKV_TRAIN_S, global_batch=RWKV_TRAIN_B),
                0).items()}
            plain_state, plain_metrics = build_train_step(rapi, rtc)(init_train_state(
                rapi.init(torch.Generator("cuda").manual_seed(0), device="cuda"), rtc), rbatch)
            state = place(init_train_state(rapi.init(torch.Generator("cuda").manual_seed(0),
                                                     device="cuda"), rtc),
                          train_state_specs(rapi, rtc))
            step = build_train_step(rapi, rtc, mesh)
            predicted = RWKV_TRAIN_LAYERS * 2 + rwkv_bwd_launches(RWKV_TRAIN_S, RWKV_TRAIN_LAYERS)
            rec = K3Inputs()
            reset_launch_counts()
            with rec({"sharded_forward": RWKV_TRAIN_S, "sharded_chunk": 64}):
                state, metrics = step(state, rbatch)
            torch.cuda.synchronize()
            counts = dict(launch_counts())
            if counts["wkv6"] != predicted or any(v for k, v in counts.items() if k != "wkv6"):
                raise AssertionError(f"[sharded] rwkv step on the mesh launched {counts}; "
                                     f"predicted {predicted} of K3 and none else")
            if not math.isclose(float(metrics["loss"]), float(plain_metrics["loss"]),
                                rel_tol=1e-5):
                raise AssertionError(f"[sharded] rwkv loss {float(metrics['loss'])} on the mesh, "
                                     f"{float(plain_metrics['loss'])} unsharded")
            rheld = hold_sharded_state(torch, state, plain_state, rtc.learning_rate, 1, "rwkv6")
            out["rwkv"] = {"arch": RWKV_ARCH, "layers": RWKV_TRAIN_LAYERS,
                           "batch": RWKV_TRAIN_B, "seq_len": RWKV_TRAIN_S,
                           "loss": float(metrics["loss"]), "k3_launches": counts["wkv6"],
                           "k3_predicted": predicted, **rheld}
            out["k3_launches"] = counts["wkv6"]
            log(f"[sharded] {RWKV_ARCH} at full width, {RWKV_TRAIN_LAYERS} layers, B={RWKV_TRAIN_B} "
                f"S={RWKV_TRAIN_S}: a train step on the mesh against the unsharded one: loss "
                f"{float(metrics['loss']):.6f} against {float(plain_metrics['loss']):.6f}; params "
                f"max abs err {rheld['param_max_abs_err']:.3g}, bit-equal {rheld['bit_equal']}; "
                f"K3 launches {counts['wkv6']} = predicted {predicted} ({RWKV_TRAIN_LAYERS} layers "
                f"x (forward + recompute + {-(-RWKV_TRAIN_S // 64) - 1} backward chunks)), under "
                f"local_map; other port kernels {counts} [{card}]")
            rwkv_k3_vs_plain(torch, rec, out, card, tag="sharded",
                             expected=("sharded_forward", "sharded_chunk"))
            del plain_state, plain_metrics, step, metrics, rec

            # 4. that state's params saved from the mesh and restored onto it
            with tempfile.TemporaryDirectory() as ckpt:
                t0 = time.perf_counter()
                path = save_checkpoint(ckpt, 1, state.params)
                save_s = time.perf_counter() - t0
                specs = rapi.param_specs()
                t0 = time.perf_counter()
                restored, _ = restore_checkpoint(path, state.params, mesh=mesh, spec_tree=specs)
                restore_s = time.perf_counter() - t0
                want_pl = sharding.spec_tree_to_shardings(mesh, rules, specs)
                leaves = list(zip(tree_leaves(restored), tree_leaves(state.params)))
                for (a, b), pl in zip(leaves, sharding_leaves(sharding, want_pl)):
                    if tuple(a.placements) != tuple(pl) or not torch.equal(whole(a), whole(b)):
                        raise AssertionError("[sharded] a restored leaf differs or is misplaced")
            out["restore"] = {"leaves": len(leaves), "save_s": save_s, "restore_s": restore_s}
            log(f"[sharded] {RWKV_ARCH}'s params after the mesh step saved from the mesh "
                f"(gathered, rank 0 writes) in {save_s:.1f} s and restored onto it in "
                f"{restore_s:.1f} s: {len(leaves)} leaves equal, each placed by its spec [{card}]")
            del state, restored, leaves
        finally:
            dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[sharded] phase {out['phase_s']:.1f} s [{card}]")


DRYRUN_CELLS = (("lstm-ae-f64-d6", "serve_64"), ("tinyllama-1.1b", "decode_32k"),
                ("whisper-large-v3", "decode_32k"), ("rwkv6-7b", "decode_32k"),
                ("jamba-v0.1-52b", "long_500k"))
DRYRUN_CELL_TIMEOUT_S = 240


def dryrun_cells(out_dir: str) -> dict:
    """Each of DRYRUN_CELLS through the dry-run launcher, each in a
    subprocess of its own without a GPU, all started together: {cell:
    (rc, its JSON record or None, the launcher's output)}."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {cell: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "single", "--arch",
         cell[0], "--shape", cell[1], "--out", out_dir], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for cell in DRYRUN_CELLS}
    done = {}
    try:
        for cell, p in procs.items():
            text, _ = p.communicate(timeout=DRYRUN_CELL_TIMEOUT_S)
            path = os.path.join(out_dir, f"{cell[0]}__{cell[1]}__single_pod_16x16.json")
            rec = json.load(open(path)) if os.path.exists(path) else None
            done[cell] = (p.returncode, rec, text)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return done


def traced_step(fn) -> dict:
    """``fn()`` (a step on meta tensors) under the dry run's trace: its
    counted FLOPs by dtype, bytes and roofline terms (no mesh: one card)."""
    from repro_torch.roofline.extract import HBM_BW, compute_seconds
    from repro_torch.roofline.trace import analyze, trace

    t0 = time.perf_counter()
    _, record = trace(fn)
    totals = analyze(record)
    kernel_ops: dict = {}
    for e in record:
        if e["op"].startswith("repro_torch."):
            kernel_ops[e["op"]] = kernel_ops.get(e["op"], 0) + e["n"]
    return {"flops": totals.flops, "flops_by_dtype": totals.flops_by_dtype,
            "bytes": totals.bytes, "compute_ms": compute_seconds(totals.flops_by_dtype) * 1e3,
            "memory_ms": totals.bytes / HBM_BW * 1e3, "ops": sum(e["n"] for e in record),
            "kernel_ops": kernel_ops,
            "trace_s": time.perf_counter() - t0}


def drive_dryrun(torch, results, card) -> None:
    """The dry run (``[dryrun]`` lines), last: the launcher's cells over a
    fake group of 256 ranks in subprocesses, then three steps the card ran
    traced on meta tensors beside this script's hand bounds and the phases'
    measured ms.  Nothing runs on the card."""
    import tempfile

    from repro_torch.config import LSTMAE_SHAPES, get_config
    from repro_torch.models import build_model
    from repro_torch.models.api import param_struct

    out = results["dryrun"] = {"cells": {}, "steps": {}}
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as tmp:
        cells = dryrun_cells(tmp)
    failed = [f"{arch} {shape}: rc {rc}, {(rec or {}).get('status')}:\n{text[-2000:]}"
              for (arch, shape), (rc, rec, text) in cells.items()
              if rc != 0 or rec is None or rec.get("status") != "ok"]
    if failed:
        raise AssertionError("[dryrun] cells failed:\n" + "\n".join(failed))
    for (arch, shape), (rc, rec, text) in cells.items():
        out["cells"][f"{arch}__{shape}"] = {k: rec[k] for k in (
            "flops_per_chip", "bytes_per_chip", "coll_bytes_per_chip", "coll_breakdown",
            "dominant", "compute_s", "memory_s", "collective_s", "compile_s")}
        log(f"[dryrun] {arch} {shape} on the 16x16 mesh (256 fake ranks, a subprocess without "
            f"a GPU): ok; per chip {rec['flops_per_chip']:.6g} FLOP, {rec['bytes_per_chip']:.6g} "
            f"bytes, {rec['coll_bytes_per_chip']:.6g} collective bytes "
            f"({', '.join(f'{k} {v:,}' for k, v in sorted(rec['coll_breakdown'].items()))}); "
            f"dominant {rec['dominant']} (compute {rec['compute_s'] * 1e3:.4g} ms, memory "
            f"{rec['memory_s'] * 1e3:.4g} ms, collective {rec['collective_s'] * 1e3:.4g} ms at "
            f"H100 datasheet rates); traced in {rec['compile_s']:.1f} s [{card}]")
    out["cells_s"] = time.perf_counter() - t_phase

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    serve = next(s for s in LSTMAE_SHAPES if s.name == "serve_64")
    steps = {}
    cfg = get_config("lstm-ae-f64-d6")
    api = build_model(cfg)
    params = param_struct(api)
    steps["lstm-ae-f64-d6 fused"] = (
        lambda: api.prefill(params, {"series": meta(serve.global_batch, serve.seq_len,
                                                     cfg.lstm_ae.input_features)},
                            schedule="fused"),
        sum(k1_bound(serve.global_batch, i, h)[0] * serve.seq_len
            for i, h in zip(cfg.lstm_ae.layer_input_sizes(), cfg.lstm_ae.layer_sizes())),
        results["serve"][0]["schedules"]["fused"]["ms_per_request_input_on_card"],
        {f"repro_torch.{k}.default": n // results["serve"][0]["requests"]
         for k, n in results["serve"][0]["schedules"]["fused"]["kernel_launches"].items()},
        f"B={serve.global_batch}, T={serve.seq_len}")
    lm = build_model(get_config(LM_ARCH))
    lm_params = param_struct(lm)
    tokens = meta(LM_SERVE_B, LM_SERVE_S, dtype=torch.int32)
    steps[f"{LM_ARCH} prefill"] = (
        lambda: lm.prefill(lm_params, {"tokens": tokens}, kv_chunk=LM_KV_CHUNK),
        lm_prefill_bound(lm.cfg, LM_SERVE_B, LM_SERVE_S)[0], results["lm"]["prefill_ms"], {},
        f"B={LM_SERVE_B}, S={LM_SERVE_S}")
    rwkv = build_model(get_config(RWKV_ARCH))
    rwkv_params = param_struct(rwkv)
    rwkv_tokens = meta(RWKV_SERVE_B, RWKV_SERVE_S, dtype=torch.int32)
    rwkv_served = results["rwkv"]["serve"]
    bf16, f32, _ = rwkv_serve_bound(rwkv.cfg, RWKV_SERVE_B, RWKV_SERVE_S,
                                    rwkv_served["params"], 1)
    steps[f"{RWKV_ARCH} prefill"] = (
        lambda: rwkv.prefill(rwkv_params, {"tokens": rwkv_tokens}),
        bf16 + f32, rwkv_served["prefill_ms"],
        {"repro_torch.wkv6.default": rwkv.cfg.num_layers}, f"B={RWKV_SERVE_B}, S={RWKV_SERVE_S}")
    for name, (fn, hand_flops, measured_ms, kernel_ops, at) in steps.items():
        with torch.no_grad():
            rec = traced_step(fn)
        if rec["kernel_ops"] != kernel_ops:
            raise AssertionError(f"[dryrun] {name}: kernel meta ops {rec['kernel_ops']}, "
                                 f"expected {kernel_ops}")
        rec.update({"hand_bound_flops": hand_flops, "flops_over_hand_bound":
                    rec["flops"] / hand_flops, "measured_ms": measured_ms})
        out["steps"][name] = rec
        by_dtype = ", ".join(f"{dt} {f:.6g}" for dt, f in sorted(rec["flops_by_dtype"].items()))
        kernels = "; ".join(f"{op} x{n} counted by its FLOP formula"
                            for op, n in rec["kernel_ops"].items()) or "no kernel op"
        log(f"[dryrun] {name} at {at}, traced on meta tensors without a mesh in "
            f"{rec['trace_s']:.1f} s ({rec['ops']:,} ops; {kernels}): FLOP by dtype {by_dtype}; "
            f"{rec['bytes']:.6g} bytes; roofline compute {rec['compute_ms']:.4g} ms, memory "
            f"{rec['memory_ms']:.4g} ms at H100 datasheet rates; this script's hand bound "
            f"{hand_flops:.6g} FLOP (counted / hand {rec['flops_over_hand_bound']:.4f}); "
            f"measured above {measured_ms:.4g} ms [{card}]")
    torch.cuda.synchronize()
    if torch.cuda.memory_allocated() != allocated:
        raise AssertionError(f"[dryrun] the phase moved the card's allocated bytes: "
                             f"{allocated:,} -> {torch.cuda.memory_allocated():,}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[dryrun] {len(cells)} cells ok, {len(steps)} steps traced; 0 bytes allocated on the "
        f"card; phase {out['phase_s']:.1f} s [{card}]")


def sharding_leaves(sharding, tree) -> list:
    """The placement tuples of a shardings tree in ``tree_leaves`` order."""
    if sharding.is_placements(tree):
        return [tree]
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in sharding_leaves(sharding, tree[k])]
    return [p for v in tree for p in sharding_leaves(sharding, v)]


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
    check_stack(torch, results)
    stack = time_stack(torch, results, card)

    svc, eager, first = drive_service(torch, "lstm-ae-f64-d6", serve.global_batch,
                                      serve.seq_len, 3, results, card)
    main_launches = results["serve"][0]["kernel_launches"]
    small = drive_service(torch, "lstm-ae-f32-d2", 1024, 64, 3, results, card)
    latency = drive_service(torch, "lstm-ae-f64-d6", 1, STACK_T, 3, results, card)
    check_streaming(torch, svc, first, results)
    drive_with_forms(torch, svc, first, results, card)
    drive_fit(torch, results, card)

    check_k2(torch, results)
    k2 = time_k2(torch, serve.global_batch, results["k1_layers"], results, card)
    k2_launches = drive_k2_path(torch, svc, first, results, card)
    drive_gateway(torch, results, card)
    transport_gw, transport_windows = drive_transport(torch, results, card)
    drive_workers(torch, results, card)
    drive_worker_launchers(torch, results, card)
    drive_multi_gpu(torch, svc, results, card)

    check_k3(torch, results)
    k3 = time_k3(torch, results, card)
    k3_launches = drive_k3_path(torch, results, card)
    check_k4(torch, results)
    k4 = time_k4(torch, results, card)
    k4_launches = drive_k4_path(torch, results, card)
    # before the LM phase: after it, the profiler's trace of a pass drops its
    # first three device events, which for a request on lstm_stack hold the
    # kernel (stack_after_lm below shows it, and that the kernel still runs)
    for out, (fused, eag, request) in zip(results["serve"],
                                          ((svc, eager, first), small, latency)):
        compare_launches(torch, out["arch"], fused, eag, request.to("cuda"), out, card)
    profile_transport_flush(torch, transport_gw, transport_windows, results, card)
    drive_lm(torch, results, card)
    stack_after_lm(torch, [(results["serve"][1], small[0]), (results["serve"][2], latency[0])],
                   results, card)
    split_fit_step(torch, results, card)
    # the main path's count (captured launches x replays) against the K1
    # kernels the profiler saw the device run for one replayed request
    main = results["serve"][0]
    main_lp = main["schedules"]["fused"]["launches_per_request"]
    if main_launches != {main_lp["wrapper"]: main["requests"] * main_lp["kernel_device_events"]}:
        raise AssertionError(f"the main path counted {main_launches} launches over "
                             f"{main['requests']} requests; the device ran "
                             f"{main_lp['kernel_device_events']} {main_lp['kernel']} per request")
    # after the profiled passes above: a profiled train step records over
    # 10,000 device kernels, and the K1 counts above must not follow it
    drive_lm_train(torch, results, card)
    drive_moe(torch, results, card)
    drive_rwkv(torch, results, card)
    drive_jamba(torch, results, card)
    drive_whisper(torch, results, card)
    drive_specs(torch, results, card)
    drive_sharded(torch, results, card)
    drive_dryrun(torch, results, card)

    kernels = {"kernels": [{
        "name": "lstm_cell",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": main_launches.get("lstm_cell", 0),
        "max_abs_err": results["k1_max_abs_err_f32"],
        "ms": k1["kernel_ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
    }, {
        "name": "lstm_stack",
        "route": "cuda",
        "source": STACK_SOURCE,
        "replaces": STACK_REPLACES,
        "launches": sum(out["kernel_launches"].get("lstm_stack", 0) for out in results["serve"]),
        "max_abs_err": results["stack_max_abs_err_f32"],
        "ms": stack["kernel_ms"],
        "plain_ms": stack["plain_ms"],
        "bound_ms": stack["bound_ms"],
        "bound_by": stack["bound_by"],
        "library_ms": stack["library_ms"],
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
        "launches": (k3_launches + results["rwkv"]["k3_launches"]
                     + results["sharded"]["k3_launches"]),
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
        f"(3 replays of one captured graph; {main_lp['kernel_device_events']} "
        f"{main_lp['kernel']} kernels per replay on the device, from the profiler); "
        f"lstm_stack: times per window of lstm-ae-f64-d6 at B=1, T={STACK_T} (one launch, "
        f"f64d6.latency's shape), launches from the fused serving path's lstm-ae-f32-d2 B=1024 "
        f"and lstm-ae-f64-d6 B=1 requests (3 replays each); "
        f"lstm_seq: times per forward of lstm-ae-f64-d6 at B={serve.global_batch}, T={K2_T} "
        f"(6 launches), launches from its lstm_seq_op path; wkv6: f32 at B={RWKV_B}, T={RWKV_T}, "
        f"H={RWKV_H}, hd={RWKV_HD}, launches from its wkv6_op path (whole + chained pair: "
        f"{k3_launches}), the [rwkv] phase's model path ({results['rwkv']['k3_launches']}) and "
        f"the [sharded] phase's ({results['sharded']['k3_launches']}); "
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
