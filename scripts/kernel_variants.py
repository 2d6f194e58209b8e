#!/usr/bin/env python3
"""Time variants of one of the port's CUDA kernels beside the committed source, on one GPU.

    python3 scripts/kernel_variants.py lstm_cell 'kTargetBlocks = 128;=>kTargetBlocks = 256;'
    python3 scripts/kernel_variants.py flash_attention 'kMmaWarps = 4;=>kMmaWarps = 8;'
    python3 scripts/kernel_variants.py lstm_seq 'kTargetThreads = 256;=>kTargetThreads = 512;'
    python3 scripts/kernel_variants.py wkv6 'kChunk = 8;=>kChunk = 4;'
    python3 scripts/kernel_variants.py lstm_stack 'kSlots = 4;=>kSlots = 8;'

Each variant is ``src/repro_torch/kernels/csrc/<kernel>.cu`` with one piece
of text replaced (``OLD=>NEW``; OLD must occur exactly once).  The script
builds the committed library and every variant with the nvcc flags of
``kernels/_build.py`` (all compilers at once, into ``kernels/_build/variants/``),
prints each build's registers and spills as ptxas reports them, holds each
build to the plain version with ``chip_smoke.py``'s checks, and times it on
the card in turns: the committed build, the variants, then the same in
reverse, so that the order favours none.  What is timed:

- ``lstm_cell``: one timestep of lstm-ae-f64-d6 (6 launches, f32) at B=8192
  and at B=256, as ``chip_smoke.time_k1``;
- ``flash_attention``: one bf16 and one f32 launch at phi4-mini-3.8b's
  heads (B=4, H=24, S=Sk=4096, d=128, causal), the shape of
  ``chip_smoke.time_k4``;
- ``lstm_seq``: one forward of lstm-ae-f64-d6 (6 launches, f32) at B=8192,
  T=64, the shape of ``chip_smoke.time_k2``;
- ``wkv6``: one f32 and one bf16 launch at rwkv6-7b's heads (B=32,
  T=4096, H=64, hd=64), the shape of ``chip_smoke.time_k3``, and f32 at B=8;
- ``lstm_stack``: one window (B=1, T=64) of lstm-ae-f64-d6 and of
  lstm-ae-f32-d2, the latency cells' forward, each held to the plain version
  at B in (1, 5) first.

Device times come from CUDA events (``chip_smoke.device_ms``).  For each
build and kernel it also prints the largest loops of the machine code
(``cuobjdump -sass``): instructions in each loop body and how many of them
are FP32 (FFMA, FMUL, FADD).  ``--json PATH`` also writes every time.  A variant that fails to build or to agree
with the plain version stops the script with a non-zero exit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

KERNELS = ("lstm_cell", "lstm_seq", "wkv6", "flash_attention", "lstm_stack")


def apply_variant(source: str, spec: str) -> str:
    """``source`` with the OLD of ``spec`` ("OLD=>NEW") replaced by NEW;
    raises ValueError unless OLD occurs exactly once."""
    if "=>" not in spec:
        raise ValueError(f"a variant is OLD=>NEW, got {spec!r}")
    old, new = spec.split("=>", 1)
    count = source.count(old)
    if count != 1:
        raise ValueError(f"{old!r} occurs {count} times in the source; it must occur once")
    return source.replace(old, new)


def ptxas_summary(log: str) -> dict:
    """Registers of every kernel and the non-zero spills in an ``nvcc -Xptxas -v`` log."""
    return {"registers": [int(n) for n in re.findall(r"Used (\d+) registers", log)],
            "spill_bytes": [int(n) for n in re.findall(r"(\d+) bytes spill", log) if n != "0"]}


FP32_OPS = ("FFMA", "FMUL", "FADD")


def sass_loops(sass: str, top: int = 3) -> dict:
    """The ``top`` largest loops of each function in ``cuobjdump -sass``
    output: (first address, instructions in the body, FP32 instructions
    among them) per backward branch, largest first."""
    funcs: dict = {}
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\S*)\s*(.*)", line)
        if m and name:
            funcs[name].append((int(m.group(1), 16), m.group(2), m.group(4)))
    out = {}
    for name, ins in funcs.items():
        loops = []
        for addr, op, rest in ins:
            b = re.match(r"(0x[0-9a-f]+)", rest) if op == "BRA" else None
            if b and int(b.group(1), 16) < addr:
                body = [o for a, o, _ in ins if int(b.group(1), 16) <= a <= addr]
                loops.append((int(b.group(1), 16), len(body), sum(o in FP32_OPS for o in body)))
        out[name] = sorted(loops, key=lambda x: -x[1])[:top]
    return out


def measure(torch, cs, kernel: str, card: str) -> dict:
    """Check the loaded build against the plain version, then time it."""
    res: dict = {}
    if kernel == "lstm_cell":
        cs.check_k1(torch, res)
        big = cs.time_k1(torch, 8192, res, card)
        small = cs.time_k1(torch, cs.GATEWAY_MAX_BATCH, res, card, tag="_small")
        return {"b8192_ms": big["kernel_ms"], "b8192_layers_ms": [r["kernel_ms"] for r in res["k1_layers"]],
                "b256_ms": small["kernel_ms"],
                "b256_layers_ms": [r["kernel_ms"] for r in res["k1_layers_small"]]}
    if kernel == "lstm_seq":
        from repro_torch.config import get_config
        from repro_torch.kernels.lstm_seq import lstm_seq_cuda

        cs.check_k2(torch, res)
        ae = get_config("lstm-ae-f64-d6").lstm_ae
        layers = []
        for li, (in_dim, hidden) in enumerate(zip(ae.layer_input_sizes(), ae.layer_sizes())):
            args = cs.seq_inputs(torch, cs.K2_T, 8192, in_dim, hidden, torch.float32, seed=2000 + li)
            layers.append(cs.device_ms(torch, lambda: lstm_seq_cuda(*args), iters=10, reps=5))
        return {"forward_ms": sum(layers), "layers_ms": layers,
                "max_abs_err_f32": res["k2_max_abs_err_f32"]}
    if kernel == "lstm_stack":
        from repro_torch.config import get_config
        from repro_torch.core.lstm import init_lstm_ae
        from repro_torch.kernels.lstm_stack import lstm_stack_cuda, lstm_stack_plain

        out = {}
        for arch, name in (("lstm-ae-f64-d6", "f64d6"), ("lstm-ae-f32-d2", "f32d2")):
            cfg = get_config(arch)
            params = init_lstm_ae(torch.Generator().manual_seed(5), cfg, device="cuda")
            layers = [dict(layer) for layer in params["layers"]]
            err = 0.0
            for bsz in (1, 5):
                xs = torch.randn(64, bsz, cfg.lstm_ae.input_features, device="cuda",
                                 generator=torch.Generator(device="cuda").manual_seed(bsz))
                got = lstm_stack_cuda(xs, layers)
                torch.cuda.synchronize()
                err = max(err, float((got - lstm_stack_plain(xs, layers)).abs().max()))
            if not err <= 1e-5:
                raise AssertionError(f"lstm_stack at {arch}: max abs err {err:.3g} against the plain version")
            xs = torch.randn(64, 1, cfg.lstm_ae.input_features, device="cuda")
            out[f"{name}_b1_ms"] = cs.device_ms(torch, lambda: lstm_stack_cuda(xs, layers), iters=50, reps=5)
            out[f"{name}_max_abs_err"] = err
        return out
    if kernel == "wkv6":
        from repro_torch.kernels.wkv6 import wkv6_cuda

        cs.check_k3(torch, res)
        out = {}
        for b, dtype, name in ((cs.RWKV_B, torch.float32, "f32"), (cs.RWKV_B, torch.bfloat16, "bf16"),
                               (8, torch.float32, "f32_b8")):
            args = cs.wkv_inputs(torch, b, cs.RWKV_T, cs.RWKV_H, cs.RWKV_HD, dtype, seed=3200)
            out[f"{name}_ms"] = cs.device_ms(torch, lambda: wkv6_cuda(*args), iters=10, reps=5)
            del args
        out["max_abs_err_f32"] = res["k3_max_abs_err_f32"]
        out["max_abs_err_bf16"] = res["k3_max_abs_err_bf16"]
        return out
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    cs.check_k4(torch, res)
    out = {}
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        q, k, v = cs.attention_inputs(torch, cs.PHI_B, cs.PHI_H, cs.PHI_S, cs.PHI_S, cs.PHI_HD,
                                      dtype, seed=4200, kv_heads=cs.PHI_KV_H)
        ms = cs.device_ms(torch, lambda: flash_attention_cuda(q, k, v, causal=True), iters=5, reps=5)
        flops = cs.k4_bound(cs.PHI_B, cs.PHI_H, cs.PHI_S, cs.PHI_S, cs.PHI_HD, True, 2)[0]
        out.update({f"{name}_ms": ms, f"{name}_tflops": flops / ms * 1e-9})
    out["max_abs_err_bf16"] = res["k4_max_abs_err_bf16"]
    out["max_abs_err_f32"] = res["k4_max_abs_err_f32"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=KERNELS)
    ap.add_argument("variants", nargs="+", help="OLD=>NEW replacements, one variant each")
    ap.add_argument("--json", default=None, help="also write every time to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is visible", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as tf
    from repro_torch.kernels import lstm_cell as tk
    from repro_torch.kernels import lstm_seq as ts
    from repro_torch.kernels import lstm_stack as tst
    from repro_torch.kernels import wkv6 as tw

    source = (_build.CSRC / f"{args.kernel}.cu").read_text()
    sources = {f"variant {i + 1}": apply_variant(source, spec) for i, spec in enumerate(args.variants)}
    libs = {"committed": _build.build((args.kernel,))[args.kernel]}
    logs = {"committed": libs["committed"].with_suffix(".log").read_text()}
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        stem = str(out_dir / f"{args.kernel}_{name.replace(' ', '_')}")
        with open(stem + ".cu", "w") as f:
            f.write(text)
        libs[name] = stem + ".so"
        procs[name] = subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS,
                                        "-o", libs[name], stem + ".cu"],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            print(f"{name} failed to build:\n{logs[name][-4000:]}", file=sys.stderr)
            return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    wrapper = {"lstm_cell": tk, "lstm_seq": ts, "wkv6": tw, "flash_attention": tf,
               "lstm_stack": tst}[args.kernel]
    real_load = _build.load
    results = {"card": card, "kernel": args.kernel,
               "variants": dict(zip(sources, args.variants)),
               "ptxas": {name: ptxas_summary(log) for name, log in logs.items()}, "runs": []}
    for name, summary in results["ptxas"].items():
        print(f"[ptxas] {name}: registers {summary['registers']}, spills {summary['spill_bytes'] or 'none'}",
              flush=True)
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    results["sass"] = {}
    for name, lib in libs.items():
        text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                              check=True).stdout
        results["sass"][name] = sass_loops(text)
        for func, loops in results["sass"][name].items():
            print(f"[sass] {name}: {func}: loops (start, instructions, FP32) {loops}", flush=True)
    order = ["committed", *sources]
    try:
        for name in order + order[::-1]:
            _build.load = (lambda _n, path=str(libs[name]): ctypes.CDLL(path))
            wrapper._lib.cache_clear()
            got = measure(torch, cs, args.kernel, card)
            results["runs"].append({"build": name, **got})
            print(f"[time] {name}: " + ", ".join(f"{k} {v:.5f}" for k, v in got.items()
                                                  if isinstance(v, float)) + f" [{card}]", flush=True)
    finally:
        _build.load = real_load
        wrapper._lib.cache_clear()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
