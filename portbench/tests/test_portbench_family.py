"""A new model family joins the benchmark by new files and new BENCHMARK.json
entries alone: a copy of the benchmark, its tests with it, gains a toy decoder
family (its configuration, system, plain reference, work count and one
fault), a traffic kind whose compared number is ``logits_rel_err``, a cell and
two metrics.  The copy's own layout, fault and import tests then pass with the
toy cell's cases among them, and the toy cell runs through
``harness.run_cell``: correct as it is, not correct with its fault planted.
On the CPU, each in a subprocess."""
import json
import os
import shutil
import subprocess
import sys

from portbench import harness

ROOT = harness.ROOT

CONFIG = {
    "name": "toy-lm", "family": "toy_lm",
    "source": "a one-layer causal decoder (Vaswani et al., 2017, Section 3.2) for the harness's tests",
    "vocab_size": 48, "d_model": 16, "n_heads": 2, "dtype": "float32",
    "reduced": ["vocab_size"], "published": {"vocab_size": 96},
    "assumed": {"weights": "N(0, 1/d_model), drawn from the seed"},
}

FAMILY = '''"""The toy decoder: an embedding, one causal attention layer with a
residual, and an unembedding, in plain torch; each request's answer is the
logits of every position."""
import sys
from dataclasses import dataclass

import torch

from portbench.reference import toy_lm_plain


def check_config(cfg):
    if cfg["d_model"] % cfg["n_heads"]:
        raise ValueError(f"{cfg['name']}: d_model is not a multiple of n_heads")


def make_weights(cfg, gen):
    v, d = cfg["vocab_size"], cfg["d_model"]
    flat = torch.randn(2 * v * d + 4 * d * d, generator=gen, device=gen.device) * d ** -0.5
    shapes = {"emb": (v, d), "wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d),
              "unemb": (d, v)}
    weights, at = {}, 0
    for name, (a, b) in shapes.items():
        weights[name] = flat[at:at + a * b].view(a, b)
        at += a * b
    return weights


def attention(x, w, heads):
    b, t, d = x.shape
    q, k, v = (
        (x @ w[n]).view(b, t, heads, d // heads).transpose(1, 2) for n in ("wq", "wk", "wv"))
    y = torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True)
    return y.transpose(1, 2).reshape(b, t, d) @ w["wo"]


@dataclass
class System:
    weights: dict
    kept: dict
    heads: int

    def score(self, tokens):
        x = self.weights["emb"][tokens.to(self.weights["emb"].device)]
        x = x + attention(x, self.weights, self.heads)
        return (x @ self.weights["unemb"]).cpu()

    def counters(self):
        return {}

    def close(self):
        self.weights = None


def build(cfg, gen, device):
    w = make_weights(cfg, gen)
    return System(weights={k: t.clone() for k, t in w.items()}, kept=w, heads=cfg["n_heads"])


def control(cfg, gen, device):
    w = make_weights(cfg, gen)
    control = System(weights=w, kept=w, heads=cfg["n_heads"])
    control.score = lambda tokens: toy_lm_plain.logits(w, tokens, cfg["n_heads"], torch.bfloat16)
    return control


def judge(system, traffic, answers, limits):
    worst = 0.0
    for i, got in answers.items():
        want = toy_lm_plain.logits(system.kept, traffic.input(i), system.heads)
        worst = max(worst, float((got - want).abs().max() / want.abs().max()))
    return {"logits_rel_err": {"value": worst, "limit": float(limits["logits_rel_err"])}}


def _attention_left_out(monkeypatch, cfg, limits):
    monkeypatch.setattr(sys.modules[__name__], "attention", lambda x, w, heads: 0 * x)


def faults(traffic_kind, on_card=False):
    return {} if on_card else {"attention_left_out": _attention_left_out}
'''

REFERENCE = '''"""The toy decoder's logits in plain float32 torch, the causal mask by hand."""
import torch


def logits(w, tokens, heads, dtype=torch.float32):
    w = {k: t.to(dtype) for k, t in w.items()}
    x = w["emb"][tokens]
    b, t, d = x.shape
    q, k, v = ((x @ w[n]).view(b, t, heads, d // heads).transpose(1, 2)
               for n in ("wq", "wk", "wv"))
    s = (q @ k.transpose(-1, -2)) / (d // heads) ** 0.5
    causal = torch.ones(t, t, dtype=torch.bool).tril()
    p = s.float().masked_fill(~causal, float("-inf")).softmax(-1).to(dtype)
    y = (p @ v).transpose(1, 2).reshape(b, t, d) @ w["wo"]
    return ((x + y) @ w["unemb"]).float()
'''

WORK = '''"""The toy decoder's FLOPs and least bytes a request, from its widths."""


def request_flops(cfg, rows, seq_len):
    d, v = cfg["d_model"], cfg["vocab_size"]
    return float(rows * seq_len * (2 * 4 * d * d + 2 * d * v + 4 * seq_len * d))


def request_bytes(cfg, rows, seq_len):
    d, v = cfg["d_model"], cfg["vocab_size"]
    return float(4 * (2 * v * d + 4 * d * d + rows * seq_len * v) + 8 * rows * seq_len)
'''

KIND = '''"""Toy decode traffic: requests of ``batch`` sequences of ``seq_len`` token
ids, one caller in a closed loop over a pool of ``pool`` batches."""
import torch

from portbench.closed_loop import Pool, drive, request, warm  # noqa: F401

SMALL = {"pool": 2, "warmup_requests": 1}
CONTROL_SECONDS = 1.0


def build(cfg, params, gen, device):
    n, b, t = int(params["pool"]), int(params["batch"]), int(params["seq_len"])
    tokens = torch.randint(0, cfg["vocab_size"], (n, b, t), generator=gen, device=gen.device)
    return Pool(pool=tokens.cpu(), seq_len=t, block=b, warmup=int(params["warmup_requests"]),
                trace_requests=4)
'''

WORKLOAD = {"name": "toy.decode", "config": "toy-lm", "traffic": "toy_decode", "chips": 1,
            "why": "toy decoder, 4 sequences of 12 tokens a request, one closed-loop caller",
            "params": {"pool": 3, "batch": 4, "seq_len": 12, "warmup_requests": 2},
            "limits": {"logits_rel_err": 1e-5}}

FILES = {
    "configs/toy-lm.json": json.dumps(CONFIG),
    "families/toy_lm.py": FAMILY,
    "reference/toy_lm_plain.py": REFERENCE,
    "work/toy_lm.py": WORK,
    "traffic/toy_decode.py": KIND,
    "workloads/toy.decode.json": json.dumps(WORKLOAD),
    "metrics/tokens_per_s.toy.py":
        "def read(run):\n    s = run.samples\n    return s.timesteps / s.window_s if s.timesteps else None\n",
    "metrics/kept_requests.toy.py":
        "def read(run):\n    return float(len(run.trace.kept)) if run.trace else None\n",
}

ENTRIES = {
    "configs": [{"name": "toy-lm", "source": "https://arxiv.org/abs/1706.03762",
                 "file": "portbench/configs/toy-lm.json", "reduced": ["vocab_size"],
                 "why": "a toy decoder that shares no file with the LSTM-AE family"}],
    "workloads": [{k: WORKLOAD[k] for k in ("name", "config", "traffic", "chips", "why")}],
    "end_to_end": [{"name": "tokens_per_s.toy", "unit": "tokens/s", "better": "higher",
                    "bound": 0.05, "source": "host_clock", "workloads": ["toy.decode"]}],
    "per_layer": [{"name": "kept_requests.toy", "unit": "requests", "better": "higher",
                   "source": "device_trace", "layer": "toy attention",
                   "moves": "tokens_per_s.toy", "workloads": ["toy.decode"]}],
}

RUN = '''import json, sys, time
import pytest, torch
from portbench import harness

fault = sys.argv[1]
with pytest.MonkeyPatch.context() as mp:
    if fault:
        wl, cfg = harness.load_cell(harness.read_json(harness.ROOT / "BENCHMARK.json"), "toy.decode")
        harness.load("families", "toy_lm").faults("toy_decode")[fault](mp, cfg, wl["limits"])
    r = harness.run_cell("toy.decode", 2**33 + 9, 0.2, False, torch.device("cpu"), time.perf_counter())
print(json.dumps(r))
'''


def _copy(tmp_path):
    """The benchmark with its tests and BENCHMARK.json, the toy family's files
    and entries added, nothing of it edited; the port's sources beside it, as
    in a checkout."""
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, text in FILES.items():
        path = tmp_path / "portbench" / rel
        assert not path.exists(), rel
        path.write_text(text)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, entries in ENTRIES.items():
        bench[key] += entries
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "src").symlink_to(ROOT / "src", target_is_directory=True)


def _env(tmp_path):
    return dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{tmp_path / 'src'}",
                PYTHONDONTWRITEBYTECODE="1")


def test_a_new_family_kind_and_check_need_only_new_files(tmp_path):
    _copy(tmp_path)
    tests = [f"portbench/tests/test_portbench_{n}.py" for n in ("layout", "faults", "imports")]
    out = subprocess.run([sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
                          "-p", "no:randomly", f"--basetemp={tmp_path / 'pytest'}", *tests],
                         cwd=tmp_path, env=_env(tmp_path),
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    passed = {line.split(" ")[0] for line in out.stdout.splitlines() if " PASSED" in line}
    for case in ("test_portbench_layout.py::test_cell_files_exist_and_agree[toy.decode]",
                 "test_portbench_layout.py::test_config_files[toy-lm]",
                 "test_portbench_layout.py::test_every_metric_has_its_reader[tokens_per_s.toy]",
                 "test_portbench_layout.py::test_every_metric_has_its_reader[kept_requests.toy]",
                 "test_portbench_faults.py::test_a_sound_run_is_correct[toy.decode]",
                 "test_portbench_faults.py::test_a_broken_timed_path_is_not_correct"
                 "[toy.decode-attention_left_out]",
                 "test_portbench_imports.py::test_no_jax_or_jax_package_import[families/toy_lm.py]",
                 "test_portbench_imports.py::test_reference_imports_nothing_of_the_program"
                 "[toy_lm_plain.py]"):
        assert f"portbench/tests/{case}" in passed, case

    results = {}
    for fault in ("", "attention_left_out"):
        run = subprocess.run([sys.executable, "-c", RUN, fault], cwd=tmp_path, env=_env(tmp_path),
                             capture_output=True, text=True, timeout=240)
        assert run.returncode == 0, run.stderr[-3000:]
        results[fault] = json.loads(run.stdout.strip().splitlines()[-1])
    sound, broken = results[""], results["attention_left_out"]
    assert sound["correct"] is True, sound["checks"]
    assert set(sound["checks"]) == {"logits_rel_err", "failed_requests"}
    assert set(sound["metrics"]) == {"setup_s", "tokens_per_s.toy"}
    assert sound["metrics"]["tokens_per_s.toy"]["value"] > 0
    assert broken["correct"] is False
    err = broken["checks"]["logits_rel_err"]
    assert err["value"] > err["limit"]
