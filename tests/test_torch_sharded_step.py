"""The sharded step (DTensor placements over a ``torch.distributed`` mesh)
against the reference's sharded functions.

Ranks are CPU processes (``torch.multiprocessing`` spawn) over gloo,
joined through a ``file://`` store under ``tmp_path``, each spawn joined
with a timeout and its children killed when it fails.  The oracle is the
JAX package's own sharded step on a ``jax.sharding.Mesh`` of the same
shape with Auto axes (``jax.make_mesh`` makes Explicit ones, which the
reference's ``with_sharding_constraint`` refuses), run once per mesh
shape in one subprocess over 8 emulated CPU devices; it writes its states
as checkpoints in the shared on-disk format, and the port's ranks read
their initial params from there.  This module imports no JAX: spawned
ranks import it.

Meshes: (2, 2) ``("data", "model")`` and (2, 1, 2) ``("pod", "data",
"model")``, where ``batch`` is over ``("pod", "data")``.

Bars: two AdamW steps, the second from the reference's state after the
first, each at the port's one-step bar (loss rtol 1e-5; params atol 1e-6,
except elements whose bias-corrected second moment is below 100 AdamW eps,
held to one update's size as in ``tests/test_torch_lm_training.py``), in
f32.  Jamba and Whisper are held to the port's own unsharded step, which
their own files hold to the reference; Jamba's MoE runs ``ep_a2a`` at the
reference EP test's capacity factor 8 (nothing drops, so the per-shard
capacity of the expert-parallel path gives the unsharded function).
Expert-parallel MoE at the reference test's bar (rtol 2e-4, atol 2e-5;
aux rtol 1e-4; ``tests/test_moe_ep.py``).  Under ``int8_ef`` a gradient
a rounding tie apart lands one int8 level away: at most 0.1% of the
elements may flip, as in the unsharded int8 tests.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")
if not dist.is_available() or not dist.is_gloo_available():
    pytest.skip("torch.distributed with gloo is not available", allow_module_level=True)

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.config import TrainConfig, reduced_config  # noqa: E402
from repro_torch.config.core import ModelConfig, MoEConfig  # noqa: E402
from repro_torch.data import LMDataConfig, make_lm_batch  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import build_train_step, init_train_state, train_state_specs  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
SPAWN_TIMEOUT_S = 700
STEP_TC = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10, loss_chunk=8)
B, S = 4, 16
TINY_GRAD = 1e-6
MESHES = {
    "2x2": ((2, 2), ("data", "model")),
    "2x1x2": ((2, 1, 2), ("pod", "data", "model")),
}
# held to the reference's sharded step
CASES = [
    dict(name="tinyllama", arch="tinyllama-1.1b", tc=STEP_TC),
    dict(name="moonshot", arch="moonshot-v1-16b-a3b", impl="ep_a2a", tc=STEP_TC),
    dict(name="rwkv6", arch="rwkv6-7b", tc=STEP_TC),
    dict(name="lstm-ae", arch="lstm-ae-f32-d2",
         tc=dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)),
]
# the global reductions of microbatching and int8 error feedback, on one mesh
VARIANT = dict(name="tinyllama-mb-int8", arch="tinyllama-1.1b",
               tc=dict(STEP_TC, microbatch=2, grad_compression="int8_ef"))
# held to the port's unsharded step
OWN_CASES = [
    dict(name="jamba", arch="jamba-v0.1-52b", impl="ep_a2a", capacity_factor=8.0, tc=STEP_TC),
    dict(name="whisper", arch="whisper-large-v3", tc=STEP_TC),
]


def _cases(mesh_name):
    """The steps held to the reference on a mesh.  None on (2, 1, 2): on a
    mesh of three dims DTensor's redistribute planner (torch 2.13) costs
    each candidate layout of an op by a graph search, and the first
    matmul whose operands disagree over the model axis takes minutes
    (ROADMAP.md, queue 3)."""
    return CASES + [VARIANT] if mesh_name == "2x2" else []


def _own_cases(mesh_name):
    return OWN_CASES if mesh_name == "2x2" else []


# ---------------------------------------------------------------- mechanics

@contextlib.contextmanager
def one_rank_mesh(store_dir, shape=(1, 1), names=("data", "model"), device="cpu"):
    """A process group of this process alone (gloo on the CPU, nccl on a
    GPU) through a file store in ``store_dir``, and a torch ``DeviceMesh``
    of ``shape`` over it; the group is destroyed on exit."""
    from torch.distributed.device_mesh import init_device_mesh

    backend = "nccl" if device == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{Path(store_dir) / 'store'}",
                            rank=0, world_size=1)
    try:
        yield init_device_mesh(device, shape, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def steps_on_one_rank_mesh(api, tc, params, batches, store_dir, device="cpu"):
    """The train step over ``batches`` twice from ``params``: unsharded, and
    on a (1, 1) mesh of this process alone (on ``device``) with the state
    placed by its specs.  Returns ((state, metrics) plain, (state gathered
    whole, metrics) on the mesh)."""
    state = init_train_state(params, tc)
    plain = build_train_step(api, tc)
    for batch in batches:
        state, metrics = plain(state, batch)
    with one_rank_mesh(store_dir, device=device) as mesh:
        rules = sharding.rules_for_mesh(mesh)
        placed = sharding.device_put(init_train_state(params, tc), mesh,
                                     sharding.spec_tree_to_shardings(
                                         mesh, rules, train_state_specs(api, tc)))
        step = build_train_step(api, tc, mesh)
        for batch in batches:
            placed, m_metrics = step(placed, batch)
        whole = dataclasses.replace(
            placed, params=tree_map(_whole, placed.params),
            opt=dataclasses.replace(placed.opt, step=_whole(placed.opt.step),
                                    mu=tree_map(_whole, placed.opt.mu),
                                    nu=tree_map(_whole, placed.opt.nu)),
            ef=None if placed.ef is None else tree_map(_whole, placed.ef))
    return (state, metrics), (whole, m_metrics)


def hold_one_rank_mesh_steps(plain, meshed):
    """The sharded step at the one-step bar: metrics rtol 1e-5, params and
    moments atol 1e-6."""
    (state, metrics), (whole, m_metrics) = plain, meshed
    assert set(metrics) == set(m_metrics)
    for k in metrics:
        np.testing.assert_allclose(float(m_metrics[k]), float(metrics[k]), rtol=1e-5)
    for a, b in zip(tree_leaves(whole.params) + tree_leaves(whole.opt.mu),
                    tree_leaves(state.params) + tree_leaves(state.opt.mu)):
        assert not hasattr(a, "placements")
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0, atol=1e-6)
    assert int(whole.opt.step) == int(state.opt.step)


def _spawn(fn, nprocs, args, timeout_s=SPAWN_TIMEOUT_S):
    """``fn(rank, *args)`` in ``nprocs`` spawned processes; joined with a
    timeout, every child killed if one fails or the time runs out."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def _cfg(case):
    cfg = reduced_config(case["arch"]).with_overrides(compute_dtype="float32")
    if case.get("impl"):
        cfg = cfg.with_overrides(moe=dataclasses.replace(
            cfg.moe, impl=case["impl"], capacity_factor=case.get("capacity_factor",
                                                                 cfg.moe.capacity_factor)))
    return cfg


def _batch(cfg, i):
    """Batch ``i``: the LM pipeline's (which the reference's equals), the
    LSTM-AE's normal series from seed ``i``, Whisper's frames beside."""
    if cfg.family == "lstm_ae":
        rng = np.random.default_rng(i)
        return {"series": torch.from_numpy(rng.standard_normal(
            (B, S, cfg.lstm_ae.input_features)).astype(np.float32))}
    batch = make_lm_batch(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B), i)
    if cfg.family == "whisper":
        rng = np.random.default_rng(100 + i)
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32))
    return batch


def _ckpt(root, name, step) -> Path:
    """Where ``save_checkpoint(root / name, step, ...)`` writes."""
    return Path(root) / name / f"step_{step:08d}"


def _template(case):
    api = build_model(_cfg(case))
    tc = TrainConfig(**case["tc"])
    return api, tc, init_train_state(api.init(torch.Generator().manual_seed(0), "cpu"), tc)


ORACLE = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
from repro.checkpoint import save_checkpoint
from repro.config import TrainConfig, reduced_config
from repro.config.core import ModelConfig, MoEConfig
from repro.data import LMDataConfig, make_lm_batch
from repro.distributed.sharding import mesh_context, rules_for_mesh, spec_tree_to_shardings
from repro.layers.moe import _apply_moe_ep_replicated, apply_moe, apply_moe_ep, init_moe
from repro.models import build_model
from repro.training import build_train_step, init_train_state, train_state_specs

spec = json.loads(sys.argv[1])
out = sys.argv[2]
os.makedirs(out, exist_ok=True)
shape, names = tuple(spec["shape"]), tuple(spec["names"])
n = int(np.prod(shape))
mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape), names)
rules = rules_for_mesh(mesh)
metrics = {}
for case in spec["cases"]:
    cfg = reduced_config(case["arch"]).with_overrides(compute_dtype="float32")
    if case.get("impl"):
        cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, impl=case["impl"]))
    api = build_model(cfg)
    tc = TrainConfig(**case["tc"])
    state = init_train_state(api, jax.random.PRNGKey(0), tc)
    save_checkpoint(os.path.join(out, case["name"]), 0, state)
    sh = spec_tree_to_shardings(mesh, rules, train_state_specs(api, tc))
    step = jax.jit(build_train_step(api, tc, mesh, rules), in_shardings=(sh, None),
                   out_shardings=(sh, None))
    state = jax.device_put(state, sh)
    got = []
    for i in range(2):
        if cfg.family == "lstm_ae":
            rng = np.random.default_rng(i)
            batch = {"series": rng.standard_normal(
                (spec["batch"], spec["seq"], cfg.lstm_ae.input_features)).astype(np.float32)}
        else:
            batch = make_lm_batch(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=spec["seq"],
                                               global_batch=spec["batch"]), i)
        state, m = step(state, {k: jnp.asarray(np.asarray(v)) for k, v in batch.items()})
        got.append({k: float(v) for k, v in m.items()})
        save_checkpoint(os.path.join(out, case["name"]), i + 1, state)
    metrics[case["name"]] = got

cfg = ModelConfig(name="t", family="transformer", num_layers=1, d_model=32, num_heads=4,
                  num_kv_heads=4, d_ff=64, vocab_size=64,
                  moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=8.0, impl="ep_a2a"))
params = init_moe(jax.random.PRNGKey(0), cfg)
x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, 32))
x1 = jax.random.normal(jax.random.PRNGKey(2), (8, 1, 32))

def under(fn):
    def run(p, xx):
        with mesh_context(mesh, rules):
            return fn(p, xx)
    return jax.jit(run)

res = {"x": x, "x1": x1, **{"p_" + k: v for k, v in params.items()}}
for tag, fn, xx in (("moe", lambda p, xx: apply_moe(p, xx, cfg), x),
                    ("ep", lambda p, xx: apply_moe_ep(p, xx, cfg), x),
                    ("moe1", lambda p, xx: apply_moe(p, xx, cfg), x1),
                    ("ep1", lambda p, xx: apply_moe_ep(p, xx, cfg), x1),
                    ("rep1", lambda p, xx: _apply_moe_ep_replicated(p, xx, cfg, mesh, rules),
                     x1)):
    res["y_" + tag], res["aux_" + tag] = under(fn)(params, xx)
np.savez(os.path.join(out, "moe.npz"), **{k: np.asarray(v) for k, v in res.items()})
with open(os.path.join(out, "metrics.json"), "w") as f:
    json.dump(metrics, f)
print("ORACLE_OK")
"""


def _oracle(mesh_name, out: Path) -> subprocess.Popen:
    shape, names = MESHES[mesh_name]
    spec = dict(shape=shape, names=names, batch=B, seq=S,
                cases=[{k: v for k, v in c.items()} for c in _cases(mesh_name)])
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", ORACLE, json.dumps(spec), str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


# ---------------------------------------------------------------- the ranks

def _ranks(rank, world, store, root):
    """One rank over both meshes, one after the other: on (2, 2) what
    needs no oracle first (the port's own cases, the serving steps,
    ``constrain``), then on each mesh, once its oracle is done, the steps
    held to it, the restores and the MoE layer.  Rank 0 writes what the
    test reads."""
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        for mesh_name, (shape, names) in MESHES.items():
            oracle_dir, out_dir = _dirs(root, mesh_name)
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
            report = {}
            for case in _own_cases(mesh_name):
                api, tc, init = _template(case)
                first = _plain_steps(api, tc, init, out_dir, case["name"] + "-plain")
                report[case["name"]] = _sharded_steps(api, tc, (init, first), mesh, out_dir,
                                                      case["name"])
            if mesh_name == "2x2":
                report["serving"] = _serving(mesh, out_dir)
                report["constrain"] = _constrain_placements(mesh)
            _await_oracle(oracle_dir)
            for case in _cases(mesh_name):
                api, tc, template = _template(case)
                starts = [restore_checkpoint(_ckpt(oracle_dir, case["name"], i), template)[0]
                          for i in (0, 1)]
                report[case["name"]] = _sharded_steps(api, tc, starts, mesh, out_dir,
                                                      case["name"])
            report["restore"] = _restores(mesh, _dirs(root, "2x2")[0])
            report["moe"] = _moe(mesh, oracle_dir, out_dir)
            if rank == 0:
                (out_dir / "report.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def _dirs(root, mesh_name) -> tuple[Path, Path]:
    """(oracle dir, port dir) of a mesh."""
    return Path(root) / f"oracle-{mesh_name}", Path(root) / f"port-{mesh_name}"


def _await_oracle(oracle_dir: Path, timeout_s=SPAWN_TIMEOUT_S):
    """Until the oracle has written its last file; its failure (marked by
    the test) or the timeout raises."""
    deadline = time.monotonic() + timeout_s
    while not (oracle_dir / "metrics.json").exists():
        if (oracle_dir / "FAILED").exists():
            raise RuntimeError("the oracle failed")
        if time.monotonic() > deadline:
            raise TimeoutError(f"no oracle after {timeout_s} s")
        time.sleep(0.2)


def _sharded_steps(api, tc, starts, mesh, out_dir, name):
    """A sharded step from each of ``starts`` (step i's start state, plain:
    the first the initial state, the second the oracle's state after
    one step), on batch i; each result saved (gathered, rank 0 writes)."""
    rules = sharding.rules_for_mesh(mesh)
    specs = train_state_specs(api, tc)
    step = build_train_step(api, tc, mesh, rules)
    metrics = []
    for i, start in enumerate(starts):
        state = sharding.device_put(start, mesh,
                                    sharding.spec_tree_to_shardings(mesh, rules, specs))
        state, m = step(state, _batch(api.cfg, i))
        metrics.append({k: float(v) for k, v in m.items()})
        save_checkpoint(Path(out_dir) / name, i + 1, state)
    # each param and moment keeps its spec's placements
    want = sharding.spec_tree_to_shardings(mesh, rules, specs)
    kept = all(tuple(t.placements) == tuple(p) for t, p in zip(
        tree_leaves(state.params) + tree_leaves(state.opt.mu),
        _placement_leaves(want.params) + _placement_leaves(want.opt.mu)))
    return {"metrics": metrics, "placements_kept": kept}


def _placement_leaves(tree):
    """The placement tuples of a shardings tree in ``tree_leaves`` order."""
    if sharding.is_placements(tree):
        return [tree]
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _placement_leaves(tree[k])]
    return [p for v in tree for p in _placement_leaves(v)]


def _plain_steps(api, tc, init, out_dir, name):
    """Two unsharded steps from ``init``, each saved (rank 0 writes); the
    state after the first."""
    step = build_train_step(api, tc)
    state = init
    metrics, states = [], []
    for i in range(2):
        state, m = step(state, _batch(api.cfg, i))
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(state)
        save_checkpoint(Path(out_dir) / name, i + 1, state)
    if dist.get_rank() == 0:
        (Path(out_dir) / f"{name}.json").write_text(json.dumps(metrics))
    return states[0]


def _restores(mesh, oracle_dir):
    """A checkpoint the reference wrote, restored onto the mesh: every leaf
    a DTensor with its spec's placements, equal to the plain restore."""
    rules = sharding.rules_for_mesh(mesh)
    ok = True
    for case in CASES:
        api, tc, template = _template(case)
        path = _ckpt(oracle_dir, case["name"], 2)
        specs = train_state_specs(api, tc)
        placed, meta = restore_checkpoint(path, template, mesh=mesh, spec_tree=specs)
        plain, _ = restore_checkpoint(path, template)
        want = sharding.spec_tree_to_shardings(mesh, rules, specs)
        for got, ref, pl in zip(tree_leaves(placed.params) + tree_leaves(placed.opt.nu),
                                tree_leaves(plain.params) + tree_leaves(plain.opt.nu),
                                _placement_leaves(want.params) + _placement_leaves(want.opt.nu)):
            ok &= tuple(got.placements) == tuple(pl) and torch.equal(got.full_tensor(), ref)
        ok &= meta["step"] == 2 and int(placed.opt.step.full_tensor()) == 2
    return ok


def _moe_cfg(impl="ep_a2a"):
    return ModelConfig(name="t", family="transformer", num_layers=1, d_model=32, num_heads=4,
                       num_kv_heads=4, d_ff=64, vocab_size=64,
                       moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=8.0, impl=impl))


def _moe(mesh, oracle_dir, out_dir):
    """``apply_moe_ep`` (S=16 and the S=1 fallback) and
    ``_apply_moe_ep_replicated`` under the mesh, their values and the grads
    of sum(y**2) + 10 aux; beside them the port's unsharded ``apply_moe``."""
    from repro_torch.layers import moe as tmoe

    ref = np.load(Path(oracle_dir) / "moe.npz")
    cfg = _moe_cfg()
    out = {}

    def run(fn, x_np, sharded):
        params = {k: torch.from_numpy(ref["p_" + k].copy()).requires_grad_(True)
                  for k in ("router", "gate", "up", "down")}
        x = torch.from_numpy(x_np.copy()).requires_grad_(True)
        # the backward too mixes plain tensors with DTensors: under the mesh
        with sharding.mesh_context(mesh if sharded else None):
            y, aux = fn(params, x, cfg)
            y = y.full_tensor() if sharded else y
            aux = aux.full_tensor() if sharded else aux
            loss = torch.sum(torch.square(y)) + 10.0 * aux
            grads = torch.autograd.grad(loss, [params[k] for k in sorted(params)] + [x])
        # a plain leaf read by a DTensor op gets a DTensor grad
        return [y.detach(), aux.detach()] + [_whole(g) for g in grads]

    for tag, fn, x_np in (("ep", tmoe.apply_moe_ep, ref["x"]), ("ep1", tmoe.apply_moe_ep, ref["x1"]),
                          ("rep1", tmoe._apply_moe_ep_replicated, ref["x1"])):
        got = run(fn, x_np, True)
        plain = run(tmoe.apply_moe, x_np, False)
        for i, (a, b) in enumerate(zip(got, plain)):
            out[f"{tag}_{i}"] = a.numpy()
            out[f"{tag}_plain_{i}"] = b.numpy()
    if dist.get_rank() == 0:
        np.savez(Path(out_dir) / "moe_port.npz", **out)
    return True


def _serving(mesh, out_dir):
    """Prefill and one decode step of reduced tinyllama under the mesh
    (params and the decode cache placed by their specs), beside the
    unsharded ones.  Both decodes start from the unsharded prefill's cache
    (bf16: a K/V one f32 ulp apart may round a bf16 ulp apart)."""
    from repro_torch.serving import build_decode_step, build_prefill_step

    cfg = reduced_config("tinyllama-1.1b").with_overrides(compute_dtype="float32")
    api = build_model(cfg)
    params = api.init(torch.Generator().manual_seed(3), "cpu")
    rules = sharding.rules_for_mesh(mesh)
    placed = sharding.device_put(params, mesh,
                                 sharding.spec_tree_to_shardings(mesh, rules, api.param_specs()))
    batch = {"tokens": _batch(cfg, 0)["tokens"]}
    plain_logits, plain_cache = build_prefill_step(api)(params, batch)
    token = torch.argmax(plain_logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
    out = {}
    for tag, p, m in (("mesh", placed, mesh), ("plain", params, None)):
        logits, cache = build_prefill_step(api, m)(p, batch)
        dec = api.stitch(plain_cache, S + 4)
        if m is not None:
            dec = sharding.device_put(dec, mesh, sharding.spec_tree_to_shardings(
                mesh, rules, api.cache_specs()))
        d_logits, dec = build_decode_step(api, m)(p, token, dec,
                                                  torch.tensor(S, dtype=torch.int32))
        out.update({f"{tag}_{name}": _whole(t).float().numpy() for name, t in (
            ("prefill", logits), ("k", cache["k"]), ("v", cache["v"]), ("decode", d_logits),
            ("cache_k", dec["k"]), ("cache_v", dec["v"]))})
    if dist.get_rank() == 0:
        np.savez(Path(out_dir) / "serving.npz", **out)
    return True


def _whole(t):
    """A DTensor gathered whole (every rank joins); a plain tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _constrain_placements(mesh):
    """``constrain`` under the mesh: the placements ``named_sharding``
    names, the local block of a plain (replicated) input, both ways
    differentiable."""
    from torch.distributed.tensor import Replicate, Shard

    rules = sharding.rules_for_mesh(mesh)
    x = torch.arange(4 * 6 * 2, dtype=torch.float32).reshape(4, 6, 2).requires_grad_(True)
    with sharding.mesh_context(mesh, rules):
        y = sharding.constrain(x, ("batch", "sp", None))
        z = sharding.constrain(y, ("batch", None, "tp"))
    ok = tuple(y.placements) == (Shard(0), Shard(1)) == sharding.named_sharding(
        mesh, rules, ("batch", "sp", None))
    ok &= tuple(z.placements) == (Shard(0), Shard(2))
    ok &= tuple(y.to_local().shape) == (2, 3, 2)
    r, c = mesh.get_coordinate()
    ok &= torch.equal(y.to_local(), x.detach()[2 * r:2 * r + 2, 3 * c:3 * c + 3])
    (g,) = torch.autograd.grad(z.full_tensor().sum(), [x])
    ok &= torch.equal(g, torch.ones_like(x))
    ok &= tuple(sharding.replicated(mesh)) == (Replicate(), Replicate())
    return bool(ok)


# ---------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both meshes' oracles beside one group of 4 ranks, which takes the
    meshes in turn and waits for an oracle where it needs one: {mesh name:
    (oracle dir, port dir)}."""
    pytest.importorskip("jax")
    import threading

    root = tmp_path_factory.mktemp("sharded")
    dirs = {m: _dirs(root, m) for m in MESHES}
    for _, port in dirs.values():
        port.mkdir()
    errors = []

    def ranks():
        try:
            _spawn(_ranks, 4, (4, str(root / "store"), str(root)))
        except BaseException as e:  # raised below, once the thread is joined
            errors.append(e)

    procs = {m: _oracle(m, d[0]) for m, d in dirs.items()}
    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        for m, p in procs.items():
            log, _ = p.communicate(timeout=SPAWN_TIMEOUT_S)
            if p.returncode != 0 or "ORACLE_OK" not in log:
                dirs[m][0].mkdir(parents=True, exist_ok=True)
                (dirs[m][0] / "FAILED").write_text(log[-4000:])
                errors.insert(0, AssertionError(f"oracle {m} failed:\n{log[-4000:]}"))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        thread.join()
    if errors:
        raise errors[0]
    return dirs


def _report(runs, mesh_name):
    return json.loads((runs[mesh_name][1] / "report.json").read_text())


# ---------------------------------------------------------------- the tests

def _hold_states(port_root, ref_root, name, ref_name=None, keep=None):
    """Each step (both from the same state) at the one-step bar: first
    moments at the train loss's grad bar (rtol 1e-4, atol 1e-6), params at
    atol 1e-6.  AdamW's update is m / (sqrt(v) + eps), bias-corrected:
    where the reference's sqrt(v) is below ``TINY_GRAD`` (100 eps; on a
    first step that is |g|) it turns on the grads' last bits, so such an
    element is held to one update's size, 2 lr."""
    lr = STEP_TC["learning_rate"]
    beta2 = TrainConfig().beta2
    template = _template(next(c for c in CASES + [VARIANT] + OWN_CASES if c["name"] == name))[2]
    for step in (1, 2):
        state = restore_checkpoint(_ckpt(port_root, name, step), template)[0]
        want = restore_checkpoint(_ckpt(ref_root, ref_name or name, step), template)[0]
        assert int(state.opt.step) == int(want.opt.step) == step
        for n, (p, jp, mu, jmu, jnu) in enumerate(zip(
                tree_leaves(state.params), tree_leaves(want.params), tree_leaves(state.opt.mu),
                tree_leaves(want.opt.mu), tree_leaves(want.opt.nu))):
            mask = np.ones(p.shape, bool) if keep is None else keep[n]
            p, jp, mu, jmu, jnu = (t.float().numpy() for t in (p, jp, mu, jmu, jnu))
            np.testing.assert_allclose(mu[mask], jmu[mask], rtol=1e-4, atol=1e-6)
            tiny = np.sqrt(jnu / (1 - beta2 ** step)) < TINY_GRAD
            diff = np.abs(p - jp)
            assert diff[mask & ~tiny].max(initial=0.0) <= 1e-6, (name, step, n)
            assert diff[mask & tiny].max(initial=0.0) <= 2 * lr, (name, step, n)
    return state, want


def _hold_metrics(got, want):
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_sharded_train_step_matches_reference(runs, case):
    oracle, port = runs["2x2"]
    report = _report(runs, "2x2")[case["name"]]
    assert report["placements_kept"]
    want = json.loads((oracle / "metrics.json").read_text())[case["name"]]
    _hold_metrics(report["metrics"], want)
    _hold_states(port, oracle, case["name"])     # the port's saves were sharded


def test_sharded_microbatch_int8_step_matches_reference(runs):
    """microbatch=2 and int8_ef together: the mean over microbatches and
    each leaf's int8 scale over the whole leaf, not one shard."""
    oracle, port = runs["2x2"]
    report = _report(runs, "2x2")[VARIANT["name"]]
    want = json.loads((oracle / "metrics.json").read_text())[VARIANT["name"]]
    _hold_metrics(report["metrics"], want)
    _, _, template = _template(VARIANT)
    state, _ = restore_checkpoint(_ckpt(port, VARIANT["name"], 2), template)
    ref, _ = restore_checkpoint(_ckpt(oracle, VARIANT["name"], 2), template)
    flips = [np.abs(e.numpy() - je.numpy()) > 1e-7
             for e, je in zip(tree_leaves(state.ef), tree_leaves(ref.ef))]
    assert sum(int(f.sum()) for f in flips) <= 1e-3 * sum(f.size for f in flips)
    _hold_states(port, oracle, VARIANT["name"], keep=[~f for f in flips])
    assert sum(float(e.abs().sum()) for e in tree_leaves(state.ef)) > 0


@pytest.mark.parametrize("case", OWN_CASES, ids=[c["name"] for c in OWN_CASES])
def test_sharded_train_step_matches_unsharded(runs, case):
    _, port = runs["2x2"]
    report = _report(runs, "2x2")[case["name"]]
    assert report["placements_kept"]
    plain = json.loads((port / f"{case['name']}-plain.json").read_text())
    _hold_metrics(report["metrics"], plain)
    _hold_states(port, port, case["name"], ref_name=case["name"] + "-plain")


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_reference_checkpoint_restores_onto_the_mesh(runs, mesh_name):
    assert _report(runs, mesh_name)["restore"]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("tag", ["ep", "ep1", "rep1"])
def test_expert_parallel_moe(runs, mesh_name, tag):
    """``apply_moe_ep`` (S=16 over the model axis; S=1 falls back to
    ``apply_moe``) and ``_apply_moe_ep_replicated`` against the reference's
    ``apply_moe`` and its own sharded function, and their grads, through
    every all_to_all, all_gather and sum, against the unsharded grads."""
    oracle, port = runs[mesh_name]
    ref = np.load(oracle / "moe.npz")
    got = np.load(port / "moe_port.npz")
    plain_tag = "moe" if tag == "ep" else "moe1"
    for y_want in (ref[f"y_{plain_tag}"], ref[f"y_{tag}"]):
        np.testing.assert_allclose(got[f"{tag}_0"], y_want, rtol=2e-4, atol=2e-5)
    for aux_want in (ref[f"aux_{plain_tag}"], ref[f"aux_{tag}"]):
        np.testing.assert_allclose(float(got[f"{tag}_1"]), float(aux_want), rtol=1e-4)
    for i in range(2, 7):            # router, down, gate, up, x
        np.testing.assert_allclose(got[f"{tag}_{i}"], got[f"{tag}_plain_{i}"],
                                   rtol=2e-4, atol=2e-5)
        assert np.abs(got[f"{tag}_{i}"]).sum() > 0


def test_serving_steps_under_the_mesh_equal_unsharded(runs):
    _, port = runs["2x2"]
    assert _report(runs, "2x2")["serving"]
    got = np.load(port / "serving.npz")
    for name in ("prefill", "k", "v", "decode", "cache_k", "cache_v"):
        np.testing.assert_allclose(got[f"mesh_{name}"], got[f"plain_{name}"],
                                   rtol=1e-5, atol=1e-5)


def test_constrain_under_a_mesh_places_by_named_sharding(runs):
    assert _report(runs, "2x2")["constrain"]


# ---------------------------------------------------------------- in-process

def test_constrain_without_a_mesh_returns_its_input():
    x = torch.zeros(2, 3)
    assert sharding.constrain(x, ("batch", None)) is x
    with sharding.mesh_context(None):
        assert sharding.constrain(x, ("batch", "tp")) is x


def test_named_sharding_refuses_axes_out_of_mesh_order(tmp_path):
    """Placements by mesh axis, a dim over several axes nested in mesh
    order (the names and sizes of the engine's mesh of 8 CPU cells: no
    process group needed), an axis of size 1 as Replicate; axes out of
    order, an axis named twice or one the mesh lacks raise, also from
    ``constrain`` under a torch mesh."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.engine.placement import make_mesh

    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), ["cpu"] * 8)
    rules = sharding.rules_for_mesh(mesh)
    assert rules.batch == ("pod", "data")
    assert sharding.named_sharding(mesh, rules, ("batch", "tp")) == (
        Shard(0), Shard(0), Shard(1))
    assert sharding.named_sharding(mesh, rules, ("tokens", None)) == (Shard(0),) * 3
    assert sharding.named_sharding(mesh, rules, (None, "fsdp")) == (
        Replicate(), Shard(1), Replicate())
    assert sharding.named_sharding(mesh, rules, (None, None)) == (Replicate(),) * 3
    thin = make_mesh((2, 1, 2), ("pod", "data", "model"), ["cpu"] * 4)
    assert sharding.named_sharding(thin, rules, ("batch", "tp")) == (
        Shard(0), Replicate(), Shard(1))
    backwards = sharding.ShardingRules(batch=("data", "pod"))
    with pytest.raises(ValueError, match="out of the mesh's order"):
        sharding.named_sharding(mesh, backwards, ("batch", None))
    with pytest.raises(ValueError, match="twice"):
        sharding.named_sharding(mesh, rules, ("tp", "sp"))
    with pytest.raises(ValueError, match="not one of the mesh's"):
        sharding.named_sharding(mesh, sharding.ShardingRules(tp="expert_axis"), ("tp",))
    with one_rank_mesh(tmp_path, (1, 1, 1), ("pod", "data", "model")) as torch_mesh:
        with sharding.mesh_context(torch_mesh, backwards):
            with pytest.raises(ValueError, match="out of the mesh's order"):
                sharding.constrain(torch.zeros(2, 2), ("batch", None))


def test_production_mesh_needs_its_ranks_and_pick_mesh_follows_the_world(monkeypatch):
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as train_launcher

    assert mesh_mod.world_size() == 1
    for multi_pod, need in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"needs {need} ranks but the process group has 1"):
            mesh_mod.make_production_mesh(multi_pod=multi_pod, device="cpu")
    built = []
    monkeypatch.setattr(train_launcher, "make_production_mesh",
                        lambda **kw: built.append(kw) or "mesh")
    for n, want in ((1, None), (255, None), (256, "mesh"), (511, "mesh"), (512, "mesh")):
        monkeypatch.setattr(train_launcher, "world_size", lambda n=n: n)
        assert train_launcher.pick_mesh("cpu") == want
    assert [kw["multi_pod"] for kw in built] == [False, False, True]


SITE_ARCHS = ["tinyllama-1.1b", "phi-3-vision-4.2b", "moonshot-v1-16b-a3b", "rwkv6-7b",
              "jamba-v0.1-52b", "whisper-large-v3", "lstm-ae-f32-d2"]
SITE_MODULES = ["layers.embeddings", "layers.mlp", "layers.attention", "layers.rwkv",
                "layers.mamba", "layers.moe", "models.transformer", "models.jamba",
                "models.rwkv6", "models.whisper"]


def _recording(monkeypatch, package, seen):
    import importlib

    def record(x, logical_axes):
        seen.append(tuple(logical_axes))
        return x
    for name in SITE_MODULES:
        monkeypatch.setattr(importlib.import_module(f"{package}.{name}"), "constrain", record)


def _python_scan(f, init, xs=None, length=None, **_):
    """``lax.scan`` as a Python loop, so that tracing calls the body once
    per step, as the port's loops do."""
    import jax

    n = length if xs is None else jax.tree.leaves(xs)[0].shape[0]
    carry, ys = init, []
    for i in range(n):
        carry, y = f(carry, None if xs is None else jax.tree.map(lambda a: a[i], xs))
        ys.append(y)
    return carry, jax.tree.map(lambda *a: jax.numpy.stack(a), *ys) if ys else None


@pytest.mark.parametrize("arch", SITE_ARCHS)
def test_constrain_sites_match_the_reference(monkeypatch, arch):
    """Over the loss's forward, a prefill and a decode step of each
    family's reduced config, the logical specs ``constrain`` receives, in
    order, are the reference's: no site missing or extra.  The reference
    is traced (``jax.make_jaxpr``) with its scans as Python loops, one call
    a layer and a chunk, as the port's loops make them.  Whisper's decode
    is left out: at decode the reference projects the cross-attention's
    K/V of the token and never reads them, and pins both; the port does
    not compute them (``decode_attention(update_cache=False)``)."""
    jax = pytest.importorskip("jax")
    from repro.models import build_model as jax_build_model
    from repro.config import reduced_config as jax_reduced_config

    cfg = reduced_config(arch)
    rng = np.random.default_rng(0)
    b, s = 2, 8
    batch = {"tokens": rng.integers(0, max(cfg.vocab_size, 2), (b, s)).astype(np.int32),
             "labels": rng.integers(0, max(cfg.vocab_size, 2), (b, s)).astype(np.int32)}
    if cfg.family == "lstm_ae":
        batch = {"series": rng.standard_normal((b, s, cfg.lstm_ae.input_features))
                 .astype(np.float32)}
    if cfg.family == "whisper":
        batch["frames"] = rng.standard_normal((b, cfg.encoder_seq_len, cfg.d_model)
                                              ).astype(np.float32)
    if cfg.frontend == "vision_stub":
        batch["image_embeds"] = rng.standard_normal((b, cfg.vision_patches, cfg.d_model)
                                                    ).astype(np.float32)

    theirs, ours = [], []
    _recording(monkeypatch, "repro", theirs)
    _recording(monkeypatch, "repro_torch", ours)
    monkeypatch.setattr(jax.lax, "scan", _python_scan)
    japi = jax_build_model(jax_reduced_config(arch))
    jparams = jax.eval_shape(japi.init, jax.random.PRNGKey(0))
    jb = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()}
    # jax.checkpoint traces its body once: the loss without remat
    jax.make_jaxpr(lambda p, bb: japi.loss(p, bb, remat=False))(jparams, jb)
    jax.make_jaxpr(japi.prefill)(jparams, jb)
    api = build_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        api.loss(params, tb, remat=False)
        api.prefill(params, tb)
    assert ours == theirs
    if cfg.family in ("lstm_ae", "whisper"):
        return
    theirs.clear()
    ours.clear()
    token = np.zeros((b, 1), np.int32)
    jax.make_jaxpr(japi.decode)(jparams, jax.ShapeDtypeStruct(token.shape, token.dtype),
                                jax.eval_shape(lambda: japi.init_cache(b, s + 2)),
                                jax.ShapeDtypeStruct((), np.int32))
    with torch.no_grad():
        api.decode(params, torch.from_numpy(token), api.init_cache(b, s + 2, device="cpu"),
                   torch.tensor(0, dtype=torch.int32))
    assert ours == theirs and ours
