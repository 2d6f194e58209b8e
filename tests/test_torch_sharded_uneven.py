"""The sharded step where the mesh's axes do not divide what they shard:
attention heads fewer than the model axis, MoE tokens and a decode batch
fewer than the ranks, against the reference's own sharded functions.

The production mesh's model axis of 16 is wider than most archs' kv heads
(tinyllama has 4, Jamba and internlm2 8), and at decode its 256 ranks
outnumber the tokens (128) and long_500k's batch of 1.  XLA pads such an
uneven shard; DTensor refuses to reshape it.  Here at a reduced size:

- reduced tinyllama-1.1b (8 heads, 2 kv heads) trained two steps on a
  (1, 4) ``("data", "model")`` mesh, each from the reference's state, at
  ``tests/test_torch_sharded_step.py``'s bars (loss, grad norm and lr
  rtol 1e-5; params atol 1e-6, except elements whose bias-corrected
  second moment is below 100 AdamW eps, held to one update's size; first
  moments rtol 1e-4 / atol 1e-6);
- a decode step at B=1 on a (2, 2) mesh of reduced jamba-v0.1-52b (Mamba
  state, attention, MoE of 4 experts) and reduced moonshot-v1-16b-a3b
  (MoE every layer): one token over four ranks, a batch of 1 over a data
  axis of 2.  Logits and the written state at the f32 decode bar of
  ``tests/test_torch_jamba.py`` (rtol 1e-4, atol 1e-4); a state leaf the
  cache keeps in bf16 (Jamba's conv history) within one bf16 rounding
  (rtol 2^-7).  The decode state
  is placed by its specs with the dims the axes do not divide replicated
  (the dry run's ``_sanitize``; ``jax.device_put`` refuses such a shard).

The oracle is the reference's step jitted on a ``jax.sharding.Mesh`` of
Auto axes over 8 emulated CPU devices, in a subprocess; it writes its
states in the shared checkpoint format.  Ranks are gloo CPU processes, as
in ``tests/test_torch_sharded_step.py``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")
if not dist.is_available() or not dist.is_gloo_available():
    pytest.skip("torch.distributed with gloo is not available", allow_module_level=True)

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.config import TrainConfig, reduced_config  # noqa: E402
from repro_torch.data import LMDataConfig, make_lm_batch  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import build_train_step, init_train_state, train_state_specs  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
TIMEOUT_S = 600
TC = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10, loss_chunk=8)
B, S = 4, 16
TINY_GRAD = 1e-6
TRAIN = dict(name="tinyllama", arch="tinyllama-1.1b", shape=(1, 4))
DECODE = [dict(name="jamba", arch="jamba-v0.1-52b", shape=(2, 2)),
          dict(name="moonshot", arch="moonshot-v1-16b-a3b", shape=(2, 2))]
MAX_LEN, CACHE_LEN, TOKEN = 8, 3, 7

ORACLE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
from repro.checkpoint import save_checkpoint
from repro.config import TrainConfig, reduced_config
from repro.data import LMDataConfig, make_lm_batch
from repro.distributed.sharding import rules_for_mesh, spec_tree_to_shardings
from repro.models import build_model
from repro.serving import build_decode_step
from repro.training import build_train_step, init_train_state, train_state_specs

spec = json.loads(sys.argv[1])
out = sys.argv[2]
def mesh_of(shape):
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))

t = spec["train"]
mesh = mesh_of(t["shape"])
rules = rules_for_mesh(mesh)
cfg = reduced_config(t["arch"]).with_overrides(compute_dtype="float32")
api = build_model(cfg)
tc = TrainConfig(**spec["tc"])
state = init_train_state(api, jax.random.PRNGKey(0), tc)
save_checkpoint(os.path.join(out, t["name"]), 0, state)
sh = spec_tree_to_shardings(mesh, rules, train_state_specs(api, tc))
step = jax.jit(build_train_step(api, tc, mesh, rules), in_shardings=(sh, None),
               out_shardings=(sh, None))
state = jax.device_put(state, sh)
metrics = []
for i in range(2):
    batch = make_lm_batch(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=spec["seq"],
                                       global_batch=spec["batch"]), i)
    state, m = step(state, {k: jnp.asarray(np.asarray(v)) for k, v in batch.items()})
    metrics.append({k: float(v) for k, v in m.items()})
    save_checkpoint(os.path.join(out, t["name"]), i + 1, state)
with open(os.path.join(out, "train.json"), "w") as f:
    json.dump(metrics, f)

for d in spec["decode"]:
    mesh = mesh_of(d["shape"])
    cfg = reduced_config(d["arch"]).with_overrides(compute_dtype="float32")
    api = build_model(cfg)
    state = init_train_state(api, jax.random.PRNGKey(1), TrainConfig())
    save_checkpoint(os.path.join(out, d["name"]), 0, state)
    cache = api.init_cache(1, spec["max_len"])
    token = jnp.full((1, 1), spec["token"], jnp.int32)
    logits, cache = jax.jit(build_decode_step(api, mesh))(state.params, token, cache,
                                                         jnp.int32(spec["cache_len"]))
    save_checkpoint(os.path.join(out, d["name"] + "-cache"), 1, cache)
    np.save(os.path.join(out, d["name"] + "-logits.npy"), np.asarray(logits))
print("ORACLE_OK")
"""


def _cfg(arch):
    return reduced_config(arch).with_overrides(compute_dtype="float32")


def _ckpt(root, name, step) -> Path:
    return Path(root) / name / f"step_{step:08d}"


def _template(arch, tc=None):
    api = build_model(_cfg(arch))
    tc = tc or TrainConfig(**TC)
    return api, tc, init_train_state(api.init(torch.Generator().manual_seed(0), "cpu"), tc)


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _sanitize(shardings, struct, mesh):
    """Each leaf's placements with the dims its mesh axes do not divide
    replicated (the dry run's ``_sanitize``, written out here)."""
    from torch.distributed.tensor import Replicate, Shard

    def fix(t, placements):
        over = {}
        for p, n in zip(placements, mesh.shape):
            if isinstance(p, Shard):
                over[p.dim] = over.get(p.dim, 1) * int(n)
        return tuple(Replicate() if isinstance(p, Shard) and t.shape[p.dim] % over[p.dim] else p
                     for p in placements)

    return sharding._zip_shardings(fix, struct, shardings)


def _ranks(rank, world, store, oracle_dir, out_dir):
    """Each rank: the train steps on (1, 4), then the decode steps on (2, 2),
    each part on its own: a part that raises leaves ``<name>.error`` (rank
    0 writes) and the next part runs.  Rank 0 writes what the tests read."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        for name, part in [(TRAIN["name"], lambda: _train(rank, oracle_dir, out_dir))] + [
                (c["name"], lambda c=c: _decode(rank, c, oracle_dir, out_dir)) for c in DECODE]:
            try:
                part()
            except Exception as e:  # the part's test reports it
                if rank == 0:
                    (Path(out_dir) / f"{name}.error").write_text(f"{type(e).__name__}: {e}")
            dist.barrier()
    finally:
        dist.destroy_process_group()


def _train(rank, oracle_dir, out_dir):
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", TRAIN["shape"], mesh_dim_names=("data", "model"))
    rules = sharding.rules_for_mesh(mesh)
    api, tc, template = _template(TRAIN["arch"])
    specs = sharding.spec_tree_to_shardings(mesh, rules, train_state_specs(api, tc))
    step = build_train_step(api, tc, mesh, rules)
    metrics = []
    for i in range(2):
        start = restore_checkpoint(_ckpt(oracle_dir, TRAIN["name"], i), template)[0]
        state = sharding.device_put(start, mesh, specs)
        batch = make_lm_batch(LMDataConfig(vocab_size=api.cfg.vocab_size, seq_len=S,
                                           global_batch=B), i)
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        save_checkpoint(Path(out_dir) / TRAIN["name"], i + 1, state)
    if rank == 0:
        (Path(out_dir) / "train.json").write_text(json.dumps(metrics))


def _decode(rank, case, oracle_dir, out_dir):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.serving import build_decode_step

    mesh = init_device_mesh("cpu", case["shape"], mesh_dim_names=("data", "model"))
    rules = sharding.rules_for_mesh(mesh)
    api, _, template = _template(case["arch"], TrainConfig())
    params = restore_checkpoint(_ckpt(oracle_dir, case["name"], 0), template)[0].params
    params = sharding.device_put(params, mesh, _sanitize(
        sharding.spec_tree_to_shardings(mesh, rules, api.param_specs()), params, mesh))
    cache = api.init_cache(1, MAX_LEN, device="cpu")
    cache = sharding.device_put(cache, mesh, _sanitize(
        sharding.spec_tree_to_shardings(mesh, rules, api.cache_specs()), cache, mesh))
    token = torch.full((1, 1), TOKEN, dtype=torch.int32)
    logits, cache = build_decode_step(api, mesh, rules)(
        params, token, cache, torch.tensor(CACHE_LEN, dtype=torch.int32))
    whole = tree_map(_whole, cache)
    logits = _whole(logits)
    if rank == 0:
        np.save(Path(out_dir) / f"{case['name']}-logits.npy", logits.numpy())
        torch.save(whole, Path(out_dir) / f"{case['name']}-cache.pt")


def _part_ok(port_dir, name):
    error = Path(port_dir) / f"{name}.error"
    assert not error.exists(), error.read_text()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The oracle, then the 4 ranks from its states: (oracle dir, port dir)."""
    pytest.importorskip("jax")
    from test_torch_sharded_step import _spawn

    root = tmp_path_factory.mktemp("uneven")
    oracle_dir, port_dir = root / "oracle", root / "port"
    port_dir.mkdir()
    spec = dict(train=TRAIN, decode=DECODE, tc=TC, batch=B, seq=S, max_len=MAX_LEN,
                token=TOKEN, cache_len=CACHE_LEN)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", ORACLE, json.dumps(spec), str(oracle_dir)],
                         env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert out.returncode == 0 and "ORACLE_OK" in out.stdout, out.stderr[-4000:]
    errors = []
    thread = threading.Thread(target=lambda: _catch(errors, _spawn, _ranks, 4, (
        4, str(root / "store"), str(oracle_dir), str(port_dir)), TIMEOUT_S))
    thread.start()
    thread.join()
    if errors:
        raise errors[0]
    return oracle_dir, port_dir


def _catch(errors, fn, *args):
    try:
        fn(*args)
    except BaseException as e:  # raised in the fixture, once the thread is joined
        errors.append(e)


def test_attention_with_fewer_kv_heads_than_the_model_axis(runs):
    """2 kv heads over a model axis of 4: two train steps, each from the
    reference's state, held to the reference's sharded step."""
    oracle_dir, port_dir = runs
    _part_ok(port_dir, TRAIN["name"])
    got = json.loads((port_dir / "train.json").read_text())
    want = json.loads((oracle_dir / "train.json").read_text())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5)
    _, _, template = _template(TRAIN["arch"])
    for step in (1, 2):
        state = restore_checkpoint(_ckpt(port_dir, TRAIN["name"], step), template)[0]
        ref = restore_checkpoint(_ckpt(oracle_dir, TRAIN["name"], step), template)[0]
        assert int(state.opt.step) == int(ref.opt.step) == step
        for p, jp, mu, jmu, jnu in zip(tree_leaves(state.params), tree_leaves(ref.params),
                                       tree_leaves(state.opt.mu), tree_leaves(ref.opt.mu),
                                       tree_leaves(ref.opt.nu)):
            np.testing.assert_allclose(mu.numpy(), jmu.numpy(), rtol=1e-4, atol=1e-6)
            # AdamW's update m / (sqrt(v) + eps) turns on a grad's last bits
            # where sqrt(v) is below 100 eps: such an element is held to one
            # update's size, 2 lr (tests/test_torch_sharded_step.py)
            tiny = np.sqrt(jnu.numpy() / (1 - TrainConfig().beta2 ** step)) < TINY_GRAD
            diff = np.abs(p.numpy() - jp.numpy())
            assert diff[~tiny].max(initial=0.0) <= 1e-6, (step, diff[~tiny].max())
            assert diff[tiny].max(initial=0.0) <= 2 * TC["learning_rate"], step


@pytest.mark.parametrize("case", DECODE, ids=[c["name"] for c in DECODE])
def test_decode_of_one_token_over_more_ranks(runs, case):
    """A decode step at B=1 on (2, 2): the MoE's one token over four ranks,
    Jamba's Mamba state and KV cache with a batch of 1 over a data axis of
    2; logits and every written state leaf held to the reference's."""
    oracle_dir, port_dir = runs
    _part_ok(port_dir, case["name"])
    got = np.load(port_dir / f"{case['name']}-logits.npy")
    want = np.load(oracle_dir / f"{case['name']}-logits.npy")
    assert got.shape == want.shape == (1, 1, _cfg(case["arch"]).vocab_size)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    cache = torch.load(port_dir / f"{case['name']}-cache.pt")
    template = tree_map(lambda t: t.clone(), cache)
    ref = restore_checkpoint(_ckpt(oracle_dir, case["name"] + "-cache", 1), template)[0]
    leaves = list(zip(tree_leaves(cache), tree_leaves(ref)))
    assert leaves
    for a, b in leaves:
        # a state kept in bf16 (the conv history) stores f32 values one
        # rounding apart: one bf16 ulp, 2^-8 of the value
        rtol = 2.0 ** -7 if a.dtype == torch.bfloat16 else 1e-4
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=rtol, atol=1e-4)
