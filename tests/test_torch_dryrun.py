"""The port's dry-run cells (``repro_torch.launch.dryrun``) against the
reference's: the CLI's cells, ``_sanitize`` and ``_batch_shardings`` over
DTensor placements, the records a cell writes, and per-chip FLOPs beside
the reference's own compiled cells.

The oracle is the reference's ``run_cell`` in a subprocess, on a
``jax.sharding.Mesh`` of Auto axes over its 512 host devices (its own
``make_production_mesh`` makes Explicit axes, which its
``with_sharding_constraint`` refuses under jax 0.9).  The port's cells run
as the CLI runs them, each in a subprocess of its own over a fake process
group of 256 ranks.  Bars on FLOPs per chip: 0.5% on prefill and decode
cells, 3% on train cells, where the two backwards recompute differently.
Bytes and collective bytes are compared by neither: XLA fuses and eager
torch does not, and the two partitioners choose other collectives.

Stated departures (``DEPARTURES``, each ratio pinned), found with
``roofline/diagnose.py`` beside the reference's HLO:

- phi4-mini-3.8b ``train_4k``, 1.0337: the port's chunked cross-entropy
  runs each chunk under a checkpoint, so its backward recomputes the
  chunk's logits product, which the reference's scan keeps; with a
  200,064 vocab that product is 3.4% of the step
  (``test_loss_chunks_recompute_their_logits``; 0.7-1.9% in the other
  train cells, inside the bar);
- rwkv6-7b ``long_500k``, 31/21: at a batch of 1 the data axis holds no
  batch, and XLA sums the r, k, v, g and channel-mix receptance products'
  partial contractions over it where the port gathers their fsdp weights
  first (``distributed/sharding.py::gather_fsdp``), as at every other cell.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
MESH = "single_pod_16x16"
CELL_TIMEOUT_S = 300
# (arch, shape) held to the reference's FLOPs per chip
PARITY = [
    ("lstm-ae-f64-d6", "serve_64"),
    ("lstm-ae-f64-d6", "stream_64"),
    ("tinyllama-1.1b", "decode_32k"),
    ("whisper-large-v3", "decode_32k"),
    ("rwkv6-7b", "decode_32k"),
    ("jamba-v0.1-52b", "decode_32k"),
    ("jamba-v0.1-52b", "long_500k"),
    ("olmo-1b", "prefill_32k"),
    ("olmo-1b", "train_4k"),
    ("tinyllama-1.1b", "train_4k"),
    ("phi4-mini-3.8b", "train_4k"),
    ("rwkv6-7b", "long_500k"),
]
DEPARTURES = {("phi4-mini-3.8b", "train_4k"): 154279520239616.0 / 149244744826880.0,
              ("rwkv6-7b", "long_500k"): 31 / 21}

ORACLE = r"""
import json, sys
from pathlib import Path
import numpy as np
import repro.launch.dryrun as d          # sets 512 host devices before jax starts
import jax
from jax.sharding import Mesh
from repro.config import get_config, shapes_for

def production_mesh(multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)

d.make_production_mesh = production_mesh
out = Path(sys.argv[1])
for arch, shape_name in json.loads(sys.argv[2]):
    shape = next(s for s in shapes_for(get_config(arch)) if s.name == shape_name)
    d.run_cell(arch, shape, False, out)
print("ORACLE_OK")
"""


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


def _port_cell(arch, shape, out: Path) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
         "--mesh", "single", "--out", str(out)],
        env=_env(CUDA_VISIBLE_DEVICES=""), cwd=ROOT, capture_output=True, text=True,
        timeout=CELL_TIMEOUT_S)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """The oracle's cells and the port's, side by side: (oracle dir, port
    dir, {cell: the port's CLI output})."""
    pytest.importorskip("jax")
    root = tmp_path_factory.mktemp("dryrun")
    ref, port = root / "ref", root / "port"
    oracle = subprocess.Popen([sys.executable, "-c", ORACLE, str(ref), json.dumps(PARITY)],
                              env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    try:
        with ThreadPoolExecutor(max_workers=3) as pool:
            runs = dict(zip(PARITY, pool.map(lambda c: _port_cell(*c, port), PARITY)))
        log, _ = oracle.communicate(timeout=CELL_TIMEOUT_S)
    finally:
        if oracle.poll() is None:
            oracle.kill()
    assert oracle.returncode == 0 and "ORACLE_OK" in log, log[-4000:]
    return ref, port, runs


def _record(d: Path, arch, shape) -> dict:
    return json.loads((d / f"{arch}__{shape}__{MESH}.json").read_text())


@pytest.mark.parametrize("cell", PARITY, ids=[f"{a}-{s}" for a, s in PARITY])
def test_flops_per_chip_match_reference(cells, cell):
    ref_dir, port_dir, runs = cells
    arch, shape = cell
    run = runs[cell]
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    got, want = _record(port_dir, arch, shape), _record(ref_dir, arch, shape)
    assert got["status"] == want["status"] == "ok"
    assert (port_dir / f"{arch}__{shape}__{MESH}.ops.json.gz").exists()
    # the reference's keys, each there (compile_s: the trace's seconds)
    assert set(want) <= set(got)
    for key in ("arch", "shape", "mesh", "chips", "model_flops"):
        assert got[key] == want[key], key
    ratio = got["flops_per_chip"] / want["flops_per_chip"]
    if cell in DEPARTURES:
        assert ratio == pytest.approx(DEPARTURES[cell], rel=1e-6), ratio
        return
    bar = 0.03 if shape.startswith(("train", "stream")) else 0.005
    assert abs(ratio - 1.0) <= bar, (ratio, got["flops_per_chip"], want["flops_per_chip"])
    assert got["flops_ratio"] == pytest.approx(want["flops_ratio"], rel=bar)


# ---------------------------------------------------------------- the launcher

def test_list_matches_reference():
    """``--list`` names the reference's cells, in its order, on both meshes."""
    ours = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--list"],
                          env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=120)
    theirs = subprocess.run([sys.executable, "-m", "repro.launch.dryrun", "--list"],
                            env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert ours.returncode == theirs.returncode == 0, ours.stderr + theirs.stderr
    assert ours.stdout == theirs.stdout
    assert ours.stdout.splitlines()[-1] == "total: 88 cells"


def test_sanitize_replicates_what_the_axes_do_not_divide():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.engine.placement import make_mesh
    from repro_torch.launch.dryrun import _batch_shardings, _sanitize

    mesh = make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    from repro_torch.distributed import sharding

    rules = sharding.rules_for_mesh(mesh)
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    specs = {"tokens": meta(6, 8), "single": meta(1, 8), "cache_len": meta()}
    batch = _batch_shardings(specs, mesh, rules)
    assert batch == {"tokens": (Shard(0), Replicate()), "single": (Shard(0), Replicate()),
                     "cache_len": (Replicate(), Replicate())}
    assert _sanitize(batch, specs, mesh) == {
        "tokens": (Shard(0), Replicate()), "single": (Replicate(), Replicate()),
        "cache_len": (Replicate(), Replicate())}
    # a dim over both axes needs 8 | size; a vocab of 51866 over 4 does not divide
    tree = {"w": (Shard(0), Shard(0)), "table": (Replicate(), Shard(1)),
            "mixed": (Shard(1), Shard(0)), "ok": (Shard(1), Shard(0))}
    structs = {"w": meta(12, 3), "table": meta(8, 51866), "mixed": meta(8, 5), "ok": meta(8, 6)}
    assert _sanitize(tree, structs, mesh) == {
        "w": (Replicate(), Replicate()), "table": (Replicate(), Replicate()),
        "mixed": (Replicate(), Shard(0)), "ok": (Shard(1), Shard(0))}


def test_opt_applies_the_reference_overrides():
    from repro.config import get_config as jax_config

    from repro_torch.config import get_config
    from repro_torch.launch.dryrun import opt_config

    for arch in ("tinyllama-1.1b", "rwkv6-7b", "moonshot-v1-16b-a3b", "jamba-v0.1-52b"):
        cfg = opt_config(get_config(arch))
        assert (cfg.decode_loop, cfg.bwd_constrain) == ("unroll", True)
        assert cfg.rwkv is None or cfg.rwkv.scan_impl == "chunked"
        assert cfg.moe is None or cfg.moe.impl == "ep_a2a"
        assert jax_config(arch).name == cfg.name


def test_fake_world_is_destroyed_when_the_cell_fails():
    import torch.distributed as dist

    from repro_torch.launch.dryrun import fake_world

    with pytest.raises(RuntimeError, match="inside"):
        with fake_world(16):
            assert dist.get_world_size() == 16
            raise RuntimeError("inside")
    assert not dist.is_initialized()


def test_run_cell_writes_the_record_and_reanalyze_reproduces_it(tmp_path, capsys):
    """A cell's JSON carries the reference's keys; its ops record beside it
    rebuilds the same JSON; the fake group is gone after the cell."""
    import torch.distributed as dist

    from repro_torch.config import get_config, shapes_for
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.roofline.reanalyze import read_ops, reanalyze_dir

    shape = next(s for s in shapes_for(get_config("lstm-ae-f32-d2")) if s.name == "serve_64")
    rec = run_cell("lstm-ae-f32-d2", shape, False, tmp_path)
    assert not dist.is_initialized()
    assert rec["status"] == "ok" and rec["chips"] == 256 and rec["mesh"] == MESH
    keys = {"arch", "shape", "mesh", "chips", "flops_per_chip", "bytes_per_chip",
            "coll_bytes_per_chip", "coll_breakdown", "compute_s", "memory_s", "collective_s",
            "dominant", "model_flops", "flops_ratio", "memory_analysis", "note", "status",
            "compile_s"}
    assert keys <= set(rec)
    path = tmp_path / f"lstm-ae-f32-d2__serve_64__{MESH}.json"
    record = read_ops(path.with_name(path.name.replace(".json", ".ops.json.gz")))
    assert sum(e["n"] for e in record) > 0
    before = json.loads(path.read_text())
    assert reanalyze_dir(tmp_path) == 1
    assert json.loads(path.read_text()) == before
    # a second run reads the cell back instead of tracing it again
    assert run_cell("lstm-ae-f32-d2", shape, False, tmp_path) == before
    assert "[dryrun] lstm-ae-f32-d2__serve_64__single_pod_16x16: ok" in capsys.readouterr().out


def test_sweep_exits_1_unless_every_cell_is_ok(tmp_path, monkeypatch):
    from repro_torch.launch import dryrun

    seen = []

    def fake(arch, shape, mp, out, opt=False):
        seen.append((arch, shape.name, mp, opt))
        return {"status": "ok" if shape.name != "serve_64" else "error: x"}

    monkeypatch.setattr(dryrun, "run_cell", fake)
    dryrun.main(["--arch", "lstm-ae-f32-d2", "--shape", "stream_16", "--mesh", "both",
                 "--opt", "--out", str(tmp_path)])
    assert seen == [("lstm-ae-f32-d2", "stream_16", False, True),
                    ("lstm-ae-f32-d2", "stream_16", True, True)]
    with pytest.raises(SystemExit) as exit_:
        dryrun.main(["--arch", "lstm-ae-f32-d2", "--mesh", "single", "--out", str(tmp_path)])
    assert exit_.value.code == 1


# ---------------------------------------------------------------- the repairs, traced

def _traced(fn, mesh_shape, *args):
    """``fn(mesh, *args)`` traced over a fake group of prod(mesh_shape)
    ranks on a ("data", "model") mesh."""
    import math

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.dryrun import fake_world
    from repro_torch.roofline.trace import trace

    with fake_world(math.prod(mesh_shape)):
        mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=("data", "model"))
        return trace(fn, mesh, *args)


def test_heads_fewer_than_the_model_axis_reshape_both_ways():
    """4 kv heads over a model axis of 16: the projection is gathered before
    it is split into heads, the heads then laid out unevenly (rank 0 one
    head, as XLA pads); the backward reshapes the grad back and hands the
    projection its grad in the projection's own layout."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.config import get_config
    from repro_torch.distributed import sharding
    from repro_torch.layers.attention import _split_heads

    cfg = get_config("tinyllama-1.1b")
    hd = cfg.resolved_head_dim()

    def step(mesh):
        rules = sharding.rules_for_mesh(mesh)
        proj = distribute_tensor(torch.empty(32, 8, cfg.num_kv_heads * hd, device="meta"),
                                 mesh, (Shard(0), Shard(2))).requires_grad_(True)
        with sharding.mesh_context(mesh, rules):
            k = sharding.constrain(_split_heads(proj, 32, 8, cfg.num_kv_heads, hd),
                                   ("batch", None, "tp", None))
            (g,) = torch.autograd.grad(k.float().sum(), [proj])
        return k, g

    (k, g), record = _traced(step, (2, 16))
    assert tuple(k.shape) == (32, 8, 4, hd)
    assert tuple(k.placements) == (Shard(0), Shard(2)) and tuple(k.to_local().shape) == (16, 8, 1, hd)
    assert tuple(g.placements) == (Shard(0), Shard(2)) and tuple(g.to_local().shape) == (16, 8, 16)
    assert any(e["op"].startswith("_c10d_functional.all_gather") for e in record)


def test_unsharded_reshapes_are_the_plain_ones():
    """Without a mesh each repaired reshape is the plain op: the same
    record as ``reshape``, bit for bit the same tensors."""
    from repro_torch.distributed.sharding import replicate_uneven, reshape_uneven
    from repro_torch.roofline.trace import trace

    x = torch.arange(2 * 3 * 8, dtype=torch.float32).reshape(2, 3, 8)
    assert torch.equal(reshape_uneven(x, (2, 3, 2, 4), {2: 2}), x.reshape(2, 3, 2, 4))
    assert replicate_uneven(x, 0, 1) is x
    meta = torch.empty(2, 3, 8, device="meta")
    assert trace(lambda t: reshape_uneven(t, (2, 3, 2, 4), {2: 2}), meta)[1] == \
        trace(lambda t: t.reshape(2, 3, 2, 4), meta)[1]


def test_loss_chunks_recompute_their_logits():
    """The cause of phi4-mini's departure: the grad of the port's chunked
    cross-entropy runs four products of each chunk with the unembedding
    (the logits, their recompute in the backward, dW, dh), the reference's
    three (its scan keeps the logits), counted by each package's own cost
    model (the reference's from its compiled HLO)."""
    import jax
    import jax.numpy as jnp
    from repro.layers.embeddings import chunked_xent_loss as jax_loss
    from repro.roofline.hlo_cost import analyze_hlo

    from repro_torch.layers.embeddings import chunked_xent_loss
    from repro_torch.roofline.trace import analyze, trace

    b, s, d, v, chunk = 2, 16, 8, 32, 4
    product = 2 * b * s * d * v

    def grads(w, h, labels):
        w, h = w.requires_grad_(True), h.requires_grad_(True)
        return torch.autograd.grad(chunked_xent_loss(w, h, labels, chunk=chunk), (w, h))

    meta = dict(device="meta")
    ours = analyze(trace(grads, torch.empty(d, v, **meta), torch.empty(b, s, d, **meta),
                         torch.zeros(b, s, dtype=torch.int32, **meta))[1]).flops
    f = jax.grad(lambda w, h, lab: jax_loss(w, h, lab, chunk=chunk), argnums=(0, 1))
    text = jax.jit(f).lower(jax.ShapeDtypeStruct((d, v), jnp.float32),
                            jax.ShapeDtypeStruct((b, s, d), jnp.float32),
                            jax.ShapeDtypeStruct((b, s), jnp.int32)).compile().as_text()
    theirs = analyze_hlo(text).flops
    assert (ours, theirs) == (4 * product, 3 * product)
