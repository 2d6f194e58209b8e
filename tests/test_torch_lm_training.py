"""Port parity of LM training: ``repro_torch.data.lm``, the chunked
cross-entropy, the dense transformer's ``train_loss`` with per-layer
recompute, the train step on LM trees (plain, microbatched, int8 error
feedback), recovery from injected failures, LM train-state checkpoints and
``launch.train --arch <LM>``, against the JAX package from carried params
on the reduced configs.  JAX runs jitted.

Tolerances: the chunked cross-entropy in f32 at rtol 1e-5 (value) and
rtol 1e-5 / atol 1e-7 (grads); ``train_loss`` in f32 at rtol 1e-4 / atol
1e-5 for the value and every grad element; in bf16 the loss at 6e-2 (the
reference's bf16 bar, tests/test_serving_consistency.py) and each grad
leaf by its relative Frobenius error at ``BF16_GRAD_REL`` (measured
1.3e-2 to 1.5e-2 on the five configs); one train step's loss at rtol 1e-5
and params at atol 1e-6 (see ``_hold`` for the elements whose grads are
near AdamW's eps)."""
import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore_checkpoint as jax_restore_checkpoint  # noqa: E402
from repro.config import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.config import reduced_config as jax_reduced_config  # noqa: E402
from repro.data import LMDataConfig as JaxLMDataConfig  # noqa: E402
from repro.data import host_slice as jax_host_slice  # noqa: E402
from repro.data import make_lm_batch as jax_make_lm_batch  # noqa: E402
from repro.layers.embeddings import chunked_xent_loss as jax_chunked_xent  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.training import build_train_step as jax_build_train_step  # noqa: E402
from repro.training import init_train_state as jax_init_train_state  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    AsyncCheckpointer,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.config import MoEConfig, TrainConfig, reduced_config  # noqa: E402
from repro_torch.data import LMDataConfig, LMIterator, host_slice, make_lm_batch  # noqa: E402
from repro_torch.distributed import FailureInjector, run_with_recovery  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.layers.embeddings import chunked_xent_loss  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import build_train_step, init_train_state  # noqa: E402
from repro_torch.utils import params_from_numpy, tree_leaves, tree_map  # noqa: E402

DENSE = ["tinyllama-1.1b", "olmo-1b", "phi4-mini-3.8b", "internlm2-20b", "phi-3-vision-4.2b"]
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_LOSS_TOL = 6e-2
BF16_GRAD_REL = 5e-2
B, S, CHUNK = 2, 12, 5          # S not a multiple of the loss chunk


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                        else np.asarray(a), tree)


def _batch(cfg, b=B, s=S, seed=0):
    """Numpy batch: random tokens and labels, the last two labels -1; under
    the vision stub also image_embeds."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[:, -2:] = -1
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "labels": labels}
    if cfg.frontend == "vision_stub":
        batch["image_embeds"] = rng.standard_normal(
            (b, cfg.vision_patches, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference(arch, dtype="float32", key=0):
    japi = jax_build_model(jax_reduced_config(arch).with_overrides(compute_dtype=dtype))
    return japi, japi.init(jax.random.PRNGKey(key))


def _port(arch, dtype="float32", key=0):
    api = build_model(reduced_config(arch).with_overrides(compute_dtype=dtype))
    return api, params_from_numpy(_np(_reference(arch, dtype, key)[1]), "cpu")


def _value_and_grad(api, params, batch, **kw):
    """(loss, metrics, grads in tree_leaves order) of the port's loss."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    tracked = _rebuild(params, it)
    loss, metrics = api.loss(tracked, batch, **kw)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _rebuild(params, leaves):
    """``params`` with its leaves replaced, in tree_leaves order."""
    if isinstance(params, dict):
        return {k: _rebuild(params[k], leaves) for k in sorted(params)}
    return next(leaves)


def _rel_fro(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got.float().numpy() - want) / max(np.linalg.norm(want), 1e-30))


# ---------------- data ----------------

@pytest.mark.parametrize("seed,index", [(0, 0), (0, 7), (3, 2)])
def test_make_lm_batch_equals_reference(seed, index):
    cfg = dict(vocab_size=300, seq_len=24, global_batch=6, seed=seed)
    got = make_lm_batch(LMDataConfig(**cfg), index)
    want = jax_make_lm_batch(JaxLMDataConfig(**cfg), index)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == torch.int64 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert torch.equal(got["tokens"][:, 1:], got["labels"][:, :-1])


def test_lm_iterator_state_round_trip():
    cfg = LMDataConfig(vocab_size=64, seq_len=8, global_batch=4, seed=5)
    it = LMIterator(cfg)
    for _ in range(3):
        next(it)
    state = it.state_dict()
    assert state == {"index": 3, "seed": 5}
    want = next(it)
    fresh = LMIterator(cfg)
    fresh.load_state_dict(json.loads(json.dumps(state)))
    got = next(iter(fresh))
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="seed mismatch"):
        LMIterator(dataclasses.replace(cfg, seed=6)).load_state_dict(state)


def test_host_slice_with_explicit_arguments():
    batch = make_lm_batch(LMDataConfig(vocab_size=64, seq_len=8, global_batch=8), 0)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    for pi, pc in ((0, 1), (1, 2), (3, 4)):
        got = host_slice(batch, pi, pc)
        want = jax_host_slice(jbatch, pi, pc)
        for k in batch:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert all(torch.equal(v, batch[k]) for k, v in host_slice(batch).items())
    with pytest.raises(ValueError, match="does not split"):
        host_slice(batch, 0, 3)


# ---------------- chunked cross-entropy ----------------

@pytest.mark.parametrize("chunk,z_loss", [(5, 0.0), (4, 1e-2), (64, 0.0)])
def test_chunked_xent_matches_reference(chunk, z_loss):
    """Ragged S (13 over chunks of 5, or one chunk), -1 labels, z-loss: the
    value at rtol 1e-5 and the grads wrt h and unembed_w at rtol 1e-5."""
    rng = np.random.default_rng(1)
    b, s, d, v = 2, 13, 16, 40
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    w = rng.standard_normal((d, v)).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    labels[:, -3:] = -1
    labels[0, 4] = -1
    jloss, (jgw, jgh) = jax.jit(jax.value_and_grad(
        lambda w_, h_: jax_chunked_xent(w_, h_, jnp.asarray(labels), chunk=chunk, z_loss=z_loss),
        argnums=(0, 1)))(jnp.asarray(w), jnp.asarray(h))
    tw, th = (torch.from_numpy(x).requires_grad_(True) for x in (w, h))
    loss = chunked_xent_loss(tw, th, torch.from_numpy(labels).long(), chunk=chunk, z_loss=z_loss)
    gw, gh = torch.autograd.grad(loss, (tw, th))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), rtol=1e-5, atol=1e-7)
    with torch.no_grad():
        assert float(chunked_xent_loss(tw, th, torch.from_numpy(labels).long(), chunk=chunk,
                                       z_loss=z_loss)) == float(loss.detach())


def test_chunked_xent_matches_dense():
    """tests/test_training.py::test_chunked_xent_matches_dense on the port:
    an uneven chunk (padded) against the dense f32 loss, rtol 1e-5."""
    g = torch.Generator().manual_seed(4)
    b, s, d, v = 2, 12, 16, 40
    h, w = torch.randn(b, s, d, generator=g), torch.randn(d, v, generator=g)
    labels = torch.randint(0, v, (b, s), generator=g)
    labels[:, -2:] = -1
    chunked = chunked_xent_loss(w, h, labels, chunk=5)
    logits = (h @ w).float()
    lse = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = labels >= 0
    dense = torch.sum((lse - gold) * mask) / torch.sum(mask)
    np.testing.assert_allclose(float(chunked), float(dense), rtol=1e-5)


def _saved_numels(fn) -> list[int]:
    """numel of every tensor autograd saves for the backward while ``fn``
    runs (a non-reentrant checkpoint keeps its region's tensors from these
    hooks: it saves none of them)."""
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sizes


def test_chunked_xent_saves_no_logits_for_backward():
    """Under grad no chunk's (B, chunk, V) logits are kept for the backward:
    only each chunk's inputs are (here each smaller than its logits)."""
    b, s, d, v = 3, 12, 8, 50
    h = torch.randn(b, s, d, requires_grad=True)
    w = torch.randn(d, v, requires_grad=True)
    labels = torch.randint(0, v, (b, s))
    sizes = _saved_numels(lambda: chunked_xent_loss(w, h, labels, chunk=4))
    assert max(sizes, default=0) < b * 4 * v


# ---------------- train_loss ----------------

@functools.lru_cache(maxsize=None)
def _reference_value_and_grad(arch, dtype):
    japi, jparams = _reference(arch, dtype)
    fn = jax.jit(jax.value_and_grad(lambda p, bt: japi.loss(p, bt, loss_chunk=CHUNK),
                                    has_aux=True))
    batch = _batch(japi.cfg)
    (jloss, jmetrics), jgrads = fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return batch, float(jloss), {k: float(x) for k, x in jmetrics.items()}, jax.tree.leaves(jgrads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_train_loss_matches_reference(arch, dtype):
    """The value, its metrics and every grad leaf against jax.value_and_grad
    of the reference's loss; the vision stub with image_embeds (its patch
    positions labelled -1), olmo-1b and phi4-mini with tied tables."""
    batch, jloss, jmetrics, jgrads = _reference_value_and_grad(arch, dtype)
    api, params = _port(arch, dtype)
    loss, metrics, grads = _value_and_grad(api, params, _torch_batch(batch), loss_chunk=CHUNK)
    assert set(metrics) == set(jmetrics) == {"xent", "aux"} and float(metrics["aux"]) == 0.0
    assert len(grads) == len(jgrads)
    if dtype == "float32":
        np.testing.assert_allclose(float(loss), jloss, **F32_TOL)
        np.testing.assert_allclose(float(metrics["xent"]), jmetrics["xent"], **F32_TOL)
        for g, w in zip(grads, jgrads):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)
    else:
        np.testing.assert_allclose(float(loss), jloss, rtol=BF16_LOSS_TOL, atol=BF16_LOSS_TOL)
        errs = [_rel_fro(g, w) for g, w in zip(grads, jgrads)]
        assert max(errs) < BF16_GRAD_REL, errs
    for g, p in zip(grads, tree_leaves(params)):
        assert g.dtype == p.dtype == torch.float32 and g.shape == p.shape


def _graph_nodes(loss) -> list:
    """(node, [the nodes it feeds from]) over the backward graph of ``loss``."""
    seen, out, todo = set(), [], [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        nexts = [n for n, _ in node.next_functions if n is not None]
        out.append((node, nexts))
        todo.extend(nexts)
    return out


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmo-1b"])
def test_remat_matches_no_remat_without_select_over_stacks(arch):
    """Per-layer recompute changes no number on the CPU (loss and grads
    bit-equal), keeps the layers' activations from autograd's saved
    tensors, and the backward graph takes each stacked leaf's layers from
    one unbind: no SelectBackward reads a stacked leaf."""
    api, params = _port(arch)
    batch = _torch_batch(_batch(api.cfg))
    lr, _, gr = _value_and_grad(api, params, batch, remat=True, loss_chunk=CHUNK)
    ln, _, gn = _value_and_grad(api, params, batch, remat=False, loss_chunk=CHUNK)
    assert torch.equal(lr, ln) and all(torch.equal(a, b) for a, b in zip(gr, gn))

    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    tracked = _rebuild(params, iter(leaves))
    loss, _ = api.loss(tracked, batch, loss_chunk=CHUNK)
    stacked = {id(t) for t in tree_leaves(tracked["layers"])}
    nodes = _graph_nodes(loss)
    reads = {}
    for node, nexts in nodes:
        for n in nexts:
            if type(n).__name__ == "AccumulateGrad" and id(n.variable) in stacked:
                reads.setdefault(id(n.variable), []).append(type(node).__name__)
    assert len(reads) == len(stacked)
    assert all(r == ["UnbindBackward0"] for r in reads.values()), reads

    saved = {r: _saved_numels(lambda: api.loss(tracked, batch, remat=r, loss_chunk=CHUNK))
             for r in (False, True)}
    assert 0 < len(saved[True]) < len(saved[False]) / 4, {r: len(v) for r, v in saved.items()}


def test_moe_loss_and_mesh_raise_naming_their_items(tmp_path):
    """A MoE config's loss is ported (item 11c, tests/test_torch_moe.py):
    finite, with a positive aux in its total.  The dense step on a (1, 1)
    mesh of one gloo rank equals the plain step (the (2, 2) mesh:
    tests/test_torch_sharded_step.py)."""
    from test_torch_sharded_step import hold_one_rank_mesh_steps, steps_on_one_rank_mesh

    cfg = reduced_config("tinyllama-1.1b").with_overrides(moe=MoEConfig(4, 2))
    api, _ = _port("tinyllama-1.1b")
    moe = build_model(cfg)
    loss, metrics = moe.loss(moe.init(torch.Generator().manual_seed(0), device="cpu"),
                             _torch_batch(_batch(cfg)))
    assert torch.isfinite(loss) and float(metrics["aux"]) > 0
    assert float(loss) == pytest.approx(float(metrics["xent"]) + 0.01 * float(metrics["aux"]),
                                        rel=1e-6)
    api, params = _port("tinyllama-1.1b")
    batches = [_lm_batch(api.cfg, i) for i in range(2)]
    hold_one_rank_mesh_steps(*steps_on_one_rank_mesh(api, TrainConfig(**STEP_TC), params,
                                                     batches, tmp_path))


# ---------------- the train step ----------------

STEP_TC = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10, loss_chunk=8)
STEP_TC_BETA1 = TrainConfig().beta1
TINY_GRAD = 1e-6


def _lm_batch(cfg, index=0, b=4, s=16):
    return make_lm_batch(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b),
                         index)


def _one_step(arch, tc_kw):
    """One step of both packages from the same params and batch:
    (port state, port metrics, reference state, reference metrics)."""
    return _one_step_cached(arch, tuple(sorted(tc_kw.items())))


@functools.lru_cache(maxsize=None)
def _one_step_cached(arch, tc_items):
    tc_kw = dict(tc_items)
    japi, _ = _reference(arch)
    jtc, tc = JaxTrainConfig(**tc_kw), TrainConfig(**tc_kw)
    jstate = jax_init_train_state(japi, jax.random.PRNGKey(0), jtc)
    state = init_train_state(params_from_numpy(_np(jstate.params), "cpu"), tc)
    assert (state.ef is None) == (jstate.ef is None)
    batch = _lm_batch(japi.cfg)
    jstate, jmetrics = jax.jit(jax_build_train_step(japi, jtc))(
        jstate, {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in batch.items()})
    state, metrics = build_train_step(_port(arch)[0], tc)(state, batch)
    return state, metrics, jstate, jmetrics


def _hold(state, metrics, jstate, jmetrics, keep=None):
    """Metrics at rtol 1e-5; the first moment (0.1 of the step's grads) at
    the train loss's grad bar; params at atol 1e-6.  AdamW's first update
    is g / (|g| + eps): where the reference's |g| is below ``TINY_GRAD``
    (100 eps) it turns on the grads' last bits (there they come from sums
    that cancel, a few percent apart between the packages), so those
    elements are held to one update's size, 2 lr, instead."""
    assert set(metrics) == set(jmetrics)
    for k in ("loss", "xent", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5)
    lr = float(jmetrics["lr"])
    for n, (p, jp, mu, jmu) in enumerate(zip(
            tree_leaves(state.params), jax.tree.leaves(jstate.params),
            tree_leaves(state.opt.mu), jax.tree.leaves(jstate.opt.mu))):
        mask = np.ones(p.shape, bool) if keep is None else keep[n]
        np.testing.assert_allclose(mu.numpy()[mask], np.asarray(jmu)[mask], rtol=1e-4, atol=1e-6)
        tiny = np.abs(np.asarray(jmu)) / (1 - STEP_TC_BETA1) < TINY_GRAD
        diff = np.abs(p.numpy() - np.asarray(jp))
        assert diff[mask & ~tiny].max(initial=0.0) <= 1e-6
        assert diff[mask & tiny].max(initial=0.0) <= 2 * lr
    assert int(state.opt.step) == int(jstate.opt.step) == 1


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmo-1b"])
def test_train_step_matches_reference(arch):
    _hold(*_one_step(arch, STEP_TC))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmo-1b"])
def test_microbatch_train_step_matches_reference(arch):
    """microbatch=2 against the reference's microbatched step, and against
    the port's full-batch step at the reference's own bar for this
    equivalence (tests/test_training.py:40-55: rtol 2e-3, atol 2e-4)."""
    state, metrics, jstate, jmetrics = _one_step(arch, {**STEP_TC, "microbatch": 2})
    _hold(state, metrics, jstate, jmetrics)
    full, fmetrics, _, _ = _one_step(arch, STEP_TC)
    np.testing.assert_allclose(float(metrics["loss"]), float(fmetrics["loss"]), rtol=2e-3)
    for a, b in zip(tree_leaves(state.params), tree_leaves(full.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmo-1b"])
def test_int8_ef_train_step_matches_reference(arch):
    """int8 error feedback against the reference's own step (the LM tree
    holds no tuples, so the reference's compress_grads reads it right).
    Rounding is discontinuous: a gradient one ulp either side of a tie
    lands one int8 level apart, moving its error by a quantum and its
    param by up to lr; at most 0.1% of the elements may flip, and the
    rest hold at atol 1e-6 (params) and 1e-7 (error buffers)."""
    state, metrics, jstate, jmetrics = _one_step(arch, {**STEP_TC, "grad_compression": "int8_ef"})
    flips = [np.abs(e.numpy() - np.asarray(je)) > 1e-7
             for e, je in zip(tree_leaves(state.ef), jax.tree.leaves(jstate.ef))]
    assert sum(int(f.sum()) for f in flips) <= 1e-3 * sum(f.size for f in flips)
    _hold(state, metrics, jstate, jmetrics, keep=[~f for f in flips])
    assert sum(float(e.abs().sum()) for e in tree_leaves(state.ef)) > 0


def test_loss_decreases_tinyllama():
    """tests/test_training.py::test_loss_decreases_tinyllama on the port:
    the mean of the last five losses of 40 steps falls by 0.3 below the
    first five's."""
    cfg = reduced_config("tinyllama-1.1b")
    api = build_model(cfg)
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=5, total_steps=40, loss_chunk=32,
                     grad_clip=1.0)
    state = init_train_state(api.init(torch.Generator().manual_seed(0), "cpu"), tc)
    step = build_train_step(api, tc)
    it = LMIterator(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8))
    losses = []
    for _ in range(40):
        state, metrics = step(state, next(it))
        losses.append(float(metrics["loss"]))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.3, f"loss did not decrease: {first:.3f} -> {last:.3f}"


def test_recovery_matches_clean_run(tmp_path):
    """tests/test_checkpoint_fault.py::test_recovery_matches_clean_run on
    the port's LM path: failures at steps 7 and 17 give the clean run's
    losses at rtol 1e-5."""
    api, params = _port("olmo-1b")
    tc = TrainConfig(loss_chunk=16)
    step = build_train_step(api, tc)

    def run(name, injector=None):
        it = LMIterator(LMDataConfig(vocab_size=api.cfg.vocab_size, seq_len=16, global_batch=4))
        return run_with_recovery(state=init_train_state(params, tc), train_step=step,
                                 iterator=it, total_steps=25, ckpt_dir=tmp_path / name,
                                 ckpt_every=10, injector=injector)

    _, clean = run("clean")
    final, faulty = run("faulty", FailureInjector((7, 17)))
    np.testing.assert_allclose(faulty, clean, rtol=1e-5)
    assert int(final.opt.step) == 25


# ---------------- checkpoints ----------------

@pytest.mark.parametrize("compression", ["none", "int8_ef"])
def test_lm_train_state_checkpoint_round_trip(tmp_path, compression):
    """An LM train state after two steps (stacked f32 leaves, AdamW's step
    and moments, ef None or a tree) and the iterator's position: bit for
    bit through save/restore and AsyncCheckpointer, on the target's
    device, and restored by the JAX package under the same keys."""
    api, params = _port("olmo-1b")
    tc = TrainConfig(loss_chunk=8, grad_compression=compression)
    state = init_train_state(params, tc)
    step = build_train_step(api, tc)
    it = LMIterator(LMDataConfig(vocab_size=api.cfg.vocab_size, seq_len=8, global_batch=2))
    for _ in range(2):
        state, _ = step(state, next(it))
    target = init_train_state(tree_map(torch.zeros_like, params), tc)

    def check(restored, meta):
        assert meta["step"] == 2 and meta["iterator"] == it.state_dict()
        got, want = _state_leaves(restored), _state_leaves(state)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)

    path = save_checkpoint(tmp_path / "sync", 2, state, extra_meta={"iterator": it.state_dict()})
    check(*restore_checkpoint(path, target))
    ckpt = AsyncCheckpointer(tmp_path / "async", keep=1)
    ckpt.save(2, state, extra_meta={"iterator": it.state_dict()})
    ckpt.wait()
    check(*restore_checkpoint(latest_checkpoint(tmp_path / "async"), target))
    japi, _ = _reference("olmo-1b")
    jtarget = jax_init_train_state(japi, jax.random.PRNGKey(1),
                                   JaxTrainConfig(grad_compression=compression))
    jrestored, _ = jax_restore_checkpoint(path, jtarget)
    for a, b in zip(_state_leaves(state), jax.tree.leaves(jrestored)):
        assert np.array_equal(a.numpy(), np.asarray(b))


def _state_leaves(state) -> list:
    return (tree_leaves(state.params) + [state.opt.step] + tree_leaves(state.opt.mu)
            + tree_leaves(state.opt.nu) + (tree_leaves(state.ef) if state.ef is not None else []))


# ---------------- the launcher ----------------

def _launch(capsys, arch, ckpt_dir, steps, *extra):
    train_launcher.main(["--arch", arch, "--device", "cpu", "--steps", str(steps),
                         "--ckpt-every", "2", "--ckpt-dir", str(ckpt_dir), "--batch", "2",
                         "--seq-len", "8", *extra])
    return capsys.readouterr().out


@pytest.mark.parametrize("arch", DENSE)
def test_train_launcher_trains_and_resumes_every_dense_arch(tmp_path, capsys, arch):
    """``launch.train --arch <LM> --device cpu``: trains, checkpoints every
    2 steps, and a second run resumes from step 4 onto the trajectory of
    one uninterrupted run (the last step's loss as printed)."""
    first = _launch(capsys, arch, tmp_path / "a", 4)
    assert f"[train] {arch}-reduced:" in first and "mesh=none, device=cpu" in first
    assert "resumed" not in first
    second = _launch(capsys, arch, tmp_path / "a", 6)
    assert "[train] resumed from step 4" in second and "stragglers=" in second
    whole = _launch(capsys, arch, tmp_path / "b", 6)

    def last_loss(text):
        return [ln for ln in text.splitlines() if ln.startswith("[train] step")][-1]

    assert last_loss(second) == last_loss(whole)
    assert "loss=nan" not in whole


def test_train_launcher_device_and_mesh(tmp_path, monkeypatch):
    """The default device raises without a GPU; a process group of 256
    ranks or more builds the production mesh (the reference's, by its
    device count), which needs that many ranks: a world monkeypatched to
    256 over one real rank raises naming the need."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_launcher.main(["--arch", "tinyllama-1.1b", "--steps", "1",
                                 "--ckpt-dir", str(tmp_path)])
    assert train_launcher.pick_mesh("cpu") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 256)
    assert train_launcher.pick_mesh("cpu") is None        # GPUs are not ranks
    monkeypatch.setattr(train_launcher, "world_size", lambda: 256)
    with pytest.raises(RuntimeError, match="needs 256 ranks but the process group has 1"):
        train_launcher.pick_mesh("cpu")


def test_make_iterator_matches_reference():
    """The reference's make_iterator: TimeseriesIterator for the LSTM-AE,
    LMIterator for an LM (the vision stub too: text only)."""
    from repro.launch.train import make_iterator as jax_make_iterator

    args = type("Args", (), {"seq_len": 8, "batch": 2})()
    for arch in ("lstm-ae-f32-d2", "tinyllama-1.1b", "phi-3-vision-4.2b"):
        it, to_batch = train_launcher.make_iterator(reduced_config(arch), args)
        jit_, jto_batch = jax_make_iterator(jax_reduced_config(arch), args)
        assert type(it).__name__ == type(jit_).__name__
        got, want = to_batch(next(it)), jto_batch(next(jit_))
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
