"""The port's durable sessions on the CPU (``repro_torch.gateway.tokens``,
``repro_torch.checkpoint``, ``repro_torch.gateway.durability``): the
contract of tests/test_durability.py's token, in-process and wire cases,
and parity with the reference across packages.

* tokens — HMAC-signed resumption tokens round-trip; tampering, expiry
  and unknown sessions are distinct failures; one secret file gives the
  same token bytes in both packages.
* checkpoints — the port writes the reference's keys and dtype map for the
  same tree, and each package restores the other's checkpoints.
* in-process — snapshot -> restore -> replay reproduces an uninterrupted
  run bit for bit, parked sessions resume with zero loss, and a restore
  writes the pool's rows in place (no new state tensors, so a captured
  pool step is never captured again; the card's test counts captures).
* over the wire — tokens and typed token errors ride bp1 and JSON; a
  session snapshotted by either package resumes on the other's server
  and continues within 1e-5 of the reference's run.

The device-claim registry and worker-front cases of tests/test_durability.py
are in tests/test_torch_workers_durability.py.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

from _hypothesis_compat import given, settings, st  # noqa: E402
from conftest import GATEWAY_ARCH as ARCH  # noqa: E402
from conftest import GATEWAY_FEATS as FEATS  # noqa: E402
from conftest import gateway_series as _series  # noqa: E402
from repro.checkpoint import restore_checkpoint as jax_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.engine import AnomalyService as JaxAnomalyService  # noqa: E402
from repro.gateway import tokens as jtokens  # noqa: E402
from repro.gateway.client import GatewayClient as JaxGatewayClient  # noqa: E402
from repro.gateway.durability import enable_durability as jax_enable_durability  # noqa: E402
from repro.gateway.server import GatewayServer as JaxGatewayServer  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    AsyncCheckpointer,
    latest_checkpoint,
    list_checkpoints,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.engine import AnomalyService  # noqa: E402
from repro_torch.gateway.client import GatewayClient, GatewayClientError  # noqa: E402
from repro_torch.gateway.durability import (  # noqa: E402
    SessionActiveError,
    enable_durability,
)
from repro_torch.gateway.server import GatewayServer  # noqa: E402
from repro_torch.gateway.tokens import (  # noqa: E402
    ExpiredTokenError,
    TamperedTokenError,
    TokenSigner,
    UnknownSessionError,
    load_or_create_secret,
)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def pair():
    """The JAX service and the port's, on the same (JAX-initialised) weights."""
    ref = JaxAnomalyService(ARCH, schedule="wavefront")
    mine = AnomalyService(ARCH, schedule="fused", device="cpu")
    mine.recalibrate(params=jax.tree.map(np.asarray, ref.params))
    return ref, mine


@pytest.fixture(scope="module")
def svc(pair):
    return pair[1]


def _solo_errors(svc, samples) -> list:
    sess = svc.stream_start(1)
    out = []
    for x in samples:
        errs, sess = svc.stream_step(torch.from_numpy(np.asarray(x)[None]), sess)
        out.append(float(errs[0]))
    return out


# -- resumption tokens ------------------------------------------------------


def test_token_roundtrip(tmp_path):
    signer = TokenSigner(load_or_create_secret(tmp_path))
    claim = signer.verify(signer.issue("s-abc", 17, epoch=3))
    assert (claim.sid, claim.seq, claim.epoch) == ("s-abc", 17, 3)


@settings(max_examples=25)
@given(seq=st.integers(0, 2**40), epoch=st.integers(0, 1000), flip=st.integers(5, 40))
def test_token_any_payload_roundtrips_and_any_tamper_fails(seq, epoch, flip):
    signer = TokenSigner(b"k" * 32)
    tok = signer.issue("s-prop", seq, epoch)
    claim = signer.verify(tok)
    assert claim.seq == seq and claim.epoch == epoch
    # flip one character anywhere in payload or signature: must not verify
    i = min(flip, len(tok) - 1)
    if tok[i] == ".":
        i += 1
    bad = tok[:i] + ("A" if tok[i] != "A" else "B") + tok[i + 1:]
    with pytest.raises(TamperedTokenError):
        signer.verify(bad)


def test_token_wrong_secret_and_malformed_rejected():
    a, b = TokenSigner(b"a" * 32), TokenSigner(b"b" * 32)
    tok = a.issue("s-x", 1)
    with pytest.raises(TamperedTokenError):
        b.verify(tok)
    for junk in ("", "rt1", "rt9.x.y", "not-a-token", None, 42):
        with pytest.raises(TamperedTokenError):
            a.verify(junk)


def test_token_expiry_uses_injected_clock():
    now = [1000.0]
    signer = TokenSigner(b"k" * 32, ttl_s=60.0, clock=lambda: now[0])
    tok = signer.issue("s-ttl", 5)
    assert signer.verify(tok).seq == 5
    now[0] += 61.0
    with pytest.raises(ExpiredTokenError):
        signer.verify(tok)
    forever = TokenSigner(b"k" * 32, ttl_s=None, clock=lambda: now[0])
    now[0] += 1e9
    assert forever.verify(forever.issue("s-ttl", 6)).seq == 6


def test_secret_file_is_created_once_and_private(tmp_path):
    s1 = load_or_create_secret(tmp_path)
    s2 = load_or_create_secret(tmp_path)
    assert s1 == s2 and len(s1) >= 16
    assert os.stat(tmp_path / "token.secret").st_mode & 0o777 == 0o600
    (tmp_path / "other").mkdir()
    assert load_or_create_secret(tmp_path / "other") != s1


@pytest.mark.parametrize("ttl_s", [3600.0, None])
def test_one_secret_file_gives_identical_tokens_in_both_packages(tmp_path, ttl_s):
    secret = load_or_create_secret(tmp_path)  # the port creates the file ...
    assert jtokens.load_or_create_secret(tmp_path) == secret  # ... the reference reads it
    clock = lambda: 1_700_000_000.25  # noqa: E731
    mine = TokenSigner(secret, ttl_s=ttl_s, clock=clock)
    ref = jtokens.TokenSigner(secret, ttl_s=ttl_s, clock=clock)
    for sid, seq, epoch in (("s-0123456789abcdef", 0, 0), ("s-feedfacefeedface", 41, 3)):
        tok = mine.issue(sid, seq, epoch)
        assert tok == ref.issue(sid, seq, epoch)
        assert ref.verify(tok) == jtokens.SessionClaim(**vars(mine.verify(tok)))
    with pytest.raises(jtokens.TamperedTokenError):
        ref.verify(TokenSigner(b"x" * 32, clock=clock).issue("s-1", 1))


# -- checkpoints, in the reference's format ---------------------------------


def _tree():
    rng = np.random.default_rng(4)
    return {"layers": ({"wx": rng.standard_normal((3, 8)).astype(np.float32),
                        "b": rng.standard_normal(8).astype(np.float32)},
                       {"wx": rng.standard_normal((2, 8)).astype(np.float32),
                        "b": np.arange(8, dtype=np.int32)}),
            "pool/sq_sum": np.float32(0.5), "step": np.int64(7)}


def _tree_specs(tree):
    return {"layers": tuple({"wx": ("batch", "tp"), "b": (None,)} for _ in tree["layers"]),
            "pool/sq_sum": (), "step": ()}


def test_checkpoint_keys_and_dtypes_match_the_reference(tmp_path):
    tree = _tree()
    tensors = {**tree, "layers": jax.tree.map(torch.from_numpy, tree["layers"])}
    mine = save_checkpoint(tmp_path / "torch", 3, tensors)
    ref = jax_save(tmp_path / "jax", 3, tree)
    m, r = (json.loads((p / "meta.json").read_text()) for p in (mine, ref))
    assert (m["keys"], m["dtypes"], m["num_leaves"], m["step"]) == \
        (r["keys"], r["dtypes"], r["num_leaves"], r["step"])
    with np.load(mine / "leaves.npz") as a, np.load(ref / "leaves.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_checkpoints_restore_across_packages_bf16_included(tmp_path):
    tree = _tree()
    bf16 = torch.randn(4, 3).bfloat16()
    mine = {**jax.tree.map(torch.from_numpy, {"layers": tree["layers"]}), "h": bf16}
    path = save_checkpoint(tmp_path, 1, mine)
    meta = json.loads((path / "meta.json").read_text())
    assert meta["dtypes"]["h"] == "bfloat16"
    with np.load(path / "leaves.npz") as data:
        assert data["h"].dtype == np.float32  # npz holds no bf16; exact upcast
    back, _ = restore_checkpoint(path, mine)
    assert back["h"].dtype == torch.bfloat16 and torch.equal(back["h"], bf16)
    ref_back, _ = jax_restore(path, jax.tree.map(lambda t: np.zeros(t.shape), mine))
    assert str(ref_back["h"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(ref_back["h"], np.float32), bf16.float().numpy())
    # the reference's checkpoint restores in the port, onto tensors or arrays
    ref_path = jax_save(tmp_path / "ref", 2, tree)
    got, _ = restore_checkpoint(ref_path, tree)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(tree)):
        assert isinstance(a, torch.Tensor) and np.array_equal(a.numpy(), b)
        assert a.numpy().dtype == np.asarray(b).dtype


def test_checkpoint_restore_refuses_shardings_and_mismatch(tmp_path):
    """With ``mesh=`` and ``spec_tree=`` each leaf comes back a DTensor
    with its spec's placements (a (1, 1) mesh of one gloo rank; the (2, 2)
    mesh: tests/test_torch_sharded_step.py); a mismatch raises."""
    from test_torch_sharded_step import one_rank_mesh
    tree = _tree()
    path = save_checkpoint(tmp_path, 0, tree)
    specs = _tree_specs(tree)
    with one_rank_mesh(tmp_path) as mesh:
        placed, _ = restore_checkpoint(path, tree, mesh=mesh, spec_tree=specs)
        whole = [(t.placements, t.full_tensor()) for t in jax.tree_util.tree_leaves(
            placed, is_leaf=lambda v: isinstance(v, torch.Tensor))]
    plain, _ = restore_checkpoint(path, tree)
    from repro_torch.distributed.sharding import ShardingRules, is_spec_leaf, named_sharding

    want = [named_sharding(mesh, ShardingRules(), s)
            for s in jax.tree_util.tree_leaves(specs, is_leaf=is_spec_leaf)]
    assert len(want) == len(whole) == 6
    for (pl, t), p, w in zip(whole, jax.tree_util.tree_leaves(plain), want):
        assert tuple(pl) == w and torch.equal(t, p)
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(path, {**tree, "step": np.zeros(2)})
    with pytest.raises(KeyError, match="missing leaf"):
        restore_checkpoint(path, {**tree, "extra": np.zeros(1)})


def test_async_checkpointer_copies_first_and_keeps_the_newest(tmp_path):
    ckpt = AsyncCheckpointer(tmp_path, keep=2)
    state = {"x": torch.zeros(3)}
    for step in range(4):
        ckpt.save(step, state)
        state["x"] += 1.0  # the caller moves on; the save holds its own copy
    ckpt.wait()
    assert not ckpt.busy and list_checkpoints(tmp_path) == [2, 3]
    assert latest_checkpoint(tmp_path).name == "step_00000003"
    got, _ = restore_checkpoint(latest_checkpoint(tmp_path), state)
    assert torch.equal(got["x"], torch.full((3,), 3.0))


# -- in-process: snapshot / restore / replay is bit-exact -------------------


def test_snapshot_resume_replay_is_bit_equal(svc, tmp_path):
    """Worker A dies after step 8 with its last snapshot at step 5; worker
    B (same store, other shard) restores from the snapshot and the client
    replays 6..8.  Every score equals an uninterrupted run, bit for bit."""
    T = 12
    data = np.random.default_rng(1).standard_normal((T, FEATS)).astype(np.float32)

    gw_o = svc.open_gateway(capacity=4)
    dur_o = enable_durability(gw_o, str(tmp_path / "oracle"), shard="oracle")
    sid_o, _ = dur_o.admit()
    oracle = [dur_o.step(sid_o, data[t])[0] for t in range(T)]

    store = str(tmp_path / "store")
    gw_a = svc.open_gateway(capacity=4)
    dur_a = enable_durability(gw_a, store, shard="worker-0")
    sid, token = dur_a.admit()
    errs, tokens = [], {0: token}
    for t in range(8):
        e, seq, tokens[seq] = dur_a.step(sid, data[t])
        errs.append(e)
        if t == 4:
            dur_a.snapshot_now(wait=True)

    gw_b = svc.open_gateway(capacity=4)
    dur_b = enable_durability(gw_b, store, shard="worker-1")
    out = dur_b.resume(tokens[8])
    assert out["sid"] == sid and out["seq"] == 5  # snapshot position
    errs_b = [dur_b.step(sid, data[t])[0] for t in range(5, T)]
    np.testing.assert_array_equal(np.asarray(oracle), np.asarray(errs[:5] + errs_b))

    # parked handoff: suspend on B, snapshot, resume on a fresh C at the
    # EXACT position (zero replay needed)
    last_tok = dur_b.step(sid, np.zeros(FEATS, np.float32))[2]
    dur_b.suspend(sid)
    dur_b.snapshot_now(wait=True)
    gw_c = svc.open_gateway(capacity=4)
    dur_c = enable_durability(gw_c, store, shard="worker-2")
    assert dur_c.resume(last_tok)["seq"] == T + 1


def test_step_tokens_amortize_but_resume_anywhere(svc, tmp_path):
    gw = svc.open_gateway(capacity=4)
    dur = enable_durability(gw, str(tmp_path), shard="w0")
    dur.token_refresh_steps = 4
    sid, tok0 = dur.admit()
    x = np.zeros(FEATS, np.float32)
    toks = [dur.step(sid, x)[2] for _ in range(8)]
    assert toks[0] == toks[1] == toks[2] == tok0   # cached (seq 1..3)
    assert toks[3] != tok0                         # re-mint at seq 4
    assert toks[3] == toks[4] == toks[5] == toks[6]
    assert toks[7] != toks[3]                      # re-mint at seq 8
    gw.recalibrate(threshold=0.5)                  # bumps the epoch ...
    tok_e = dur.step(sid, x)[2]
    assert tok_e not in toks                       # ... forcing a re-mint
    assert dur.store.signer.verify(tok_e).epoch == 1
    dur.snapshot_now(wait=True)
    dur2 = enable_durability(svc.open_gateway(capacity=4), str(tmp_path), shard="w1")
    assert dur2.resume(toks[1])["seq"] == 9        # stale-seq token: fine
    gw.recalibrate(threshold=None)


def test_unknown_session_and_double_resume_rejected(svc, tmp_path):
    gw = svc.open_gateway(capacity=4)
    dur = enable_durability(gw, str(tmp_path), shard="w0")
    sid, tok = dur.admit()
    dur.step(sid, np.zeros(FEATS, np.float32))
    with pytest.raises(SessionActiveError):
        dur.resume(tok)  # still live on this worker
    ghost = dur.store.signer.issue("s-0000000000000000", 3)
    with pytest.raises(UnknownSessionError):
        dur.resume(ghost)  # validly signed, exists in no snapshot


def test_restore_writes_the_pool_rows_in_place(svc, tmp_path):
    """Resume loads rows into the pool's existing state tensors: no tensor
    is replaced, so a captured pool step (which reads them by address) is
    replayed as it is, never captured again."""
    gw = svc.open_gateway(capacity=4)
    dur = enable_durability(gw, str(tmp_path), shard="w0")
    sid, _ = dur.admit()
    data = _series(5, 6)
    for t in range(3):
        tok = dur.step(sid, data[t])[2]
    dur.suspend(sid)
    pool = gw.pool
    (blk,) = pool._blocks
    before = [(leaf, leaf.data_ptr()) for leaf in blk.leaves()]
    sums = (blk.sq_sum, blk.steps)
    assert dur.resume(tok)["seq"] == 3
    assert [(leaf, leaf.data_ptr()) for leaf in blk.leaves()] == before
    assert (blk.sq_sum, blk.steps) == sums
    np.testing.assert_array_equal(
        [dur.step(sid, data[t])[0] for t in range(3, 6)],
        _solo_errors_via_pool(svc, data)[3:])
    assert pool.captures == 0  # the CPU runs eagerly


def _solo_errors_via_pool(svc, data) -> list:
    gw = svc.open_gateway(capacity=4)
    gw.admit("solo")
    return [gw.step({"solo": x})["solo"] for x in data]


def test_snapshot_layout_and_gauges(svc, tmp_path):
    gw = svc.open_gateway(capacity=4)
    dur = enable_durability(gw, str(tmp_path), shard="w0")
    live, _ = dur.admit()
    parked, _ = dur.admit()
    for sid in (live, parked):
        dur.step(sid, _series(6, 2)[0])
    dur.suspend(parked)
    out = dur.snapshot_now(wait=True)
    assert out["sessions"] == 2 and out["bytes"] > 0
    path = latest_checkpoint(tmp_path / "shards" / "w0")
    meta = json.loads((path / "meta.json").read_text())
    n = meta["num_state_leaves"]
    assert n == 2 * len(svc.params["layers"])
    with np.load(path / "leaves.npz") as data:
        assert {f"pool/state{i}" for i in range(n)} | {"pool/sq_sum", "pool/steps"} <= \
            set(data.files)
        assert {f"parked/{parked}/state{i}" for i in range(n)} <= set(data.files)
        # every c leaf (f32) first, then every h leaf
        hidden = [w["wh"].shape[0] for w in svc.params["layers"]]
        assert [data[f"pool/state{i}"].shape[1] for i in range(n)] == hidden + hidden
    assert meta["sessions"][live]["kind"] == "live"
    assert meta["sessions"][parked]["kind"] == "parked"
    g = gw.stats()["gauges"]
    assert g["durability.snapshot_copy_ms"] >= 0 and g["durability.snapshot_write_ms"] > 0
    # a waited snapshot's write gauge is that write, timed where it ran
    assert g["durability.snapshot_write_ms"] == dur.store.last_write_ms
    assert gw.stats()["durability"]["parked"] == 1


def test_cadence_snapshot_write_is_timed_on_the_writer_thread(svc, tmp_path, monkeypatch):
    """A cadence snapshot (``wait=False``) hands the write to the
    checkpointer's thread: the write gauge is published only once that
    write has completed, with the time the writer thread measured, never
    the handoff's."""
    import repro_torch.checkpoint.manager as manager

    gate = threading.Event()
    real_save = manager.save_checkpoint

    def slow_save(*args, **kw):
        gate.wait(10)
        time.sleep(0.02)
        return real_save(*args, **kw)

    monkeypatch.setattr(manager, "save_checkpoint", slow_save)
    gw = svc.open_gateway(capacity=4)
    dur = enable_durability(gw, str(tmp_path), shard="w0", snapshot_interval_ms=1e6)
    sid, _ = dur.admit()
    dur.step(sid, _series(7, 2)[0])
    assert dur.maybe_snapshot() is True          # the first tick writes
    assert dur.store.busy and dur.store.last_write_ms is None
    assert "durability.snapshot_write_ms" not in gw.stats()["gauges"]
    gate.set()
    dur.store.wait()
    assert dur.maybe_snapshot() is False         # inside the interval: no write
    ms = gw.stats()["gauges"]["durability.snapshot_write_ms"]
    assert ms == dur.store.last_write_ms and ms >= 20.0


# -- over the wire -----------------------------------------------------------


def test_durable_resume_over_binary_frames(svc, tmp_path):
    """A durable session stepped over bp1 yields tokens, and a second
    client resumes from the token with replay: running errors within the
    solo oracle's tolerance, and the JSON protocol too."""
    data = _series(21, 8)
    oracle = _solo_errors(svc, data)
    gw = svc.open_gateway(capacity=4, max_batch=4, max_wait_ms=5.0)
    enable_durability(gw, str(tmp_path / "store"))
    server = GatewayServer(gw, port=0, pump_interval_ms=2.0)
    host, port = server.start_in_thread()
    try:
        for protocol in ("binary", "json"):
            with GatewayClient(host, port, protocol=protocol) as c1:
                for t in range(5):
                    c1.step(data[t])
                c1.request("snapshot")
                c1.step(data[5])  # past the snapshot: replayed below
                token, replay = c1.session_token, c1.replay_buffer()
                assert token and c1.session_seq == 6
            with GatewayClient(host, port, protocol=protocol) as c2:
                out = c2.resume(token, replay=replay)
                # the drop parked the session at seq 6, fresher than the
                # snapshot, so nothing needed replaying
                assert out["seq"] == 6 and out["replayed"] == 0
                errs = [c2.step(data[t])["running_error"] for t in range(6, 8)]
                np.testing.assert_allclose(errs, oracle[6:], rtol=RTOL, atol=ATOL)
                c2.end_session()
    finally:
        server.stop_in_thread()


def test_wire_rejects_tampered_expired_unknown_tokens(svc, tmp_path):
    store = str(tmp_path / "store")
    gw = svc.open_gateway(capacity=4, max_batch=4, max_wait_ms=5.0)
    enable_durability(gw, store)
    server = GatewayServer(gw, port=0, pump_interval_ms=2.0)
    host, port = server.start_in_thread()
    try:
        with GatewayClient(host, port) as c:
            c.step(np.zeros(FEATS, np.float32))
            good = c.session_token
            with pytest.raises(GatewayClientError) as ei:
                c.request("resume", token=good)  # this connection carries it
            assert ei.value.error == "ValueError"
            with GatewayClient(host, port, protocol="binary") as c2:
                with pytest.raises(GatewayClientError) as ei:
                    c2.request("resume", token=good)  # live elsewhere
                assert ei.value.error == "SessionActiveError"
        secret = load_or_create_secret(store)

        def resume_error(token) -> str:
            with GatewayClient(host, port) as c2:
                with pytest.raises(GatewayClientError) as ei:
                    c2.request("resume", token=token)
            return ei.value.error

        mid = len(good) // 2
        flipped = good[:mid] + ("A" if good[mid] != "A" else "B") + good[mid + 1:]
        assert resume_error(flipped) == "TamperedTokenError"
        assert resume_error("garbage") == "TamperedTokenError"
        expired = TokenSigner(secret, ttl_s=3600.0,
                              clock=lambda: time.time() - 7200.0).issue("s-feedfacefeedface", 3)
        assert resume_error(expired) == "ExpiredTokenError"
        unknown = TokenSigner(secret).issue("s-feedfacefeedface", 3)
        assert resume_error(unknown) == "UnknownSessionError"
    finally:
        server.stop_in_thread()


def test_drain_hands_off_and_a_new_server_resumes(svc, tmp_path):
    """A rolling restart on one store: the drain snapshots every resident
    durable session (the handoff), and a second server resumes each at its
    exact position — bit-equal to an uninterrupted run."""
    store = str(tmp_path / "store")
    data = [_series(30 + i, 10) for i in range(3)]
    uninterrupted = [_solo_errors_via_pool(svc, d) for d in data]
    gw = svc.open_gateway(capacity=4)
    enable_durability(gw, store)
    server = GatewayServer(gw, port=0, pump_interval_ms=2.0)
    host, port = server.start_in_thread()
    clients = [GatewayClient(host, port, protocol="binary") for _ in data]
    got = [[] for _ in data]
    for c, d, g in zip(clients, data, got):
        g.extend(c.step_many(d[:6]))
    clients[0].close()  # dropped: parked before the drain
    server.stop_in_thread()
    assert gw.durability.last_handoff["sessions_migrated"] == 2
    assert gw.durability.last_handoff["parked_carried"] == 1
    gw2 = svc.open_gateway(capacity=4)
    enable_durability(gw2, store)
    server2 = GatewayServer(gw2, port=0, pump_interval_ms=2.0)
    host, port = server2.start_in_thread()
    try:
        for c, d, g in zip(clients, data, got):
            with GatewayClient(host, port) as c2:
                out = c2.resume(c.session_token, replay=c.replay_buffer())
                assert (out["seq"], out["replayed"]) == (6, 0)
                g.extend(c2.step_many(d[6:]))
            c.close()
    finally:
        server2.stop_in_thread()
    np.testing.assert_array_equal(np.asarray(got), np.asarray(uninterrupted, np.float32))


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_snapshot_resumes_across_packages(pair, tmp_path, direction):
    """A session stepped and snapshotted by one package's DurableSessions
    resumes on the other package's server (the reference's client
    against the port's server, and the reverse) and continues within
    1e-5 of the reference's uninterrupted run."""
    ref, mine = pair
    store = str(tmp_path / "store")
    data = _series(44, 10)
    sess, oracle = ref.stream_start(1), []
    for x in data:
        errs, sess = ref.stream_step(x[None], sess)
        oracle.append(float(errs[0]))
    first, second = (ref, mine) if direction == "jax-to-port" else (mine, ref)
    enable = jax_enable_durability if first is ref else enable_durability
    dur = enable(first.open_gateway(capacity=4), store, shard="writer")
    sid, token = dur.admit()
    for t in range(6):
        _, _, token = dur.step(sid, data[t])
    dur.snapshot_now(wait=True)

    gw = second.open_gateway(capacity=4, max_batch=4, max_wait_ms=5.0)
    if second is mine:
        enable_durability(gw, store, shard="reader")
        server, client_cls = GatewayServer(gw, port=0, pump_interval_ms=2.0), JaxGatewayClient
    else:
        jax_enable_durability(gw, store, shard="reader")
        server, client_cls = JaxGatewayServer(gw, port=0, pump_interval_ms=2.0), GatewayClient
    host, port = server.start_in_thread()
    try:
        with client_cls(host, port, protocol="binary") as c:
            out = c.resume(token)
            assert out["seq"] == 6
            np.testing.assert_allclose(out["running_error"], oracle[5], rtol=RTOL, atol=ATOL)
            rest = c.step_many(data[6:])
            np.testing.assert_allclose(rest, oracle[6:], rtol=RTOL, atol=ATOL)
            c.end_session()
    finally:
        server.stop_in_thread()  # every client closed first
