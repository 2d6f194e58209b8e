"""The port's fault-tolerant training loop and launchers on the CPU:
``repro_torch.distributed`` (heartbeat monitor, failure injection,
``run_with_recovery``) against the cases of
tests/test_checkpoint_fault.py:109-133 and against the JAX package's own
recovery loop from carried params; train-state checkpoints that cross
between the packages; ``python -m repro_torch.launch.train`` with a
resume from its newest checkpoint; ``launch.dryrun --placement`` against
the reference's report; and the control-plane flags of
``launch.serve``, which no longer exit as not ported (only ``--mesh``
does).
"""
import argparse
import functools
import json
import os
import re
import signal
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore_checkpoint as jax_restore_checkpoint  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save_checkpoint  # noqa: E402
from repro.config import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.config import get_config as jax_get_config  # noqa: E402
from repro.data import TimeseriesConfig as JaxTimeseriesConfig  # noqa: E402
from repro.data import TimeseriesIterator as JaxTimeseriesIterator  # noqa: E402
from repro.distributed import fault as jax_fault  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.training import build_train_step as jax_build_train_step  # noqa: E402
from repro.training import init_train_state as jax_init_train_state  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.config import TrainConfig, get_config  # noqa: E402
from repro_torch.data import TimeseriesConfig, TimeseriesIterator  # noqa: E402
from repro_torch.distributed import (  # noqa: E402
    FailureInjector,
    HeartbeatMonitor,
    SimulatedFailure,
    run_with_recovery,
)
from repro_torch.models import train_loss  # noqa: E402
from repro_torch.training import build_train_step, init_train_state  # noqa: E402
from repro_torch.utils import params_from_numpy, tree_leaves  # noqa: E402

ARCH = "lstm-ae-f32-d2"
ROOT = Path(__file__).resolve().parent.parent
DATA = dict(features=32, seq_len=12, batch=8, anomaly_rate=0.0)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _reference_state(tc_kw):
    api = build_model(jax_get_config(ARCH))
    return api, jax_init_train_state(api, jax.random.PRNGKey(0), JaxTrainConfig(**tc_kw))


def _port_loop(params_np, tc_kw):
    """The port's state from carried params, its train step, its iterator."""
    tc = TrainConfig(**tc_kw)
    state = init_train_state(params_from_numpy(params_np, "cpu"), tc)
    api = types.SimpleNamespace(loss=functools.partial(train_loss, cfg=get_config(ARCH)))
    step = build_train_step(api, tc)
    return state, (lambda s, b: step(s, {"series": b[0]})), TimeseriesIterator(TimeseriesConfig(**DATA))


TC = dict(learning_rate=5e-3, warmup_steps=3, total_steps=25)


def test_straggler_detection():
    mon = HeartbeatMonitor(straggler_factor=2.0)
    for _ in range(20):
        mon.report("host0", 0.10)
        mon.report("host1", 0.11)
    mon.report("host2", 0.5)  # 5x median
    assert mon.stragglers() == ["host2"]
    assert 0.09 < mon.p50() < 0.2


def test_failure_injector_fires_once_per_step():
    inj = FailureInjector((3,))
    inj.maybe_fail(2)
    with pytest.raises(SimulatedFailure, match="step 3"):
        inj.maybe_fail(3)
    inj.maybe_fail(3)  # once each


def test_recovery_matches_clean_run(tmp_path):
    """Kill the job twice; the recovered loss trajectory equals the clean
    run's (rtol 1e-5, as the reference holds its own; on one CPU thread the
    two are bit-equal), and the heartbeat monitor saw every step."""
    _, jstate = _reference_state(TC)
    params = jax.tree.map(np.asarray, jstate.params)
    state, step, it = _port_loop(params, TC)
    _, clean = run_with_recovery(state=state, train_step=step, iterator=it, total_steps=25,
                                 ckpt_dir=tmp_path / "clean", ckpt_every=10)
    state, step, it = _port_loop(params, TC)
    mon = HeartbeatMonitor()
    final, faulty = run_with_recovery(state=state, train_step=step, iterator=it, total_steps=25,
                                      ckpt_dir=tmp_path / "faulty", ckpt_every=10,
                                      injector=FailureInjector((7, 17)), monitor=mon)
    np.testing.assert_allclose(faulty, clean, rtol=1e-5)
    assert faulty == clean
    assert len(mon.history["host0"]) == 25 + 7 + 7  # replays after each restore
    assert int(final.opt.step) == 25


def test_recovery_losses_match_reference(tmp_path):
    """The JAX package's recovery loop and the port's, from the same
    params and batches with the same two injected failures: the loss per
    step within rtol 1e-5 (the train step's parity tolerance)."""
    tc = dict(learning_rate=5e-3, warmup_steps=3, total_steps=12)
    api, jstate = _reference_state(tc)
    jstep = jax.jit(jax_build_train_step(api, JaxTrainConfig(**tc)))
    _, want = jax_fault.run_with_recovery(
        state=jstate, train_step=lambda s, b: jstep(s, {"series": jnp.asarray(b[0])}),
        iterator=JaxTimeseriesIterator(JaxTimeseriesConfig(**DATA)), total_steps=12,
        ckpt_dir=tmp_path / "ref", ckpt_every=5, injector=jax_fault.FailureInjector((3, 8)))
    state, step, it = _port_loop(jax.tree.map(np.asarray, jstate.params), tc)
    _, got = run_with_recovery(state=state, train_step=step, iterator=it, total_steps=12,
                               ckpt_dir=tmp_path / "port", ckpt_every=5,
                               injector=FailureInjector((3, 8)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_train_state_checkpoints_cross_packages(tmp_path):
    """A train state saved by either package restores in the other: the
    port keys a dataclass field as ``.name``, as ``jax.tree_util`` does."""
    tc = dict(learning_rate=5e-3, warmup_steps=3, total_steps=5)
    _, jstate = _reference_state(tc)
    state, step, it = _port_loop(jax.tree.map(np.asarray, jstate.params), tc)
    for _ in range(2):
        state, _ = step(state, next(it))
    path = save_checkpoint(tmp_path / "port", 2, state, extra_meta={"iterator": it.state_dict()})
    jpath = jax_save_checkpoint(tmp_path / "jax", 0, jstate)
    keys = json.loads((path / "meta.json").read_text())["keys"]
    assert keys == json.loads((jpath / "meta.json").read_text())["keys"]
    assert ".opt/.step" in keys
    restored, meta = jax_restore_checkpoint(path, jstate)
    assert meta["step"] == 2 and meta["iterator"] == it.state_dict()
    assert len(_state_leaves(state)) == len(jax.tree.leaves(restored)) == len(keys)
    for a, b in zip(_state_leaves(state), jax.tree.leaves(restored)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    back, _ = restore_checkpoint(jpath, state)
    for a, b in zip(_state_leaves(back), jax.tree.leaves(jstate)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert back.opt.step.dtype == torch.int32 and back.ef is None


def _state_leaves(state) -> list:
    """A train state's leaves in ``jax.tree.leaves`` order (fields in order)."""
    return (tree_leaves(state.params) + [state.opt.step] + tree_leaves(state.opt.mu)
            + tree_leaves(state.opt.nu) + (tree_leaves(state.ef) if state.ef is not None else []))


def _train(ckpt_dir, steps, *extra):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH, "--device", "cpu",
         "--steps", str(steps), "--ckpt-every", "3", "--ckpt-dir", str(ckpt_dir),
         "--batch", "4", "--seq-len", "8", *extra],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def _losses(text):
    return dict(re.findall(r"step\s+(\d+)\s+loss=(\S+)", text))


def test_train_launcher_resumes_from_newest_checkpoint(tmp_path):
    """Two runs over one checkpoint directory continue the trajectory of
    one uninterrupted run: params, optimizer state and the iterator's
    position come back from the newest checkpoint."""
    first = _train(tmp_path / "a", 6)
    assert "resumed" not in first and "mesh=none, device=cpu" in first
    second = _train(tmp_path / "a", 9)
    assert "[train] resumed from step 6" in second
    assert sorted(os.listdir(tmp_path / "a")) == ["step_00000003", "step_00000006",
                                                  "step_00000009"]
    whole = _train(tmp_path / "b", 9)
    assert _losses(second)["8"] == _losses(whole)["8"]
    assert "stragglers=" in second


def test_launchers_raise_without_a_gpu(tmp_path):
    """``train`` and ``serve --workers`` default to the GPU and raise
    without one, as every other entry point does."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device resolves")
    for cmd in (["repro_torch.launch.train", "--arch", ARCH, "--steps", "1",
                 "--ckpt-dir", str(tmp_path)],
                ["repro_torch.launch.serve", "--arch", ARCH, "--workers", "2"]):
        out = subprocess.run([sys.executable, "-m", *cmd], env=_env(), cwd=ROOT,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and "no CUDA device" in out.stderr, out.stderr


# -- dryrun --placement ------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--max-batch", "16"],
    ["--max-batch", "256", "--seq-len", "48", "--slo-p95-ms", "10", "--target-rps", "50000",
     "--full-config"],
    ["--max-batch", "8", "--slo-p95-ms", "0.01"],
])
def test_dryrun_placement_report_matches_reference(tmp_path, argv, capsys):
    from repro.launch.dryrun import placement_report as ref_report
    from repro_torch.launch import dryrun

    dryrun.main(["--placement", "data=1", "--arch", "lstm-ae-f64-d6",
                 "--out", str(tmp_path / "port"), *argv])
    printed = capsys.readouterr().out
    ns = argparse.Namespace(arch="lstm-ae-f64-d6", placement="data=1", reduced=True,
                            max_batch=16, seq_len=64, slo_p95_ms=None, target_rps=None,
                            out=str(tmp_path / "ref"))
    for flag, value in zip(argv[::2], argv[1::2]):
        setattr(ns, flag[2:].replace("-", "_"), float(value) if "." in value or "rps" in flag
                or "slo" in flag else int(value))
    if "--full-config" in argv:
        ns.reduced = False
    want = ref_report(ns)
    name = "placement__lstm-ae-f64-d6__data1.json"
    got = json.loads((tmp_path / "port" / name).read_text())
    assert got == json.loads((tmp_path / "ref" / name).read_text()) == json.loads(json.dumps(want))
    assert printed.replace(str(tmp_path / "port"), "OUT") == \
        capsys.readouterr().out.replace(str(tmp_path / "ref"), "OUT")


def test_dryrun_refuses_what_is_not_ported(tmp_path, capsys):
    """``--placement`` on an LM exits, as the reference's does (the gateway
    it reports on serves the LSTM-AE; the cells of every arch are
    ``tests/test_torch_dryrun.py``'s); ``--placement data=2`` reports as the
    reference's ``placement_report`` does, printed lines included."""
    from repro.launch.dryrun import placement_report as ref_report
    from repro_torch.launch import dryrun

    lm = argparse.Namespace(arch="tinyllama-1.1b", placement="data=2", reduced=True,
                            max_batch=16, seq_len=64, slo_p95_ms=None, target_rps=None,
                            out=str(tmp_path / "ref"))
    with pytest.raises(SystemExit) as ref_exit:
        ref_report(lm)
    with pytest.raises(SystemExit) as port_exit:
        dryrun.main(["--placement", "data=2", "--arch", "tinyllama-1.1b",
                     "--out", str(tmp_path / "port")])
    assert str(port_exit.value) == str(ref_exit.value)
    capsys.readouterr()
    dryrun.main(["--placement", "data=2", "--arch", ARCH, "--out", str(tmp_path / "port")])
    printed = capsys.readouterr().out
    ref_report(argparse.Namespace(arch=ARCH, placement="data=2", reduced=True, max_batch=16,
                                  seq_len=64, slo_p95_ms=None, target_rps=None,
                                  out=str(tmp_path / "ref")))
    name = f"placement__{ARCH}__data2.json"
    got = json.loads((tmp_path / "port" / name).read_text())
    assert got == json.loads((tmp_path / "ref" / name).read_text())
    assert got["data_shards"] == 2 and got["rows_per_shard"] == 8
    assert printed.replace(str(tmp_path / "port"), "OUT") == \
        capsys.readouterr().out.replace(str(tmp_path / "ref"), "OUT")


# -- serve: the control-plane flags and --mesh -------------------------------


def test_serve_control_config_matches_reference():
    from repro.launch.serve import control_cfg_for as ref_cfg_for
    from repro.launch.serve import parse_autoscale as ref_parse
    from repro_torch.launch.serve import control_cfg_for, parse_autoscale

    for spec in (None, "", "1:3", "2:2"):
        assert parse_autoscale(spec) == ref_parse(spec)
    for bad in ("3", "0:2", "3:1"):
        with pytest.raises(SystemExit):
            parse_autoscale(bad)
    base = dict(slo_p95_ms=None, control_tick_s=1.0, priority_classes=1, tenant_rate=None,
                seq_len=64, arch=ARCH, max_wait_ms=5.0)
    for kw, autoscale in ((base, None), ({**base, "slo_p95_ms": 25.0}, None),
                          ({**base, "priority_classes": 3, "tenant_rate": 50.0}, (1, 2)),
                          (base, (1, 4))):
        ns = argparse.Namespace(**kw)
        got, want = control_cfg_for(ns, autoscale=autoscale), ref_cfg_for(ns, autoscale=autoscale)
        assert (got is None) == (want is None)
        if got is not None:
            assert vars(got) == vars(want)


def test_serve_mesh_is_the_only_flag_not_ported(capsys):
    """``--mesh`` is ported: ``--mesh data=2 --device cpu`` serves from an
    engine on two emulated CPU devices; a spec with another axis exits."""
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--mesh", "data=2", "--device", "cpu", "--requests", "2",
                "--batch", "4", "--seq-len", "8"])
    out = capsys.readouterr().out
    assert f"[serve] {ARCH}-reduced [wavefront]: 2 requests" in out
    with pytest.raises(SystemExit):
        serve.main(["--arch", ARCH, "--mesh", "model=2", "--device", "cpu"])
    assert "axes supported: data" in capsys.readouterr().err
    assert not hasattr(serve, "NOT_PORTED")


def test_serve_http_runs_the_control_plane(tmp_path):
    """``serve --http`` with an SLO and priority classes attaches the
    control plane: the ready line says so, its ticks ride the pump, its
    section shows in the wire ``stats``, its decisions land in
    ``controller.jsonl``, and the SIGTERM drain still exits 0."""
    from repro_torch.gateway.client import GatewayClient

    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--http",
         "--device", "cpu", "--port", "0", "--slo-p95-ms", "50", "--priority-classes", "3",
         "--control-tick-s", "0.1", "--max-batch", "4", "--event-dir", str(tmp_path)],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert "listening on" in line and "slo_p95_ms=50.0, priority_classes=3" in line, line
        port = int(line.split("listening on ")[1].split()[0].rsplit(":", 1)[1])
        rng = np.random.default_rng(1)
        with GatewayClient("127.0.0.1", port) as c:
            for _ in range(4):
                assert np.isfinite(c.score(rng.standard_normal((8, 32)).astype(np.float32)))
            deadline = time.monotonic() + 30
            while c.stats()["control"]["ticks"] < 2:
                assert time.monotonic() < deadline
                time.sleep(0.05)
            control = c.stats()["control"]
        assert control["slo_p95_ms"] == 50.0 and control["admission"]["classes"] == 3
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0 and "[http] drained: 4 one-shot scores" in out, out
    rows = [json.loads(ln) for ln in (tmp_path / "controller.jsonl").read_text().splitlines()]
    assert rows and all(r["kind"] == "control_tick" and r["scope"] == "gateway" for r in rows)
