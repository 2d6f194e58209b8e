import os
import sys

# tests run on the REAL single CPU device (the 512-device override is
# exclusively for launch/dryrun.py, per the assignment)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (hand-written CUDA kernels); skips elsewhere")

# -- shared gateway/transport test helpers (test_gateway.py, test_server.py).
# Both suites check the same contract — pooled/socketed serving is value-
# identical to solo streaming — so the reference data and solo oracle live
# here, one copy.  The AnomalyService fixtures stay per-module on purpose:
# several tests mutate the service (thresholds, monkeypatched engines) and
# module isolation keeps those blast radii apart.

GATEWAY_ARCH = "lstm-ae-f32-d2"
GATEWAY_FEATS = 32


def gateway_series(stream: int, t_len: int = 16, seed: int = 0):
    """Deterministic (T, F) window for logical stream ``stream``."""
    import numpy as np

    rng = np.random.default_rng(np.random.SeedSequence([seed, stream]))
    return rng.standard_normal((t_len, GATEWAY_FEATS)).astype(np.float32)


def breaking_score_masked(engine, fail_times: list, make_exc=None):
    """Wrap ``engine.score_masked`` to raise while ``fail_times[0] > 0``
    (then recover) — the flush-failure injection both suites use."""
    real = engine.score_masked
    if make_exc is None:
        def make_exc():
            return RuntimeError("injected engine failure")

    def broken(batch):
        if fail_times[0] > 0:
            fail_times[0] -= 1
            raise make_exc()
        return real(batch)

    return broken


def solo_stream_errors(svc, samples) -> list:
    """Running errors of one stream stepped alone (B=1), per timestep —
    the oracle every pooled/socketed serving path must match."""
    import jax.numpy as jnp

    sess = svc.stream_start(1)
    out = []
    for x in samples:
        errs, sess = svc.stream_step(jnp.asarray(x[None]), sess)
        out.append(float(errs[0]))
    return out
