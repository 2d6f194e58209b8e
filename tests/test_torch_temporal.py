"""Port parity: the wavefront schedule (paper §3.2) of repro_torch against
repro.core.temporal and against the port's own layer-by-layer schedule."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.config import get_config as jax_get_config  # noqa: E402
from repro.core import lstm as jl  # noqa: E402
from repro.core import temporal as jt  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.core import temporal as tt  # noqa: E402
from repro_torch.core.lstm import lstm_ae_sequential  # noqa: E402
from repro_torch.utils import params_from_numpy  # noqa: E402

PAPER_ARCHS = ["lstm-ae-f32-d2", "lstm-ae-f32-d6", "lstm-ae-f64-d2", "lstm-ae-f64-d6"]


@pytest.mark.parametrize("n,t", [(1, 1), (2, 5), (6, 3), (6, 16), (4, 1)])
def test_schedule_table_matches_reference(n, t):
    assert tt.schedule_table(n, t) == jt.schedule_table(n, t)


@pytest.mark.parametrize("pwl", [False, True])
@pytest.mark.parametrize("arch", PAPER_ARCHS)
def test_wavefront_forward(arch, pwl):
    tree = jax.tree.map(np.asarray, jl.init_lstm_ae(jax.random.PRNGKey(1), jax_get_config(arch)))
    f = get_config(arch).lstm_ae.input_features
    xs = np.random.default_rng(5).standard_normal((9, 3, f)).astype(np.float32)
    params = params_from_numpy(tree, "cpu")
    got = tt.wavefront_forward(params, torch.from_numpy(xs), pwl=pwl)
    assert tuple(got.shape) == xs.shape
    want = np.asarray(jt.wavefront_forward(tree, jnp.asarray(xs), pwl=pwl))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    seq = lstm_ae_sequential(params, torch.from_numpy(xs), pwl=pwl)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=1e-5, atol=1e-6)


def test_wavefront_single_timestep_shorter_than_depth():
    """T < depth: every output still waits for all layers (drain steps)."""
    tree = jax.tree.map(np.asarray, jl.init_lstm_ae(jax.random.PRNGKey(2),
                                                     jax_get_config("lstm-ae-f32-d6")))
    xs = np.random.default_rng(6).standard_normal((2, 4, 32)).astype(np.float32)
    params = params_from_numpy(tree, "cpu")
    got = tt.wavefront_forward(params, torch.from_numpy(xs))
    np.testing.assert_allclose(got.numpy(), np.asarray(jt.wavefront_forward(tree, jnp.asarray(xs))),
                               rtol=1e-5, atol=1e-6)
