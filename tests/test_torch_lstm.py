"""Port parity: repro_torch.core.lstm against repro.core.lstm on the four
paper configs, with the same weights (carried as numpy arrays) and inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.config import get_config as jax_get_config  # noqa: E402
from repro.core import lstm as jl  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.core import lstm as tl  # noqa: E402
from repro_torch.utils import params_from_numpy, params_to_numpy  # noqa: E402

PAPER_ARCHS = ["lstm-ae-f32-d2", "lstm-ae-f32-d6", "lstm-ae-f64-d2", "lstm-ae-f64-d6"]
RTOL, ATOL = 1e-5, 1e-6


def _np_params(arch):
    return jax.tree.map(np.asarray, jl.init_lstm_ae(jax.random.PRNGKey(0), jax_get_config(arch)))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=rtol, atol=atol)


def test_config_copy_matches_reference():
    """Every arch of the reference's registry is the port's, field for field
    (``dataclasses.asdict``), full and reduced: the paper configs'
    ``subquadratic=True`` included.  The port has one arch more, of a family
    the reference lacks (``tests/test_torch_moonlight.py``)."""
    import dataclasses

    from repro.config import list_archs as jax_list_archs
    from repro.config import reduced_config as jax_reduced_config
    from repro_torch.config import list_archs, reduced_config

    # the port's registry is the reference's and its own DeepSeek-V3 arch
    assert list_archs() == sorted(jax_list_archs() + ["moonlight-16b-a3b"])
    for arch in jax_list_archs():
        for mine, ref in ((get_config(arch), jax_get_config(arch)),
                          (reduced_config(arch), jax_reduced_config(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref), arch
    for arch in PAPER_ARCHS:
        mine, ref = get_config(arch), jax_get_config(arch)
        assert mine.subquadratic and reduced_config(arch).subquadratic
        assert mine.lstm_ae.layer_sizes() == ref.lstm_ae.layer_sizes()
        assert mine.lstm_ae.layer_input_sizes() == ref.lstm_ae.layer_input_sizes()
    from repro.config import LSTMAE_SHAPES as ref_shapes
    from repro_torch.config import LSTMAE_SHAPES

    assert [(s.name, s.seq_len, s.global_batch, s.kind) for s in LSTMAE_SHAPES] == \
        [(s.name, s.seq_len, s.global_batch, s.kind) for s in ref_shapes]


def test_weight_carrier_round_trip():
    tree = _np_params("lstm-ae-f32-d6")
    back = params_to_numpy(params_from_numpy(tree, "cpu"))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert isinstance(back["layers"], tuple)


def test_init_lstm_ae_shapes_and_distribution():
    """Seeded torch init: the reference's shapes and truncated-normal law
    (values differ from JAX's by design)."""
    cfg = get_config("lstm-ae-f64-d6")
    p = tl.init_lstm_ae(torch.Generator().manual_seed(0), cfg, device="cpu")
    ref = _np_params("lstm-ae-f64-d6")
    for mine, theirs in zip(p["layers"], ref["layers"]):
        for k in ("wx", "wh", "b"):
            assert tuple(mine[k].shape) == theirs[k].shape and mine[k].dtype == torch.float32
        std = mine["wx"].shape[0] ** -0.5
        assert float(mine["wx"].abs().max()) <= 2 * std + 1e-7
        assert not mine["b"].any()
    again = tl.init_lstm_ae(torch.Generator().manual_seed(0), cfg, device="cpu")
    torch.testing.assert_close(p["layers"][0]["wx"], again["layers"][0]["wx"], rtol=0, atol=0)
    big = tl.init_lstm_ae(torch.Generator().manual_seed(1), get_config("lstm-ae-f64-d2"), "cpu")
    w = big["layers"][1]["wh"] * 64 ** 0.5   # unit-std truncated normal: std ~0.88
    assert 0.85 < float(w.std()) < 0.91


def test_pwl_activations():
    x = np.linspace(-6, 6, 97, dtype=np.float32)
    _close(tl.pwl_sigmoid(torch.from_numpy(x)), jl.pwl_sigmoid(jnp.asarray(x)), 0, 0)
    _close(tl.pwl_tanh(torch.from_numpy(x)), jl.pwl_tanh(jnp.asarray(x)), 0, 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pwl", [False, True])
@pytest.mark.parametrize("in_dim,hidden", [(32, 16), (16, 64)])
def test_lstm_cell(in_dim, hidden, pwl, dtype):
    rng = np.random.default_rng(in_dim + hidden)
    p = jax.tree.map(np.asarray, jl.init_lstm_cell(jax.random.PRNGKey(hidden), in_dim, hidden))
    p["b"] = rng.standard_normal(4 * hidden).astype(np.float32) * 0.1
    x, h = (rng.standard_normal((5, n)).astype(np.float32) for n in (in_dim, hidden))
    c = rng.standard_normal((5, hidden)).astype(np.float32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    hj, cj = jl.lstm_cell(p, jnp.asarray(x, jd), jnp.asarray(h, jd), jnp.asarray(c), pwl=pwl)
    ht, ct = tl.lstm_cell(params_from_numpy(p, "cpu"), torch.from_numpy(x).to(td),
                          torch.from_numpy(h).to(td), torch.from_numpy(c), pwl=pwl)
    assert ht.dtype == td and ct.dtype == torch.float32
    tol = (RTOL, ATOL) if dtype == "float32" else (2e-2, 2e-2)
    _close(ht, np.asarray(hj, np.float32), *tol)
    _close(ct, np.asarray(cj, np.float32), *tol)


@pytest.mark.parametrize("with_state", [False, True])
def test_lstm_layer(with_state):
    rng = np.random.default_rng(7)
    p = jax.tree.map(np.asarray, jl.init_lstm_cell(jax.random.PRNGKey(2), 32, 16))
    xs = rng.standard_normal((6, 3, 32)).astype(np.float32)
    h0 = rng.standard_normal((3, 16)).astype(np.float32) if with_state else None
    c0 = rng.standard_normal((3, 16)).astype(np.float32) if with_state else None
    ys_j, (h_j, c_j) = jl.lstm_layer(p, jnp.asarray(xs), h0, c0)
    ys_t, (h_t, c_t) = tl.lstm_layer(
        params_from_numpy(p, "cpu"), torch.from_numpy(xs),
        None if h0 is None else torch.from_numpy(h0), None if c0 is None else torch.from_numpy(c0))
    for got, want in ((ys_t, ys_j), (h_t, h_j), (c_t, c_j)):
        _close(got, want)


@pytest.mark.parametrize("pwl", [False, True])
@pytest.mark.parametrize("arch", PAPER_ARCHS)
def test_lstm_ae_sequential_and_error(arch, pwl):
    tree = _np_params(arch)
    f = get_config(arch).lstm_ae.input_features
    xs = np.random.default_rng(3).standard_normal((7, 3, f)).astype(np.float32)
    params = params_from_numpy(tree, "cpu")
    _close(tl.lstm_ae_sequential(params, torch.from_numpy(xs), pwl=pwl),
           jl.lstm_ae_sequential(tree, jnp.asarray(xs), pwl=pwl))
    _close(tl.lstm_ae_reconstruction_error(params, torch.from_numpy(xs), pwl=pwl),
           jl.lstm_ae_reconstruction_error(tree, jnp.asarray(xs), pwl=pwl))


@pytest.mark.parametrize("arch", PAPER_ARCHS)
def test_stacked_cell_params(arch):
    tree = _np_params(arch)
    st_j, in_j, hid_j = jl.stacked_cell_params(tree["layers"])
    st_t, in_t, hid_t = tl.stacked_cell_params(params_from_numpy(tree, "cpu")["layers"])
    assert (in_t, hid_t) == (in_j, hid_j)
    for k in ("wx", "wh", "b"):
        np.testing.assert_array_equal(st_t[k].numpy(), np.asarray(st_j[k]))
    # explicit global padding (the stage-grouping form)
    sub_j, _, _ = jl.stacked_cell_params(tree["layers"][:1], in_max=128, h_max=96)
    sub_t, _, _ = tl.stacked_cell_params(params_from_numpy(tree, "cpu")["layers"][:1],
                                         in_max=128, h_max=96)
    for k in ("wx", "wh", "b"):
        np.testing.assert_array_equal(sub_t[k].numpy(), np.asarray(sub_j[k]))
