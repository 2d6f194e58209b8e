"""The whole-stack kernel's wrapper on the CPU and on meta tensors: its
plain version against K1's chain, its meta op against K1's, its fit rule
and the ``fused`` schedule's choice between the two.  The CUDA kernel
itself is held to the plain version in tests/test_torch_cuda.py."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.config import get_config  # noqa: E402
from repro_torch.core.lstm import init_lstm_ae  # noqa: E402
from repro_torch.engine.schedules import (  # noqa: E402
    STACK_CROSSOVER,
    fused_launches,
    fused_takes_stack,
    stack_max_batch,
)
from repro_torch.kernels import lstm_stack as tst  # noqa: E402
from repro_torch.kernels.lstm_cell import pack_weights  # noqa: E402
from repro_torch.kernels.ops import (  # noqa: E402
    launch_counts,
    lstm_cell_op,
    lstm_stack_op,
    reset_launch_counts,
)

ARCHS = ["lstm-ae-f64-d6", "lstm-ae-f32-d2", "lstm-ae-f64-d2", "lstm-ae-f32-d6"]


def _k1_chain(layers, xs, pwl=False):
    """The ``fused`` schedule's K1 path: one ``lstm_cell_op`` a (layer, timestep)."""
    ys = xs.contiguous()
    t_len, bsz, _ = xs.shape
    for layer in layers:
        packed = pack_weights(layer)
        hidden = packed[1].shape[1]
        out = torch.empty((t_len, bsz, hidden), dtype=xs.dtype, device=xs.device)
        h = torch.zeros((bsz, hidden), dtype=xs.dtype, device=xs.device)
        c = torch.zeros((bsz, hidden), dtype=torch.float32, device=xs.device)
        for t in range(t_len):
            h, c = lstm_cell_op(packed, ys[t], h, c, pwl=pwl, h_out=out[t], c_out=c)
        ys = out
    return ys


def _stack(arch, bsz, t_len, device="cpu", seed=0):
    cfg = get_config(arch)
    params = init_lstm_ae(torch.Generator().manual_seed(seed), cfg, device="cpu")
    layers = [{k: v.to(device) for k, v in layer.items()} for layer in params["layers"]]
    xs = torch.randn(t_len, bsz, cfg.lstm_ae.input_features,
                     generator=torch.Generator().manual_seed(seed + 1)).to(device)
    return layers, xs


@pytest.mark.parametrize("pwl", [False, True])
@pytest.mark.parametrize("t_len", [1, 7, 16])
@pytest.mark.parametrize("bsz", [1, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_plain_version_equals_the_k1_chain(arch, bsz, t_len, pwl):
    """On the CPU ``lstm_stack_op`` is the chain of ``lstm_cell_plain``
    steps that the K1 path makes, bit for bit, and counts no launch."""
    layers, xs = _stack(arch, bsz, t_len, seed=bsz * 100 + t_len)
    reset_launch_counts()
    got = lstm_stack_op(layers, xs, pwl=pwl)
    assert sum(launch_counts().values()) == 0
    want = _k1_chain(layers, xs, pwl=pwl)
    assert got.shape == want.shape == xs.shape and got.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_op_counts_the_k1_chains_flops(arch):
    """On meta tensors the stack is one op whose output and FLOPs equal the
    K1 chain's D x T ops, so the dry run's counts do not move."""
    t_len, bsz = 64, 5
    layers, xs = _stack(arch, bsz, t_len, device="meta")
    counts = []
    for fn in (lstm_stack_op, _k1_chain):
        with FlopCounterMode(display=False) as fc:
            out = fn(layers, xs)
        counts.append(fc.get_total_flops())
        assert out.shape == xs.shape and out.device.type == "meta"
        assert out.dtype == torch.float32
    dims = tst.layer_dims(layers)
    assert counts[0] == counts[1] == sum(8 * bsz * t_len * h * (i + h) for i, h in dims)


def test_fit_rule():
    """Every LSTM-AE configuration fits; the rule's edges: H 64, the slice
    of 96 weights (lstm-ae-f64-d6's widest layer, 32 -> 64, is exactly 96),
    depth 8, chained widths, 48 KB of buffers."""
    for arch in ARCHS:
        cfg = get_config(arch)
        ins = cfg.lstm_ae.layer_input_sizes()
        assert tst.fits(list(zip(ins, cfg.lstm_ae.layer_sizes())))
    assert tst.fits([(8, 64)]) and not tst.fits([(8, 65)])     # H <= 64
    assert tst.fits([(32, 64)]) and not tst.fits([(36, 64)])   # In + H <= 96 at H 64
    assert tst.fits([(160, 32)]) and not tst.fits([(164, 32)])  # (In + H) / 2 <= 96
    assert tst.fits([(8, 8)] * 8) and not tst.fits([(8, 8)] * 9)
    assert not tst.fits([]) and not tst.fits([(8, 16), (8, 8)])
    assert tst.fits([(348, 16)]) and not tst.fits([(352, 16)])  # the buffers at 8 rows, 48 KB
    assert not tst.fits([(0, 8)])


def test_fused_takes_the_stack_at_small_batches():
    """The ``fused`` forward's choice, from what the call can see: the stack
    at B = 1 and at the crossover of each T, K1 above it and at the bulk
    cells' B = 32,768, and K1 for bf16 or f64 inputs, a stack that does not
    fit or CPU tensors."""
    layers, _ = _stack("lstm-ae-f64-d6", 1, 1, device="meta")
    meta = dict(device="meta")
    dims = tst.layer_dims(layers)
    for t_len in (8, 16, 64):
        top = stack_max_batch(dims, t_len)
        for bsz, stack in ((1, True), (top, True), (top + 1, False), (32768, False)):
            xs = torch.empty(t_len, bsz, 64, **meta)
            assert fused_takes_stack(layers, xs) is stack
            assert fused_launches(layers, xs) == ({"lstm_stack": 1} if stack
                                                  else {"lstm_cell": 6 * t_len})
    xs = torch.empty(64, 1, 64, **meta)
    assert not fused_takes_stack(layers, xs.to(torch.bfloat16))
    assert not fused_takes_stack([{k: v.double() for k, v in l.items()} for l in layers],
                                 xs.double())
    wide = [{"wx": torch.empty(64, 4 * 128, **meta), "wh": torch.empty(128, 4 * 128, **meta),
             "b": torch.empty(4 * 128, **meta)}]
    assert not fused_takes_stack(wide, xs)
    cpu_layers, cpu_xs = _stack("lstm-ae-f32-d2", 2, 3)
    assert not fused_takes_stack(cpu_layers, cpu_xs)   # the CPU keeps K1's plain chain


def test_crossover_follows_the_sweep():
    """The crossover grows with T as the chain of D·T K1 launches outgrows
    the stack's T + D − 1 steps, and sits where the sweep on an H100 put it
    (PERF.md): at lstm-ae-f64-d6 the stack was ahead at 768 rows and behind
    at 1,024 for T = 8, ahead at 768 and behind at 1,024 for T = 16, ahead
    at 1,024 and behind at 1,536 for T = 32 and 64; at lstm-ae-f32-d2 ahead
    at 1,024 and behind at 2,048 for every T."""
    measured = {"lstm-ae-f64-d6": {8: (768, 1024), 16: (768, 1024), 32: (1024, 1536),
                                   64: (1024, 1536)},
                "lstm-ae-f32-d2": {t: (1024, 2048) for t in (8, 16, 32, 64)}}
    for arch, by_t in measured.items():
        layers, _ = _stack(arch, 1, 1, device="meta")
        dims = tst.layer_dims(layers)
        tops = [stack_max_batch(dims, t) for t in sorted(by_t)]
        assert tops == sorted(tops)
        for t_len, (ahead, behind) in by_t.items():
            assert ahead <= stack_max_batch(dims, t_len) < behind, (arch, t_len)
    assert stack_max_batch([(64, 32), (32, 16), (16, 8), (8, 16), (16, 32), (32, 64)], 64) == \
        STACK_CROSSOVER * 6 * 64 // (69 * 96)


def test_check_stack_args_refuses_what_the_kernel_does_not_take():
    layers, xs = _stack("lstm-ae-f32-d2", 2, 3)
    tst.check_stack_args(xs, layers)
    bad = [
        (xs[0], layers, ValueError, "must be"),
        (xs[..., :16], layers, ValueError, "features"),
        (xs.double(), layers, TypeError, "float32"),
        (xs, [layers[0], {**layers[1], "b": layers[1]["b"][:8]}], ValueError, "layer 1 b"),
        (xs, [{**layers[0], "wx": layers[0]["wx"].t().contiguous().t()}, layers[1]],
         ValueError, "contiguous"),
    ]
    for args_xs, args_layers, exc, msg in bad:
        with pytest.raises(exc, match=msg):
            tst.check_stack_args(args_xs, args_layers)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tst.lstm_stack_cuda(xs, layers)


def test_fused_engine_on_the_cpu_is_unchanged():
    """The ``fused`` engine on the CPU is K1's chain of plain cells, which
    the stack's plain version equals bit for bit."""
    from repro_torch.engine import build_engine

    cfg = get_config("lstm-ae-f32-d2")
    params = init_lstm_ae(torch.Generator().manual_seed(5), cfg, device="cpu")
    engine = build_engine(cfg, "fused", params=params, device="cpu")
    series = torch.randn(3, 9, 32, generator=torch.Generator().manual_seed(6))
    got = engine.reconstruct({"series": series})
    xs = series.transpose(0, 1).contiguous()
    for want in (_k1_chain(engine.params["layers"], xs), lstm_stack_op(engine.params["layers"], xs)):
        assert torch.equal(got, want.transpose(0, 1))
