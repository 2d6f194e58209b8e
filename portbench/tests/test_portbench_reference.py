"""The plain reference against the port on the CPU, and the seeded inputs."""
import json

import pytest
import torch

from portbench import harness
from portbench.families import lstm_ae as family
from portbench.reference import lstm_ae_plain
from portbench.series import make_windows


def _cfg(name):
    return json.loads((harness.HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["lstm-ae-f64-d6", "lstm-ae-f32-d2"])
def test_reference_matches_the_port_on_the_cpu(name):
    """The same weights and windows through ``AnomalyService(..., device="cpu")``
    (the fused schedule's plain cell) and through the reference."""
    cfg = _cfg(name)
    gen = torch.Generator().manual_seed(2**31 + 17)
    system = family.build(cfg, gen, torch.device("cpu"))
    series, labels = make_windows(gen, 24, 64, cfg["input_features"], 0.5)
    assert labels.any()
    got = system.score(series)
    want = lstm_ae_plain.scores(system.weights, series, block=10)
    assert family.score_rel_err(got, want) < 1e-5
    # the engine's sequential schedule, the port's own plain path, agrees as well
    from repro_torch.engine import AnomalyService

    seq = AnomalyService(cfg["port_config"], schedule="sequential", device="cpu")
    seq.recalibrate(params={"layers": tuple(system.weights)})
    assert family.score_rel_err(seq.score(series), want) < 1e-5


def test_reference_reads_the_raw_layout_and_takes_blocks():
    cfg = _cfg("lstm-ae-f32-d2")
    gen = torch.Generator().manual_seed(3)
    weights = family.make_weights(cfg, gen)
    assert [tuple(w["wx"].shape) for w in weights] == [(32, 64), (16, 128)]
    assert [tuple(w["wh"].shape) for w in weights] == [(16, 64), (32, 128)]
    for w, h in zip(weights, cfg["layer_sizes"]):
        for t in w.values():
            assert float(t.abs().max()) <= 1 / h ** 0.5
    x, _ = make_windows(gen, 9, 16, 32, 0.0)
    whole = lstm_ae_plain.scores(weights, x, block=9)
    # rows are independent; only the products' blocking differs with the block
    torch.testing.assert_close(lstm_ae_plain.scores(weights, x, block=4), whole,
                               rtol=1e-6, atol=0)
    # one window's score by hand: the mean squared error of its reconstruction
    recon = lstm_ae_plain.reconstruct(weights, x[:1])
    assert recon.shape == x[:1].shape
    assert float(whole[0]) == pytest.approx(float((recon - x[:1]).square().mean()), rel=1e-6)


def test_reference_turns_tf32_back_off(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with lstm_ae_plain.no_tf32():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


def test_tf32_rounding_keeps_ten_bits_of_mantissa():
    one = 1.0
    ulp = 2.0 ** -10                                  # TF32's step at 1
    x = torch.tensor([one, one + ulp / 2, one + ulp / 2 - 2**-20, -(one + ulp / 2),
                      3.0 + 2**-12, 1e-30, -0.0])
    got = lstm_ae_plain.to_tf32(x)
    assert got.tolist()[:4] == [one, one + ulp, one, -(one + ulp)]   # ties away from zero
    assert float(got[4]) == 3.0
    assert torch.equal(lstm_ae_plain.to_tf32(got), got)
    assert float(got[5]) == pytest.approx(1e-30, rel=2**-10)
    assert str(float(got[6])) == "-0.0"


def test_the_control_computes_in_tf32():
    """The control's scores differ from the float32 reference's by TF32's
    rounding: over the f32-d2 cells' limit, far under a fault's reading."""
    cfg = _cfg("lstm-ae-f32-d2")
    gen = torch.Generator().manual_seed(2**31 + 3)
    weights = family.make_weights(cfg, gen)
    x, _ = make_windows(gen, 512, 64, 32, 0.05)
    want = lstm_ae_plain.scores(weights, x, block=512)
    got = family.control(cfg, torch.Generator().manual_seed(2**31 + 3), torch.device("cpu"))
    err = family.score_rel_err(got.score(x), want)
    limit = json.loads((harness.HERE / "workloads" / "f32d2.latency.json").read_text())
    assert float(limit["limits"]["score_rel_err"]) < err < 1e-3


def test_windows_follow_the_generator_of_the_port():
    gen = torch.Generator().manual_seed(2**33 + 1)   # seeds past 32 bits are taken
    x, labels = make_windows(gen, 4000, 64, 64, 0.05)
    assert x.shape == (4000, 64, 64) and x.dtype == torch.float32
    assert 0.03 < float(labels.float().mean()) < 0.07
    benign = x[~labels]
    assert float(benign.abs().max()) < 1.0 + 6 * 0.05
    # an anomalous window differs from a sine mixture on a quarter of its features
    assert float(x[labels].abs().amax(dim=(1, 2)).median()) > 1.5
    again, _ = make_windows(torch.Generator().manual_seed(2**33 + 1), 4000, 64, 64, 0.05)
    assert torch.equal(x, again)
    other, _ = make_windows(torch.Generator().manual_seed(2**33 + 2), 4000, 64, 64, 0.05)
    assert not torch.equal(x, other)


def test_score_rel_err_is_infinite_for_a_wrong_answer():
    want = torch.tensor([1.0, 2.0])
    assert family.score_rel_err(torch.tensor([1.0, 2.002]), want) == pytest.approx(1e-3, rel=1e-4)
    assert family.score_rel_err(torch.tensor([1.0, float("nan")]), want) == float("inf")
    assert family.score_rel_err(torch.tensor([1.0]), want) == float("inf")
