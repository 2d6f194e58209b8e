"""scripts/kernel_variants.py, the tool that times variants of a port kernel
on the GPU: its source edit and its reading of the ptxas report, on the CPU."""
import os
import sys

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import kernel_variants  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402


@pytest.mark.parametrize("kernel,spec", [
    ("lstm_cell", "kTargetBlocks = 128;=>kTargetBlocks = 256;"),
    ("flash_attention", "kMmaWarps = 4;=>kMmaWarps = 8;"),
    ("lstm_seq", "kTargetThreads = 256;=>kTargetThreads = 512;"),
])
def test_variant_replaces_one_constant_of_the_committed_source(kernel, spec):
    source = (_build.CSRC / f"{kernel}.cu").read_text()
    old, new = spec.split("=>")
    got = kernel_variants.apply_variant(source, spec)
    assert got.count(new) == 1 and old not in got
    assert len(got) == len(source) + len(new) - len(old)


@pytest.mark.parametrize("spec,match", [
    ("int x;=>int y;", "occurs 0 times"),
    ("a=>b", "occurs 2 times"),
    ("no arrow", "OLD=>NEW"),
])
def test_variant_refuses_an_ambiguous_or_missing_edit(spec, match):
    with pytest.raises(ValueError, match=match):
        kernel_variants.apply_variant("a; a;", spec)


def test_ptxas_summary_reads_registers_and_nonzero_spills():
    log = ("ptxas info    : Used 168 registers, used 1 barriers\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 128 registers, used 1 barriers\n"
           "    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n")
    assert kernel_variants.ptxas_summary(log) == {"registers": [168, 128], "spill_bytes": [8, 12]}
