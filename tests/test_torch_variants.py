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
    ("wkv6", "kGroups = 4;=>kGroups = 8;"),
    ("wkv6", "kChunk = 8;=>kChunk = 4;"),
    ("wkv6", "kStages = 3;=>kStages = 4;"),
    ("wkv6", "kBlockThreads = 128;=>kBlockThreads = 64;"),
    ("wkv6", "kStepUnroll = 8;=>kStepUnroll = 2;"),
    ("lstm_stack", "kSlots = 4;=>kSlots = 8;"),
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


def test_every_built_kernel_takes_variants():
    assert set(kernel_variants.KERNELS) == set(_build.KERNELS)


def test_ptxas_summary_reads_registers_and_nonzero_spills():
    log = ("ptxas info    : Used 168 registers, used 1 barriers\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 128 registers, used 1 barriers\n"
           "    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n")
    assert kernel_variants.ptxas_summary(log) == {"registers": [168, 128], "spill_bytes": [8, 12]}


def test_sass_loops_counts_loop_bodies_and_their_fp32_share():
    sass = """
        Function : _Z6kernelv
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   FFMA R5, R4, R6, R5 ;
        /*0030*/                   FMUL R7, R4, R6 ;
        /*0040*/               @!P0 BRA 0x10 ;
        /*0050*/                   FADD R5, R5, R7 ;
        /*0060*/              @P1 BRA 0x30 ;
        /*0070*/                   BRA 0x70;
        /*0080*/                   EXIT ;
"""
    # the branch to itself that ends every kernel is no loop
    got = kernel_variants.sass_loops(sass)
    assert got == {"_Z6kernelv": [(0x10, 4, 2), (0x30, 4, 2)]}
