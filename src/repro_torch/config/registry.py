"""Architecture registry of the port: ``--arch <id>`` resolves here.

Each ``repro_torch/configs/<id>.py`` module defines ``CONFIG`` (the paper's
configuration) and ``reduced()`` (a smoke-test-sized config of the same
family).  The port serves every architecture of the reference's registry:
the paper's four LSTM-AE models, the transformer LMs, dense and MoE, the
RWKV-6 LM, the Jamba hybrid and the Whisper encoder-decoder; and the archs
of ``PORT_ONLY``, which the reference has no family for (the DeepSeek-V3
``moonlight-16b-a3b``).  The dry run's cells are the reference's archs'
(``launch/dryrun.py``): its analytic roofline has no latent attention.
"""
from __future__ import annotations

import importlib

from repro_torch.config.core import ModelConfig

_ARCH_MODULES: dict[str, str] = {
    # DeepSeek-V3: latent attention, sigmoid-routed experts with shared ones
    "moonlight-16b-a3b": "repro_torch.configs.moonlight_16b_a3b",
    # MoE decoder-only transformers
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    # hybrid: Mamba + attention (1:7) with MoE on every second layer
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    # attention-free recurrent LM
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    # encoder-decoder with the audio frontend stubbed
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    # dense decoder-only transformers of the reference's assigned pool
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "phi-3-vision-4.2b": "repro_torch.configs.phi_3_vision_4_2b",
    # the paper's own models (Section 4.1)
    "lstm-ae-f32-d2": "repro_torch.configs.lstm_ae_f32_d2",
    "lstm-ae-f32-d6": "repro_torch.configs.lstm_ae_f32_d6",
    "lstm-ae-f64-d2": "repro_torch.configs.lstm_ae_f64_d2",
    "lstm-ae-f64-d6": "repro_torch.configs.lstm_ae_f64_d6",
}

REGISTRY = dict(_ARCH_MODULES)  # public view of known ids
# archs of the port alone: the reference's registry has no family for them
PORT_ONLY = ("moonlight-16b-a3b",)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    """The exact published configuration for ``arch``."""
    return _module(arch).CONFIG


def reduced_config(arch: str) -> ModelConfig:
    """A smoke-test-sized config of the same family."""
    return _module(arch).reduced()


def list_archs() -> list[str]:
    return sorted(_ARCH_MODULES)


def reference_archs() -> list[str]:
    """The archs the reference's registry also has: ``list_archs()`` less
    ``PORT_ONLY``."""
    return [a for a in list_archs() if a not in PORT_ONLY]
