"""Layers of the LM families, as plain PyTorch on tensors.

Counterpart of ``repro/layers``: the same parameter trees, shapes and
layouts, so ``repro_torch.utils.params_from_numpy`` carries the JAX
package's weights over unchanged.  The transformer's layers (linear,
norms, rotary, embeddings, mlp, attention, moe), RWKV-6's (rwkv),
Jamba's Mamba mixer (mamba) and Whisper's cross-attention and sinusoidal
table (in attention and rotary) are ported: every layer module of the
reference, each with its ``*_specs`` (logical-axis spec trees, equal to
the reference's; ``repro_torch.distributed.sharding``).
"""
