"""Layers of the LM families, as plain PyTorch on tensors.

Counterpart of ``repro/layers``: the same parameter trees, shapes and
layouts, so ``repro_torch.utils.params_from_numpy`` carries the JAX
package's weights over unchanged.  The transformer's layers (linear,
norms, rotary, embeddings, mlp, attention, moe), RWKV-6's (rwkv) and
Jamba's Mamba mixer (mamba) are ported.
"""
