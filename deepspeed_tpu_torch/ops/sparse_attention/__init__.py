"""Block-sparse attention: the layouts and the config-driven module.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/``. The reference's
Triton block-sparse matmuls and softmax are one fused computation here,
``flash_attention_sparse``, whose forward and backward are the CUDA kernels
of ``csrc/sparse_attention.cu`` walking the layout's CTA schedules.
"""

from __future__ import annotations

import math

import torch

from deepspeed_tpu_torch.ops.pallas.flash_attention import (NEG_INF, flash_attention_sparse,
                                                            sparse_mha_reference, sparse_pairs)
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    MODES, BigBirdSparsityConfig, BSLongformerSparsityConfig, DenseSparsityConfig,
    FixedSparsityConfig, LocalSlidingWindowSparsityConfig, SparsityConfig,
    VariableSparsityConfig)


class SparseSelfAttention:
    """Config-driven block-sparse attention on (B, T, H, D) tensors, with one
    layout per sequence length, built at first use.

    Without masks it runs the fused kernel path (:func:`flash_attention_sparse`).
    A ``key_padding_mask`` (B, T) or an ``attn_mask`` (T, T), True where a
    key is kept, changes the visible keys per row, which a block layout
    cannot express: then the dense masked computation runs, as in the JAX
    package."""

    def __init__(self, sparsity_config: SparsityConfig, key_padding_mask_mode: str = "add",
                 attn_mask_mode: str = "mul"):
        self.sparsity_config = sparsity_config
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self._layouts = {}

    def get_layout(self, seq_len: int):
        if seq_len not in self._layouts:
            self._layouts[seq_len] = self.sparsity_config.make_layout(seq_len)
        return self._layouts[seq_len]

    def __call__(self, q, k, v, causal: bool = True, key_padding_mask=None, attn_mask=None):
        layout = self.get_layout(q.shape[1])
        if key_padding_mask is None and attn_mask is None:
            return flash_attention_sparse(q, k, v, layout, causal=causal)
        mask = sparse_pairs(layout, causal, q.shape[1], q.device).mask[None, None]
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (1.0 / math.sqrt(q.shape[-1]))
        logits = logits.masked_fill(~mask, NEG_INF)
        if key_padding_mask is not None:
            keep = torch.as_tensor(key_padding_mask, device=q.device).bool()
            logits = logits.masked_fill(~keep[:, None, None, :], NEG_INF)
        if attn_mask is not None:
            keep = torch.as_tensor(attn_mask, device=q.device).bool()
            logits = logits.masked_fill(~keep[None, None], NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def sparse_self_attention(block: dict, num_heads: int) -> SparseSelfAttention:
    """The module of a ds_config ``sparse_attention`` block: ``mode``
    (default "fixed") picks the layout class and the other keys are its
    keyword arguments, so a key of another mode raises ``TypeError``."""
    d = dict(block)
    mode = d.pop("mode", "fixed")
    if mode not in MODES:
        raise ValueError(f"sparse_attention mode {mode!r} unknown")
    return SparseSelfAttention(MODES[mode](num_heads=num_heads, **d))


__all__ = ["SparsityConfig", "DenseSparsityConfig", "FixedSparsityConfig",
           "VariableSparsityConfig", "BigBirdSparsityConfig", "BSLongformerSparsityConfig",
           "LocalSlidingWindowSparsityConfig", "SparseSelfAttention", "sparse_self_attention",
           "flash_attention_sparse", "sparse_mha_reference"]
