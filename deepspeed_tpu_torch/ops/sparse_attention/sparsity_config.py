"""Block-sparsity configurations: the layouts of block-sparse attention.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``
(and so of the reference's ``ops/sparse_attention/sparsity_config.py``).
Each config builds a (num_blocks, num_blocks) bool layout over ``block``-sized
tiles of the sequence; ``flash_attention_sparse`` turns it into the CSR pair
lists its CUDA kernels walk. The port keeps its own copy (numpy only) and
builds the same layouts bit for bit, the seeded ``RandomState(0)`` of the
BigBird and Variable random blocks included.

One layout is shared by all heads, as in the JAX package:
``different_layout_per_head`` and ``num_different_global_patterns`` are
accepted and collapse to that one layout.
"""

from __future__ import annotations

import numpy as np


class SparsityConfig:
    """Base: the dense layout."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(f"seq_len {seq_len} not divisible by block {self.block}")
        n = seq_len // self.block
        return np.zeros((n, n), dtype=bool)

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = True
        return layout


class DenseSparsityConfig(SparsityConfig):
    """Every block attends everywhere."""


class FixedSparsityConfig(SparsityConfig):
    """Local windows of ``num_local_blocks`` plus global columns: the last
    ``num_global_blocks`` of every window."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_local_blocks=4, num_global_blocks=1,
                 attention="bidirectional", horizontal_global_attention=False,
                 num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[0]
        L, G = self.num_local_blocks, self.num_global_blocks
        for i in range(n):
            w = (i // L) * L
            layout[i, w:min(w + L, n)] = True           # local window
        for w in range(0, n, L):                         # global columns
            g0 = max(0, min(w + L, n) - G)
            layout[:, g0:min(w + L, n)] = True
            if self.horizontal_global_attention:
                layout[g0:min(w + L, n), :] = True
        return layout


def _global_block_ends(indices, end_indices):
    if end_indices is not None and len(end_indices) != len(indices):
        raise ValueError("global_block_end_indices must match global_block_indices in length")
    return end_indices


def _set_global_blocks(layout, indices, end_indices, horizontal: bool):
    n = layout.shape[0]
    for i, g in enumerate(indices):
        if g >= n:
            continue
        end = min(end_indices[i], n) if end_indices else g + 1
        layout[:, g:end] = True
        if horizontal:
            layout[g:end, :] = True


def _set_random_blocks(layout, num_random_blocks: int):
    n = layout.shape[0]
    rng = np.random.RandomState(0)
    for i in range(n):
        layout[i, rng.choice(n, size=min(num_random_blocks, n), replace=False)] = True


class VariableSparsityConfig(SparsityConfig):
    """Local windows of the listed sizes (the last one repeating), explicit
    global blocks, and optional random blocks."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=0, local_window_blocks=None,
                 global_block_indices=None, global_block_end_indices=None,
                 attention="bidirectional", horizontal_global_attention=False):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = _global_block_ends(self.global_block_indices,
                                                           global_block_end_indices)
        self.horizontal_global_attention = horizontal_global_attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[0]
        i = widx = 0
        while i < n:
            w = self.local_window_blocks[min(widx, len(self.local_window_blocks) - 1)]
            layout[i:i + w, i:min(i + w, n)] = True
            i += w
            widx += 1
        _set_global_blocks(layout, self.global_block_indices, self.global_block_end_indices,
                           self.horizontal_global_attention)
        if self.num_random_blocks:
            _set_random_blocks(layout, self.num_random_blocks)
        return layout


class BigBirdSparsityConfig(SparsityConfig):
    """Sliding window, global rows and columns, and random blocks."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=1, num_sliding_window_blocks=3,
                 num_global_blocks=1, attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[0]
        w = self.num_sliding_window_blocks // 2
        for i in range(n):
            layout[i, max(0, i - w):min(n, i + w + 1)] = True
        g = self.num_global_blocks
        layout[:, :g] = True
        layout[:g, :] = True
        _set_random_blocks(layout, self.num_random_blocks)
        return layout


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """A sliding window and nothing else; ``attention='unidirectional'`` (the
    default) keeps only its causal half."""

    def __init__(self, num_heads, block=16, num_sliding_window_blocks=3,
                 attention="unidirectional"):
        super().__init__(num_heads, block)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[0]
        w = self.num_sliding_window_blocks // 2
        for i in range(n):
            hi = min(n, i + w + 1) if self.attention == "bidirectional" else i + 1
            layout[i, max(0, i - w):hi] = True
        return layout


class BSLongformerSparsityConfig(SparsityConfig):
    """Sliding window plus the listed global blocks (rows and columns)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_sliding_window_blocks=3, global_block_indices=None,
                 global_block_end_indices=None, attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = _global_block_ends(self.global_block_indices,
                                                           global_block_end_indices)

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[0]
        w = self.num_sliding_window_blocks // 2
        for i in range(n):
            layout[i, max(0, i - w):min(n, i + w + 1)] = True
        _set_global_blocks(layout, self.global_block_indices, self.global_block_end_indices,
                           horizontal=True)
        return layout


# the ds_config "sparse_attention" block's modes
MODES = {"dense": DenseSparsityConfig, "fixed": FixedSparsityConfig,
         "variable": VariableSparsityConfig, "bigbird": BigBirdSparsityConfig,
         "bslongformer": BSLongformerSparsityConfig,
         "localslidingwindow": LocalSlidingWindowSparsityConfig}
