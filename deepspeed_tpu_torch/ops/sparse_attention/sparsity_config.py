"""Block-sparse attention layouts (a copy of
deepspeed_tpu/ops/sparse_attention/sparsity_config.py, which is numpy
only; the port keeps its own copy so that it imports nothing of the JAX
package).  The layouts are bitwise those of the JAX package, BigBird's and
Variable's random blocks included (`np.random.RandomState(seed)`).

Reference: deepspeed/ops/sparse_attention/sparsity_config.py —
SparsityConfig:9 (base, block size + per-head layouts), Dense:63, Fixed:94
(Sparse-Transformers-style local windows + global summary columns),
Variable:243 (custom window sizes, random + global blocks), BigBird:421
(random + sliding window + global), BSLongformer:544 (sliding window +
selected global tokens).

A layout is a boolean array [num_heads, num_blocks, num_blocks]; entry
(h, i, j) allows query block i to attend key block j for head h.  Layouts
are built in NumPy once per sequence length; the consumers turn them into
gather indices (sparse_self_attention.py, block_sparse_flash.py).
"""

from typing import List, Optional

import numpy as np


class SparsityConfig:
    """Base layout config (reference: sparsity_config.py:9)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(
                f"seq_len {seq_len} must be divisible by block {self.block}")
        num_blocks = seq_len // self.block
        return np.zeros((self.num_heads, num_blocks, num_blocks), bool)

    def check_and_propagate_first_head_layout(
            self, layout: np.ndarray) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[1:] = layout[0:1]
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """All blocks attend all blocks (reference: Dense:63) — debugging /
    parity baseline."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[...] = True
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Sparse-Transformers 'fixed' pattern (reference: Fixed:94).

    Blocks attend their local window of `num_local_blocks`; the last
    `num_global_blocks` blocks of each window are global columns (attended
    by everyone); optional horizontal global rows.  `attention`
    'unidirectional' lower-triangles everything for causal LMs.
    `num_different_global_patterns` rotates which window-slice acts global
    across heads (requires different_layout_per_head)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 num_different_global_patterns: int = 1):
        super().__init__(num_heads, block, different_layout_per_head)
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(f"attention {attention!r}")
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError(
                "horizontal global attention needs bidirectional attention")
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError(
                f"num_local_blocks {num_local_blocks} must be a multiple of "
                f"num_global_blocks {num_global_blocks}")
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError(
                "num_different_global_patterns > 1 needs "
                "different_layout_per_head")
        if num_different_global_patterns > (num_local_blocks //
                                            num_global_blocks):
            raise ValueError("too many global patterns for the window size")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        uni = self.attention == "unidirectional"
        for h in range(self.num_heads):
            # local windows
            for start in range(0, nb, self.num_local_blocks):
                end = min(start + self.num_local_blocks, nb)
                for i in range(start, end):
                    hi = (i + 1) if uni else end
                    layout[h, i, start:hi] = True
            # global slice index rotates across heads
            pattern = (h % self.num_different_global_patterns)
            first = (self.num_local_blocks -
                     (pattern + 1) * self.num_global_blocks)
            for start in range(0, nb, self.num_local_blocks):
                g0 = start + first
                g1 = g0 + self.num_global_blocks
                if g1 > nb:
                    continue
                # vertical: everyone (after, if unidirectional) sees globals
                lo = g1 if uni else 0
                layout[h, lo:, g0:g1] = True
                if uni:
                    # within-window causality already covers rows < g1
                    pass
                if self.horizontal_global_attention:
                    layout[h, g0:g1, :] = True
        if uni:
            tril = np.tril(np.ones((nb, nb), bool))
            layout &= tril[None]
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """Custom local windows + random + global blocks (reference:
    Variable:243).  local_window_blocks lists successive window sizes (last
    repeats); global_block_indices/end_indices choose global columns."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 0,
                 local_window_blocks: Optional[List[int]] = None,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 seed: int = 1):
        super().__init__(num_heads, block, different_layout_per_head)
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(f"attention {attention!r}")
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = (global_block_indices
                                     if global_block_indices is not None
                                     else [0])
        self.global_block_end_indices = global_block_end_indices
        if global_block_end_indices is not None and len(
                global_block_end_indices) != len(self.global_block_indices):
            raise ValueError("global block start/end lists differ in length")
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        uni = self.attention == "unidirectional"
        rng = np.random.RandomState(self.seed)
        # local windows of varying size
        sizes = list(self.local_window_blocks)
        for h in range(self.num_heads):
            start = 0
            k = 0
            while start < nb:
                w = sizes[min(k, len(sizes) - 1)]
                end = min(start + w, nb)
                for i in range(start, end):
                    hi = (i + 1) if uni else end
                    layout[h, i, start:hi] = True
                start = end
                k += 1
            # random blocks (per head when different_layout_per_head)
            for i in range(nb):
                if self.num_random_blocks > 0:
                    cols = rng.choice(nb, self.num_random_blocks,
                                      replace=False)
                    for c in cols:
                        if not uni or c <= i:
                            layout[h, i, c] = True
            # global columns/rows
            for gi, g0 in enumerate(self.global_block_indices):
                if self.global_block_end_indices is not None:
                    g1 = self.global_block_end_indices[gi]
                else:
                    g1 = g0 + 1
                g0, g1 = min(g0, nb), min(g1, nb)
                lo = g1 if uni else 0
                layout[h, lo:, g0:g1] = True
                if self.horizontal_global_attention:
                    layout[h, g0:g1, :] = True
        if uni:
            layout &= np.tril(np.ones((nb, nb), bool))[None]
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird: random + sliding window + global (reference: BigBird:421)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 1,
                 num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1, seed: int = 1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        if nb < self.num_sliding_window_blocks:
            raise ValueError(
                f"{nb} blocks < sliding window "
                f"{self.num_sliding_window_blocks}")
        rng = np.random.RandomState(self.seed)
        w = self.num_sliding_window_blocks // 2
        g = self.num_global_blocks
        for h in range(self.num_heads):
            for i in range(nb):
                layout[h, i, max(0, i - w):min(nb, i + w + 1)] = True  # band
                cols = rng.choice(nb, self.num_random_blocks, replace=False)
                layout[h, i, cols] = True                              # rand
            layout[h, :, :g] = True   # first blocks global (columns)
            layout[h, :g, :] = True   # ...and rows
            layout[h, :, nb - g:] = True
            layout[h, nb - g:, :] = True
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer: sliding window + selected global blocks
    (reference: BSLongformer:544)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = (global_block_indices
                                     if global_block_indices is not None
                                     else [0])
        self.global_block_end_indices = global_block_end_indices
        if global_block_end_indices is not None and len(
                global_block_end_indices) != len(self.global_block_indices):
            raise ValueError("global block start/end lists differ in length")

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_heads):
            for i in range(nb):
                layout[h, i, max(0, i - w):min(nb, i + w + 1)] = True
            for gi, g0 in enumerate(self.global_block_indices):
                if self.global_block_end_indices is not None:
                    g1 = self.global_block_end_indices[gi]
                else:
                    g1 = g0 + 1
                g0, g1 = min(g0, nb), min(g1, nb)
                layout[h, :, g0:g1] = True
                layout[h, g0:g1, :] = True
        return self.check_and_propagate_first_head_layout(layout)
