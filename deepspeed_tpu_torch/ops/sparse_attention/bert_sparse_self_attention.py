"""BERT-style sparse self-attention module (counterpart of
deepspeed_tpu/ops/sparse_attention/bert_sparse_self_attention.py):
query / key / value projections and SparseSelfAttention with the BERT
attention mask as the key-padding mask, returning the merged
[B, S, hidden] context.

The parameters follow the JAX tree ({"query": {"kernel", "bias"}, ...},
kernels [in, out], `x @ W`), so `query.kernel` of the state dict is the JAX
leaf `["query"]["kernel"]`.
"""

from typing import Optional

import torch
from torch import nn

from .sparse_self_attention import SparseSelfAttention
from .sparsity_config import FixedSparsityConfig, SparsityConfig


class _Projection(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(hidden, hidden))
        self.bias = nn.Parameter(torch.zeros(hidden))

    def forward(self, x):
        return x @ self.kernel.to(x.dtype) + self.bias.to(x.dtype)


class BertSparseSelfAttention(nn.Module):
    """`BertSparseSelfAttention(config, sparsity_config)`: config needs
    `hidden_size` and `num_attention_heads` (or `num_heads`), like the
    reference's BERT config contract."""

    def __init__(self, config, sparsity_config: Optional[SparsityConfig]
                 = None, key_padding_mask_mode: str = "add"):
        super().__init__()
        hidden = getattr(config, "hidden_size")
        heads = getattr(config, "num_attention_heads",
                        getattr(config, "num_heads", None))
        if heads is None:
            raise ValueError("config needs num_attention_heads/num_heads")
        if hidden % heads:
            raise ValueError(
                f"The hidden size ({hidden}) is not a multiple of the "
                f"number of attention heads ({heads})")
        self.num_attention_heads = heads
        self.attention_head_size = hidden // heads
        self.all_head_size = hidden
        if sparsity_config is None:
            sparsity_config = FixedSparsityConfig(num_heads=heads)
        if sparsity_config.num_heads != heads:
            raise ValueError(
                f"sparsity_config built for {sparsity_config.num_heads} "
                f"heads, model has {heads}")
        self.query = _Projection(hidden)
        self.key = _Projection(hidden)
        self.value = _Projection(hidden)
        self.sparse_self_attention = SparseSelfAttention(
            sparsity_config, key_padding_mask_mode=key_padding_mask_mode)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator):
        """Kernels ~ N(0, 0.02) drawn from `generator`, biases 0."""
        for proj in (self.query, self.key, self.value):
            proj.kernel.normal_(0.0, 0.02, generator=generator)
            proj.bias.zero_()
        return self

    def _transpose_for_scores(self, x):
        b, s, _ = x.shape
        return x.view(b, s, self.num_attention_heads,
                      self.attention_head_size).transpose(1, 2)

    def forward(self, hidden_states, attention_mask=None):
        """hidden_states [B, S, hidden]; attention_mask [B, S] is the
        key-padding mask, as in the reference forward
        (bert_sparse_self_attention.py:78).  Its values follow this
        module's key_padding_mask_mode: the default 'add' takes an
        additive mask (0 keep, a large negative such as -10000 pad); 'mul'
        takes 1 keep / 0 pad.  Returns the [B, S, hidden] context."""
        qh, kh, vh = (self._transpose_for_scores(proj(hidden_states))
                      for proj in (self.query, self.key, self.value))
        ctx = self.sparse_self_attention(qh, kh, vh,
                                         key_padding_mask=attention_mask)
        b, _, s, _ = ctx.shape
        return ctx.transpose(1, 2).reshape(b, s, self.all_head_size)
