"""GPT-2 (counterpart of deepspeed_tpu/models/gpt2.py), the serving forward.

The parameters mirror the JAX tree: `wte` [V, H], `wpe` [P, H], the layers
under `h.<i>.` (unrolled in a Python loop where the JAX package scans a
stacked [L, ...] tree), `ln_f.w`/`ln_f.b`, and `lm_head` [H, V] when the
embeddings are untied.  Training (the loss, the fused cross-entropy, layer
streaming) comes with the training slice.
"""

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..ops.normalize import fused_layer_norm
from ..ops.transformer import (DeepSpeedTransformerConfig,
                               DeepSpeedTransformerLayer)


@dataclass
class GPT2Config:
    vocab_size: int = 50304          # 50257 padded to a 128 multiple
    n_positions: int = 1024
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None
    embd_dropout: float = 0.1
    attn_dropout: float = 0.1
    hidden_dropout: float = 0.1
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    bf16: bool = True
    tie_word_embeddings: bool = True

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size

    @property
    def dtype(self):
        return torch.bfloat16 if self.bf16 else torch.float32

    def layer_config(self) -> DeepSpeedTransformerConfig:
        return DeepSpeedTransformerConfig(
            hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            heads=self.num_heads,
            attn_dropout_ratio=self.attn_dropout,
            hidden_dropout_ratio=self.hidden_dropout,
            num_hidden_layers=self.num_layers,
            initializer_range=self.initializer_range,
            layer_norm_eps=self.layer_norm_eps,
            bf16=self.bf16,
            pre_layer_norm=True,
            causal=True,
        )


class _FinalNorm(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.w = nn.Parameter(torch.ones(hidden), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(hidden), requires_grad=False)


class GPT2Model(nn.Module):
    """Decoder-only LM over DeepSpeedTransformerLayers.  Parameters are
    fp32 at creation (embeddings and matmul weights zero until
    init_params or load_state_dict); compute runs in config.dtype."""

    # parameters that stay fp32 when the inference engine casts the rest
    LN_PARAMS = ("ln_f.w", "ln_f.b")

    def __init__(self, config: GPT2Config):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.wte = nn.Parameter(torch.zeros(config.vocab_size, h),
                                requires_grad=False)
        self.wpe = nn.Parameter(torch.zeros(config.n_positions, h),
                                requires_grad=False)
        layer_cfg = config.layer_config()
        self.h = nn.ModuleList(DeepSpeedTransformerLayer(layer_cfg)
                               for _ in range(config.num_layers))
        self.ln_f = _FinalNorm(h)
        if not config.tie_word_embeddings:
            self.lm_head = nn.Parameter(torch.zeros(h, config.vocab_size),
                                        requires_grad=False)

    def is_ln_param(self, name: str) -> bool:
        return name in self.LN_PARAMS or \
            name.rsplit(".", 1)[-1] in DeepSpeedTransformerLayer.LN_PARAMS

    @torch.no_grad()
    def init_params(self, generator: torch.Generator):
        """Embeddings and matmul weights ~ N(0, initializer_range) drawn
        from `generator` (on the parameters' device), biases 0, LN 1/0."""
        std = self.config.initializer_range
        self.wte.normal_(0.0, std, generator=generator)
        self.wpe.normal_(0.0, std, generator=generator)
        for layer in self.h:
            layer.init_params(generator)
        self.ln_f.w.fill_(1.0)
        self.ln_f.b.zero_()
        if not self.config.tie_word_embeddings:
            self.lm_head.normal_(0.0, std, generator=generator)
        return self

    # -- forward -------------------------------------------------------- #
    def embed(self, input_ids, position_offset: int = 0):
        """Token + position embedding of int ids [B, S]; position_offset
        places a decode token at its position in the sequence."""
        dtype = self.config.dtype
        ids = input_ids.long()
        pos = torch.arange(position_offset, position_offset + ids.shape[1],
                           device=ids.device)
        return self.wte.to(dtype)[ids] + self.wpe.to(dtype)[pos]

    def _head_matrix(self, dtype):
        """[H, V] LM projection: tied wte.T or the untied lm_head."""
        if self.config.tie_word_embeddings:
            return self.wte.to(dtype).T
        return self.lm_head.to(dtype)

    def head_logits(self, h):
        """Final LN + LM head, fp32 logits."""
        h = fused_layer_norm(h, self.ln_f.w, self.ln_f.b,
                             self.config.layer_norm_eps)
        return (h @ self._head_matrix(h.dtype)).float()

    def hidden_states(self, input_ids):
        """input_ids [B, S] -> pre-head hidden states [B, S, H]
        (deterministic: dropout belongs to the training slice)."""
        h = self.embed(input_ids)
        for layer in self.h:
            h = layer(h)
        return h

    def logits(self, input_ids):
        return self.head_logits(self.hidden_states(input_ids))

    forward = logits
