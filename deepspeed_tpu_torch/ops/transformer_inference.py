"""Inference layer with a KV cache (counterpart of
deepspeed_tpu/ops/transformer_inference.py).

Prefill runs the layer's flash path (kernel B) over the whole prompt and
fills the cache; decode is a one-token step whose attention over the cache
is plain PyTorch, as in the JAX package.  The cache is a static-shape
[B, heads, max_len, d] pair that prefill and decode write IN PLACE (JAX
returns an updated copy instead); decode attends to the filled prefix
cache[..., :pos + 1, :], which computes the same function as the JAX
package's mask over the whole static cache.
"""

import math
from typing import NamedTuple, Optional

import torch

from .flash_attention import flash_attention
from .transformer import DeepSpeedTransformerConfig, DeepSpeedTransformerLayer


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, heads, max_len, head_dim]
    v: torch.Tensor


def init_kv_cache(batch: int, heads: int, max_len: int, head_dim: int,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    shape = (batch, heads, max_len, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


class DeepSpeedTransformerInference:
    """Inference twin of DeepSpeedTransformerLayer: the same parameters
    (the layer module is passed where the JAX package passes its params
    dict), plus the KV-cache plumbing."""

    def __init__(self, config: DeepSpeedTransformerConfig):
        self.config = config

    def prefill(self, layer: DeepSpeedTransformerLayer, x, cache: KVCache,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-prompt forward, x [B, S, H]; writes K/V at positions [0, S)
        of the cache in place and returns the layer output."""
        cfg = self.config
        x = x.to(cfg.dtype)
        q, k, v = layer.qkv_heads(x)
        s = x.shape[1]
        cache.k[:, :, :s].copy_(k)
        cache.v[:, :, :s].copy_(v)
        ctx = flash_attention(q, k, v, causal=cfg.causal, bias=attn_mask)
        return layer.attn_out_mlp(ctx, x)

    def decode(self, layer: DeepSpeedTransformerLayer, x, cache: KVCache,
               pos: int) -> torch.Tensor:
        """One-token step, x [B, 1, H] at position `pos`; writes its K/V at
        `pos` in place and attends to cache positions [0, pos]."""
        cfg = self.config
        x = x.to(cfg.dtype)
        q, k, v = layer.qkv_heads(x)  # [B, heads, 1, d]
        cache.k[:, :, pos:pos + 1].copy_(k)
        cache.v[:, :, pos:pos + 1].copy_(v)
        keys = cache.k[:, :, :pos + 1]
        values = cache.v[:, :, :pos + 1]
        d = q.shape[-1]
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), keys.float()) / \
            math.sqrt(d)
        p = torch.softmax(s, dim=-1).to(values.dtype)
        ctx = torch.einsum("bhqk,bhkd->bhqd", p, values)
        return layer.attn_out_mlp(ctx, x)
