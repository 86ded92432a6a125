"""Elementwise transformer ops (counterpart of deepspeed_tpu/ops/activations.py).

Plain PyTorch, as the JAX package leaves them to XLA fusion.  Dropout
draws from an explicit `torch.Generator` on x's device; its masks are not
JAX's.
"""

import math

import torch


def gelu(x):
    """tanh-approximation gelu, computed in fp32, cast back to x's dtype."""
    xf = x.float()
    out = 0.5 * xf * (1.0 + torch.tanh(0.7978845608028654 *
                                       (xf + 0.044715 * xf * xf * xf)))
    return out.to(x.dtype)


def gelu_exact(x):
    """Exact (erf) gelu, computed in fp32."""
    xf = x.float()
    return (xf * 0.5 * (1.0 + torch.erf(xf / math.sqrt(2.0)))).to(x.dtype)


def bias_gelu(x, bias, approximate: bool = True):
    """bias-add + gelu."""
    y = x + bias
    return gelu(y) if approximate else gelu_exact(y)


def dropout(x, rate: float, generator=None, deterministic: bool = False):
    """Inverted dropout with keep probability 1 - rate, masks drawn from
    `generator` (on x's device)."""
    if deterministic or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def bias_dropout_residual(x, bias, residual, rate: float, generator=None,
                          deterministic: bool = False):
    """bias-add + dropout + residual-add."""
    return dropout(x + bias, rate, generator, deterministic) + residual
