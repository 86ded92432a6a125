"""Elementwise ops: the PyTorch port (deepspeed_tpu_torch.ops.activations)
against the JAX package's, on the same numpy inputs.  Dropout masks come
from different generators, so dropout is held to its contract instead."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepspeed_tpu.ops import activations as jax_act
from deepspeed_tpu_torch.ops.activations import (bias_gelu, dropout, gelu,
                                                 gelu_exact)


@pytest.mark.parametrize("approximate", [True, False])
def test_bias_gelu_matches_jax(approximate):
    """fp32, atol = rtol = 1e-6."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 64)) * 3).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    ref = jax_act.bias_gelu(jnp.asarray(x), jnp.asarray(b),
                            approximate=approximate)
    out = bias_gelu(torch.from_numpy(x), torch.from_numpy(b),
                    approximate=approximate)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("fn,jax_fn", [(gelu, jax_act.gelu),
                                       (gelu_exact, jax_act.gelu_exact)])
def test_gelu_bf16_keeps_dtype_and_matches_jax(fn, jax_fn):
    """bf16 in, bf16 out, fp32 inside; atol = rtol = 2e-2."""
    x = np.random.default_rng(1).standard_normal(256).astype(np.float32)
    out = fn(torch.from_numpy(x).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    ref = jax_fn(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref),
                               rtol=2e-2, atol=2e-2)


def test_dropout_contract():
    """Identity when deterministic or at rate 0; otherwise kept entries are
    scaled by 1/keep, the rest are 0, the keep share is near 1 - rate, and
    one generator seed gives one mask."""
    x = torch.ones(64, 256)
    assert dropout(x, 0.3, deterministic=True) is x
    assert dropout(x, 0.0) is x
    a = dropout(x, 0.25, torch.Generator().manual_seed(3))
    b = dropout(x, 0.25, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    kept = a != 0
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.75))
    assert abs(kept.float().mean().item() - 0.75) < 0.02
