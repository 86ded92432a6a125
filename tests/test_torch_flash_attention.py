"""Attention forward: the PyTorch port (deepspeed_tpu_torch.ops.
flash_attention) against the JAX package's Pallas flash kernel
(interpret mode) and its plain mha_reference, on the same numpy inputs.
On the CPU the port runs its plain version; chip_smoke.py holds the CUDA
kernel against it on the card."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepspeed_tpu.ops.flash_attention import flash_attention_pallas
from deepspeed_tpu.ops.flash_attention import mha_reference as jax_mha
from deepspeed_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_attention_cuda)


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_pallas_interpret(causal):
    """out and lse at [2, 4, 128, 32], fp32, atol = rtol = 1e-5."""
    q, k, v = _qkv((2, 4, 128, 32))
    ref_out, ref_lse = flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=64, block_k=64, interpret=True, return_lse=True)
    out, lse = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=1e-5,
                               atol=1e-5)


def test_bias_path_matches_mha_reference():
    """Additive bias takes the plain path on both sides; fp32, 1e-5."""
    q, k, v = _qkv((2, 4, 32, 16), seed=1)
    bias = np.random.default_rng(9).standard_normal(
        (2, 1, 32, 32)).astype(np.float32)
    ref = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  bias=jnp.asarray(bias))
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), bias=torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("seq", [1, 77])
def test_ragged_and_short_sequences_match_mha_reference(seq):
    """Lengths with no 128-aligned tiling (the JAX dispatcher sends them to
    XLA); causal, explicit sm_scale, fp32 1e-5."""
    q, k, v = _qkv((1, 3, seq, 64), seed=2)
    ref = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=True, sm_scale=0.3)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True, sm_scale=0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_bf16_matches_mha_reference():
    """bf16 inputs, fp32 softmax on both sides; atol = rtol = 2e-2."""
    q, k, v = _qkv((2, 2, 64, 64), seed=3)
    ref = jax_mha(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
                  causal=True)
    out = flash_attention(*(torch.from_numpy(t).to(torch.bfloat16)
                            for t in (q, k, v)), causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(t) for t in _qkv((1, 1, 8, 64)))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
