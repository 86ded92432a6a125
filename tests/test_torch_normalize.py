"""LayerNorm: the PyTorch port (deepspeed_tpu_torch.ops.normalize) against
the JAX package's Pallas kernel (interpret mode) and plain reference, on the
same numpy inputs.  On the CPU the port runs its plain version; the CUDA
kernel itself is held against that version on the card by chip_smoke.py."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepspeed_tpu.ops.normalize import layer_norm_pallas
from deepspeed_tpu.ops.normalize import layer_norm_reference as jax_ln_reference
from deepspeed_tpu_torch.ops import dispatch
from deepspeed_tpu_torch.ops.normalize import (fused_layer_norm,
                                               layer_norm_cuda,
                                               layer_norm_reference)


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3.0 + 0.5).astype(np.float32)
    gamma = (rng.standard_normal(shape[-1]) + 1.0).astype(np.float32)
    beta = rng.standard_normal(shape[-1]).astype(np.float32)
    return x, gamma, beta


@pytest.mark.parametrize("shape", [(4, 96, 256), (16, 32), (8, 768)])
def test_fused_layer_norm_matches_pallas_interpret(shape):
    """fp32, atol = rtol = 1e-5 (same statistics, summation order aside)."""
    x, g, b = _inputs(shape)
    ref = layer_norm_pallas(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                            interpret=True)
    out = fused_layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                           torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
def test_layer_norm_reference_matches_jax_reference(eps):
    x, g, b = _inputs((6, 48), seed=1)
    ref = jax_ln_reference(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                           eps)
    out = layer_norm_reference(torch.from_numpy(x), torch.from_numpy(g),
                               torch.from_numpy(b), eps)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_fused_layer_norm_bf16_matches_jax():
    """bf16 activations, fp32 gamma/beta (the serving layout); atol = rtol
    = 2e-2, the chip-lane bf16 tolerance."""
    x, g, b = _inputs((8, 2, 768), seed=2)
    ref = jax_ln_reference(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g),
                           jnp.asarray(b))
    out = fused_layer_norm(torch.from_numpy(x).to(torch.bfloat16),
                           torch.from_numpy(g), torch.from_numpy(b))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_cpu_tensors_take_the_plain_path_and_the_wrapper_refuses_them():
    x, g, b = _inputs((4, 64), seed=3)
    xt, gt, bt = map(torch.from_numpy, (x, g, b))
    before = layer_norm_cuda.launches
    fused_layer_norm(xt, gt, bt)
    assert layer_norm_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        layer_norm_cuda(xt, gt, bt)
    with pytest.raises(ValueError, match="device type 'meta'"):
        dispatch.use_kernel(torch.empty(2, device="meta"))
