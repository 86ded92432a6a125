"""LayerNorm: the PyTorch port (deepspeed_tpu_torch.ops.normalize) against
the JAX package's Pallas kernel (interpret mode) and plain reference, on the
same numpy inputs, forward (kernel A) and backward (kernel D).  On the CPU
the port runs the plain versions; the CUDA kernels themselves are held
against them on the card by chip_smoke.py."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepspeed_tpu.ops.normalize import layer_norm_pallas
from deepspeed_tpu.ops.normalize import layer_norm_reference as jax_ln_reference
from deepspeed_tpu_torch.ops import dispatch
from deepspeed_tpu_torch.ops.normalize import (fused_layer_norm,
                                               layer_norm_bwd_cuda,
                                               layer_norm_bwd_reference,
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


# ---------------------------------------------------------------------- #
# backward: kernel D's plain twin and the autograd.Function
# ---------------------------------------------------------------------- #
def _bwd_inputs(shape, seed):
    x, g, b = _inputs(shape, seed)
    dy = np.random.default_rng(seed + 100).standard_normal(shape).astype(
        np.float32)
    return x, g, b, dy


@pytest.mark.parametrize("shape", [(4, 64, 256), (16, 32), (8, 768)])
def test_layer_norm_bwd_matches_pallas_interpret(shape):
    """layer_norm_bwd_reference (kernel D's twin) vs
    layer_norm_bwd_pallas(interpret=True): dx, dgamma, dbeta, fp32 1e-5
    (dgamma / dbeta relative to their largest entry, being sums over up to
    16384 rows)."""
    from deepspeed_tpu.ops.normalize import layer_norm_bwd_pallas
    x, g, _, dy = _bwd_inputs(shape, seed=4)
    ref = layer_norm_bwd_pallas(jnp.asarray(x), jnp.asarray(g),
                                jnp.asarray(dy), interpret=True)
    out = layer_norm_bwd_reference(torch.from_numpy(x), torch.from_numpy(g),
                                   torch.from_numpy(dy))
    for o, r in zip(out, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max())


def test_fused_layer_norm_grads_match_jax_vjp():
    """fused_layer_norm's autograd (the plain pair on the CPU) vs
    jax.vjp(layer_norm_reference): dx, dgamma, dbeta at fp32 1e-5."""
    import jax
    x, g, b, dy = _bwd_inputs((6, 10, 96), seed=5)
    _, vjp = jax.vjp(lambda x_, g_, b_: jax_ln_reference(x_, g_, b_),
                     jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    ref = vjp(jnp.asarray(dy))
    xt, gt, bt = (torch.from_numpy(t).requires_grad_() for t in (x, g, b))
    fused_layer_norm(xt, gt, bt).backward(torch.from_numpy(dy))
    for o, r in zip((xt.grad, gt.grad, bt.grad), ref):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max())


def test_fused_layer_norm_bf16_grads_match_jax_vjp():
    """bf16 x and dy, bf16 gamma/beta (the training engine casts every
    parameter to the compute dtype): dx in bf16, dgamma/dbeta reduced in
    fp32 and returned in the parameters' dtype; atol = rtol = 2e-2 relative
    to each grad's largest entry."""
    import jax
    x, g, b, dy = _bwd_inputs((8, 4, 768), seed=6)
    bf = jnp.bfloat16
    _, vjp = jax.vjp(lambda x_, g_, b_: jax_ln_reference(x_, g_, b_),
                     jnp.asarray(x, bf), jnp.asarray(g, bf),
                     jnp.asarray(b, bf))
    ref = vjp(jnp.asarray(dy, bf))
    xt, gt, bt = (torch.from_numpy(t).to(torch.bfloat16).requires_grad_()
                  for t in (x, g, b))
    fused_layer_norm(xt, gt, bt).backward(
        torch.from_numpy(dy).to(torch.bfloat16))
    for o, r in zip((xt.grad, gt.grad, bt.grad), ref):
        assert o.dtype == torch.bfloat16
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(o.float().numpy(), r, rtol=2e-2,
                                   atol=2e-2 * np.abs(r).max())


def test_layer_norm_bwd_wrapper_refuses_cpu_tensors():
    x, g, _, dy = (torch.from_numpy(t) for t in _bwd_inputs((4, 64), seed=7))
    with pytest.raises(ValueError, match="CUDA"):
        layer_norm_bwd_cuda(x, g, dy)
