"""int8 weights: the PyTorch port (deepspeed_tpu_torch.ops.quant,
runtime.weight_quantizer) against the JAX package's Pallas dequant-matmul
(interpret mode) and its numpy quantizer, on the same numpy inputs.  On
the CPU the port runs its plain version; chip_smoke.py holds the CUDA
kernel against it on the card."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepspeed_tpu.ops.quant import QuantizedWeight as JaxQW
from deepspeed_tpu.ops.quant import fused_dequant_matmul as jax_fused_dq
from deepspeed_tpu.runtime.weight_quantizer import (
    WeightQuantization as JaxWQ)
from deepspeed_tpu.runtime.weight_quantizer import (
    quantize_weight as jax_quantize_weight)
from deepspeed_tpu_torch.ops.quant import (QuantizedWeight,
                                           fused_dequant_matmul,
                                           matmul_maybe_int8)
from deepspeed_tpu_torch.runtime.weight_quantizer import (WeightQuantization,
                                                          dequantize_weight,
                                                          quantize_weight)


def _weight(k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((k, n)) * 0.02).astype(np.float32)


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("m,k,n", [(8, 256, 384), (64, 128, 256)])
def test_matmul_maybe_int8_matches_pallas_interpret(m, k, n, groups):
    """Same int8 weight and scales through the Pallas kernel (interpret)
    and the port; fp32, atol = rtol = 1e-5."""
    w = _weight(k, n, seed=m + groups)
    x = np.random.default_rng(groups).standard_normal((m, k)).astype(
        np.float32)
    jq = jax_quantize_weight(w, groups)
    ref = jax_fused_dq(jnp.asarray(x), jq, interpret=True)
    tq = QuantizedWeight(torch.from_numpy(np.array(jq.qweight)),
                         torch.from_numpy(np.array(jq.scale)))
    out = matmul_maybe_int8(torch.from_numpy(x), tq)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_group_scales_of_different_magnitude_match_pallas_interpret():
    """Rows of scale group g scaled by 2 ** (g % 4), so that each row must
    take its own group's scale; fp32, atol = rtol = 1e-5."""
    k, n, groups = 256, 128, 8
    w = _weight(k, n, seed=11)
    w *= 2.0 ** (np.arange(k) // (k // groups) % 4)[:, None]
    x = np.random.default_rng(12).standard_normal((16, k)).astype(np.float32)
    jq = jax_quantize_weight(w, groups)
    assert len(set(np.asarray(jq.scale).ravel().round(6))) == groups
    ref = jax_fused_dq(jnp.asarray(x), jq, interpret=True)
    out = matmul_maybe_int8(torch.from_numpy(x), quantize_weight(w, groups))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_matmul_maybe_int8_3d_and_dense():
    """[B, S, K] activations reshape through the 2-D product; a dense weight
    is a plain matmul.  fp32, 1e-5."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = _weight(64, 96, seed=6)
    qw = quantize_weight(w, 2)
    out = matmul_maybe_int8(torch.from_numpy(x), qw)
    assert out.shape == (2, 3, 96)
    ref = x @ dequantize_weight(qw).numpy()
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    dense = matmul_maybe_int8(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(dense.numpy(), x @ w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("groups", [1, 4, 3])
def test_quantize_weight_bit_identical_to_jax(groups):
    """Same int8 bytes and fp32 scales (groups=3 does not divide 96 rows:
    both fall back to one group)."""
    w = _weight(96, 40, seed=groups)
    jq = jax_quantize_weight(w, groups)
    tq = quantize_weight(w, groups)
    assert tq.qweight.dtype == torch.int8
    np.testing.assert_array_equal(tq.qweight.numpy(), np.asarray(jq.qweight))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))


def test_weight_quantization_mlp_extra_grouping_matches_jax():
    rng = np.random.default_rng(7)
    layer = {name: (rng.standard_normal(shape) * 0.02).astype(np.float32)
             for name, shape in (("attn_qkvw", (16, 48)),
                                 ("inter_w", (16, 64)),
                                 ("output_w", (64, 16)))}
    jout = JaxWQ(mlp_extra_grouping=True,
                 quantize_groups=2).quantize_layer_params(layer)
    tout = WeightQuantization(mlp_extra_grouping=True,
                              quantize_groups=2).quantize_layer_params(layer)
    for name in layer:
        assert isinstance(jout[name], JaxQW)
        assert tout[name].scale.shape[0] == (4 if name != "attn_qkvw" else 2)
        np.testing.assert_array_equal(tout[name].qweight.numpy(),
                                      np.asarray(jout[name].qweight))
        np.testing.assert_array_equal(tout[name].scale.numpy(),
                                      np.asarray(jout[name].scale))


def test_wrapper_refuses_cpu_tensors():
    qw = quantize_weight(_weight(32, 64, seed=8))
    with pytest.raises(ValueError, match="CUDA"):
        fused_dequant_matmul(torch.zeros(4, 32), qw)
