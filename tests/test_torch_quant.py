"""int8 weights: the PyTorch port (deepspeed_tpu_torch.ops.quant,
runtime.weight_quantizer) against the JAX package's Pallas dequant-matmul
(interpret mode) and its numpy quantizer, on the same numpy inputs.  On
the CPU the port runs its plain version; chip_smoke.py holds the CUDA
kernel against it on the card."""

import ctypes
import functools

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
from deepspeed_tpu_torch.ops import op_builder, quant
from deepspeed_tpu_torch.ops.quant import (GEMV_ROWS, GEMV_SMS,
                                           QuantizedWeight,
                                           dequant_matmul_reference,
                                           dequant_plan,
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


@pytest.mark.parametrize("m", [1, 8, 77])
def test_plain_twin_matches_pallas_interpret_at_decode_and_prompt_rows(m):
    """Kernel C's plain twin (which chip_smoke.py holds the CUDA routes
    against) vs the Pallas kernel in interpret mode at the rows the routes
    split on: one decode row, the decode batch (the GEMV) and a 77-token
    prompt (the tensor-core route); [768, 768] with 8 scale groups of
    different magnitude, fp32, atol = rtol = 1e-5."""
    k, n, groups = 768, 768, 8
    w = _weight(k, n, seed=20 + m)
    w *= 2.0 ** (np.arange(k) // (k // groups) % 4)[:, None]
    x = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
    jq = jax_quantize_weight(w, groups)
    ref = jax_fused_dq(jnp.asarray(x), jq, interpret=True)
    tq = QuantizedWeight(torch.from_numpy(np.array(jq.qweight)),
                         torch.from_numpy(np.array(jq.scale)))
    out = dequant_matmul_reference(torch.from_numpy(x), tq)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# GPT-2 124M's four int8 products per layer: c_attn, attn c_proj, c_fc,
# mlp c_proj ([K, N])
GPT2_SHAPES = [(768, 2304), (768, 768), (768, 3072), (3072, 768)]


@pytest.mark.parametrize("k,n", GPT2_SHAPES)
def test_decode_plan_uses_every_sm(k, n):
    """At each GPT-2 shape and M = 1 and 8 (a decode step of batch 1 and
    8), kernel C runs a GEMV with at least one block per SM of the H100
    (132): bf16 on the tensor cores, 64 columns a block (8-byte loads), a
    K split of at most 16 (a non-portable cluster) in whole k-steps of 16
    and at most 128 rows a slice, 8 warps a block (16 above 8 k-steps);
    fp32 on the CUDA cores with a K split that is a portable cluster
    (<= 8), whole warps of at most 256 threads and one batch of GEMV_ROWS
    rows a k-lane.  Both splits cover K."""
    for m in (1, 8):
        plan = dequant_plan(m, k, n, torch.bfloat16)
        assert plan.route == "gemv_mma" and plan.width == 64
        assert plan.blocks >= GEMV_SMS
        assert plan.blocks == -(-n // plan.width) * plan.split
        assert 1 <= plan.split <= 16
        rows = -(-(-(-k // plan.split)) // 16) * 16
        assert rows * plan.split >= k and rows <= 128 or plan.split == 16
        assert plan.threads == (256 if rows <= 128 else 512)
        plan = dequant_plan(m, k, n, torch.float32)
        assert plan.route == "gemv"
        assert plan.blocks >= GEMV_SMS
        assert plan.blocks == -(-n // plan.width) * plan.split
        assert plan.width in (32, 64, 128) and 1 <= plan.split <= 8
        assert plan.threads % 32 == 0 and plan.threads <= 256
        rows = -(-(-(-k // plan.split)) // 8) * 8
        assert rows * plan.split >= k
        # every k-lane has at most one batch of GEMV_ROWS rows
        lanes = plan.threads // (plan.width // 16)
        assert lanes * GEMV_ROWS >= rows


@pytest.mark.parametrize("k,n", GPT2_SHAPES)
def test_prefill_plan_takes_the_tensor_cores_in_bf16(k, n):
    """M = 1024 (a prefill of 8 x 128 tokens): bf16 runs the tensor-core
    product on 64 x 128 output tiles where those fill the H100's 132 SMs
    twice (N = 2304, 3072), else on 64 x 64 (N = 768: 192 blocks); fp32
    the CUDA-core tiled kernel on 64 x 64 tiles; a weight off the 16-byte
    boundary keeps the decode step off the GEMV (the tensor-core route
    stages it by plain loads)."""
    plan = dequant_plan(1024, k, n, torch.bfloat16)
    width = 64 if n == 768 else 128
    assert plan == ("mma", width, 0, 0, (n // width) * 16)
    assert plan.blocks >= GEMV_SMS
    assert dequant_plan(1024, k, n, torch.float32) == (
        "tiled", 0, 0, 0, (n // 64) * 16)
    assert dequant_plan(8, k, n, torch.bfloat16, w_aligned=False).route \
        == "mma"
    assert dequant_plan(8, k, n, torch.float32, w_aligned=False).route \
        == "tiled"


def _at(ptr, shape, dtype):
    """The contiguous tensor of `shape` at CPU address ptr (what a kernel
    reads and writes there)."""
    numel = int(np.prod(shape))
    size = torch.empty((), dtype=dtype).element_size()
    raw = (ctypes.c_char * (numel * size)).from_address(ptr)
    return torch.frombuffer(raw, dtype=dtype).view(shape)


class _Kernels:
    """Stand-in for the kernel library's ds_dequant_matmul: reads x, the
    weight and its scales back from the pointers the wrapper hands it,
    writes the plain twin's result through the output pointer, and records
    the x pointer."""

    def __init__(self):
        self.x_ptrs = []

    def ds_dequant_matmul(self, x, qw, scale, out, m, k, n, groups, code,
                          _stream):
        dtype = torch.bfloat16 if code == op_builder.DTYPE_BF16 \
            else torch.float32
        w = QuantizedWeight(_at(qw, (k, n), torch.int8),
                            _at(scale, (groups, 1), torch.float32))
        _at(out, (m, n), dtype).copy_(
            dequant_matmul_reference(_at(x, (m, k), dtype), w))
        self.x_ptrs.append(x)
        return 0


@pytest.mark.parametrize("m,dtype,copied", [
    (1024, torch.bfloat16, True), (77, torch.bfloat16, True),
    (8, torch.bfloat16, False), (1024, torch.float32, False)])
def test_a_misaligned_bf16_x_is_copied_once_and_counted(monkeypatch, m,
                                                        dtype, copied):
    """x two (bf16) or four (fp32) bytes off a 16-byte boundary: where the
    launch takes the tensor-core route (bf16, M > 8) the wrapper hands it a
    fresh aligned copy and counts one on `realigned`; the GEMV (M <= 8)
    and the tiled route (fp32) read x as it lies, and copy nothing.  The
    result equals the plain twin's on the original x, bitwise."""
    lib = _Kernels()
    monkeypatch.setattr(op_builder, "load", lambda: lib)
    monkeypatch.setattr(quant, "check_cuda", lambda name, *t: 0)
    monkeypatch.setattr(quant, "stream_handle", lambda index: 0)
    k, n = 768, 768
    qw = quantize_weight(_weight(k, n, seed=9), 8)
    buf = torch.from_numpy(np.random.default_rng(10).standard_normal(
        m * k + 8).astype(np.float32)).to(dtype)
    x = buf[1:1 + m * k].view(m, k)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    fused_dequant_matmul.realigned = 0
    out = fused_dequant_matmul(x, qw)
    assert fused_dequant_matmul.realigned == int(copied)
    assert (lib.x_ptrs[-1] != x.data_ptr()) == copied
    if copied:
        assert lib.x_ptrs[-1] % 16 == 0
    assert torch.equal(out, dequant_matmul_reference(x, qw))
    fused_dequant_matmul.realigned = 0
    aligned = x.clone()
    assert aligned.data_ptr() % 16 == 0
    fused_dequant_matmul(aligned, qw)
    assert fused_dequant_matmul.realigned == 0
    assert lib.x_ptrs[-1] == aligned.data_ptr()


@pytest.fixture
def kernel_route(monkeypatch):
    """matmul_maybe_int8 on the kernel route with CPU tensors: the launch
    goes to the _Kernels stand-in, which writes the plain twin's result
    through the output pointer."""
    lib = _Kernels()
    monkeypatch.setattr(op_builder, "load", lambda: lib)
    monkeypatch.setattr(quant, "use_kernel", lambda *t: True)
    monkeypatch.setattr(quant, "check_cuda", lambda name, *t: 0)
    monkeypatch.setattr(quant, "stream_handle", lambda index: 0)
    monkeypatch.setattr(fused_dequant_matmul, "launches", 0)
    return lib


def _rel_err(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("m", [8, 77])
@pytest.mark.parametrize("groups", [1, 8])
def test_kernel_route_grads_match_jax_fused_dq(monkeypatch, kernel_route,
                                               groups, m, dtype, tol):
    """Kernel C on its route (the stand-in library) is differentiable: the
    output has a grad_fn, and the grads of x and of the group scales for a
    seeded output cotangent match jax.vjp of the JAX package's custom_vjp
    `_fused_dq` (its forward the Pallas kernel in interpret mode): fp32
    within max|d| / max|ref| <= 1e-5, bf16 within 5e-2 (the chip-lane
    grad tolerance).  The int8 weight gets no grad."""
    import jax
    from deepspeed_tpu.ops import quant as jquant
    monkeypatch.setattr(jquant, "fused_dequant_matmul",
                        functools.partial(jquant.fused_dequant_matmul,
                                          interpret=True))
    k, n = 256, 384
    w = _weight(k, n, seed=30 + groups)
    w *= 2.0 ** (np.arange(k) // (k // groups) % 4)[:, None]
    jq = jax_quantize_weight(w, groups)
    rng = np.random.default_rng(m + groups)
    x = rng.standard_normal((m, k)).astype(np.float32)
    g = rng.standard_normal((m, n)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    _, vjp = jax.vjp(lambda x_, s_: jquant._fused_dq(x_, jq.qweight, s_),
                     jnp.asarray(x, jdt), jq.scale)
    ref_dx, ref_ds = vjp(jnp.asarray(g, jdt))

    tx = torch.from_numpy(x).to(dtype).requires_grad_(True)
    ts = torch.from_numpy(np.array(jq.scale)).requires_grad_(True)
    tq = torch.from_numpy(np.array(jq.qweight))
    out = matmul_maybe_int8(tx, QuantizedWeight(tq, ts))
    assert out.grad_fn is not None and out.dtype == dtype
    assert fused_dequant_matmul.launches == 1 and kernel_route.x_ptrs
    out.backward(torch.from_numpy(g).to(dtype))
    assert tx.grad.dtype == dtype and ts.grad.dtype == torch.float32
    assert ts.grad.shape == (groups, 1)
    assert _rel_err(tx.grad.float(), ref_dx) <= tol
    assert _rel_err(ts.grad, ref_ds) <= tol
    assert tq.grad is None


def test_scale_grad_is_computed_only_when_the_scale_needs_one(
        monkeypatch, kernel_route):
    """On the kernel route the scales' cotangent (`dequant_scale_grad`) is
    computed only when the scales require grad, as XLA drops the unused
    matmul of `_fused_dq_bwd`; x's grad is computed either way.  Without
    any input that needs a grad (or under no_grad) the launch is direct and
    the output has no grad_fn."""
    calls = []
    real = quant.dequant_scale_grad

    def spy(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(quant, "dequant_scale_grad", spy)
    qw = quantize_weight(_weight(64, 96, seed=31), 4)
    x = torch.from_numpy(np.random.default_rng(32).standard_normal(
        (8, 64)).astype(np.float32))
    tx = x.clone().requires_grad_(True)
    matmul_maybe_int8(tx, qw).square().sum().backward()
    assert calls == [] and tx.grad is not None
    np.testing.assert_allclose(
        tx.grad.numpy(), (2 * dequant_matmul_reference(x, qw)
                          @ dequantize_weight(qw).t()).numpy(),
        rtol=1e-5, atol=1e-5)
    ts = qw.scale.clone().requires_grad_(True)
    matmul_maybe_int8(x, QuantizedWeight(qw.qweight, ts)).sum().backward()
    assert calls == [1] and ts.grad is not None
    assert matmul_maybe_int8(x, qw).grad_fn is None
    with torch.no_grad():
        assert matmul_maybe_int8(tx, qw).grad_fn is None
    assert fused_dequant_matmul.launches == 4
