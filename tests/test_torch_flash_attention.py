"""Flash attention: the PyTorch port (deepspeed_tpu_torch.ops.
flash_attention) against the JAX package's Pallas flash kernels
(interpret mode) and its plain mha_reference, on the same numpy inputs,
forward (kernel B) and backward (kernel E), dropout off and on.  On the CPU
the port runs its plain versions; chip_smoke.py holds the CUDA kernels
against them on the card."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepspeed_tpu.ops.flash_attention import flash_attention_pallas
from deepspeed_tpu.ops.flash_attention import mha_reference as jax_mha
from deepspeed_tpu_torch.ops.flash_attention import (
    dropout_keep_mask, flash_attention, flash_attention_bwd_dkdv_cuda,
    flash_attention_bwd_dq_cuda, flash_attention_bwd_reference,
    flash_attention_cuda, keep_scale, mha_reference, philox4x32_10,
    quantized_threshold)


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


# ---------------------------------------------------------------------- #
# backward (kernel E's plain twin through the autograd.Function), dropout
# ---------------------------------------------------------------------- #
def _port_grads(q, k, v, do, **kwargs):
    """The port's flash_attention out and (dq, dk, dv) by autograd."""
    qt, kt, vt = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out, lse = flash_attention(qt, kt, vt, return_lse=True, **kwargs)
    out.backward(torch.from_numpy(do))
    return out.detach(), lse, (qt.grad, kt.grad, vt.grad)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_bwd_matches_pallas_interpret(causal):
    """Dropout off: the port's grads vs flash_attention_bwd_pallas
    (interpret mode, as tests/unit/test_ops.py runs it) at [2, 3, 128, 32],
    fp32, atol = rtol = 1e-4."""
    from deepspeed_tpu.ops.flash_attention import flash_attention_bwd_pallas
    q, k, v = _qkv((2, 3, 128, 32), seed=4)
    do = _qkv((2, 3, 128, 32), seed=5)[0]
    jq, jk, jv, jdo = (jnp.asarray(t) for t in (q, k, v, do))
    jout, jlse = flash_attention_pallas(jq, jk, jv, causal=causal,
                                        block_q=64, block_k=64,
                                        interpret=True, return_lse=True)
    ref = flash_attention_bwd_pallas(jq, jk, jv, jout, jlse, jdo,
                                     causal=causal, block_q=64, block_k=64,
                                     interpret=True)
    _, _, grads = _port_grads(q, k, v, do, causal=causal)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("d", [32, 96, 80, 36, 256, 264, 320])
def test_plain_twins_match_pallas_at_kernel_head_dims(d):
    """mha_reference's out and lse and flash_attention_bwd_reference's
    grads (the plain twins of kernels B and E, which the CUDA kernels are
    held against on the card) vs the Pallas kernels in interpret mode at
    D = 32, 96 and 256, at D = 80, which the kernels run zero-filled in
    their D = 96 instantiation, at D = 36, which the tensor-core route
    pads to 40, and at D = 264 and 320, which run the wide kernels in three
    column chunks; causal, [1, 2, 128, D], fp32, atol = rtol = 1e-4."""
    from deepspeed_tpu.ops.flash_attention import flash_attention_bwd_pallas
    q, k, v = _qkv((1, 2, 128, d), seed=d)
    do = _qkv((1, 2, 128, d), seed=d + 1)[0]
    jq, jk, jv, jdo = (jnp.asarray(t) for t in (q, k, v, do))
    jout, jlse = flash_attention_pallas(jq, jk, jv, causal=True, block_q=64,
                                        block_k=64, interpret=True,
                                        return_lse=True)
    ref = flash_attention_bwd_pallas(jq, jk, jv, jout, jlse, jdo, causal=True,
                                     block_q=64, block_k=64, interpret=True)
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, do))
    out, lse = mha_reference(tq, tk, tv, causal=True, return_lse=True)
    grads = flash_attention_bwd_reference(tq, tk, tv, out, lse, tdo,
                                          causal=True)
    for got, want in [(out, jout), (lse, jlse), *zip(grads, ref)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


def _pack_keep32(keep, block_q):
    """The JAX package's bit-packed mask layout (_pack_keep32 per q-block
    of block_q rows, stacked over the blocks): [B, H, S/32, S] uint32, bit
    j of packed row r of block i = keep[i * block_q + j * block_q / 32 + r]."""
    b, h, s, sk = keep.shape
    gr = block_q // 32
    k = keep.reshape(b, h, s // block_q, 32, gr, sk).astype(np.uint32)
    packed = np.zeros((b, h, s // block_q, gr, sk), np.uint32)
    for j in range(32):
        packed |= k[:, :, :, j] << np.uint32(j)
    return packed.reshape(b, h, s // 32, sk)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_bwd_dropout_matches_pallas_with_the_port_mask(causal):
    """Dropout 0.1 at [1, 2, 256, 32]: the port's grads vs the JAX
    backward (interpret mode) fed the port's own keep mask through its
    packed-mask path (dropout_mask, block_q = 256), with the port's
    out / lse; the 8-bit keep scale 256/230 is the same on both sides.
    fp32, atol = rtol = 1e-4."""
    from deepspeed_tpu.ops.flash_attention import flash_attention_bwd_pallas
    rate, seed = 0.1, 1234
    q, k, v = _qkv((1, 2, 256, 32), seed=6)
    do = _qkv((1, 2, 256, 32), seed=7)[0]
    out, lse, grads = _port_grads(q, k, v, do, causal=causal,
                                  dropout_rate=rate, dropout_seed=seed)
    keep = dropout_keep_mask(seed, 1, 2, 256, 256, rate).numpy()
    ref = flash_attention_bwd_pallas(
        *(jnp.asarray(t) for t in (q, k, v, out.numpy(), lse.numpy(), do)),
        causal=causal, block_q=256, block_k=128, interpret=True,
        dropout_rate=rate, dropout_seed=seed,
        dropout_mask=jnp.asarray(_pack_keep32(keep, 256)),
        dropout_mask_block_q=256)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)


def test_flash_attention_dropout_forward_matches_the_mask():
    """The forward drops the normalized P with the mask it reports: out
    equals softmax(S) * keep * 256/230 @ V, computed in numpy (fp32 1e-5);
    lse is dropout's no-op."""
    rate, seed = 0.1, 99
    q, k, v = _qkv((1, 2, 70, 16), seed=8)
    out, lse = flash_attention(*map(torch.from_numpy, (q, k, v)),
                               causal=True, dropout_rate=rate,
                               dropout_seed=seed, return_lse=True)
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(16.0)
    s = np.where(np.triu(np.ones((70, 70), bool), 1), -np.inf, s)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    keep = dropout_keep_mask(seed, 1, 2, 70, 70, rate).numpy()
    ref = np.einsum("bhqk,bhkd->bhqd", p * keep * (256 / 230), v)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    ref_lse = mha_reference(*map(torch.from_numpy, (q, k, v)), causal=True,
                            return_lse=True)[1]
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), rtol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_gradcheck_with_dropout(causal):
    """float64 gradcheck of the port's flash autograd.Function on the CPU
    with dropout 0.3: the backward regenerates the forward's mask (a
    mismatch would fail the finite-difference check)."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 13, 4)))
               .requires_grad_() for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: flash_attention(q_, k_, v_, causal=causal,
                                           dropout_rate=0.3,
                                           dropout_seed=17),
        (q, k, v))


def test_dropout_mask_keep_fraction_and_unbiased_scale():
    """At rate 0.1 the 8-bit threshold is 230: the keep share of 2 * 4 *
    256 * 256 positions lies within 4 sigma of 230/256, the scale is its
    exact inverse (so E[keep * scale] = 1), and masks differ between
    seeds and between heads."""
    assert quantized_threshold(0.1) == 230
    assert keep_scale(0.1) == 256 / 230
    keep = dropout_keep_mask(5, 2, 4, 256, 256, 0.1)
    n = keep.numel()
    p = 230 / 256
    assert abs(keep.float().mean().item() - p) <= 4 * np.sqrt(p * (1 - p) / n)
    assert not torch.equal(keep[0, 0], keep[0, 1])
    assert not torch.equal(keep, dropout_keep_mask(6, 2, 4, 256, 256, 0.1))


def test_philox_twin_matches_the_known_answers():
    """philox4x32_10 on int64 tensors against Random123's known-answer
    vectors (counter and key all 0, and all 0xffffffff)."""
    z = torch.zeros((), dtype=torch.int64)
    assert [int(w) for w in philox4x32_10(z, z, z, z, z, z)] == [
        0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8]
    f = torch.full((), 0xffffffff, dtype=torch.int64)
    assert [int(w) for w in philox4x32_10(f, f, f, f, f, f)] == [
        0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd]


def test_backward_wrappers_refuse_cpu_tensors():
    q, k, v = (torch.from_numpy(t) for t in _qkv((1, 1, 8, 64)))
    stats = torch.zeros(1, 1, 8)
    for fn in (flash_attention_bwd_dkdv_cuda, flash_attention_bwd_dq_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, k, v, q, stats, stats)
