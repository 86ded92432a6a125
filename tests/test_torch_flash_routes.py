"""Kernels B and E pick their route by dtype: bf16 multiplies on the
tensor cores from 16-byte cp.async copies, fp32 on the CUDA cores.  The
choice (the dtype code the launch passes) and the tensor-core route's
alignment rule (checked where the wrappers read the strides) are plain
Python, held here on CPU tensors (the kernels themselves run only on the
card, where chip_smoke.py holds them against their plain twins)."""

import pytest
import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.dispatch import kernel_dtype_code
from deepspeed_tpu_torch.ops.flash_attention import (CP_ASYNC_BYTES,
                                                     _heads_layout,
                                                     _seq_strides)


def _fused_views(b=2, s=8, h=3, d=64, dtype=torch.bfloat16, extra=0):
    """The layer's q, k, v: head views of one [B, S, 3 * H * D + extra]
    projection, as ops/transformer.py splits and transposes it."""
    qkv = torch.zeros(b, s, 3 * h * d + extra, dtype=dtype)
    return [t.view(b, s, h, d).transpose(1, 2)
            for t in qkv[..., :3 * h * d].split(h * d, dim=-1)]


def _route_strides(name, dtype, **operands):
    """What a kernel B or E wrapper does with its operands before the
    launch: the dtype code, then each operand's strides, with the
    alignment rule on the tensor-core route."""
    cp_async = kernel_dtype_code(torch.empty(0, dtype=dtype)) \
        == op_builder.DTYPE_BF16
    return [_seq_strides(name, arg, t, cp_async)
            for arg, t in operands.items()]


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tensor_cores"),
                                         (torch.float32, "cuda_cores")])
def test_kernel_route_by_dtype(dtype, route):
    """bf16 passes DTYPE_BF16, which the kernels dispatch to tc:: (and the
    wrappers hold to the cp.async rule); fp32 passes DTYPE_FP32 (fp32::)."""
    code = kernel_dtype_code(torch.empty(0, dtype=dtype))
    expected = {"tensor_cores": op_builder.DTYPE_BF16,
                "cuda_cores": op_builder.DTYPE_FP32}[route]
    assert code == expected
    assert op_builder.DTYPE_BF16 != op_builder.DTYPE_FP32


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_kernel_route_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        kernel_dtype_code(torch.empty(0, dtype=dtype))


@pytest.mark.parametrize("d", [64, 128])
def test_the_layers_layouts_pass_the_alignment_check(d):
    """Contiguous [B, H, S, D], the fused-QKV head views and the wrappers'
    own [B, S, H, D] outputs all meet the rule."""
    q, k, v = _fused_views(d=d)
    out = _heads_layout(2, 3, 8, d, q)
    dense = torch.zeros(2, 3, 8, d, dtype=torch.bfloat16)
    strides = _route_strides("t", torch.bfloat16, q=q, k=k, v=v, out=out,
                             dense=dense)
    assert strides[0] == (8 * 3 * 3 * d, d, 3 * 3 * d)
    assert strides[3] == (8 * 3 * d, d, 3 * d)
    assert strides[4] == (3 * 8 * d, 8 * d, d)


def test_misaligned_base_pointer_names_the_operand():
    """A head view that starts one element into the projection is 2 bytes
    off a 16-byte boundary."""
    q, _, _ = _fused_views()
    shifted = torch.zeros(2, 8, 3 * 3 * 64 + 1, dtype=torch.bfloat16)[..., 1:]
    k = shifted[..., :192].view(2, 8, 3, 64).transpose(1, 2)
    assert k.data_ptr() % CP_ASYNC_BYTES == 2
    with pytest.raises(ValueError, match=r"flash_attention_cuda: `k` starts "
                                         r"at address .* not a multiple of "
                                         r"16 bytes"):
        _route_strides("flash_attention_cuda", torch.bfloat16, q=q, k=k, v=q)


def test_odd_sequence_stride_names_the_operand():
    """A projection of 3 * H * D + 1 columns gives a sequence stride of
    577 elements (1154 bytes)."""
    q, k, _ = _fused_views()
    v = _fused_views(extra=1)[2]
    assert v.stride(2) == 3 * 3 * 64 + 1
    with pytest.raises(ValueError, match=r"`v` has a sequence stride of 1154 "
                                         r"bytes"):
        _route_strides("flash_attention_bwd_dq_cuda", torch.bfloat16, q=q,
                       k=k, v=v)


@pytest.mark.parametrize("dim,what", [(0, "batch"), (1, "head")])
def test_odd_batch_or_head_stride_names_the_operand(dim, what):
    base = torch.zeros(4 * 4 * 8 * 64 + 64, dtype=torch.bfloat16)
    strides = [4 * 8 * 64, 8 * 64, 64, 1]
    strides[dim] += 1
    t = base.as_strided((2, 2, 8, 64), strides)
    with pytest.raises(ValueError, match=f"`dout` has a {what} stride"):
        _route_strides("t", torch.bfloat16, q=base[:64].view(1, 1, 1, 64),
                       dout=t)


def test_strides_of_length_one_dims_are_ignored():
    """A batch or head of one is never stepped over: its stride does not
    matter (PyTorch may leave any value there)."""
    t = torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16).as_strided(
        (1, 1, 8, 64), (3, 5, 64, 1))
    assert _route_strides("t", torch.bfloat16, q=t) == [(3, 5, 64)]


def test_fp32_takes_the_cuda_core_route_without_the_alignment_rule():
    """The CUDA-core route reads element by element: a misaligned fp32
    view is its to take, the same bytes in bf16 raise."""
    raw = torch.zeros(2 * 8 * 3 * 64 + 1)
    q = raw[1:].view(2, 8, 3, 64).transpose(1, 2)
    assert q.data_ptr() % CP_ASYNC_BYTES == 4
    assert len(_route_strides("t", torch.float32, q=q, k=q, v=q)) == 3
    q16 = torch.zeros(2 * 8 * 3 * 64 + 1, dtype=torch.bfloat16)[1:].view(
        2, 8, 3, 64).transpose(1, 2)
    with pytest.raises(ValueError, match="`q` starts at address"):
        _route_strides("t", torch.bfloat16, q=q16, k=q16, v=q16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_strided_head_dim_names_the_operand_on_either_route(dtype):
    """Both routes read rows of D contiguous elements."""
    q, _, _ = _fused_views(dtype=dtype)
    lse_like = torch.zeros(2, 3, 64, 8, dtype=dtype).transpose(2, 3)
    with pytest.raises(ValueError, match=r"`dout`: the head dim must be "
                                         r"dense"):
        _route_strides("t", dtype, q=q, dout=lse_like)
