"""Attention forward (counterpart of deepspeed_tpu/ops/flash_attention.py).

`flash_attention` runs kernel B (csrc/flash_attention_fwd.cu, the port of
`flash_attention_pallas` / `_fa_kernel`) on CUDA tensors and its plain twin
`mha_reference` on CPU tensors.  With an additive `bias` it takes the plain
path on either device, as the JAX dispatcher does.  The kernel masks its
own ragged edge, so any sequence length runs on it: there is no
short-sequence crossover to XLA (the JAX package's AUTO_MIN_SEQ is a v5e
measurement).  Forward only: dropout and the backward kernels come with
the training slice.
"""

import math
from typing import Optional

import numpy as np
import torch

from . import op_builder
from .dispatch import check_cuda, kernel_dtype_code, stream_handle, use_kernel

# Finite mask value: keeps the running max finite for fully masked rows.
DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

# head dims the kernel is compiled for
KERNEL_HEAD_DIMS = (64, 128)


def mha_reference(q, k, v, causal: bool = False,
                  sm_scale: Optional[float] = None, bias=None,
                  return_lse: bool = False):
    """Plain multi-head attention: q, k, v [B, H, S, D] -> [B, H, S, D].

    Scores and softmax in fp32 whatever the input dtype; the probabilities
    are cast to v's dtype for the product with v.  return_lse adds the
    per-row logsumexp [B, H, S] in fp32."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        q_len, k_len = s.shape[-2], s.shape[-1]
        above = torch.ones(q_len, k_len, dtype=torch.bool,
                           device=s.device).triu(1)
        s = s.masked_fill(above, DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def _seq_strides(t):
    """(batch, head, seq) strides of a [B, H, S, D] tensor whose last dim
    is dense."""
    if t.stride(3) != 1:
        raise ValueError("flash_attention_cuda: the head dim must be dense "
                         f"(strides {t.stride()})")
    return t.stride(0), t.stride(1), t.stride(2)


def flash_attention_cuda(q, k, v, causal: bool = False,
                         sm_scale: Optional[float] = None):
    """Kernel B on CUDA tensors q [B, H, Sq, D], k, v [B, H, Sk, D] (any
    batch/head/seq strides, dense D).  Returns (out [B, H, Sq, D],
    lse [B, H, Sq] fp32); out is laid out as [B, Sq, H, D] in memory, so
    merging the heads back into [B, Sq, H*D] is a free view."""
    name = "flash_attention_cuda"
    index = check_cuda(name, q, k, v)
    code = kernel_dtype_code(q)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v dtypes differ: {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not compiled "
                         f"(kernel takes {KERNEL_HEAD_DIMS})")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    out = torch.empty((b, sq, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = op_builder.load()
    err = lib.ds_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, h, sq, sk, d, *_seq_strides(q), *_seq_strides(k),
        *_seq_strides(v), *_seq_strides(out), float(sm_scale), int(causal),
        code, stream_handle(index))
    op_builder.check_launch(name, err)
    flash_attention_cuda.launches += 1
    return out, lse


flash_attention_cuda.launches = 0


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: Optional[float] = None, bias=None,
                    return_lse: bool = False):
    """Multi-head attention, q, k, v [B, H, S, D] -> [B, H, S, D]
    (and the fp32 logsumexp [B, H, S] with return_lse).  Kernel B on CUDA,
    the plain version on the CPU; an additive bias always takes the plain
    path."""
    if bias is not None or not use_kernel(q, k, v):
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale,
                             bias=bias, return_lse=return_lse)
    out, lse = flash_attention_cuda(q, k, v, causal=causal, sm_scale=sm_scale)
    return (out, lse) if return_lse else out
