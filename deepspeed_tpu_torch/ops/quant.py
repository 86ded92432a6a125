"""Quantized-weight carrier and the int8 dequant-matmul (counterpart of
deepspeed_tpu/ops/quant.py).

`matmul_maybe_int8` runs kernel C (csrc/dequant_matmul.cu, the port of
`fused_dequant_matmul` / `_dq_kernel`) for a `QuantizedWeight` on CUDA, the
plain twin `dequant_matmul_reference` on the CPU, and `torch.matmul` for a
dense weight (a product the JAX package leaves to XLA).
"""

from typing import Any, NamedTuple

import torch

from . import op_builder
from .dispatch import (check_contiguous, check_cuda, kernel_dtype_code,
                       stream_handle, use_kernel)


class QuantizedWeight(NamedTuple):
    """Per-group symmetric int8 weight [K, N]: the scale groups split the
    leading (input) dimension, scale is [groups, 1] fp32."""
    qweight: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.qweight.shape

    @property
    def dtype(self):
        return self.qweight.dtype


def _row_scales(w: QuantizedWeight, dtype):
    """[rows] per-row scale vector from the per-group scales."""
    rows = w.qweight.shape[0]
    groups = w.scale.shape[0]
    return w.scale.reshape(groups).to(dtype).repeat_interleave(rows // groups)


def dequant(w: QuantizedWeight, dtype):
    """int8 -> dtype with the per-row scale applied in dtype."""
    if w.qweight.dim() != 2:
        raise ValueError(f"QuantizedWeight matmul expects a 2-D weight, got "
                         f"{tuple(w.qweight.shape)}")
    return w.qweight.to(dtype) * _row_scales(w, dtype)[:, None]


def dequant_matmul_reference(x, w: QuantizedWeight):
    """x [M, K] @ dequant(w) [K, N] in x's dtype."""
    return x @ dequant(w, x.dtype)


def fused_dequant_matmul(x, w: QuantizedWeight):
    """Kernel C on CUDA tensors: x [M, K] (bf16/fp32, contiguous) @ the int8
    weight [K, N] with its fp32 group scales -> [M, N] in x's dtype.  Device
    memory sees only the int8 weight bytes."""
    name = "fused_dequant_matmul"
    qw, scale = w.qweight, w.scale
    index = check_cuda(name, x, qw, scale)
    code = kernel_dtype_code(x)
    if qw.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"{name}: qweight must be int8 and scale float32, "
                        f"got {qw.dtype} and {scale.dtype}")
    check_contiguous(name, x=x, qweight=qw, scale=scale)
    if x.dim() != 2 or qw.dim() != 2 or x.shape[1] != qw.shape[0]:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)} and qweight "
                         f"{tuple(qw.shape)} do not multiply")
    m, k = x.shape
    n = qw.shape[1]
    groups = scale.shape[0]
    if scale.numel() != groups or groups < 1 or k % groups:
        raise ValueError(f"{name}: scale {tuple(scale.shape)} must be "
                         f"[groups, 1] with groups dividing K={k}")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    lib = op_builder.load()
    err = lib.ds_dequant_matmul(x.data_ptr(), qw.data_ptr(), scale.data_ptr(),
                                out.data_ptr(), m, k, n, groups, code,
                                stream_handle(index))
    op_builder.check_launch(name, err)
    fused_dequant_matmul.launches += 1
    return out


fused_dequant_matmul.launches = 0


def matmul_maybe_int8(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ w over the last dim of x; a QuantizedWeight is dequantized on the
    fly (kernel C on CUDA, the plain version on the CPU)."""
    if isinstance(w, QuantizedWeight):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        if use_kernel(x2, w.qweight, w.scale):
            out = fused_dequant_matmul(x2.contiguous(), w)
        else:
            out = dequant_matmul_reference(x2, w)
        return out.reshape(*shape[:-1], -1)
    return x @ w.to(x.dtype)
