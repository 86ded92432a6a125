"""LayerNorm (counterpart of deepspeed_tpu/ops/normalize.py).

`fused_layer_norm` runs kernel A (csrc/layer_norm.cu, the port of
`layer_norm_pallas` / `_ln_kernel`) on a CUDA tensor and its plain twin
`layer_norm_reference` on a CPU tensor.  The JAX package defaults to the
XLA LN over its Pallas kernel, a choice measured on v5e; on the card the
port always runs its kernel.  Forward only: the backward kernel comes with
the training slice.
"""

import torch

from . import op_builder
from .dispatch import (check_contiguous, check_cuda, kernel_dtype_code,
                       stream_handle, use_kernel)


def layer_norm_reference(x, gamma, beta, eps: float = 1e-5):
    """LN over the last dim with fp32 statistics, output in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def layer_norm_cuda(x, gamma, beta, eps: float = 1e-5):
    """Kernel A on a contiguous CUDA tensor: LN over the last dim, gamma and
    beta of [hidden] (taken in fp32)."""
    name = "layer_norm_cuda"
    index = check_cuda(name, x, gamma, beta)
    check_contiguous(name, x=x)
    code = kernel_dtype_code(x)
    for t in (gamma, beta):
        kernel_dtype_code(t)  # raises unless bf16 or fp32
    hidden = x.shape[-1]
    if gamma.shape != (hidden,) or beta.shape != (hidden,):
        raise ValueError(f"{name}: gamma {tuple(gamma.shape)} and beta "
                         f"{tuple(beta.shape)} must be [{hidden}]")
    gamma = gamma.float().contiguous()
    beta = beta.float().contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // hidden if hidden else 0
    if rows == 0:
        return out
    lib = op_builder.load()
    err = lib.ds_layer_norm_fwd(x.data_ptr(), gamma.data_ptr(),
                                beta.data_ptr(), out.data_ptr(), rows, hidden,
                                float(eps), code, stream_handle(index))
    op_builder.check_launch(name, err)
    layer_norm_cuda.launches += 1
    return out


layer_norm_cuda.launches = 0


def fused_layer_norm(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the last dim: kernel A on CUDA, the plain version on
    the CPU."""
    if use_kernel(x, gamma, beta):
        return layer_norm_cuda(x.contiguous(), gamma, beta, eps)
    return layer_norm_reference(x, gamma, beta, eps)
