"""LayerNorm (counterpart of deepspeed_tpu/ops/normalize.py).

`fused_layer_norm` is differentiable: on CUDA tensors its forward is
kernel A (csrc/layer_norm.cu, the port of `layer_norm_pallas` /
`_ln_kernel`) and its backward kernel D (csrc/layer_norm_bwd.cu, the port
of `layer_norm_bwd_pallas` / `_ln_bwd_kernel`); on CPU tensors it runs
their plain twins `layer_norm_reference` and `layer_norm_bwd_reference`.
The JAX package defaults to the XLA LN over its Pallas kernels, a choice
measured on v5e; on the card the port always runs its kernels.
"""

import torch

from . import op_builder
from .dispatch import (check_contiguous, check_cuda, kernel_dtype_code,
                       stream_handle, use_kernel)

# csrc/layer_norm_bwd.cu kRowsPerBlock: rows per block of the backward's
# first pass, which sizes its [blocks, hidden] dgamma / dbeta workspaces
LN_BWD_ROWS_PER_BLOCK = 32


def layer_norm_reference(x, gamma, beta, eps: float = 1e-5):
    """LN over the last dim with fp32 statistics, output in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def layer_norm_bwd_reference(x, gamma, dy, eps: float = 1e-5):
    """The LN backward of `_ln_bwd_kernel`: (dx in x's dtype, dgamma and
    dbeta [hidden] summed over every row in fp32)."""
    hidden = x.shape[-1]
    xf = x.reshape(-1, hidden).float()
    dyf = dy.reshape(-1, hidden).float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * rstd
    dyg = dyf * gamma.float()
    m1 = dyg.mean(dim=-1, keepdim=True)
    m2 = (dyg * xhat).mean(dim=-1, keepdim=True)
    dx = (dyg - m1 - xhat * m2) * rstd
    return (dx.to(x.dtype).reshape(x.shape), (dyf * xhat).sum(dim=0),
            dyf.sum(dim=0))


def _check_ln_operands(name, x, vectors, rows=()):
    """The checks of kernels A and D: every operand on one CUDA device, x
    (and the other [..., hidden] tensors `rows`) contiguous in bf16 or fp32,
    each of `vectors` (gamma, beta) a bf16 or fp32 [hidden]."""
    index = check_cuda(name, x, *vectors, *rows)
    check_contiguous(name, x=x)
    code = kernel_dtype_code(x)
    hidden = x.shape[-1]
    for t in vectors:
        kernel_dtype_code(t)  # raises unless bf16 or fp32
        if t.shape != (hidden,):
            raise ValueError(f"{name}: gamma / beta {tuple(t.shape)} must "
                             f"be [{hidden}]")
    return index, code, hidden


def layer_norm_cuda(x, gamma, beta, eps: float = 1e-5):
    """Kernel A on a contiguous CUDA tensor: LN over the last dim, gamma and
    beta of [hidden] (taken in fp32)."""
    name = "layer_norm_cuda"
    index, code, hidden = _check_ln_operands(name, x, (gamma, beta))
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


def layer_norm_bwd_cuda(x, gamma, dy, eps: float = 1e-5):
    """Kernel D on contiguous CUDA tensors x and dy (same shape and dtype)
    and gamma [hidden] (taken in fp32): (dx in x's dtype, dgamma, dbeta in
    fp32), the column sums taken in a fixed order with no atomics."""
    name = "layer_norm_bwd_cuda"
    index, code, hidden = _check_ln_operands(name, x, (gamma,), (dy,))
    check_contiguous(name, dy=dy)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} {dy.dtype} must match "
                         f"x {tuple(x.shape)} {x.dtype}")
    gamma = gamma.float().contiguous()
    dx = torch.empty_like(x)
    dgamma = torch.zeros(hidden, dtype=torch.float32, device=x.device)
    dbeta = torch.zeros(hidden, dtype=torch.float32, device=x.device)
    rows = x.numel() // hidden if hidden else 0
    if rows == 0:
        return dx, dgamma, dbeta
    blocks = -(-rows // LN_BWD_ROWS_PER_BLOCK)
    part = torch.empty((2, blocks, hidden), dtype=torch.float32,
                       device=x.device)
    lib = op_builder.load()
    err = lib.ds_layer_norm_bwd(x.data_ptr(), gamma.data_ptr(),
                                dy.data_ptr(), dx.data_ptr(),
                                part[0].data_ptr(), part[1].data_ptr(),
                                dgamma.data_ptr(), dbeta.data_ptr(), rows,
                                hidden, float(eps), code,
                                stream_handle(index))
    op_builder.check_launch(name, err)
    layer_norm_bwd_cuda.launches += 1
    return dx, dgamma, dbeta


layer_norm_bwd_cuda.launches = 0


class _FusedLayerNorm(torch.autograd.Function):
    """Kernel A forward and kernel D backward on CUDA, the plain pair on the
    CPU.  dgamma / dbeta are reduced in fp32 and returned in gamma's and
    beta's dtypes (normalize.py _fused_ln_bwd)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        x = x.contiguous()
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        ctx.beta_dtype = beta.dtype
        if use_kernel(x, gamma, beta):
            return layer_norm_cuda(x, gamma, beta, eps)
        return layer_norm_reference(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        if use_kernel(x, gamma, dy):
            dx, dgamma, dbeta = layer_norm_bwd_cuda(x, gamma, dy, ctx.eps)
        else:
            dx, dgamma, dbeta = layer_norm_bwd_reference(x, gamma, dy, ctx.eps)
        return dx, dgamma.to(gamma.dtype), dbeta.to(ctx.beta_dtype), None


def fused_layer_norm(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the last dim.  Kernels A / D on CUDA, the plain pair
    on the CPU.  Without autograd (serving) the forward is called directly,
    which keeps the per-launch host cost of eager decode down."""
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return _FusedLayerNorm.apply(x, gamma, beta, eps)
    if use_kernel(x, gamma, beta):
        return layer_norm_cuda(x.contiguous(), gamma, beta, eps)
    return layer_norm_reference(x, gamma, beta, eps)
