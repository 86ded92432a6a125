"""Quantized-weight carrier and the int8 dequant-matmul (counterpart of
deepspeed_tpu/ops/quant.py).

`matmul_maybe_int8` runs kernel C (csrc/dequant_matmul.cu, the port of
`fused_dequant_matmul` / `_dq_kernel`) for a `QuantizedWeight` on CUDA, the
plain twin `dequant_matmul_reference` on the CPU, and `torch.matmul` for a
dense weight (a product the JAX package leaves to XLA).

Kernel C's launcher picks its kernel from the shape (`dequant_plan`
mirrors it): M <= 8 (decode) a GEMV, its K split over thread-block
clusters so that every SM of the card takes part, on the tensor cores for
bf16 x ("gemv_mma") and the CUDA cores otherwise ("gemv"); bf16 x with
M > 8 (prefill) the tensor-core weight product of csrc/tile_mma.cuh
("mma"); anything else the CUDA-core tiled kernel ("tiled").  The
tensor-core prefill route reads x with 16-byte `cp.async` copies: the
wrapper copies an x whose base is not 16-byte aligned into a fresh tensor
first and counts the copy on `fused_dequant_matmul.realigned` (0 on the
serving path).

Kernel C is differentiable: on CUDA, `matmul_maybe_int8` takes it through
`_FusedDequantMatmul` when x or the scales need a gradient.  Its backward
is the JAX package's `_fused_dq_bwd` in plain PyTorch (the JAX package
computes it outside any Pallas kernel too): dx = g @ dequant(w)^T, the
scales' cotangent from x^T g (`dequant_scale_grad`, only when the scales
need it), and none for the int8 weight.
"""

from typing import Any, NamedTuple

import torch

from . import op_builder
from .dispatch import (check_contiguous, check_cuda, kernel_dtype_code,
                       stream_handle, use_kernel)

# the kernels ds_dequant_matmul_route names, by its codes
DEQUANT_ROUTES = ("gemv", "mma", "tiled", "gemv_mma")
GEMV_MAX_M = 8          # rows of x the GEMVs take
GEMV_ROWS = 8           # weight rows of 16 bytes a GEMV thread has in flight
GEMV_MAX_THREADS = 256
GEMV_MAX_SPLIT = 8      # K slices per column block: a portable cluster
GEMV_SMS = 132          # the SMs of an H100 SXM
GEMV_MMA_COLS = 64      # the tensor-core GEMV's columns a block,
GEMV_MMA_ROWS = 128     # ... rows of K a block has in flight,
GEMV_MMA_MAX_SPLIT = 16  # ... and K slices (a non-portable cluster)
MMA_ROWS = 64           # the prefill route's output tile rows; its columns
                        # are 128 where those blocks fill 2 x GEMV_SMS, else 64
TILED_TILE = (64, 64)   # the tiled route's (rows, columns)
CP_ASYNC_BYTES = 16


class DequantPlan(NamedTuple):
    """Kernel C's launch for a shape: the route; the output columns a block
    owns (GEMVs and the prefill route; 0 on the tiled route); for a GEMV
    its K split (the cluster size) and threads a block (0 on the other
    routes); and the blocks the launch runs."""
    route: str
    width: int
    split: int
    threads: int
    blocks: int


def dequant_route(m, k, n, code, w_aligned=True, x_aligned=True) -> str:
    """The kernel ds_dequant_matmul_route picks (csrc/dequant_matmul.cu):
    for M <= 8 with N % 16 == 0 and a 16-byte aligned weight a GEMV, on the
    tensor cores for bf16 x (dtype code `code`) with K % 16 == 0 and a
    16-byte aligned x, else on the CUDA cores; else the tensor-core product
    for bf16 x with K % 8 == 0 and a 16-byte aligned x; else the tiled
    kernel."""
    bf16 = code == op_builder.DTYPE_BF16
    if m <= GEMV_MAX_M and n % 16 == 0 and w_aligned:
        return "gemv_mma" if bf16 and k % 16 == 0 and x_aligned else "gemv"
    if bf16 and k % 8 == 0 and x_aligned:
        return "mma"
    return "tiled"


def gemv_plan(k, n):
    """(width, split, threads) of the GEMV for a [k, n] weight: the widest
    column block (128, 64, 32) whose column blocks times a K split of at
    most GEMV_MAX_SPLIT reach one block per SM, slices at least GEMV_ROWS
    deep; enough k-lanes for one batch of rows a thread, at most
    GEMV_MAX_THREADS threads, whole warps (csrc/dequant_matmul.cu
    gemv_plan)."""
    width = 128
    while True:
        col_blocks = -(-n // width)
        split = min(GEMV_MAX_SPLIT, -(-GEMV_SMS // col_blocks))
        split = max(1, min(split, -(-k // GEMV_ROWS)))
        if col_blocks * split >= GEMV_SMS or width == 32:
            break
        width //= 2
    rows = -(-(-(-k // split)) // 8) * 8
    groups = width // 16
    per_warp = 32 // groups
    lanes = min(-(-rows // GEMV_ROWS), GEMV_MAX_THREADS // groups)
    lanes = -(-lanes // per_warp) * per_warp
    return width, split, lanes * groups


def gemv_mma_plan(k, n):
    """(split, threads) of the tensor-core GEMV for a [k, n] weight, whose
    blocks own GEMV_MMA_COLS columns (csrc/dequant_matmul.cu gemv_mma_plan,
    from a sweep on the H100): a K split that gives every SM a block and at
    most GEMV_MMA_ROWS rows a slice (at most GEMV_MMA_MAX_SPLIT, in whole
    k-steps of 16); 8 warps a block, 16 when a slice has more than 8
    k-steps."""
    col_blocks = -(-n // GEMV_MMA_COLS)
    split = max(-(-GEMV_SMS // col_blocks), -(-k // GEMV_MMA_ROWS))
    split = max(1, min(split, GEMV_MMA_MAX_SPLIT, -(-k // 16)))
    rows = -(-(-(-k // split)) // 16) * 16
    return split, (16 if rows // 16 > 8 else 8) * 32


def dequant_plan(m, k, n, dtype, w_aligned=True) -> DequantPlan:
    """Kernel C's whole launch for x [m, k] of `dtype` (16-byte aligned, as
    the wrapper makes it where the route needs it) and a [k, n] int8
    weight: ds_dequant_matmul_plan's in Python."""
    code = kernel_dtype_code(torch.empty(0, dtype=dtype))
    route = dequant_route(m, k, n, code, w_aligned)
    if route == "gemv":
        width, split, threads = gemv_plan(k, n)
        return DequantPlan(route, width, split, threads,
                           -(-n // width) * split)
    if route == "gemv_mma":
        split, threads = gemv_mma_plan(k, n)
        return DequantPlan(route, GEMV_MMA_COLS, split, threads,
                           -(-n // GEMV_MMA_COLS) * split)
    if route == "mma":
        width = 128 if -(-n // 128) * -(-m // MMA_ROWS) >= 2 * GEMV_SMS \
            else 64
        return DequantPlan(route, width, 0, 0,
                           -(-n // width) * -(-m // MMA_ROWS))
    bm, bn = TILED_TILE
    return DequantPlan(route, 0, 0, 0, -(-n // bn) * -(-m // bm))


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
    if x.data_ptr() % CP_ASYNC_BYTES and dequant_route(
            m, k, n, code, qw.data_ptr() % CP_ASYNC_BYTES == 0) == "mma":
        x = x.clone(memory_format=torch.contiguous_format)
        fused_dequant_matmul.realigned += 1
    lib = op_builder.load()
    err = lib.ds_dequant_matmul(x.data_ptr(), qw.data_ptr(), scale.data_ptr(),
                                out.data_ptr(), m, k, n, groups, code,
                                stream_handle(index))
    op_builder.check_launch(name, err)
    fused_dequant_matmul.launches += 1
    return out


fused_dequant_matmul.launches = 0
fused_dequant_matmul.realigned = 0


def dequant_scale_grad(x, g, qweight, scale):
    """The cotangent of the [groups, 1] scales of x @ dequant(w) for the
    output cotangent g (`_fused_dq_bwd`): gw = x^T g in fp32, each weight
    row's sum of gw * float(qweight), summed over its group's rows; in the
    scales' dtype."""
    gw = x.float().t() @ g.float()
    per_row = (gw * qweight.float()).sum(dim=1)
    groups = scale.shape[0]
    return per_row.reshape(groups, -1).sum(dim=1).reshape(scale.shape).to(
        scale.dtype)


class _FusedDequantMatmul(torch.autograd.Function):
    """Kernel C forward; backward `_fused_dq_bwd` in plain PyTorch, the
    scales' cotangent only when they need one (x is saved only then)."""

    @staticmethod
    def forward(ctx, x, qweight, scale):
        ctx.save_for_backward(x if ctx.needs_input_grad[2] else None,
                              qweight, scale)
        return fused_dequant_matmul(x, QuantizedWeight(qweight, scale))

    @staticmethod
    def backward(ctx, g):
        x, qweight, scale = ctx.saved_tensors
        dx = dscale = None
        if ctx.needs_input_grad[0]:
            dx = g @ dequant(QuantizedWeight(qweight, scale), g.dtype).t()
        if ctx.needs_input_grad[2]:
            dscale = dequant_scale_grad(x, g, qweight, scale)
        return dx, None, dscale


def matmul_maybe_int8(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ w over the last dim of x; a QuantizedWeight is dequantized on the
    fly (kernel C on CUDA, differentiable in x and the scales; the plain
    version on the CPU)."""
    if isinstance(w, QuantizedWeight):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        if use_kernel(x2, w.qweight, w.scale):
            x2 = x2.contiguous()
            if torch.is_grad_enabled() and (x2.requires_grad
                                            or w.scale.requires_grad):
                out = _FusedDequantMatmul.apply(x2, w.qweight, w.scale)
            else:
                out = fused_dequant_matmul(x2, w)
        else:
            out = dequant_matmul_reference(x2, w)
        return out.reshape(*shape[:-1], -1)
    return x @ w.to(x.dtype)
