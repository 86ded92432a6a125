"""LayerNorm (counterpart of deepspeed_tpu/ops/normalize.py).

`fused_layer_norm` is differentiable: on CUDA tensors its forward is
kernel A (csrc/layer_norm.cu, the port of `layer_norm_pallas` /
`_ln_kernel`) and its backward kernel D (csrc/layer_norm_bwd.cu, the port
of `layer_norm_bwd_pallas` / `_ln_bwd_kernel`); on CPU tensors it runs
their plain twins `layer_norm_reference` and `layer_norm_bwd_reference`.
The JAX package defaults to the XLA LN over its Pallas kernels, a choice
measured on v5e; on the card the port always runs its kernels.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from . import op_builder
from .dispatch import (DTYPE_CODES, PARAM_DTYPE_CODES, check_contiguous,
                       check_cuda, stream_handle, use_kernel)

# csrc/layer_norm_row.cuh: the routes (by code) and the constants of its plan
LN_ROUTES = ("vector", "scalar", "streamed")
LN_VECTOR_CAP = 4          # 16-byte packs a thread a row
LN_SCALAR_CAP = 16         # element packs a thread a row (powers of two)
LN_MAX_ROW_THREADS = 512   # a row in registers: at most 16 warps
LN_SLOT_THREADS = 256      # a block's threads when its rows are narrower
LN_STREAM_THREADS = 1024   # the streamed route: a block, one row at a time
LN_FWD_BLOCKS = 264        # A: 2 blocks per SM of an H100 SXM (a constant)
LN_BWD_BLOCKS = 132        # D: 1 block per SM (fewer workspace rows)
LN_ALIGN = 16              # the vector route's 16-byte loads and stores
_ROUTE_CODE = {r: i for i, r in enumerate(LN_ROUTES)}


class LayerNormPlan(NamedTuple):
    """Kernel A's or D's launch for x [rows, hidden]: the route ("vector":
    the row in registers from 16-byte loads; "scalar": the same from
    element loads; "streamed": a row too wide for registers, a block
    taking its rows one at a time and re-reading each in every pass), the
    threads a row (whole warps; more than 32 split the row over the warps
    of a block), the packs a thread holds (0 when streamed), the rows a block holds at once (slots) and takes one after
    another each (rows_per_slot), the blocks, and for D the chunks: the
    rows of its fp32 workspace, one a block, that its second launch sums in
    a fixed order (0 for A)."""
    route: str
    threads_per_row: int
    per_thread: int
    slots: int
    rows_per_slot: int
    blocks: int
    chunks: int

    @property
    def rows_per_block(self) -> int:
        return self.slots * self.rows_per_slot

    @property
    def launch_args(self) -> tuple:
        """What the launch passes for the launchers to check: (route code,
        threads a row, rows a block, blocks)."""
        return (_ROUTE_CODE[self.route], self.threads_per_row,
                self.rows_per_block, self.blocks)


def layer_norm_plan(rows: int, hidden: int, code: int, aligned: bool = True,
                    backward: bool = False) -> LayerNormPlan:
    """The plan of kernel A (backward False) or D for x [rows, hidden] of
    dtype code `code`, every tensor the launch reads or writes starting on
    16 bytes when `aligned` (csrc/layer_norm_row.cuh plan(), which the
    launchers hold the launch to).  Any hidden >= 1 has one.  A function of
    its arguments and the constants above only, never of the device (its
    SM count): D's column sums take the same order on any card."""
    if hidden < 1:
        raise ValueError(f"layer_norm_plan: hidden {hidden} must be >= 1")
    vec = LN_ALIGN // (2 if code == op_builder.DTYPE_BF16 else 4)
    if aligned and hidden % vec == 0:
        route, n, cap = "vector", hidden // vec, LN_VECTOR_CAP
    else:
        route, n, cap = "scalar", hidden, LN_SCALAR_CAP
    warps = -(-n // (32 * cap))
    if 32 * warps > LN_MAX_ROW_THREADS:
        route, tpr, per = "streamed", LN_STREAM_THREADS, 0
    else:
        tpr = 32 * warps
        per = -(-n // tpr)
        if route == "scalar":
            per = 1 << (per - 1).bit_length()
    max_slots = LN_SLOT_THREADS // tpr if tpr < LN_SLOT_THREADS else 1
    spread = LN_BWD_BLOCKS if backward else LN_FWD_BLOCKS
    slots = min(max_slots, max(1, -(-rows // spread)))
    rps = -(-rows // (slots * spread)) if rows > 0 else 1
    blocks = -(-rows // (slots * rps)) if rows > 0 else 0
    return LayerNormPlan(route, tpr, per, slots, rps, blocks,
                         blocks if backward else 0)


@functools.lru_cache(maxsize=512)
def _shape_launches(name, shape, dtype, pdtype, vector_shapes, backward):
    """Kernel A's (backward False) or D's launch facts for x of `shape` and
    `dtype` and gamma (and beta) of `pdtype` and `vector_shapes`, checked
    once a shape: (rows, the int32 arrays an unaligned and an aligned
    launch pass (csrc/layer_norm_row.cuh LaunchField): rows, hidden, x's
    and gamma's dtype codes, then layer_norm_plan's launch_args).  The
    wrappers run on every decode step, which the host paces: a call reads
    these facts here and hands the launcher one pointer."""
    code = DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f"{name}: the CUDA kernels take bfloat16 or float32, "
                        f"got {dtype}")
    pcode = _param_code(name, pdtype)
    hidden = shape[-1]
    for vshape in vector_shapes:
        if vshape != (hidden,):
            raise ValueError(f"{name}: gamma / beta {tuple(vshape)} must "
                             f"be [{hidden}]")
    rows = shape.numel() // hidden if hidden else 0
    if rows == 0:
        return 0, ()
    return rows, tuple(
        (ctypes.c_int * 8)(rows, hidden, code, pcode, *layer_norm_plan(
            rows, hidden, code, aligned, backward).launch_args)
        for aligned in (False, True))


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


def _param_code(name, pdtype):
    """gamma's and beta's dtype code: fp32, bf16, or fp16 (an fp16 run's
    parameters); raises for any other dtype."""
    pcode = PARAM_DTYPE_CODES.get(pdtype)
    if pcode is None:
        raise TypeError(f"{name}: gamma and beta must be bfloat16, float16 or "
                        f"float32, got {pdtype}")
    return pcode


def _as_params(name, vectors):
    """gamma (and beta) as the kernels read them: as they are when they
    share a dtype and are contiguous (every model path: bf16 in training,
    fp32 in serving, fp16 in an fp16 run), else (off the model's paths) as
    contiguous fp32 copies."""
    first = vectors[0]
    if all(t.dtype is first.dtype and t.is_contiguous() for t in vectors):
        return vectors
    for t in vectors:
        _param_code(name, t.dtype)
    return tuple(t.float().contiguous() for t in vectors)


def layer_norm_cuda(x, gamma, beta, eps: float = 1e-5):
    """Kernel A on a contiguous CUDA tensor x (bf16 or fp32): LN over the
    last dim, gamma and beta [hidden] in bf16, fp16 or fp32, read in their
    own dtype.  One device kernel, no other."""
    name = "layer_norm_cuda"
    index = check_cuda(name, x, gamma, beta)
    if not x.is_contiguous():
        check_contiguous(name, x=x)
    gamma, beta = _as_params(name, (gamma, beta))
    rows, launches = _shape_launches(name, x.shape, x.dtype, gamma.dtype,
                                     (gamma.shape, beta.shape), False)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    xp, gp, bp, op = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                      out.data_ptr())
    err = op_builder.load().ds_layer_norm_fwd(
        xp, gp, bp, op, eps, launches[not (xp | gp | bp | op) % LN_ALIGN],
        stream_handle(index))
    if err:
        op_builder.check_launch(name, err)
    layer_norm_cuda.launches += 1
    return out


layer_norm_cuda.launches = 0


def layer_norm_bwd_cuda(x, gamma, dy, eps: float = 1e-5):
    """Kernel D on contiguous CUDA tensors x and dy (same shape and dtype,
    bf16 or fp32) and gamma [hidden] (bf16, fp16 or fp32, read in its own
    dtype): (dx in x's
    dtype, dgamma, dbeta in gamma's dtype), the column sums taken in fp32 in
    a fixed order with no atomics and rounded once.  Two device kernels, no
    other."""
    name = "layer_norm_bwd_cuda"
    index = check_cuda(name, x, gamma, dy)
    check_contiguous(name, x=x, dy=dy)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} {dy.dtype} must match "
                         f"x {tuple(x.shape)} {x.dtype}")
    (gamma,) = _as_params(name, (gamma,))
    rows, launches = _shape_launches(name, x.shape, x.dtype, gamma.dtype,
                                     (gamma.shape,), True)
    dx = torch.empty_like(x)
    hidden = x.shape[-1]
    if rows == 0:
        return (dx, torch.zeros(hidden, dtype=gamma.dtype, device=x.device),
                torch.zeros(hidden, dtype=gamma.dtype, device=x.device))
    xp, gp, dyp, dxp = (x.data_ptr(), gamma.data_ptr(), dy.data_ptr(),
                        dx.data_ptr())
    launch = launches[not (xp | gp | dyp | dxp) % LN_ALIGN]
    # the workspace: one fp32 [dgamma | dbeta] row a block (launch[-1])
    ws = torch.empty((launch[-1], 2, hidden), dtype=torch.float32,
                     device=x.device)
    dgamma = torch.empty(hidden, dtype=gamma.dtype, device=x.device)
    dbeta = torch.empty(hidden, dtype=gamma.dtype, device=x.device)
    err = op_builder.load().ds_layer_norm_bwd(
        xp, gp, dyp, dxp, ws.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
        eps, launch, stream_handle(index))
    op_builder.check_launch(name, err)
    layer_norm_bwd_cuda.launches += 1
    return dx, dgamma, dbeta


layer_norm_bwd_cuda.launches = 0


class _FusedLayerNorm(torch.autograd.Function):
    """Kernel A forward and kernel D backward on CUDA, the plain pair on the
    CPU.  dgamma / dbeta are reduced in fp32 and returned in gamma's and
    beta's dtypes, fp16 ones too (normalize.py _fused_ln_bwd)."""

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
