"""Block-sparse flash attention over a SparsityConfig layout (counterpart of
deepspeed_tpu/ops/sparse_attention/block_sparse_flash.py).

`block_sparse_flash_attention` is differentiable.  On CUDA tensors its
forward is kernel F (csrc/block_sparse_flash_fwd.cu, the port of
`block_sparse_flash_fwd` / `_bsf_fwd_kernel`) and its backward kernel G
(csrc/block_sparse_flash_bwd.cu, the port of `block_sparse_flash_bwd`: one
launch for dq walking the forward gather indices, one for dk/dv walking the
transposed ones).  On CPU tensors it runs their plain twins
`block_sparse_flash_fwd_reference` and `block_sparse_flash_bwd_reference`.

The twins loop over (head, q-block) and gather only the k-blocks that row
allows and that lie on or below the causal diagonal, so their memory follows
the layout's true density: the JAX gather path pads every row to the
layout's largest degree, which for BigBird's global rows is dense-size.

The gather indices are layout_gather's, as device int32 tensors: idx / valid
[H, nb, max_deg], each row's valid entries first, padded by repeating the
last valid index.  The kernels loop over a row's valid entries only.

Routes and operands follow kernels B and E (flash_attention.py,
`head_dim_plan`): up to D = 256 bf16 on the tensor cores, fp32 on the CUDA
cores (`kernel_head_dim`: the smallest of 32, 64, 96, 128 and 256 at or
above D runs, zero-filled past the launch's D); a bf16 operand whose head
dim is not a multiple of 8 is copied into a zero-padded buffer
(`launch_head_dim`) and one whose base or strides are not multiples of 16
bytes into a fresh contiguous one, before the launch, each copy counted on
the wrapper's `realigned`.  Above D = 256 the wide kernels run (bf16 on the
tensor cores, fp32 on the CUDA cores), the output columns in chunks over
the grid, over the same layout walk.
"""

import math
from typing import Optional

import numpy as np
import torch

from .. import op_builder
from ..dispatch import stream_handle, use_kernel
from ..flash_attention import (DEFAULT_MASK_VALUE, _acc_dtype,
                               _check_attention, _check_stats, _heads_layout,
                               _launch_operands, _stride_array,
                               _true_head_dim, head_dim_plan)

# rows of a q-tile and keys of a k-tile in kernels F and G: a layout block
# must be a multiple of it for the kernels to take it
KERNEL_TILE = 64


def layout_gather(layout: np.ndarray, transpose: bool = False):
    """[H, nb, nb] bool -> (idx [H, nb, max_deg] int32, valid int32).

    Rows pad by repeating the last valid index (or 0 for empty rows);
    transpose=True gathers over the first block axis instead (the dk/dv
    direction: for k-block i, the q-blocks attending to it).  Shares its
    gather core with layout_to_gather_indices (sparse_self_attention.py)."""
    from .sparse_self_attention import _gather_core
    if transpose:
        layout = layout.transpose(0, 2, 1)
    idx, valid = _gather_core(layout, pad_last_valid=True,
                              allow_empty_rows=True)
    return idx, valid.astype(np.int32)


def sparse_tiling_ok(block: int) -> bool:
    """Kernels F and G cut a layout block into 64-row / 64-key tiles."""
    return block % KERNEL_TILE == 0


def _live_rows(idx, valid, causal: bool):
    """Per head, per row block: the live blocks of that row (valid, and on
    or below the diagonal when causal), as host lists."""
    idx_l, valid_l = idx.tolist(), valid.tolist()
    return [[[c for c, ok in zip(cols, oks) if ok and (not causal or c <= i)]
             for i, (cols, oks) in enumerate(zip(idx_h, valid_h))]
            for idx_h, valid_h in zip(idx_l, valid_l)]


def _gathered(blocks, block, device):
    """Token positions [n] of the listed blocks, in their order."""
    blk = torch.tensor(blocks, dtype=torch.int64, device=device)
    return (blk[:, None] * block + torch.arange(block, device=device)).reshape(-1)


def _scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


def block_sparse_flash_fwd_reference(q, k, v, idx, valid, block: int,
                                     causal: bool = False,
                                     sm_scale: Optional[float] = None):
    """Plain twin of kernel F: (out [B, H, S, D] in q's dtype, lse [B, H, S]),
    computed in fp32 (fp64 for fp64 inputs).  A row with no live
    block gets out 0 and lse DEFAULT_MASK_VALUE, as the kernels."""
    b, h, s, d = q.shape
    scale = _scale(q, sm_scale)
    acc = _acc_dtype(q)
    out = torch.zeros((b, h, s, d), dtype=acc, device=q.device)
    lse = torch.full((b, h, s), DEFAULT_MASK_VALUE, dtype=acc, device=q.device)
    rows = torch.arange(block, device=q.device)
    for hh, row_blocks in enumerate(_live_rows(idx, valid, causal)):
        for i, blocks in enumerate(row_blocks):
            if not blocks:
                continue
            cols = _gathered(blocks, block, q.device)
            r = slice(i * block, (i + 1) * block)
            sc = torch.einsum("bqd,bkd->bqk", q[:, hh, r].to(acc),
                              k[:, hh, cols].to(acc)) * scale
            if causal:
                sc = sc.masked_fill(cols[None, :] > (i * block + rows)[:, None],
                                    DEFAULT_MASK_VALUE)
            m = sc.amax(dim=-1, keepdim=True)
            p = torch.exp(sc - m)
            denom = p.sum(dim=-1, keepdim=True)
            out[:, hh, r] = torch.einsum("bqk,bkd->bqd", p,
                                         v[:, hh, cols].to(acc)) / denom
            lse[:, hh, r] = (m + torch.log(denom)).squeeze(-1)
    return out.to(q.dtype), lse


def block_sparse_flash_bwd_reference(q, k, v, out, lse, do, idx, valid,
                                     block: int, causal: bool = False,
                                     sm_scale: Optional[float] = None):
    """Plain twin of kernel G: (dq, dk, dv) from the forward's out and lse,
    FlashAttention-2 style over the live blocks of each row, in fp32 (fp64
    for fp64 inputs), each grad in its input's dtype.  Rows with no live
    block are never visited, so exp(s - lse) never sees their mask-value
    lse.  dk and dv are scattered from the rows, so this twin needs no
    transposed indices."""
    b, h, s, d = q.shape
    scale = _scale(q, sm_scale)
    acc = _acc_dtype(q)
    dq = torch.zeros((b, h, s, d), dtype=acc, device=q.device)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    delta = (do.to(acc) * out.to(acc)).sum(dim=-1)
    lse = lse.to(acc)
    rows = torch.arange(block, device=q.device)
    for hh, row_blocks in enumerate(_live_rows(idx, valid, causal)):
        for i, blocks in enumerate(row_blocks):
            if not blocks:
                continue
            cols = _gathered(blocks, block, q.device)
            r = slice(i * block, (i + 1) * block)
            qb, dob = q[:, hh, r].to(acc), do[:, hh, r].to(acc)
            kg, vg = k[:, hh, cols].to(acc), v[:, hh, cols].to(acc)
            sc = torch.einsum("bqd,bkd->bqk", qb, kg) * scale
            p = torch.exp(sc - lse[:, hh, r, None])
            if causal:
                p = p.masked_fill(cols[None, :] > (i * block + rows)[:, None],
                                  0.0)
            dp = torch.einsum("bqd,bkd->bqk", dob, vg)
            ds = p * (dp - delta[:, hh, r, None]) * scale
            dq[:, hh, r] = torch.einsum("bqk,bkd->bqd", ds, kg)
            dk[:, hh].index_add_(1, cols, torch.einsum("bqk,bqd->bkd", ds, qb))
            dv[:, hh].index_add_(1, cols, torch.einsum("bqk,bqd->bkd", p, dob))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------- #
# the kernel wrappers
# ---------------------------------------------------------------------- #
def _check_sparse(name, q, k, v, idx, valid, block, *more):
    """The checks of kernels F and G: the attention operands (kernel B's
    rules), one sequence length divisible by a block that is a multiple of
    the kernels' tile, and int32 gather indices [H, nb, max_deg] on the
    same device.  Returns (device index, dtype code, B, H, S, D).  The
    block is checked first: a block the kernels cannot tile raises here,
    it never drops to the plain twin."""
    if not sparse_tiling_ok(block) or q.shape[-2] % block:
        raise ValueError(
            f"{name}: the CUDA kernels take a layout block that is a "
            f"multiple of {KERNEL_TILE} and divides S; got block {block}, "
            f"S {q.shape[-2]}")
    index, code, b, h, sq, sk, d = _check_attention(name, q, k, v, idx,
                                                    valid, *more)
    if sq != sk:
        raise ValueError(f"{name}: q and k lengths differ ({sq}, {sk})")
    for arg, t in (("idx", idx), ("valid", valid)):
        if t.dtype != torch.int32 or t.dim() != 3 \
                or t.shape[:2] != (h, sq // block) or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous int32 "
                             f"[{h}, {sq // block}, max_deg], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if idx.shape != valid.shape:
        raise ValueError(f"{name}: idx {tuple(idx.shape)} and valid "
                         f"{tuple(valid.shape)} differ")
    return index, code, b, h, sq, d


def block_sparse_flash_fwd_cuda(q, k, v, idx, valid, block: int,
                                causal: bool = False,
                                sm_scale: Optional[float] = None):
    """Kernel F on CUDA tensors q, k, v [B, H, S, D] (any batch/head/seq
    strides, dense D; a misaligned bf16 operand is copied first) and the
    device int32 gather indices idx / valid of layout_gather(layout).
    Returns (out [B, H, S, D] laid out as [B, S, H, D], lse [B, H, S]
    fp32)."""
    name = "block_sparse_flash_fwd_cuda"
    index, code, b, h, s, d = _check_sparse(name, q, k, v, idx, valid, block)
    scale, plan = _scale(q, sm_scale), head_dim_plan(code, d)
    width = plan.width
    out = _heads_layout(b, h, s, width, q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if out.numel():
        (q, k, v), strides = _launch_operands(
            name, block_sparse_flash_fwd_cuda, code, dict(q=q, k=k, v=v),
            dict(out=out), width)
        err = op_builder.load().ds_block_sparse_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), idx.data_ptr(), valid.data_ptr(), b, h, s, width,
            plan.chunks, block, idx.shape[-1], _stride_array(strides),
            float(scale), int(causal), code, stream_handle(index))
        op_builder.check_launch(name, err)
        block_sparse_flash_fwd_cuda.launches += 1
    return _true_head_dim(out, d), lse


block_sparse_flash_fwd_cuda.launches = 0
block_sparse_flash_fwd_cuda.realigned = 0


def block_sparse_flash_bwd_dq_cuda(q, k, v, dout, lse, delta, idx, valid,
                                   block: int, causal: bool = False,
                                   sm_scale: Optional[float] = None):
    """Kernel G's dq launch (one block per q-tile, walking idx / valid):
    q, k, v, dout [B, H, S, D], lse and delta = rowsum(dO * O) [B, H, S]
    fp32.  Returns dq laid out as [B, S, H, D]."""
    name = "block_sparse_flash_bwd_dq_cuda"
    index, code, b, h, s, d = _check_sparse(name, q, k, v, idx, valid, block,
                                            dout, lse, delta)
    _check_stats(name, lse, delta, b, h, s)
    scale, plan = _scale(q, sm_scale), head_dim_plan(code, d)
    width = plan.width
    dq = _heads_layout(b, h, s, width, q)
    if dq.numel():
        (q, k, v, dout), strides = _launch_operands(
            name, block_sparse_flash_bwd_dq_cuda, code,
            dict(q=q, k=k, v=v, dout=dout), dict(dq=dq), width)
        err = op_builder.load().ds_block_sparse_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), idx.data_ptr(),
            valid.data_ptr(), b, h, s, width, plan.chunks, block,
            idx.shape[-1], _stride_array(strides), float(scale), int(causal),
            code, stream_handle(index))
        op_builder.check_launch(name, err)
        block_sparse_flash_bwd_dq_cuda.launches += 1
    return _true_head_dim(dq, d)


block_sparse_flash_bwd_dq_cuda.launches = 0
block_sparse_flash_bwd_dq_cuda.realigned = 0


def block_sparse_flash_bwd_dkdv_cuda(q, k, v, dout, lse, delta, idx_t,
                                     valid_t, block: int,
                                     causal: bool = False,
                                     sm_scale: Optional[float] = None):
    """Kernel G's dk/dv launch (one block per k-tile, walking the
    transposed indices idx_t / valid_t of layout_gather(layout,
    transpose=True)); other arguments as block_sparse_flash_bwd_dq_cuda.
    Returns (dk, dv), laid out as [B, S, H, D]."""
    name = "block_sparse_flash_bwd_dkdv_cuda"
    index, code, b, h, s, d = _check_sparse(name, q, k, v, idx_t, valid_t,
                                            block, dout, lse, delta)
    _check_stats(name, lse, delta, b, h, s)
    scale, plan = _scale(q, sm_scale), head_dim_plan(code, d)
    width = plan.width
    dk = _heads_layout(b, h, s, width, k)
    dv = _heads_layout(b, h, s, width, v)
    if dk.numel():
        (q, k, v, dout), strides = _launch_operands(
            name, block_sparse_flash_bwd_dkdv_cuda, code,
            dict(q=q, k=k, v=v, dout=dout), dict(dk=dk, dv=dv), width)
        err = op_builder.load().ds_block_sparse_flash_bwd_dkdv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            idx_t.data_ptr(), valid_t.data_ptr(), b, h, s, width, plan.chunks,
            block, idx_t.shape[-1], _stride_array(strides), float(scale),
            int(causal), code, stream_handle(index))
        op_builder.check_launch(name, err)
        block_sparse_flash_bwd_dkdv_cuda.launches += 1
    return _true_head_dim(dk, d), _true_head_dim(dv, d)


block_sparse_flash_bwd_dkdv_cuda.launches = 0
block_sparse_flash_bwd_dkdv_cuda.realigned = 0


def block_sparse_flash_bwd(q, k, v, out, lse, dout, idx, valid, idx_t,
                           valid_t, block: int, causal: bool = False,
                           sm_scale: Optional[float] = None):
    """(dq, dk, dv): kernel G's two launches on CUDA, with
    delta = rowsum(dO * O) in plain PyTorch (the JAX package leaves it to
    XLA); the plain twin on the CPU."""
    if not use_kernel(q, k, v, out, lse, dout):
        return block_sparse_flash_bwd_reference(
            q, k, v, out, lse, dout, idx, valid, block, causal=causal,
            sm_scale=sm_scale)
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    delta = (dout.float() * out.float()).sum(dim=-1)
    dq = block_sparse_flash_bwd_dq_cuda(q, k, v, dout, lse, delta, idx,
                                        valid, block, causal, sm_scale)
    dk, dv = block_sparse_flash_bwd_dkdv_cuda(q, k, v, dout, lse, delta,
                                              idx_t, valid_t, block, causal,
                                              sm_scale)
    return dq, dk, dv


class _BlockSparseFlash(torch.autograd.Function):
    """Kernel F forward and kernel G backward on CUDA, the plain pair on the
    CPU; saves out, lse and the gather indices."""

    @staticmethod
    def forward(ctx, q, k, v, idx, valid, idx_t, valid_t, block, causal,
                sm_scale):
        if use_kernel(q, k, v):
            out, lse = block_sparse_flash_fwd_cuda(q, k, v, idx, valid, block,
                                                   causal, sm_scale)
        else:
            out, lse = block_sparse_flash_fwd_reference(
                q, k, v, idx, valid, block, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse, idx, valid, idx_t, valid_t)
        ctx.args = (block, causal, sm_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, idx, valid, idx_t, valid_t = ctx.saved_tensors
        block, causal, sm_scale = ctx.args
        dq, dk, dv = block_sparse_flash_bwd(q, k, v, out, lse, dout, idx,
                                            valid, idx_t, valid_t, block,
                                            causal, sm_scale)
        return dq, dk, dv, None, None, None, None, None, None, None


def _index_tensor(t, device):
    """Gather indices as a contiguous int32 tensor on `device`; tensors
    already there (SparseSelfAttention's cached ones) pass unchanged."""
    if isinstance(t, torch.Tensor) and t.device == device \
            and t.dtype == torch.int32 and t.is_contiguous():
        return t
    return torch.as_tensor(np.asarray(t) if not isinstance(t, torch.Tensor)
                           else t, device=device).to(torch.int32).contiguous()


def block_sparse_flash_attention(q, k, v, idx, valid, idx_t, valid_t,
                                 block: int, causal: bool = False,
                                 sm_scale: Optional[float] = None):
    """Differentiable block-sparse flash attention.

    q, k, v: [B, H, S, D]; idx / valid from layout_gather(layout), idx_t /
    valid_t from layout_gather(layout, transpose=True), as numpy arrays or
    int32 tensors (pass device tensors to avoid a copy per call); block is
    the SparsityConfig block size.  Kernels F / G on CUDA tensors (block a
    multiple of 64, or the call raises), the plain twins on the CPU."""
    device = q.device
    idx, valid, idx_t, valid_t = (_index_tensor(t, device)
                                  for t in (idx, valid, idx_t, valid_t))
    block, causal = int(block), bool(causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _BlockSparseFlash.apply(q, k, v, idx, valid, idx_t, valid_t,
                                       block, causal, sm_scale)
    if use_kernel(q, k, v):
        return block_sparse_flash_fwd_cuda(q, k, v, idx, valid, block,
                                           causal, sm_scale)[0]
    return block_sparse_flash_fwd_reference(q, k, v, idx, valid, block,
                                            causal, sm_scale)[0]
