"""Flash attention (counterpart of deepspeed_tpu/ops/flash_attention.py).

`flash_attention` is differentiable.  On CUDA tensors its forward is
kernel B (csrc/flash_attention_fwd.cu, the port of `flash_attention_pallas`
/ `_fa_kernel`, with in-kernel probability dropout) and its backward kernel
E (csrc/flash_attention_bwd.cu, the port of `flash_attention_bwd_pallas`:
one launch for dk/dv over k-tiles, one for dq over q-tiles).  On CPU
tensors it runs their plain twins `mha_reference` and
`flash_attention_bwd_reference`.  With an additive `bias` it takes the
plain path on either device, as the JAX dispatcher does.  The kernels mask
their own ragged edge, so any sequence length runs on them: there is no
short-sequence crossover to XLA (the JAX package's AUTO_MIN_SEQ is a v5e
measurement).

Routes. `head_dim_plan` picks one from the dtype and the head dim, in the
open, and the launch passes it (the launchers refuse a plan they would not
make themselves). Up to D = 256 the dtype code (`kernel_dtype_code`)
decides: bf16 multiplies on the tensor cores (`mma.sync` tiles fed by
16-byte `cp.async` copies, csrc/attention_mma.cuh), fp32 on the CUDA cores
(a tensor-core fp32 product would be TF32 and miss the fp32 parity). Both
are compiled for head dims 32, 64, 96, 128 and 256 (KERNEL_HEAD_DIMS), and
any head dim from 1 to 256 runs the smallest of them at or above it
(`kernel_head_dim`): the kernels take the launch's D, zero-fill the
columns past it on load and store none of them. A head dim above 256 runs
the wide kernels (csrc/attention_wide.cuh), bf16 on the tensor cores and
fp32 on the CUDA cores: the output columns in chunks of WIDE_CHUNK over the
grid, each block computing its scores over the whole D from slices. The
tensor-core routes copy 8 bf16 columns (16 bytes) at a time, so they
launch D rounded up to a multiple of 8
(`launch_head_dim`): an operand of another D is copied once into a
zero-padded buffer of that width, the scale stays 1 / sqrt(true D), and the
outputs are handed back as views of the true D. The route also needs every
operand's base address and its batch, head and sequence strides to be
multiples of 16 bytes: the wrapper copies an operand that breaks the rule
into a fresh contiguous tensor before the launch (`_launch_operands`). The
wrapper's `realigned` counts both kinds of copy; every call the layer and
the engines make (D = 64, the fused projection's head views) needs
neither, so on their paths the count stays 0.

Dropout.  The JAX kernel keys the TPU's PRNG by tile, which no other
tiling can reproduce.  Here the keep decision of score (row, col) of head
(b, h) is a pure function of those coordinates and a per-call seed
(Philox4x32-10, csrc/dropout.cuh), so the forward, both backward launches
and the plain twins draw the identical mask whatever their tiling, and the
mask is regenerated in the backward rather than stored (the JAX package's
mask-reuse mode is a TPU trade-off with no counterpart here).  The keep
probability is quantised to 8 bits as the JAX kernel's default: a byte is
kept below round((1 - rate) * 256), scaled by the exact inverse
256 / threshold.  The seed is a device int32 tensor, so drawing it needs no
host round trip.
"""

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import op_builder
from .dispatch import check_cuda, kernel_dtype_code, stream_handle, use_kernel

# Finite mask value: keeps the running max finite for fully masked rows.
DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

# head dims the kernels are compiled for (both routes); any head dim from 1
# to the largest runs the smallest of them at or above it
KERNEL_HEAD_DIMS = (32, 64, 96, 128, 256)
# the tensor-core route launches a head dim that is a multiple of
# HEAD_DIM_STEP (a cp.async copy moves 8 bf16 columns at a time)
HEAD_DIM_STEP = 8
# above KERNEL_HEAD_DIMS[-1] the wide kernels own WIDE_CHUNK output columns
# a block (csrc/common.cuh DS_WIDE_CHUNK)
WIDE_CHUNK = 128
# the routes of kernels B, E, F and G
ROUTE_TENSOR_CORES = "tensor_cores"
ROUTE_CUDA_CORES = "cuda_cores"
ROUTE_TENSOR_CORES_WIDE = "tensor_cores_wide"
ROUTE_CUDA_CORES_WIDE = "cuda_cores_wide"

# the tensor-core route's cp.async copies move 16 bytes, 8 bf16 elements
CP_ASYNC_BYTES = 16

# Philox4x32-10 constants (csrc/dropout.cuh)
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def quantized_threshold(rate: float) -> int:
    """The 8-bit keep threshold (flash_attention.py _quantized_threshold)."""
    return max(1, min(256, round((1.0 - rate) * 256)))


def keep_scale(rate: float) -> float:
    """Exact inverse keep probability of the quantised threshold
    (flash_attention.py _keep_scale)."""
    return 256.0 / quantized_threshold(rate)


def _mulhilo(m: int, x):
    """(hi, lo) 32-bit halves of the 64-bit product m * x, m < 2**32 and x
    an int64 tensor of values < 2**32.  The product is split at 16 bits so
    that no partial product leaves int64."""
    a = m * (x & 0xFFFF)                 # < 2**48
    b = m * (x >> 16)                    # < 2**48
    mid = ((b & 0xFFFF) << 16) + a       # < 2**49
    return (b >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors (broadcast together) holding 32-bit
    values; returns the four output words.  Bit-for-bit csrc/dropout.cuh
    ds_philox4x32_10."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def dropout_keep_mask(seed, batch: int, heads: int, q_len: int, k_len: int,
                      rate: float, device=None):
    """The kernels' keep mask [batch, heads, q_len, k_len] (bool): Philox
    keyed by (seed, b * heads + h) with counter (row, col // 64, col % 4, 0);
    its output byte i (bits 8 * (i % 4) of word i // 4, i = 0..15) is the
    keep byte of column 64 * (col // 64) + 4 * i + col % 4."""
    seed = torch.as_tensor(seed, device=device).to(torch.int64).reshape(())
    k0 = seed & _MASK32
    n64 = -(-k_len // 64)
    ar = dict(dtype=torch.int64, device=device)
    bh = torch.arange(batch * heads, **ar).view(-1, 1, 1, 1)
    row = torch.arange(q_len, **ar).view(1, -1, 1, 1)
    c64 = torch.arange(n64, **ar).view(1, 1, -1, 1)
    lane = torch.arange(4, **ar).view(1, 1, 1, -1)
    words = philox4x32_10(row, c64, lane, torch.zeros((), **ar), k0, bh)
    # byte i (0..15) of a call is bits 8 * (i % 4) of word i // 4
    shifts = (8 * torch.arange(4, **ar)).view(1, 1, 1, 1, 4)
    keep_bytes = torch.cat([(w.unsqueeze(-1) >> shifts) & 0xFF for w in words],
                           dim=-1)                     # [BH, Sq, n64, 4, 16]
    # column 64 * c + 4 * i + lane
    keep_bytes = keep_bytes.transpose(-1, -2).reshape(
        batch * heads, q_len, n64 * 64)[..., :k_len]
    keep = keep_bytes < quantized_threshold(rate)
    return keep.view(batch, heads, q_len, k_len)


def _acc_dtype(t):
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _causal_above(q_len, k_len, device):
    return torch.ones(q_len, k_len, dtype=torch.bool, device=device).triu(1)


def mha_reference(q, k, v, causal: bool = False,
                  sm_scale: Optional[float] = None, bias=None,
                  return_lse: bool = False, dropout_rate: float = 0.0,
                  dropout_seed=None):
    """Plain multi-head attention: q, k, v [B, H, S, D] -> [B, H, S, D].

    Scores and softmax in fp32 (fp64 for fp64 inputs) whatever the input
    dtype; the probabilities are cast to v's dtype for the product with v.
    dropout_rate > 0 drops the normalized probabilities with the kernels'
    own keep mask (dropout_keep_mask of dropout_seed).  return_lse adds the
    per-row logsumexp [B, H, S], which dropout does not change."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    acc = _acc_dtype(q)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * sm_scale
    if bias is not None:
        s = s + bias.to(acc)
    if causal:
        s = s.masked_fill(_causal_above(s.shape[-2], s.shape[-1], s.device),
                          DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
        b, h, q_len, k_len = p.shape
        keep = dropout_keep_mask(dropout_seed, b, h, q_len, k_len,
                                 dropout_rate, p.device)
        p = torch.where(keep, p * keep_scale(dropout_rate),
                        torch.zeros_like(p))
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def flash_attention_bwd_reference(q, k, v, out, lse, do, causal: bool = False,
                                  sm_scale: Optional[float] = None,
                                  dropout_rate: float = 0.0,
                                  dropout_seed=None):
    """Plain twin of kernel E: (dq, dk, dv) from the forward's out and lse,
    FlashAttention-2 style, in fp32 (fp64 for fp64 inputs), each grad in its
    input's dtype."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    acc = _acc_dtype(q)
    qf, kf, vf, dof = (t.to(acc) for t in (q, k, v, do))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale
    p = torch.exp(s - lse.to(acc).unsqueeze(-1))
    if causal:
        p = p.masked_fill(_causal_above(s.shape[-2], s.shape[-1], s.device),
                          0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    delta = (dof * out.to(acc)).sum(dim=-1, keepdim=True)
    p_drop = p
    if dropout_rate > 0.0:
        b, h, q_len, k_len = p.shape
        keep = dropout_keep_mask(dropout_seed, b, h, q_len, k_len,
                                 dropout_rate, p.device)
        scale = keep_scale(dropout_rate)
        p_drop = torch.where(keep, p * scale, torch.zeros_like(p))
        dp = torch.where(keep, dp * scale, torch.zeros_like(dp))
    dv = torch.einsum("bhqk,bhqd->bhkd", p_drop, dof)
    ds = p * (dp - delta) * sm_scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _seq_strides(name, arg, t):
    """(batch, head, seq) strides of the [B, H, S, D] operand `arg`; its
    last dim must be dense (raises ValueError naming the operand).  Runs on
    tensors of any device."""
    sb, sh, ss, sd = t.stride()
    if sd != 1:
        raise ValueError(f"{name}: `{arg}`: the head dim must be dense "
                         f"(strides {t.stride()})")
    return sb, sh, ss


def _misaligned(t):
    """Whether operand t breaks the tensor-core route's rule: its base
    address, or its batch, head or sequence stride in bytes (of a dim
    longer than 1), not a multiple of 16 (the size of a cp.async copy)."""
    if t.data_ptr() % CP_ASYNC_BYTES:
        return True
    return any(n > 1 and st * t.element_size() % CP_ASYNC_BYTES
               for n, st in zip(t.shape[:3], t.stride()[:3]))


def _zero_padded(t, width):
    """A contiguous copy of t whose last dim is zero-padded to `width`."""
    buf = t.new_zeros(tuple(t.shape[:-1]) + (width,))
    buf[..., :t.shape[-1]].copy_(t)
    return buf


def _launch_operands(name, wrapper, code, inputs, outputs, width=None):
    """The input tensors a launch reads and the (batch, head, seq) strides
    of every operand, inputs then outputs, in argument order; `inputs` and
    `outputs` map argument names to tensors.  On the tensor-core routes
    (dtype code DTYPE_BF16) an input narrower than the launch's head dim
    `width` is copied once into a zero-padded contiguous buffer of that
    width, and one that breaks the 16-byte rule into a fresh contiguous
    tensor, whose base and strides meet it; `wrapper.realigned` counts each
    copy (the wrappers allocate the outputs themselves, aligned and of the
    launch's width).  Runs on tensors of any device."""
    tensors, strides = [], []
    for arg, t in inputs.items():
        _seq_strides(name, arg, t)
        if code == op_builder.DTYPE_BF16:
            if width is not None and t.shape[-1] < width:
                t = _zero_padded(t, width)
                wrapper.realigned += 1
            elif _misaligned(t):
                t = t.clone(memory_format=torch.contiguous_format)
                wrapper.realigned += 1
        tensors.append(t)
        strides.extend(t.stride()[:3])
    for arg, t in outputs.items():
        strides.extend(_seq_strides(name, arg, t))
    return tensors, strides


def _stride_array(strides):
    """Strides as the int64 array the launchers with many operands take."""
    return (op_builder.I64_PTR._type_ * len(strides))(*strides)


def _heads_layout(b, h, s, d, like):
    """An empty [B, H, S, D] laid out as [B, S, H, D] in memory, so that
    merging the heads back into [B, S, H*D] is a free view."""
    return torch.empty((b, s, h, d), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def kernel_head_dim(d: int) -> int:
    """The compiled head dim a tiled launch at head dim `d` runs: the
    smallest of KERNEL_HEAD_DIMS at or above it.  Raises ValueError for a
    `d` outside 1 to 256 (a larger one runs the wide kernels, which are not
    compiled per head dim: head_dim_plan)."""
    if not 1 <= d <= KERNEL_HEAD_DIMS[-1]:
        raise ValueError(
            f"head dim {d} has no tiled instantiation (those take 1 to "
            f"{KERNEL_HEAD_DIMS[-1]})")
    return next(c for c in KERNEL_HEAD_DIMS if c >= d)


def launch_head_dim(code: int, d: int) -> int:
    """The head dim a launch passes for a true head dim `d`: on the
    tensor-core routes (dtype code DTYPE_BF16) `d` rounded up to a multiple
    of HEAD_DIM_STEP, the operands zero-padded to it; `d` itself on the
    CUDA-core routes, which read element by element."""
    if code == op_builder.DTYPE_BF16:
        return -(-d // HEAD_DIM_STEP) * HEAD_DIM_STEP
    return d


class HeadDimPlan(NamedTuple):
    """How kernels B, E, F and G run a head dim: the route, the head dim
    the launch passes (`width`) and the output-column chunks on the grid
    (1 but on the wide route)."""
    route: str
    width: int
    chunks: int


def head_dim_plan(code: int, d: int) -> HeadDimPlan:
    """The plan of a launch at dtype code `code` and true head dim `d`: bf16
    on the tensor cores and fp32 on the CUDA cores; up to 256 the tiled
    kernels, one chunk; above 256 the wide kernels, ceil(width / WIDE_CHUNK)
    chunks.  Raises ValueError for d < 1."""
    if d < 1:
        raise ValueError(f"head dim {d} not supported (the kernels take any "
                         "head dim >= 1)")
    width = launch_head_dim(code, d)
    bf16 = code == op_builder.DTYPE_BF16
    if d > KERNEL_HEAD_DIMS[-1]:
        return HeadDimPlan(
            ROUTE_TENSOR_CORES_WIDE if bf16 else ROUTE_CUDA_CORES_WIDE,
            width, -(-width // WIDE_CHUNK))
    return HeadDimPlan(ROUTE_TENSOR_CORES if bf16 else ROUTE_CUDA_CORES,
                       width, 1)


def _true_head_dim(t, d):
    """An output of the launch's head dim as a view of the true `d`."""
    return t if t.shape[-1] == d else t[..., :d]


def _check_attention(name, q, k, v, *more):
    """Dtype, shape and device checks shared by kernels B, E, F and G, the
    device last (so that the rest holds on CPU tensors too); returns
    (device index, dtype code, B, H, Sq, Sk, D)."""
    code = kernel_dtype_code(q)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v dtypes differ: {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, h, sq, d = q.shape
    try:
        head_dim_plan(code, d)
    except ValueError as exc:
        raise ValueError(f"{name}: {exc}") from None
    index = check_cuda(name, q, k, v, *more)
    return index, code, b, h, sq, k.shape[2], d


def _dropout_args(name, rate, seed, device):
    """(seed pointer, keep threshold, keep scale) for a launch: threshold
    256 and a null seed when rate is 0; else the seed as a device int32."""
    if not rate > 0.0:
        return 0, 256, 1.0, None
    if seed is None:
        raise ValueError(f"{name}: dropout_rate > 0 requires dropout_seed")
    seed_t = torch.as_tensor(seed, device=device).to(torch.int32).reshape(1)
    return seed_t.data_ptr(), quantized_threshold(rate), keep_scale(rate), seed_t


def flash_attention_cuda(q, k, v, causal: bool = False,
                         sm_scale: Optional[float] = None,
                         dropout_rate: float = 0.0, dropout_seed=None):
    """Kernel B on CUDA tensors q [B, H, Sq, D], k, v [B, H, Sk, D] (any
    batch/head/seq strides, dense D; a bf16 operand whose strides or base
    address are not multiples of 16 bytes is copied first).  Returns
    (out [B, H, Sq, D], lse [B, H, Sq] fp32); out is laid out as
    [B, Sq, H, D] in memory.  dropout_seed: an int or a device int32 tensor
    of one element."""
    name = "flash_attention_cuda"
    index, code, b, h, sq, sk, d = _check_attention(name, q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    plan = head_dim_plan(code, d)
    out = _heads_layout(b, h, sq, plan.width, q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return _true_head_dim(out, d), lse
    (q, k, v), strides = _launch_operands(
        name, flash_attention_cuda, code, dict(q=q, k=k, v=v), dict(out=out),
        plan.width)
    seed_ptr, threshold, scale, _seed_t = _dropout_args(
        name, dropout_rate, dropout_seed, q.device)
    lib = op_builder.load()
    err = lib.ds_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, h, sq, sk, plan.width, plan.chunks, *strides,
        float(sm_scale),
        int(causal), seed_ptr, threshold, scale, code, stream_handle(index))
    op_builder.check_launch(name, err)
    flash_attention_cuda.launches += 1
    return _true_head_dim(out, d), lse


flash_attention_cuda.launches = 0
flash_attention_cuda.realigned = 0


def _bwd_launch(name, wrapper, fn, tensors, outs, shapes, causal, sm_scale,
                dropout_rate, dropout_seed):
    """One kernel E launch: `tensors` (q, k, v, dout) and `outs` (argument
    name -> grad, of the launch's head dim) give their (batch, head, seq)
    strides in argument order."""
    q, k, v, dout, lse, delta = tensors
    index, code, b, h, sq, sk, d = shapes
    plan = head_dim_plan(code, d)
    (q, k, v, dout), strides = _launch_operands(
        name, wrapper, code, dict(q=q, k=k, v=v, dout=dout), outs,
        plan.width)
    seed_ptr, threshold, scale, _seed_t = _dropout_args(
        name, dropout_rate, dropout_seed, q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(),
             *(t.data_ptr() for t in outs.values()), b, h, sq, sk,
             plan.width, plan.chunks,
             _stride_array(strides), float(sm_scale), int(causal), seed_ptr,
             threshold, scale, code, stream_handle(index))
    op_builder.check_launch(name, err)


def _check_stats(name, lse, delta, b, h, sq):
    for arg, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (b, h, sq) \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous fp32 "
                             f"[{b}, {h}, {sq}], got {t.dtype} "
                             f"{tuple(t.shape)}")


def flash_attention_bwd_dkdv_cuda(q, k, v, dout, lse, delta,
                                  causal: bool = False,
                                  sm_scale: Optional[float] = None,
                                  dropout_rate: float = 0.0,
                                  dropout_seed=None):
    """Kernel E's dk/dv launch (one block per k-tile) on CUDA tensors:
    q, dout [B, H, Sq, D], k, v [B, H, Sk, D], lse and delta = rowsum(dO * O)
    [B, H, Sq] fp32.  Returns (dk, dv), laid out as [B, Sk, H, D]."""
    name = "flash_attention_bwd_dkdv_cuda"
    shapes = _check_attention(name, q, k, v, dout, lse, delta)
    _, code, b, h, sq, sk, d = shapes
    _check_stats(name, lse, delta, b, h, sq)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    width = head_dim_plan(code, d).width
    dk = _heads_layout(b, h, sk, width, k)
    dv = _heads_layout(b, h, sk, width, v)
    if dk.numel():
        _bwd_launch(name, flash_attention_bwd_dkdv_cuda,
                    op_builder.load().ds_flash_attention_bwd_dkdv,
                    (q, k, v, dout, lse, delta), dict(dk=dk, dv=dv), shapes,
                    causal, sm_scale, dropout_rate, dropout_seed)
        flash_attention_bwd_dkdv_cuda.launches += 1
    return _true_head_dim(dk, d), _true_head_dim(dv, d)


flash_attention_bwd_dkdv_cuda.launches = 0
flash_attention_bwd_dkdv_cuda.realigned = 0


def flash_attention_bwd_dq_cuda(q, k, v, dout, lse, delta,
                                causal: bool = False,
                                sm_scale: Optional[float] = None,
                                dropout_rate: float = 0.0,
                                dropout_seed=None):
    """Kernel E's dq launch (one block per q-tile); arguments as
    flash_attention_bwd_dkdv_cuda.  Returns dq laid out as [B, Sq, H, D]."""
    name = "flash_attention_bwd_dq_cuda"
    shapes = _check_attention(name, q, k, v, dout, lse, delta)
    _, code, b, h, sq, sk, d = shapes
    _check_stats(name, lse, delta, b, h, sq)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    dq = _heads_layout(b, h, sq, head_dim_plan(code, d).width, q)
    if dq.numel() and sk == 0:
        dq.zero_()
    elif dq.numel():
        _bwd_launch(name, flash_attention_bwd_dq_cuda,
                    op_builder.load().ds_flash_attention_bwd_dq,
                    (q, k, v, dout, lse, delta), dict(dq=dq), shapes, causal,
                    sm_scale, dropout_rate, dropout_seed)
        flash_attention_bwd_dq_cuda.launches += 1
    return _true_head_dim(dq, d)


flash_attention_bwd_dq_cuda.launches = 0
flash_attention_bwd_dq_cuda.realigned = 0


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        dropout_rate: float = 0.0, dropout_seed=None):
    """(dq, dk, dv): kernel E's two launches on CUDA, with
    delta = rowsum(dO * O) in plain PyTorch (the JAX package leaves it to
    XLA); the plain twin on the CPU."""
    if not use_kernel(q, k, v, out, lse, dout):
        return flash_attention_bwd_reference(
            q, k, v, out, lse, dout, causal=causal, sm_scale=sm_scale,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    delta = (dout.float() * out.float()).sum(dim=-1)
    dk, dv = flash_attention_bwd_dkdv_cuda(
        q, k, v, dout, lse, delta, causal=causal, sm_scale=sm_scale,
        dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    dq = flash_attention_bwd_dq_cuda(
        q, k, v, dout, lse, delta, causal=causal, sm_scale=sm_scale,
        dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Kernel B forward and kernel E backward on CUDA, the plain pair on
    the CPU; saves out, lse and the dropout seed, from which the backward
    regenerates the forward's keep mask."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, dropout_rate, dropout_seed):
        if use_kernel(q, k, v):
            out, lse = flash_attention_cuda(
                q, k, v, causal=causal, sm_scale=sm_scale,
                dropout_rate=dropout_rate, dropout_seed=dropout_seed)
        else:
            out, lse = mha_reference(
                q, k, v, causal=causal, sm_scale=sm_scale, return_lse=True,
                dropout_rate=dropout_rate, dropout_seed=dropout_seed)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, sm_scale, dropout_rate, dropout_seed)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        causal, sm_scale, dropout_rate, dropout_seed = ctx.args
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout, causal=causal, sm_scale=sm_scale,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: Optional[float] = None, bias=None,
                    dropout_rate: float = 0.0, dropout_seed=None,
                    return_lse: bool = False):
    """Multi-head attention, q, k, v [B, H, S, D] -> [B, H, S, D] (and the
    fp32 logsumexp [B, H, S] with return_lse).  Kernels B / E on CUDA, the
    plain pair on the CPU; an additive bias always takes the plain path
    (differentiated by autograd).  dropout_rate > 0 drops the normalized
    probabilities with the mask of dropout_seed (an int or a device int32
    tensor of one element)."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if bias is not None:
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale,
                             bias=bias, return_lse=return_lse,
                             dropout_rate=dropout_rate,
                             dropout_seed=dropout_seed)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = _FlashAttention.apply(q, k, v, causal, sm_scale,
                                         dropout_rate, dropout_seed)
    elif use_kernel(q, k, v):
        out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                        sm_scale=sm_scale,
                                        dropout_rate=dropout_rate,
                                        dropout_seed=dropout_seed)
    else:
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale,
                             return_lse=return_lse, dropout_rate=dropout_rate,
                             dropout_seed=dropout_seed)
    return (out, lse) if return_lse else out
