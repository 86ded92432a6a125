"""ZeRO++-style low-bandwidth collectives: qwZ / qgZ building blocks
(counterpart of deepspeed_tpu/runtime/comm/low_bandwidth.py).

  qwZ  blockwise-int8 (or packed int4) quantize BEFORE the weight
       all-gather, dequantize after; the backward is the unchanged fp32
       reduce-scatter (straight-through quantizer).
  qgZ  quantized gradient reduce-scatter in the all-to-all form: quantize
       my chunk table, all-to-all so every shard receives all copies of ITS
       chunk, dequantize in fp32 and reduce locally in shard-index order.
       `qgz_reduce_scatter_inner` carries a persistent error-feedback
       buffer.

Everything here is plain PyTorch, as the JAX package leaves these
functions to XLA.  Where the JAX functions run per device under
`shard_map`, these take and return per-rank values: a list with one tensor
per rank of the mesh (parallel/mesh.py), in rank order; `mesh=None` means
the registered mesh context.  The scale layout follows ops/quant.py's
QuantizedWeight convention, extended with sub-blocks over the flattened
remainder, so a block never straddles a shard boundary along the gathered
dimension.
"""

from typing import List, Tuple

import numpy as np
import torch

from ...parallel.mesh import DATA_AXIS, get_mesh_context

_QMAX = {8: 127, 4: 7}
DEFAULT_BLOCK = 256


def _check_bits(bits: int, what: str) -> None:
    if bits not in _QMAX:
        raise ValueError(f"{what}={bits} unsupported — use 4 or 8 "
                         "(0 disables)")


def largest_divisor_at_most(n: int, bound: int, even: bool = False) -> int:
    bound = max(1, min(n, bound))
    for g in range(bound, 0, -1):
        if n % g == 0 and (not even or g % 2 == 0):
            return g
    return 1


def axes_tuple(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def resolve_mesh(mesh):
    return mesh if mesh is not None else get_mesh_context()


def block_size(rest: int, bits: int, block: int = DEFAULT_BLOCK) -> int:
    """Elements per scale block for a flattened remainder of `rest`
    elements: the largest divisor at most `block`, even for 4 bits unless
    no even divisor exists (the payload then keeps the 8-bit layout)."""
    bs = largest_divisor_at_most(rest, block, even=(bits == 4))
    if bits == 4 and bs % 2 != 0:
        bs = largest_divisor_at_most(rest, block)
    return bs


# --------------------------------------------------------------------- #
# blockwise symmetric quantization
# --------------------------------------------------------------------- #
def blockwise_quantize(x: torch.Tensor, dim: int = 0, bits: int = 8,
                       block: int = DEFAULT_BLOCK
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize `x` to int8 (optionally int4-packed) with per-block fp32
    scales.  `dim` moves to the front and stays whole in the scale layout;
    the remaining elements are flattened and split into blocks of at most
    `block` (the largest divisor, so no padding).

    Returns (q, scale): q int8 [m, nb, bs] (bits=8) or [m, nb, bs // 2]
    packed (bits=4), scale fp32 [m, nb].  The scale is taken in x's dtype
    (amax / qmax) and then widened, the quotient x / scale in fp32, and
    the rounding is half to even."""
    _check_bits(bits, "bits")
    xt = torch.movedim(x, dim, 0)
    m = xt.shape[0]
    rest = int(np.prod(xt.shape[1:])) if xt.dim() > 1 else 1
    bs = block_size(rest, bits, block)
    g = xt.reshape(m, rest // bs, bs)
    qmax = _QMAX[bits]
    amax = g.abs().amax(dim=-1)                                # [m, nb]
    # a tensor divisor: a CUDA tensor over a Python scalar is multiplied by
    # the scalar's reciprocal, which is not the same quotient
    scale = torch.where(amax > 0, amax / torch.full_like(amax, qmax),
                        torch.ones_like(amax)).to(torch.float32)
    q = torch.clamp(torch.round(g / scale[..., None]), -qmax, qmax
                    ).to(torch.int8)
    if bits == 4 and bs % 2 == 0:
        q = pack_int4(q)
    return q, scale


def blockwise_dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
                         dim: int = 0, dtype=torch.float32,
                         bits: int = 8) -> torch.Tensor:
    """Inverse of blockwise_quantize for a target `shape` (the shape AFTER
    any collective: shape[dim] may be a gathered multiple of the quantized
    shard's).  A 4-bit payload is taken as packed when it holds half the
    target's elements."""
    _check_bits(bits, "bits")
    shape = tuple(shape)
    moved = (shape[dim],) + tuple(s for i, s in enumerate(shape) if i != dim)
    if bits == 4 and 2 * q.numel() == int(np.prod(moved)):
        q = unpack_int4(q)
    deq = q.to(torch.float32) * scale[..., None]
    return torch.movedim(deq.reshape(moved).to(dtype), 0, dim)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int8 values in [-7, 7] two per byte along the last axis (which
    must be even): out[..., i] holds q[..., 2i] in the low nibble and
    q[..., 2i + 1] in the high nibble."""
    u = q.contiguous().view(torch.uint8)
    lo = u[..., 0::2] & 0xF
    hi = u[..., 1::2] & 0xF
    return (lo | (hi << 4)).view(torch.int8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4 (sign-extending both nibbles)."""
    u = p.contiguous().view(torch.uint8)
    lo = ((u & 0xF).to(torch.int8) ^ 8) - 8
    hi = (((u >> 4) & 0xF).to(torch.int8) ^ 8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1],
                                                 p.shape[-1] * 2)


def quantized_gather_saves_bytes(shape, dim: int, dtype, bits: int,
                                 block: int = DEFAULT_BLOCK) -> bool:
    """True when a blockwise-quantized collective over an array of
    `shape` / `dtype` along `dim` moves fewer wire bytes than the
    native-width collective (skinny leaves pay 4 scale bytes per payload
    byte and must fall back dense)."""
    shape = tuple(shape)
    m = shape[dim]
    rest = int(np.prod(shape)) // max(m, 1)
    bs = block_size(rest, bits, block)
    payload = rest // 2 if (bits == 4 and bs % 2 == 0) else rest
    scale_bytes = (rest // bs) * 4
    native = rest * torch.empty((), dtype=dtype).element_size()
    return payload + scale_bytes < native


def as_quantized_weight(q: torch.Tensor, scale: torch.Tensor):
    """Bridge to ops/quant.py's carrier for the 2-D, one-block-per-row
    case: a `blockwise_quantize(w, dim=0)` result with nb == 1 IS a per-row
    QuantizedWeight (groups == rows, scale [rows, 1]), so the dequant-matmul
    kernel accepts the gathered payload directly."""
    from ...ops.quant import QuantizedWeight
    if q.dim() != 3 or scale.shape[1] != 1:
        raise ValueError(
            f"QuantizedWeight bridge needs a [rows, 1, cols] blockwise "
            f"layout, got q{tuple(q.shape)} scale{tuple(scale.shape)}")
    return QuantizedWeight(q.reshape(q.shape[0], -1), scale.reshape(-1, 1))


def ordered_sum(table: torch.Tensor) -> torch.Tensor:
    """Sum of a [W, ...] table over its leading axis in index order 0, 1,
    ..., W - 1: the accumulation contract of the qgZ reduce-scatter."""
    total = table[0]
    for i in range(1, table.shape[0]):
        total = total + table[i]
    return total


def f32_psum_scatter(g: List[torch.Tensor], axes, dim, mesh=None):
    """Tiled psum_scatter that promotes half dtypes to fp32 for the
    reduction and demotes after: cross-shard accumulation happens in fp32
    whatever the compute dtype."""
    mesh = resolve_mesh(mesh)
    half = g[0].is_floating_point() and g[0].element_size() < 4
    if half:
        shards = mesh.psum_scatter([t.to(torch.float32) for t in g], axes, dim)
        return [s.to(g[0].dtype) for s in shards]
    return mesh.psum_scatter(g, axes, dim)


# --------------------------------------------------------------------- #
# qwZ: quantized weight all-gather
# --------------------------------------------------------------------- #
def _gathered_shape(shape, dim, world):
    return tuple(shape[:dim]) + (shape[dim] * world,) + tuple(shape[dim + 1:])


def _lbag_forward(xs, axes, dim, qwz_bits, block, mesh):
    if not qwz_bits:
        return mesh.all_gather(xs, axes, dim)
    qs, scales = zip(*(blockwise_quantize(x, dim=dim, bits=qwz_bits,
                                          block=block) for x in xs))
    q_g = mesh.all_gather(list(qs), axes, 0)
    s_g = mesh.all_gather(list(scales), axes, 0)
    world = int(np.prod([mesh.axis_size(a) for a in axes]))
    return [blockwise_dequantize(q, s, _gathered_shape(x.shape, dim, world),
                                 dim=dim, dtype=x.dtype, bits=qwz_bits)
            for q, s, x in zip(q_g, s_g, xs)]


class _LowBandwidthAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, dim, qwz_bits, qgz_bits, block, *xs):
        ctx.meta = (mesh, axes, dim, qgz_bits, block)
        return tuple(_lbag_forward(list(xs), axes, dim, qwz_bits, block, mesh))

    @staticmethod
    def backward(ctx, *gs):
        mesh, axes, dim, qgz_bits, block = ctx.meta
        if qgz_bits:
            grads = quantized_psum_scatter(list(gs), axes, dim, bits=qgz_bits,
                                           block=block, mesh=mesh)
        else:
            grads = f32_psum_scatter(list(gs), axes, dim, mesh=mesh)
        return (None,) * 6 + tuple(grads)


def low_bandwidth_all_gather(x: List[torch.Tensor], axes, dim, qwz_bits=8,
                             qgz_bits=0, block=DEFAULT_BLOCK, mesh=None):
    """Tiled all-gather with a quantized forward wire (qwZ) and an
    optionally quantized reduce-scatter transpose (qgZ).

    qwz_bits=8/4: each shard is blockwise-quantized before the gather and
    dequantized after; qwz_bits=0 gathers at native width.  qgz_bits=8/4:
    the backward reduce-scatters the gradient through
    quantized_psum_scatter; qgz_bits=0 keeps the fp32 reduce-scatter, so
    with qgZ off the gradients are those of the fp32 gather path
    (straight-through quantizer).  `x` and the result are per-rank
    lists."""
    mesh = resolve_mesh(mesh)
    mesh.check_ranked("low_bandwidth_all_gather", x)
    return list(_LowBandwidthAllGather.apply(
        mesh, axes_tuple(axes), dim, qwz_bits, qgz_bits, block, *x))


# --------------------------------------------------------------------- #
# qgZ: quantized gradient reduce-scatter (all-to-all transport)
# --------------------------------------------------------------------- #
def chunk_table(x: torch.Tensor, dim: int, world: int, what: str,
                axis_name: str) -> torch.Tensor:
    """x with `dim` moved to the front and split into the [world, m / world,
    ...] table of per-owner chunks."""
    xt = torch.movedim(x, dim, 0)
    m = xt.shape[0]
    if m % world != 0:
        raise ValueError(
            f"{what}: dim {dim} (size {m}) must be divisible by the "
            f"{axis_name!r} axis size {world}")
    return xt.reshape((world, m // world) + tuple(xt.shape[1:]))


def _quantized_reduce_scatter_one_axis(xs, axis_name, dim, bits, block, mesh):
    """One axis of quantized_psum_scatter: quantize my chunk table,
    transpose ownership with all_to_all, dequantize and reduce in fp32 in
    shard-index order."""
    world = mesh.axis_size(axis_name)
    tabs = [chunk_table(x, dim, world, "quantized reduce-scatter", axis_name)
            for x in xs]
    qs, scales = zip(*(blockwise_quantize(t, dim=0, bits=bits, block=block)
                       for t in tabs))
    q_t = mesh.all_to_all(list(qs), axis_name)
    s_t = mesh.all_to_all(list(scales), axis_name)
    out = []
    for q, s, tab, x in zip(q_t, s_t, tabs, xs):
        deq = blockwise_dequantize(q, s, tab.shape, dim=0,
                                   dtype=torch.float32, bits=bits)
        out.append(torch.movedim(ordered_sum(deq).to(x.dtype), 0, dim))
    return out


def quantized_psum_scatter(x: List[torch.Tensor], axes, dim, bits: int = 8,
                           block: int = DEFAULT_BLOCK, mesh=None):
    """Drop-in for the tiled psum_scatter with a quantized wire.  Multiple
    axes reduce sequentially in tuple order (each stage re-quantizes its
    partial sums)."""
    _check_bits(bits, "qgz_bits")
    mesh = resolve_mesh(mesh)
    mesh.check_ranked("quantized_psum_scatter", x)
    for ax in axes_tuple(axes):
        x = _quantized_reduce_scatter_one_axis(x, ax, dim, bits, block, mesh)
    return x


def qgz_reduce_scatter_inner(x: List[torch.Tensor], error: List[torch.Tensor],
                             axis_name: str = DATA_AXIS, dim: int = 0,
                             bits: int = 8, block: int = DEFAULT_BLOCK,
                             mesh=None):
    """Error-compensated quantized reduce-scatter over per-rank values.

    The persistent `error` buffers (same shapes as `x`, carried by the
    caller across steps) absorb each step's quantization residual, so
    repeated reductions of a persistent signal converge on the exact mean.
    Returns (reduced, new_error), both per-rank lists: `reduced[r]` is rank
    r's SUM over workers of its `dim`-chunk, and new_error = (x + error) -
    dequant(quant(x + error))."""
    _check_bits(bits, "qgz_bits")
    mesh = resolve_mesh(mesh)
    mesh.check_ranked("qgz_reduce_scatter_inner", x)
    world = mesh.axis_size(axis_name)
    comps = [a + e for a, e in zip(x, error)]
    tabs = [chunk_table(c, dim, world, "qgz reduce-scatter", axis_name)
            for c in comps]
    qs, scales = zip(*(blockwise_quantize(t, dim=0, bits=bits, block=block)
                       for t in tabs))
    q_t = mesh.all_to_all(list(qs), axis_name)
    s_t = mesh.all_to_all(list(scales), axis_name)
    reduced, new_error = [], []
    for r, (comp, tab) in enumerate(zip(comps, tabs)):
        applied = blockwise_dequantize(qs[r], scales[r], tab.shape, dim=0,
                                       dtype=comp.dtype, bits=bits)
        deq = blockwise_dequantize(q_t[r], s_t[r], tab.shape, dim=0,
                                   dtype=torch.float32, bits=bits)
        reduced.append(torch.movedim(ordered_sum(deq).to(x[r].dtype), 0, dim))
        moved = (tab.shape[0] * tab.shape[1],) + tuple(tab.shape[2:])
        new_error.append(comp - torch.movedim(applied.reshape(moved), 0, dim))
    return reduced, new_error


def init_error_feedback(tree):
    """Zero-initialized persistent error buffers matching a grad tree (a
    tensor, or lists / tuples / dicts of them); the caller carries these
    across steps."""
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    if isinstance(tree, dict):
        return {k: init_error_feedback(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(init_error_feedback(v) for v in tree)
    raise TypeError(f"init_error_feedback: unsupported leaf "
                    f"{type(tree).__name__}")


def qgz_reduce_scatter(x_stacked: torch.Tensor, error_stacked: torch.Tensor,
                       mesh_ctx=None, axis_name: str = DATA_AXIS,
                       bits: int = 8, block: int = DEFAULT_BLOCK):
    """Worker-stacked wrapper: `x_stacked` [W, ...] holds worker i's tensor
    in row i.  Returns (reduced [W, chunk...], new_error [W, ...]): row i of
    `reduced` is worker i's reduce-scattered chunk, `new_error` the
    per-worker compensation state to carry into the next call."""
    mesh = resolve_mesh(mesh_ctx)
    if x_stacked.shape[0] != mesh.world_size:
        raise ValueError(
            f"qgz_reduce_scatter: leading dimension {x_stacked.shape[0]} is "
            f"not the mesh's world size {mesh.world_size}")
    reduced, new_error = qgz_reduce_scatter_inner(
        list(x_stacked.unbind(0)), list(error_stacked.unbind(0)), axis_name,
        dim=0, bits=bits, block=block, mesh=mesh)
    dev = x_stacked.device
    return (torch.stack([r.to(dev) for r in reduced]),
            torch.stack([e.to(dev) for e in new_error]))
