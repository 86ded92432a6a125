"""Fused collective-matmul: per-tile fusion of the qwZ / qgZ transports
with the GEMMs that consume / produce them (counterpart of
deepspeed_tpu/ops/collective_matmul.py; T3, arXiv:2401.16677).

Two layers, as in the JAX package:

1. The GEMM-fused ops `fused_allgather_matmul` (forward: the qwZ
   dequant-all-gather in the consuming GEMM's prologue) and
   `fused_matmul_reduce_scatter` (backward: the qgZ reduce-scatter in the
   producer GEMM's epilogue), each with two routes:

   - the FUSED route (default; `_ag_matmul_tpu` / `_matmul_rs_tpu`'s
     structure).  All-gather-matmul: an fp32 accumulator lives across the W
     ring steps, the shard for step t + 1 travels into the other of two
     slots on the sender's copy stream while step t's product (kernel I,
     csrc/fcm_ag_matmul.cu) runs on the compute stream, and the output is
     cast once, by the last step.  Matmul-reduce-scatter (int8 only): one
     tile per destination in ring order, distance 1 first and the own tile
     last, each compensated with its error rows, quantized in the product's
     epilogue (kernel J's producer, csrc/fcm_matmul_rs.cu) and sent as it
     completes; then the source table is dequantized and summed in
     shard-index order (kernel J's collect launch).
   - the PER-TILE route (`per_tile=True`; `_ag_matmul_interp`'s
     structure): one kernel-H launch (csrc/fcm_tile.cu) per hop writing a
     fresh fp32 partial, the partials combined by the caller, the hops
     moved by `MeshContext.permute` in program order; for the
     reduce-scatter the `a^T b` tile of kernel H and the plain quantizer.

2. Per-tile TRANSPORT drop-ins for a consumer that is not one GEMM:
   `fcm_all_gather` (for `low_bandwidth_all_gather`), `fcm_reduce_scatter`
   (for `quantized_psum_scatter` / `f32_psum_scatter`) and
   `fcm_qgz_reduce_scatter_inner`: W - 1 quantize -> permute -> dequant
   tile chains in place of the monolithic collective, bitwise equal to the
   modular functions.

Per-rank values are lists with one tensor per rank of the mesh
(parallel/mesh.py), in rank order; `mesh=None` means the registered mesh
context.  CUDA tensors take the hand-written kernels or the call raises;
CPU tensors take the plain twins beside each wrapper, through the same
host code.  Every transport runs under
`torch.profiler.record_function(FCM_SCOPE)`.
"""

import contextlib
from typing import List, NamedTuple, Optional

import torch

from .. import constants as C
from ..runtime.comm.low_bandwidth import (DEFAULT_BLOCK, _check_bits,
                                          axes_tuple, blockwise_dequantize,
                                          blockwise_quantize, chunk_table,
                                          largest_divisor_at_most,
                                          ordered_sum, resolve_mesh,
                                          unpack_int4)
from . import op_builder
from .dispatch import check_cuda, kernel_dtype_code, stream_handle, use_kernel

FCM_SCOPE = C.FCM_SCOPE

# payload layouts of csrc/tile_matmul.cuh's weight loader
W_NATIVE, W_INT8, W_INT4 = 0, 1, 2

# Kernels H, I and J have two routes each: bf16 left operands (x, g; a and
# b) multiply on the tensor cores (csrc/tile_mma.cuh), fp32 or mixed ones
# on the CUDA cores (csrc/tile_matmul.cuh; a tensor-core fp32 product would
# be TF32).
ROUTE_TENSOR_CORES, ROUTE_CUDA_CORES = "tensor_cores", "cuda_cores"
# the tensor-core route reads its left operands with 16-byte cp.async
# copies: base and row pitch must be multiples of this many bytes
CP_ASYNC_BYTES = 16
# Where the output has too few tiles to fill the card, the tensor-core
# route splits K over blocks so that at least two per SM run, into fp32
# partials summed in split order by a second pass (SM_COUNT: the H100
# SXM's).  Output tile and K step of the two split launches
# (csrc/tile_mma.cuh WprodCfg<true> and AtbCfg), which kernel H's
# transposed and producer tiles share with I and J.
SM_COUNT = 132
SPLIT_MIN_BLOCKS = 2 * SM_COUNT
AG_T_TILE = (64, 64, 64)   # kernel I, transposed: BM, BN, BK
RS_TILE = (64, 128, 32)    # kernel J's producer: BM, BN, BK


def _fcm_scope():
    """The profiler scope every fused transport runs under."""
    return torch.profiler.record_function(FCM_SCOPE)


def _ranks(mesh):
    return range(mesh.world_size)


# A test may record the fused route's schedule: which slot each product
# reads and each copy writes, in the order the host enqueues them.
_schedule: Optional[list] = None


@contextlib.contextmanager
def record_schedule():
    """Collect the fused routes' (kind, step, rank, ...) schedule entries
    enqueued inside the block into the yielded list."""
    global _schedule
    saved, _schedule = _schedule, []
    try:
        yield _schedule
    finally:
        _schedule = saved


def _log(*entry):
    if _schedule is not None:
        _schedule.append(entry)


# --------------------------------------------------------------------- #
# per-tile ring transport (the mesh-level schedule both layers share)
# --------------------------------------------------------------------- #
def _ring_tiles(payloads, axis_name, mesh):
    """Ring-circulate per-rank payload tiles and return them in SOURCE
    order.

    `payloads` is a tuple of per-rank lists (or None).  Ranks forward along
    a send-left ring (rank d sends to d - 1, receives from d + 1), so after
    step t rank d holds the tile that originated at (d + t) % W: W - 1
    hops.  The returned tables are per-rank lists of [W, ...] stacks in
    source-index order (a roll by the rank's own index converts arrival
    order to source order)."""
    world = mesh.axis_size(axis_name)
    perm = [(i, (i - 1) % world) for i in range(world)]
    rows = [list(payloads)]
    cur = list(payloads)
    for _t in range(1, world):
        cur = [None if p is None else mesh.permute(p, axis_name, perm)
               for p in cur]
        rows.append(cur)
    tables = []
    for k, p in enumerate(payloads):
        if p is None:
            tables.append(None)
            continue
        table = []
        for r in _ranks(mesh):
            with mesh.rank(r):
                stacked = torch.stack([row[k][r] for row in rows], dim=0)
                table.append(torch.roll(stacked, mesh.axis_index(r, axis_name),
                                        dims=0))
        tables.append(table)
    return tables


def _scatter_tiles(payloads, axis_name, mesh):
    """Ring-scheduled all-to-all of per-destination tiles, returning each
    rank's received tiles in SOURCE order.

    `payloads` is a tuple of per-rank lists of [W, ...] tables where row j
    is the tile this rank owes destination j.  Round t (t = 1..W - 1) moves
    every rank's distance-t tile in one shifted permutation; row `my` stays
    local.  Returns per-rank lists of [W, ...] tables where row s is the
    tile SOURCE s sent here."""
    world = mesh.axis_size(axis_name)
    # rolled[k][r][t] = rank r's tile for destination (my + t) % W
    rolled = []
    for p in payloads:
        if p is None:
            rolled.append(None)
            continue
        per_rank = []
        for r in _ranks(mesh):
            with mesh.rank(r):
                per_rank.append(torch.roll(
                    p[r], -mesh.axis_index(r, axis_name), dims=0))
        rolled.append(per_rank)
    arrivals = [[None if rk is None else [t[0] for t in rk] for rk in rolled]]
    for t in range(1, world):
        perm = [(i, (i + t) % world) for i in range(world)]
        arrivals.append([
            None if rk is None
            else mesh.permute([tab[t] for tab in rk], axis_name, perm)
            for rk in rolled])
    tables = []
    for k, p in enumerate(payloads):
        if p is None:
            tables.append(None)
            continue
        table = []
        for r in _ranks(mesh):
            # arrivals[t][k][r] came from source (my - t) % W; reversing
            # gives a rotation of source order, fixed up by one roll
            with mesh.rank(r):
                rev = torch.stack([arrivals[t][k][r]
                                   for t in range(world)][::-1], dim=0)
                table.append(torch.roll(
                    rev, mesh.axis_index(r, axis_name) + 1, dims=0))
        tables.append(table)
    return tables


def _quantize_scatter_reduce(chunk_tab, axis_name, bits, block, mesh,
                             applied_dtype=None):
    """The fused scatter's ONE accumulation pipeline: quantize each rank's
    destination-index chunk table once (per-chunk scales, the modular qgZ
    layout), move each tile in a ring-scheduled all-to-all round,
    dequantize the received source table and reduce in SHARD-INDEX order.
    bits=0 moves fp32 chunks unquantized.

    Returns (reduced, applied), per-rank lists: `applied` is
    deq(quant(chunk_tab)) in `applied_dtype` for error-feedback callers
    (None when not requested; bits=0 quantizes nothing, so applied ==
    chunk_tab)."""
    applied = None
    if bits:
        qs, ss = [], []
        for r in _ranks(mesh):
            with mesh.rank(r):
                q, s = blockwise_quantize(chunk_tab[r], dim=0, bits=bits,
                                          block=block)
                qs.append(q)
                ss.append(s)
        if applied_dtype is not None:
            applied = []
            for r in _ranks(mesh):
                with mesh.rank(r):
                    applied.append(blockwise_dequantize(
                        qs[r], ss[r], chunk_tab[r].shape, dim=0,
                        dtype=applied_dtype, bits=bits))
        q_tab, s_tab = _scatter_tiles((qs, ss), axis_name, mesh)
        reduced = []
        for r in _ranks(mesh):
            with mesh.rank(r):
                reduced.append(ordered_sum(blockwise_dequantize(
                    q_tab[r], s_tab[r], chunk_tab[r].shape, dim=0,
                    dtype=torch.float32, bits=bits)))
        return reduced, applied
    wide = []
    applied = [] if applied_dtype is not None else None
    for r in _ranks(mesh):
        with mesh.rank(r):
            wide.append(chunk_tab[r].to(torch.float32))
            if applied is not None:
                applied.append(chunk_tab[r].to(applied_dtype))
    (deq,) = _scatter_tiles((wide,), axis_name, mesh)
    reduced = []
    for r in _ranks(mesh):
        with mesh.rank(r):
            reduced.append(ordered_sum(deq[r]))
    return reduced, applied


# --------------------------------------------------------------------- #
# layer 2: per-tile transport drop-ins
# --------------------------------------------------------------------- #
def _fcm_gather_one_axis(parts, axis_name, cdim, mesh):
    """One axis of the fused gather: ring the payload tiles gathered so far
    (concatenated along `cdim` for transport) and return the new per-source
    tile lists.  `parts` is a tuple of lists, one per payload kind, of
    per-rank lists, each in source order along the axes already rung."""
    world = mesh.axis_size(axis_name)
    cats = []
    for tiles in parts:
        if len(tiles) == 1:
            cats.append(tiles[0])
            continue
        per_rank = []
        for r in _ranks(mesh):
            with mesh.rank(r):
                per_rank.append(torch.cat([t[r] for t in tiles], dim=cdim))
        cats.append(per_rank)
    tabs = _ring_tiles(tuple(cats), axis_name, mesh)
    return tuple([[tab[r][p] for r in _ranks(mesh)] for p in range(world)]
                 for tab in tabs)


def _fcm_gather_impl(x, axes, dim, bits, block, mesh):
    """Per-tile ring gather over one or more mesh axes.  Each shard is
    quantized ONCE at the source (as the modular qwZ path does); the
    (payload, scales) tiles then ride the rings, innermost axis first, so
    the final source order is the joint tiled all_gather's axis-major
    layout, and each final tile gets its own dequant."""
    if bits:
        qs, ss = [], []
        for r in _ranks(mesh):
            with mesh.rank(r):
                q, s = blockwise_quantize(x[r], dim=dim, bits=bits,
                                          block=block)
                qs.append(q)
                ss.append(s)
        pq, ps = [qs], [ss]
        for ax in reversed(axes):
            pq, ps = _fcm_gather_one_axis((pq, ps), ax, 0, mesh)
        out = []
        for r in _ranks(mesh):
            shape = x[r].shape
            with mesh.rank(r):
                tiles = []
                for qt, st in zip(pq, ps):
                    mult = st[r].shape[0] // ss[r].shape[0]
                    tshape = (tuple(shape[:dim]) + (shape[dim] * mult,)
                              + tuple(shape[dim + 1:]))
                    tiles.append(blockwise_dequantize(
                        qt[r], st[r], tshape, dim=dim, dtype=x[r].dtype,
                        bits=bits))
                out.append(torch.cat(tiles, dim=dim) if len(tiles) > 1
                           else tiles[0])
        return out
    px = [list(x)]
    for ax in reversed(axes):
        (px,) = _fcm_gather_one_axis((px,), ax, dim, mesh)
    out = []
    for r in _ranks(mesh):
        with mesh.rank(r):
            out.append(torch.cat([t[r] for t in px], dim=dim) if len(px) > 1
                       else px[0][r].clone())
    return out


def _fcm_scatter_one_axis(x, axis_name, dim, bits, block, mesh):
    """One axis of the fused scatter: split into per-owner chunks, then the
    shared quantize -> ring all-to-all -> dequant -> shard-order reduce
    pipeline.  bits=0 moves native chunks promoted to fp32."""
    world = mesh.axis_size(axis_name)
    chunks = [chunk_table(t, dim, world, "fused reduce-scatter", axis_name)
              for t in x]
    red, _ = _quantize_scatter_reduce(chunks, axis_name, bits, block, mesh)
    out = []
    for r in _ranks(mesh):
        with mesh.rank(r):
            out.append(torch.movedim(red[r].to(x[r].dtype), 0, dim))
    return out


def _fcm_reduce_scatter_impl(x, axes, dim, bits, block, mesh):
    with _fcm_scope(), mesh.forked():
        for ax in axes:
            x = _fcm_scatter_one_axis(x, ax, dim, bits, block, mesh)
    return x


def fcm_reduce_scatter(x: List[torch.Tensor], axes, dim, bits: int = 0,
                       block: int = DEFAULT_BLOCK, mesh=None):
    """Per-tile drop-in for `quantized_psum_scatter` (bits=4/8) and
    `f32_psum_scatter` (bits=0): the gradient leaves as per-owner tiles on
    a ring-scheduled all-to-all instead of one monolithic collective.
    Multiple axes reduce sequentially in tuple order."""
    mesh = resolve_mesh(mesh)
    mesh.check_ranked("fcm_reduce_scatter", x)
    return _fcm_reduce_scatter_impl(list(x), axes_tuple(axes), dim, bits,
                                    block, mesh)


class _FcmAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, dim, qwz_bits, qgz_bits, block, *xs):
        ctx.meta = (mesh, axes, dim, qgz_bits, block)
        with _fcm_scope(), mesh.forked():
            return tuple(_fcm_gather_impl(list(xs), axes, dim, qwz_bits,
                                          block, mesh))

    @staticmethod
    def backward(ctx, *gs):
        # straight-through: the forward quantizer is identity
        mesh, axes, dim, qgz_bits, block = ctx.meta
        grads = _fcm_reduce_scatter_impl(list(gs), axes, dim, qgz_bits, block,
                                         mesh)
        return (None,) * 6 + tuple(grads)


def fcm_all_gather(x: List[torch.Tensor], axes, dim, qwz_bits=0, qgz_bits=0,
                   block=DEFAULT_BLOCK, mesh=None):
    """Per-tile drop-in for `low_bandwidth_all_gather` (and, at qwz_bits=0,
    for the native tiled all-gather): the weights arrive tile by tile over
    a ring with the dequant folded in per tile.  Forward values are BITWISE
    those of the modular path; the backward reduce-scatters through
    `fcm_reduce_scatter` (qgZ-quantized when `qgz_bits`, the fp32 table
    otherwise)."""
    mesh = resolve_mesh(mesh)
    mesh.check_ranked("fcm_all_gather", x)
    return list(_FcmAllGather.apply(mesh, axes_tuple(axes), dim, qwz_bits,
                                    qgz_bits, block, *x))


def fcm_qgz_reduce_scatter_inner(x: List[torch.Tensor],
                                 error: List[torch.Tensor], axis_name: str,
                                 dim: int = 0, bits: int = 8,
                                 block: int = DEFAULT_BLOCK, mesh=None):
    """Error-compensated fused reduce-scatter: the per-tile analog of
    `qgz_reduce_scatter_inner` with the identical error-feedback contract
    (new_error = (x + error) - deq(quant(x + error))).  Returns
    (reduced, new_error), per-rank lists, both bitwise equal to the modular
    variant's; only the transport is per tile."""
    _check_bits(bits, "qgz_bits")
    mesh = resolve_mesh(mesh)
    mesh.check_ranked("fcm_qgz_reduce_scatter_inner", x)
    world = mesh.axis_size(axis_name)
    comps = [a + e for a, e in zip(x, error)]
    chunks = [chunk_table(c, dim, world, "fused qgz reduce-scatter",
                          axis_name) for c in comps]
    reduced, new_error = [], []
    with _fcm_scope(), mesh.forked():
        red, applied = _quantize_scatter_reduce(
            chunks, axis_name, bits, block, mesh,
            applied_dtype=comps[0].dtype)
        for r in _ranks(mesh):
            with mesh.rank(r):
                reduced.append(torch.movedim(red[r].to(x[r].dtype), 0, dim))
    for comp, tab, app in zip(comps, chunks, applied):
        moved = (tab.shape[0] * tab.shape[1],) + tuple(tab.shape[2:])
        new_error.append(comp - torch.movedim(app.reshape(moved), 0, dim))
    return reduced, new_error


# --------------------------------------------------------------------- #
# layer 1: the kernels' wrappers and their plain twins
# --------------------------------------------------------------------- #
def _dequant_tile(q, s, kc, n, bits):
    """The kernels' dequant prologue in plain PyTorch: [kc, nb, bs(/2)]
    int8 payload + fp32 block scales -> [kc, n] fp32 weight tile (bits=0:
    the native tile, no scales)."""
    if not bits:
        return q.to(torch.float32).reshape(kc, n)
    if bits == 4 and 2 * q.numel() == kc * n:
        q = unpack_int4(q)
    return (q.to(torch.float32) * s[..., None]).reshape(kc, n)


def _tile_n(q, kc, bits):
    """Columns of the dequantized weight tile for a quantized payload."""
    elems = q.numel()
    if bits == 4:
        elems *= 2
    return elems // kc


def _weight_args(name, q, s, kc, n, bits):
    """(payload pointer, scale pointer, layout, dtype code, block size) of
    a ring payload for csrc/tile_matmul.cuh's weight loader."""
    if not q.is_contiguous():
        raise ValueError(f"{name}: the weight payload must be contiguous")
    if not bits:
        if tuple(q.shape) != (kc, n):
            raise ValueError(f"{name}: native tile {tuple(q.shape)}, expected "
                             f"{(kc, n)}")
        return q.data_ptr(), 0, W_NATIVE, kernel_dtype_code(q), n
    if q.dtype != torch.int8 or s is None or s.dtype != torch.float32 \
            or s.dim() != 2 or s.shape[0] != kc or not s.is_contiguous():
        raise TypeError(f"{name}: a quantized payload is int8 with contiguous "
                        f"fp32 scales [kc, nb]")
    nb = s.shape[1]
    if nb < 1 or n % nb:
        raise ValueError(f"{name}: {nb} scale blocks do not divide n={n}")
    packed = bits == 4 and 2 * q.numel() == kc * n
    if q.numel() != (kc * n // 2 if packed else kc * n):
        raise ValueError(f"{name}: payload of {q.numel()} elements for a "
                         f"[{kc}, {n}] tile at {bits} bits")
    return (q.data_ptr(), s.data_ptr(), W_INT4 if packed else W_INT8, 0,
            n // nb)


def _check_operand(name, arg, t, rows=None, cols=None):
    """A left or right GEMM operand: 2-D, unit stride along its rows (a
    column block of a wider matrix is fine)."""
    if t.dim() != 2 or (t.shape[1] > 1 and t.stride(1) != 1):
        raise ValueError(f"{name}: `{arg}` must be 2-D with unit column "
                         f"stride (shape {tuple(t.shape)}, strides "
                         f"{t.stride()})")
    if (rows is not None and t.shape[0] != rows) or \
            (cols is not None and t.shape[1] != cols):
        raise ValueError(f"{name}: `{arg}` has shape {tuple(t.shape)}, "
                         f"expected ({rows}, {cols})")


def fcm_route(*operands):
    """The route kernels H, I and J take for their left operands: the
    tensor cores when every one is bf16, else the CUDA cores."""
    if all(t.dtype == torch.bfloat16 for t in operands):
        return ROUTE_TENSOR_CORES
    return ROUTE_CUDA_CORES


def split_plan(m, n, k, tile):
    """How many parts the tensor-core route splits K into for an [m, n]
    output of BM x BN tiles and K steps of BK: enough that the blocks
    reach SPLIT_MIN_BLOCKS, each part a whole number of steps (the C
    launchers split the same way).  1 when the tiles alone suffice."""
    bm, bn, bk = tile
    tiles = -(-m // bm) * -(-n // bn)
    want = max(1, min(-(-SPLIT_MIN_BLOCKS // tiles), -(-k // bk)))
    depth = -(-(-(-k // want)) // bk) * bk
    return -(-k // depth)


def _partials(splits, rows, cols, device):
    """The fp32 partials' workspace [splits, rows, cols] of a split
    launch."""
    return torch.empty((splits, rows, cols), dtype=torch.float32,
                       device=device)


def _cp_async_operand(wrapper, t):
    """A bf16 left operand as the tensor-core route reads it: base and row
    pitch multiples of 16 bytes.  One that breaks the rule (a column block
    at an odd offset, an odd width) is copied once into a buffer whose rows
    are padded to the rule, and `wrapper.realigned` counts the copy; the
    kernel zero-fills past the true width.  Runs on tensors of any
    device."""
    rows, cols = t.shape
    pitch = t.stride(0) * t.element_size()
    pitch_ok = rows <= 1 or pitch % CP_ASYNC_BYTES == 0
    if t.data_ptr() % CP_ASYNC_BYTES == 0 and pitch_ok:
        return t
    step = CP_ASYNC_BYTES // t.element_size()
    buf = torch.empty((rows, -(-cols // step) * step), dtype=t.dtype,
                      device=t.device)
    view = buf[:, :cols]
    view.copy_(t)
    wrapper.realigned += 1
    return view


def _launch(name, wrapper, fn, *args):
    op_builder.check_launch(name, fn(*args))
    wrapper.launches += 1


# ---- kernel H: one ring step's tile, fp32 out ------------------------ #
def fcm_tile_ag_reference(x, q, s, bits, kc, n):
    """x [m, kc] @ deq(q, s) [kc, n] in fp32."""
    return x.to(torch.float32) @ _dequant_tile(q, s, kc, n, bits)


def fcm_tile_ag_cuda(x, q, s, bits, kc, n):
    """Kernel H, forward tile: x [m, kc] (bf16 / fp32; a column block is
    fine) @ the dequantized ring payload -> fp32 [m, n].  bf16 x takes the
    tensor cores (`fcm_route`), its columns copied first when they break
    the 16-byte rule (counted on `realigned`)."""
    name = "fcm_tile_ag"
    index = check_cuda(name, x, q, *(() if s is None else (s,)))
    _check_operand(name, "x", x, cols=kc)
    w, sc, mode, wcode, bs = _weight_args(name, q, s, kc, n, bits)
    m = x.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if out.numel():
        if fcm_route(x) == ROUTE_TENSOR_CORES:
            x = _cp_async_operand(fcm_tile_ag_cuda, x)
        _launch(name, fcm_tile_ag_cuda, op_builder.load().ds_fcm_tile_ag,
                x.data_ptr(), x.stride(0), kernel_dtype_code(x), w, sc, mode,
                wcode, bs, out.data_ptr(), m, kc, n, stream_handle(index))
    return out


fcm_tile_ag_cuda.launches = 0
fcm_tile_ag_cuda.realigned = 0


def fcm_tile_ag_t_reference(g, q, s, bits, kc, n):
    """g [m, n] @ deq(q, s)^T [n, kc] in fp32."""
    return g.to(torch.float32) @ _dequant_tile(q, s, kc, n, bits).t()


def fcm_tile_ag_t_cuda(g, q, s, bits, kc, n):
    """Kernel H, transposed tile of the dx backward: g [m, n] @ the
    dequantized payload's transpose -> fp32 [m, kc].  On the tensor-core
    route (bf16 g) K = n may be split over blocks (`split_plan`), the
    partials going to a workspace allocated here and summed in split order
    by the same launch."""
    name = "fcm_tile_ag_t"
    index = check_cuda(name, g, q, *(() if s is None else (s,)))
    _check_operand(name, "g", g, cols=n)
    w, sc, mode, wcode, bs = _weight_args(name, q, s, kc, n, bits)
    m = g.shape[0]
    out = torch.empty((m, kc), dtype=torch.float32, device=g.device)
    if out.numel():
        splits, work = 1, None
        if fcm_route(g) == ROUTE_TENSOR_CORES:
            g = _cp_async_operand(fcm_tile_ag_t_cuda, g)
            splits = split_plan(m, kc, n, AG_T_TILE)
            if splits > 1:
                work = _partials(splits, m, kc, g.device)
        _launch(name, fcm_tile_ag_t_cuda, op_builder.load().ds_fcm_tile_ag_t,
                g.data_ptr(), g.stride(0), kernel_dtype_code(g), w, sc, mode,
                wcode, bs, out.data_ptr(), m, kc, n,
                0 if work is None else work.data_ptr(), splits,
                stream_handle(index))
    return out


fcm_tile_ag_t_cuda.launches = 0
fcm_tile_ag_t_cuda.realigned = 0


def fcm_tile_rs_reference(a, b):
    """a [B, kc]^T @ b [B, n] in fp32."""
    return a.to(torch.float32).t() @ b.to(torch.float32)


def fcm_tile_rs_cuda(a, b):
    """Kernel H, producer tile of dW: a [B, kc]^T (a column block of lhs)
    @ b [B, n] -> fp32 [kc, n].  On the tensor-core route (bf16 a and b)
    K = B is split over blocks (`split_plan`) into a workspace allocated
    here, summed in split order by the same launch; with one part the
    product writes the tile itself."""
    name = "fcm_tile_rs"
    index = check_cuda(name, a, b)
    _check_operand(name, "a", a)
    _check_operand(name, "b", b, rows=a.shape[0])
    bdim, kc, n = a.shape[0], a.shape[1], b.shape[1]
    out = torch.empty((kc, n), dtype=torch.float32, device=a.device)
    if out.numel():
        splits, work = 1, None
        if fcm_route(a, b) == ROUTE_TENSOR_CORES:
            a = _cp_async_operand(fcm_tile_rs_cuda, a)
            b = _cp_async_operand(fcm_tile_rs_cuda, b)
            splits = split_plan(kc, n, bdim, RS_TILE)
            if splits > 1:
                work = _partials(splits, kc, n, a.device)
        _launch(name, fcm_tile_rs_cuda, op_builder.load().ds_fcm_tile_rs,
                a.data_ptr(), a.stride(0), kernel_dtype_code(a), b.data_ptr(),
                b.stride(0), kernel_dtype_code(b), out.data_ptr(), bdim, kc, n,
                0 if work is None else work.data_ptr(), splits,
                stream_handle(index))
    return out


fcm_tile_rs_cuda.launches = 0
fcm_tile_rs_cuda.realigned = 0


def _tile(cuda, reference, *args):
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    return cuda(*args) if use_kernel(*tensors) else reference(*args)


# ---- kernel I: one step of the fused all-gather-matmul --------------- #
def fcm_ag_step_reference(x, q, s, bits, kc, n, acc, out, first, last):
    """One forward ring step: the sum so far (nothing when `first`) plus
    x [m, kc] @ deq(q, s), kept in the fp32 accumulator or, when `last`,
    cast once into `out`."""
    total = x.to(torch.float32) @ _dequant_tile(q, s, kc, n, bits)
    if not first:
        total = acc + total
    if last:
        out.copy_(total.to(out.dtype))
    else:
        acc.copy_(total)


def fcm_ag_step_cuda(x, q, s, bits, kc, n, acc, out, first, last):
    """Kernel I, forward step: acc (+)= x [m, kc] @ deq(q, s) [kc, n] in
    the caller-held fp32 accumulator [m, n]; the last step writes the sum
    to `out` [m, n] in out's dtype instead."""
    name = "fcm_ag_step"
    tensors = [x, q] + ([] if s is None else [s]) \
        + ([] if acc is None else [acc]) + ([out] if last else [])
    index = check_cuda(name, *tensors)
    _check_operand(name, "x", x, cols=kc)
    w, sc, mode, wcode, bs = _weight_args(name, q, s, kc, n, bits)
    m = x.shape[0]
    if not (first and last):
        if acc is None or acc.dtype != torch.float32 or \
                tuple(acc.shape) != (m, n) or not acc.is_contiguous():
            raise ValueError(f"{name}: the accumulator must be contiguous "
                             f"fp32 [{m}, {n}]")
    if last and (tuple(out.shape) != (m, n) or not out.is_contiguous()):
        raise ValueError(f"{name}: `out` must be contiguous [{m}, {n}]")
    if m * n == 0:
        return
    if fcm_route(x) == ROUTE_TENSOR_CORES:
        x = _cp_async_operand(fcm_ag_step_cuda, x)
    _launch(name, fcm_ag_step_cuda, op_builder.load().ds_fcm_ag_step,
            x.data_ptr(), x.stride(0), kernel_dtype_code(x), w, sc, mode,
            wcode, bs, 0 if acc is None else acc.data_ptr(),
            out.data_ptr() if last else 0,
            kernel_dtype_code(out) if last else 0, int(not first), m, kc, n,
            stream_handle(index))


fcm_ag_step_cuda.launches = 0
fcm_ag_step_cuda.realigned = 0


def fcm_ag_step_t_reference(g, q, s, bits, kc, n, out_cols):
    """One transposed ring step: g [m, n] @ deq(q, s)^T written into the
    output's column block `out_cols` [m, kc]."""
    out_cols.copy_((g.to(torch.float32)
                    @ _dequant_tile(q, s, kc, n, bits).t()).to(out_cols.dtype))


def fcm_ag_step_t_cuda(g, q, s, bits, kc, n, out_cols):
    """Kernel I, transposed step of dx: g [m, n] @ deq(q, s)^T -> the
    column block `out_cols` [m, kc] (a view of dx at columns src * kc) in
    its dtype.  The blocks of the W steps are disjoint, so each is cast as
    it is written and no fp32 copy of dx is kept.  On the tensor-core route
    (bf16 g) K = n may be split over blocks (`split_plan`), the partials
    going to a workspace allocated here and summed in split order by the
    same launch."""
    name = "fcm_ag_step_t"
    index = check_cuda(name, g, q, out_cols, *(() if s is None else (s,)))
    _check_operand(name, "g", g, cols=n)
    _check_operand(name, "out_cols", out_cols, rows=g.shape[0], cols=kc)
    w, sc, mode, wcode, bs = _weight_args(name, q, s, kc, n, bits)
    if out_cols.numel() == 0:
        return
    m, splits, work = g.shape[0], 1, None
    if fcm_route(g) == ROUTE_TENSOR_CORES:
        g = _cp_async_operand(fcm_ag_step_t_cuda, g)
        splits = split_plan(m, kc, n, AG_T_TILE)
        if splits > 1:
            work = _partials(splits, m, kc, g.device)
    _launch(name, fcm_ag_step_t_cuda, op_builder.load().ds_fcm_ag_step_t,
            g.data_ptr(), g.stride(0), kernel_dtype_code(g), w, sc, mode,
            wcode, bs, out_cols.data_ptr(), out_cols.stride(0),
            kernel_dtype_code(out_cols), m, kc, n,
            0 if work is None else work.data_ptr(), splits,
            stream_handle(index))


fcm_ag_step_t_cuda.launches = 0
fcm_ag_step_t_cuda.realigned = 0


# ---- kernel J: the producer with the quantize epilogue, the collect -- #
RS_QMAX = 127.0
# widest quantization block the producer's epilogue owns whole: the width
# of its output tile (csrc/fcm_matmul_rs.cu kBN)
RS_TILE_COLS = 256


def quantize_tile_reference(comp, bs):
    """(q [nb, bs] int8, scale [1, nb] fp32, new_error like comp) of a
    compensated fp32 tile, as `_matmul_rs_tpu` quantizes it: blockwise
    amax / 127, round half to even, clip; new_error = comp - q * scale."""
    g = comp.reshape(-1, bs)
    amax = g.abs().amax(dim=-1)
    # a tensor divisor: a CUDA tensor over a Python scalar is multiplied by
    # the scalar's reciprocal, which is not the same quotient
    scale = torch.where(amax > 0, amax / torch.full_like(amax, RS_QMAX),
                        torch.ones_like(amax))
    qf = torch.clamp(torch.round(g / scale[:, None]), -RS_QMAX, RS_QMAX)
    new_error = comp - (qf * scale[:, None]).reshape(comp.shape)
    return qf.to(torch.int8), scale.reshape(1, -1), new_error


def fcm_rs_producer_reference(a, b, err, q_out, s_out, nerr, bs,
                              comp_out=None):
    """One destination's tile: a [B, kc]^T @ b [B, n] (+ err [kc, n]),
    quantized into q_out [nb, bs] / s_out [1, nb]; the residual into `nerr`
    [kc, n] when given."""
    comp = a.to(torch.float32).t() @ b.to(torch.float32)
    if err is not None:
        comp = comp + err
    q, scale, new_error = quantize_tile_reference(comp, bs)
    q_out.copy_(q)
    s_out.copy_(scale)
    if nerr is not None:
        nerr.copy_(new_error)
    if comp_out is not None:
        comp_out.copy_(comp)


def fcm_rs_producer_cuda(a, b, err, q_out, s_out, nerr, bs, comp_out=None):
    """Kernel J, producer: a [B, kc]^T (a column block of lhs) @ b [B, n],
    plus the error rows `err` [kc, n] fp32 (or None), quantized blockwise
    to int8 in the product's epilogue: q_out [nb, bs], s_out [1, nb], and
    the residual comp - q * scale into `nerr` [kc, n] (or None).
    `comp_out` [kc, n] fp32, when given, receives the compensated tile the
    kernel quantized.

    Tensor-core route (bf16 a and b): K = the rows of a and b is split
    over blocks (`split_plan`) into a workspace allocated here, and the
    same launch's second pass sums the partials in split order, adds the
    error rows and quantizes, for any block size.  CUDA-core route: the
    epilogue owns whole quantization blocks when they lie inside the output
    tile's rows (bs divides both n and the tile's 256 columns); otherwise
    the product writes the compensated tile to a workspace and a second
    launch quantizes it.  Every launch counts."""
    name = "fcm_rs_producer"
    given = [t for t in (err, nerr, comp_out) if t is not None]
    index = check_cuda(name, a, b, q_out, s_out, *given)
    _check_operand(name, "a", a)
    _check_operand(name, "b", b, rows=a.shape[0])
    kc, n = a.shape[1], b.shape[1]
    total = kc * n
    if total == 0:
        return
    if bs < 1 or total % bs:
        raise ValueError(f"{name}: block {bs} does not divide the tile's "
                         f"{total} elements")
    nb = total // bs
    if q_out.dtype != torch.int8 or q_out.numel() != total or \
            s_out.dtype != torch.float32 or s_out.numel() != nb or \
            not q_out.is_contiguous() or not s_out.is_contiguous():
        raise ValueError(f"{name}: q_out must be contiguous int8 [{nb}, {bs}] "
                         f"and s_out contiguous fp32 [1, {nb}]")
    for arg, t in (("err", err), ("nerr", nerr), ("comp_out", comp_out)):
        if t is not None and (t.dtype != torch.float32 or not t.is_contiguous()
                              or tuple(t.shape) != (kc, n)):
            raise ValueError(f"{name}: `{arg}` must be contiguous fp32 "
                             f"[{kc}, {n}]")
    lib = op_builder.load()
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    stream = stream_handle(index)
    bdim = a.shape[0]
    tensor_cores = fcm_route(a, b) == ROUTE_TENSOR_CORES
    if tensor_cores:
        a = _cp_async_operand(fcm_rs_producer_cuda, a)
        b = _cp_async_operand(fcm_rs_producer_cuda, b)
        splits = split_plan(kc, n, bdim, RS_TILE)
        # the second pass sums the partials into partial 0 and quantizes
        # from there, so J takes a workspace even when K is not split
        work = _partials(splits, kc, n, a.device)
        fused = True  # the second pass quantizes any block size
    else:
        splits, work = 0, None
        fused = n % bs == 0 and RS_TILE_COLS % bs == 0
        if not fused and comp_out is None:
            comp_out = torch.empty((kc, n), dtype=torch.float32,
                                   device=a.device)
    _launch(name, fcm_rs_producer_cuda, lib.ds_fcm_rs_producer,
            a.data_ptr(), a.stride(0), kernel_dtype_code(a), b.data_ptr(),
            b.stride(0), kernel_dtype_code(b), ptr(err), q_out.data_ptr(),
            s_out.data_ptr(), ptr(nerr), ptr(comp_out), bdim, kc, n, bs,
            int(fused), ptr(work), splits, stream)
    if not fused:
        _launch(name, fcm_rs_producer_cuda, lib.ds_fcm_rs_quantize,
                comp_out.data_ptr(), q_out.data_ptr(), s_out.data_ptr(),
                ptr(nerr), total, bs, stream)


fcm_rs_producer_cuda.launches = 0
fcm_rs_producer_cuda.realigned = 0


def fcm_rs_collect_reference(qtab, stab, kc, n):
    """The [W] source table dequantized and summed in shard-index order
    0, 1, ..., W - 1: qtab [W, nb, bs] int8, stab [W, 1, nb] fp32 ->
    fp32 [kc, n]."""
    world = qtab.shape[0]
    deq = qtab.to(torch.float32) * stab.reshape(world, -1, 1)
    return ordered_sum(deq.reshape(world, kc, n))


# kernel J's collect (csrc/fcm_matmul_rs.cu collect_kernel): threads a
# block, blocks an SM at most (the grid strides beyond), sources unrolled
# at most (a larger world loads them in groups of four)
COLLECT_THREADS = 128
COLLECT_BLOCKS_PER_SM = 128
COLLECT_MAX_UNROLLED = 8


class CollectPlan(NamedTuple):
    """The collect's launch: the elements a thread takes at once (a chunk:
    4, or 1 where the block size or the tables' alignment rule 4 out; one
    scale block), threads a block, blocks, and the sources it unrolls (W up
    to COLLECT_MAX_UNROLLED, else 0)."""
    width: int
    threads: int
    blocks: int
    unrolled: int


def collect_alignment(qtab_ptr, out_ptr):
    """The widest chunk the tables' addresses allow: 4 when out lies on 16
    bytes (one float4 store) and the q table on 4 (one 4-byte load), else
    1."""
    return 4 if out_ptr % 16 == 0 and qtab_ptr % 4 == 0 else 1


def collect_plan(world, total, bs, alignment=4) -> CollectPlan:
    """ds_fcm_rs_collect_plan in Python: chunks of 4 where bs and
    `alignment` (collect_alignment) allow, else 1, one chunk a thread, the
    grid capped at COLLECT_BLOCKS_PER_SM blocks an SM."""
    width = 4 if bs % 4 == 0 and alignment % 4 == 0 else 1
    blocks = -(-(total // width) // COLLECT_THREADS)
    return CollectPlan(width, COLLECT_THREADS,
                       min(blocks, SM_COUNT * COLLECT_BLOCKS_PER_SM),
                       world if world <= COLLECT_MAX_UNROLLED else 0)


def fcm_rs_collect_cuda(qtab, stab, kc, n):
    """Kernel J, collect: dequantize the source table and add in
    shard-index order, starting from zero (launch: `collect_plan`)."""
    name = "fcm_rs_collect"
    index = check_cuda(name, qtab, stab)
    world, total = qtab.shape[0], kc * n
    out = torch.empty((kc, n), dtype=torch.float32, device=qtab.device)
    if total == 0:
        return out
    nb = stab.numel() // world
    if qtab.dtype != torch.int8 or stab.dtype != torch.float32 or \
            qtab.numel() != world * total or nb < 1 or total % nb or \
            stab.numel() != world * nb or not qtab.is_contiguous() or \
            not stab.is_contiguous():
        raise ValueError(f"{name}: expected contiguous int8 [W, nb, bs] and "
                         f"fp32 [W, 1, nb] tables of a [{kc}, {n}] tile, got "
                         f"{tuple(qtab.shape)} and {tuple(stab.shape)}")
    _launch(name, fcm_rs_collect_cuda, op_builder.load().ds_fcm_rs_collect,
            qtab.data_ptr(), stab.data_ptr(), out.data_ptr(), world, total,
            total // nb, stream_handle(index))
    return out


fcm_rs_collect_cuda.launches = 0


# --------------------------------------------------------------------- #
# layer 1: the two routes of the all-gather-matmul
# --------------------------------------------------------------------- #
def _quantize_shard(w_shard, bits, block):
    if not bits:
        return w_shard, None
    return blockwise_quantize(w_shard, dim=0, bits=bits, block=block)


def _quantize_shards(w_shards, bits, block, mesh):
    qs, ss = [], []
    for r in _ranks(mesh):
        with mesh.rank(r):
            q, s = _quantize_shard(w_shards[r], bits, block)
            qs.append(q.contiguous())
            ss.append(s)
    return qs, (ss if bits else None)


def _ag_matmul_per_tile(x, q, s, axis_name, bits, out_dtype, transpose, mesh):
    """Per-tile route: each hop's shard arrives by `permute`, one kernel-H
    launch per hop writes a fresh fp32 partial, and the partials are
    combined here, hops in program order."""
    world = mesh.axis_size(axis_name)
    kc = q[0].shape[0]
    n = _tile_n(q[0], kc, bits) if bits else q[0].shape[1]
    perm = [(i, (i - 1) % world) for i in range(world)]
    cq, cs = q, s
    acc = [None] * mesh.world_size
    for t in range(world):
        if t > 0:
            cq = mesh.permute(cq, axis_name, perm)
            if cs is not None:
                cs = mesh.permute(cs, axis_name, perm)
        for r in _ranks(mesh):
            src = (mesh.axis_index(r, axis_name) + t) % world
            sr = None if cs is None else cs[r]
            with mesh.rank(r):
                if transpose:
                    # dx backward: the OUTPUT's column block selects the source
                    part = _tile(fcm_tile_ag_t_cuda, fcm_tile_ag_t_reference,
                                 x[r], cq[r], sr, bits, kc, n)
                    if acc[r] is None:
                        acc[r] = torch.zeros((x[r].shape[0], kc * world),
                                             dtype=torch.float32,
                                             device=x[r].device)
                    acc[r][:, src * kc:(src + 1) * kc] = part
                else:
                    part = _tile(fcm_tile_ag_cuda, fcm_tile_ag_reference,
                                 x[r][:, src * kc:(src + 1) * kc], cq[r], sr,
                                 bits, kc, n)
                    acc[r] = part if acc[r] is None else acc[r] + part
    out = []
    for r in _ranks(mesh):
        with mesh.rank(r):
            out.append(acc[r].to(out_dtype))
    return out


def _ag_matmul_fused(x, q, s, axis_name, bits, out_dtype, transpose, mesh):
    """Fused route (`_ag_matmul_tpu`'s structure).  Every rank holds two
    slots (its own payload stands for slot 0 at step 0).  At step t kernel I
    multiplies slot t % 2 on the rank's compute stream while its copy
    stream forwards the same slot to the left neighbour's other slot; the
    steps are enqueued breadth first over the ranks.  A copy into a slot
    waits for the product that last read it and for the send that last
    left it; step t + 1's product waits for the copy's end.  Nothing
    synchronizes the host."""
    world = mesh.axis_size(axis_name)
    kc = q[0].shape[0]
    n = _tile_n(q[0], kc, bits) if bits else q[0].shape[1]
    qbuf, sbuf, acc, out, arrived = [], [], [], [], []
    for r in _ranks(mesh):
        m = x[r].shape[0]
        with mesh.rank(r):
            qbuf.append(torch.empty((2,) + tuple(q[r].shape),
                                    dtype=q[r].dtype, device=q[r].device))
            sbuf.append(None if s is None else torch.empty(
                (2,) + tuple(s[r].shape), dtype=s[r].dtype,
                device=s[r].device))
            acc.append(None if transpose or world == 1 else torch.empty(
                (m, n), dtype=torch.float32, device=x[r].device))
            out.append(torch.empty((m, kc * world if transpose else n),
                                   dtype=out_dtype, device=x[r].device))
        arrived.append(mesh.record(r))  # the own payload is quantized

    def held(r, t):
        """The payload rank r reads at step t: its own at step 0 (which
        stands for slot 0, so nothing is staged), then slot t % 2."""
        if t == 0:
            return q[r], None if s is None else s[r]
        return qbuf[r][t % 2], None if s is None else sbuf[r][t % 2]

    none = [None] * mesh.world_size
    read, sent = list(none), list(none)  # the previous step's events
    for t in range(world):
        slot, nxt = t % 2, (t + 1) % 2
        landing, sending, reading = list(none), list(none), list(none)
        for r in _ranks(mesh):
            my = mesh.axis_index(r, axis_name)
            src = (my + t) % world
            qr, sr = held(r, t)
            _log("product", t, r, slot, src)
            with mesh.rank(r, wait=(arrived[r],)):
                if transpose:
                    _tile(fcm_ag_step_t_cuda, fcm_ag_step_t_reference, x[r],
                          qr, sr, bits, kc, n,
                          out[r][:, src * kc:(src + 1) * kc])
                else:
                    _tile(fcm_ag_step_cuda, fcm_ag_step_reference,
                          x[r][:, src * kc:(src + 1) * kc], qr, sr, bits, kc,
                          n, acc[r], out[r], t == 0, t == world - 1)
            reading[r] = mesh.record(r)
            if t == world - 1:
                continue
            # the send is enqueued right behind the product that reads the
            # same slot, so that it runs under it even when the host, not
            # the card, sets the pace
            left = mesh.peer(r, axis_name, my - 1)
            pairs = [(qr, qbuf[left][nxt])]
            if sr is not None:
                pairs.append((sr, sbuf[left][nxt]))
            _log("copy", t, r, slot, left, nxt)
            sending[r] = landing[left] = mesh.copy(
                r, pairs, wait=(arrived[r], read[left], sent[left]))
        if t < world - 1:
            arrived, sent, read = landing, sending, reading
    for r in _ranks(mesh):  # drain the last sends before the slots go
        with mesh.rank(r, wait=(sent[r],)):
            pass
    return out


def _ag_matmul(x, q, s, axis_name, bits, out_dtype, transpose, per_tile,
               mesh):
    route = _ag_matmul_per_tile if per_tile else \
        _ag_matmul_fused
    return route(x, q, s, axis_name, bits, out_dtype, transpose, mesh)


def _check_ag_shapes(x, w_shard, axis_name, mesh):
    world = mesh.axis_size(axis_name)
    for xr, wr in zip(x, w_shard):
        kc = wr.shape[0]
        if xr.dim() != 2 or wr.dim() != 2:
            raise ValueError("fused_allgather_matmul: x must be [M, K] and "
                             f"w_shard [K/W, N], got {tuple(xr.shape)} and "
                             f"{tuple(wr.shape)}")
        if xr.shape[-1] != kc * world:
            raise ValueError(
                f"fused_allgather_matmul: x has K={xr.shape[-1]} but the "
                f"gathered weight has {kc * world} rows "
                f"({kc} x {world} shards)")


class _FusedAllGatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis_name, qwz_bits, qgz_bits, block, per_tile,
                *tensors):
        world = mesh.world_size
        x, w_shard = list(tensors[:world]), list(tensors[world:])
        ctx.meta = (mesh, axis_name, qwz_bits, qgz_bits, block, per_tile)
        ctx.save_for_backward(*tensors)
        with _fcm_scope(), mesh.forked():
            q, s = _quantize_shards(w_shard, qwz_bits, block, mesh)
            return tuple(_ag_matmul(x, q, s, axis_name, qwz_bits, x[0].dtype,
                                    False, per_tile, mesh))

    @staticmethod
    def backward(ctx, *gs):
        mesh, axis_name, qwz_bits, qgz_bits, block, per_tile = ctx.meta
        world = mesh.world_size
        x = list(ctx.saved_tensors[:world])
        w_shard = list(ctx.saved_tensors[world:])
        gs = [g.contiguous() for g in gs]
        with _fcm_scope(), mesh.forked():
            q, s = _quantize_shards(w_shard, qwz_bits, block, mesh)
            dx = _ag_matmul(gs, q, s, axis_name, qwz_bits, x[0].dtype, True,
                            per_tile, mesh)
            dw, _ = _matmul_reduce_scatter(x, gs, None, axis_name, qgz_bits,
                                           block, per_tile, mesh)
            for r in _ranks(mesh):
                with mesh.rank(r):
                    dw[r] = dw[r].to(w_shard[r].dtype)
        return (None,) * 6 + tuple(dx) + tuple(dw)


def fused_allgather_matmul(x: List[torch.Tensor],
                           w_shard: List[torch.Tensor], axis_name,
                           qwz_bits=8, qgz_bits=0, block=DEFAULT_BLOCK,
                           per_tile: Optional[bool] = None, mesh=None):
    """`x @ all_gather(w_shard, axis=0)` per rank, with the qwZ
    dequant-all-gather fused into the GEMM's prologue.  `w_shard[r]` is
    rank r's [K/W, N] row shard, `x[r]` its [M, K] rows; returns the
    per-rank [M, N] products in x's dtype.

    Each shard is blockwise-quantized ONCE at its source; the ring then
    moves the int8 (or packed int4) payload and its fp32 scales tile by
    tile while the product of the tile that already arrived runs, the
    dequant folded into each tile's load.  Backward: dx re-rings the
    quantized shards (recomputed from `w_shard`) through the transposed
    tile product; dW takes `fused_matmul_reduce_scatter` with no error
    feedback and is the SUM over the ranks (straight-through quantizer:
    with qgz_bits=0 the dW wire is fp32).

    `per_tile=True` takes the per-tile route (one kernel-H launch per hop,
    partials combined by the caller); the default is the fused route."""
    mesh = resolve_mesh(mesh)
    mesh.check_ranked("fused_allgather_matmul", x)
    mesh.check_ranked("fused_allgather_matmul", w_shard)
    _check_ag_shapes(x, w_shard, axis_name, mesh)
    if qwz_bits:
        _check_bits(qwz_bits, "qwz_bits")
    return list(_FusedAllGatherMatmul.apply(
        mesh, axis_name, qwz_bits, qgz_bits, block, per_tile, *x, *w_shard))


# --------------------------------------------------------------------- #
# layer 1: the two routes of the matmul-reduce-scatter
# --------------------------------------------------------------------- #
def _matmul_rs_per_tile(lhs, rhs, error, axis_name, qgz_bits, block, mesh):
    """Per-tile route: kernel H's `a^T b` tile per destination, the error
    rows added, then the shared quantize -> scatter -> reduce pipeline."""
    world = mesh.axis_size(axis_name)
    k, n = lhs[0].shape[1], rhs[0].shape[1]
    kc = k // world
    track = error is not None
    dest_tab = []
    for r in _ranks(mesh):
        my = mesh.axis_index(r, axis_name)
        with mesh.rank(r):
            tiles = []
            for t in range(world):
                dst = (my + t) % world
                tile = _tile(fcm_tile_rs_cuda, fcm_tile_rs_reference,
                             lhs[r][:, dst * kc:(dst + 1) * kc], rhs[r])
                if track:
                    tile = tile + error[r][dst * kc:(dst + 1) * kc].to(
                        torch.float32)
                tiles.append(tile)
            # destination-order [W, kc, n] table (row t -> dst (my + t) % W),
            # rolled to destination-index order for the quantizer
            dest_tab.append(torch.roll(torch.stack(tiles, dim=0), my, dims=0))
    my_chunk, applied = _quantize_scatter_reduce(
        dest_tab, axis_name, qgz_bits, block, mesh,
        applied_dtype=torch.float32 if track else None)
    if not track:
        return my_chunk, None
    new_error = []
    for r in _ranks(mesh):
        with mesh.rank(r):
            new_error.append((dest_tab[r] - applied[r]).reshape(k, n).to(
                error[r].dtype))
    return my_chunk, new_error


def _matmul_rs_fused(lhs, rhs, error, axis_name, block, mesh):
    """Fused route, int8 (`_matmul_rs_tpu`'s structure).  Round t = 1..W - 1:
    every rank's producer launch computes the tile for destination
    (my + t) % W into one of two staging slots, and the rank's copy stream
    sends it into row `my` of the destination's source table as soon as it
    is done; a slot is produced into again only after its last send.  The
    own tile comes last, straight into the own table; then the collect
    launch waits for the W - 1 arrivals."""
    world = mesh.axis_size(axis_name)
    k, n = lhs[0].shape[1], rhs[0].shape[1]
    kc = k // world
    bs = largest_divisor_at_most(kc * n, block)
    nb = kc * n // bs
    track = error is not None
    qtab, stab, qstage, sstage, err_in, nerr = [], [], [], [], [], []
    for r in _ranks(mesh):
        dev = lhs[r].device
        with mesh.rank(r):
            qtab.append(torch.empty((world, nb, bs), dtype=torch.int8,
                                    device=dev))
            stab.append(torch.empty((world, 1, nb), dtype=torch.float32,
                                    device=dev))
            qstage.append(torch.empty((2, nb, bs), dtype=torch.int8,
                                      device=dev))
            sstage.append(torch.empty((2, 1, nb), dtype=torch.float32,
                                      device=dev))
            err_in.append(error[r].to(torch.float32).contiguous()
                          if track else None)
            nerr.append(torch.empty((k, n), dtype=torch.float32, device=dev)
                        if track else None)
    arrivals = [[] for _ in _ranks(mesh)]
    slot_sent = [[None, None] for _ in _ranks(mesh)]

    def produce(r, dst, q_out, s_out, wait=()):
        rows = slice(dst * kc, (dst + 1) * kc)
        with mesh.rank(r, wait=wait):
            _tile(fcm_rs_producer_cuda, fcm_rs_producer_reference,
                  lhs[r][:, rows], rhs[r],
                  err_in[r][rows] if track else None, q_out, s_out,
                  nerr[r][rows] if track else None, bs)
        return mesh.record(r)

    for t in range(1, world):
        slot = t % 2
        for r in _ranks(mesh):
            my = mesh.axis_index(r, axis_name)
            dst = (my + t) % world
            peer = mesh.peer(r, axis_name, dst)
            _log("produce", t, r, slot, dst)
            done = produce(r, dst, qstage[r][slot], sstage[r][slot],
                           wait=(slot_sent[r][slot],))
            # remote tables are indexed by SOURCE: my row is `my`
            _log("send", t, r, slot, peer, my)
            sent = mesh.copy(r, [(qstage[r][slot], qtab[peer][my]),
                                 (sstage[r][slot], stab[peer][my])],
                             wait=(done,))
            slot_sent[r][slot] = sent
            arrivals[peer].append(sent)
    chunks = []
    for r in _ranks(mesh):
        my = mesh.axis_index(r, axis_name)
        _log("produce", 0, r, None, my)
        produce(r, my, qtab[r][my], stab[r][my])
    for r in _ranks(mesh):
        _log("collect", world, r, None, None)
        with mesh.rank(r, wait=arrivals[r] + slot_sent[r]):
            chunks.append(_tile(fcm_rs_collect_cuda, fcm_rs_collect_reference,
                                qtab[r], stab[r], kc, n))
    if not track:
        return chunks, None
    new_error = []
    for r in _ranks(mesh):
        with mesh.rank(r):
            new_error.append(nerr[r].to(error[r].dtype))
    return chunks, new_error


def _matmul_reduce_scatter(lhs, rhs, error, axis_name, qgz_bits, block,
                           per_tile, mesh):
    if not per_tile and qgz_bits == 8:
        return _matmul_rs_fused(lhs, rhs, error, axis_name, block, mesh)
    return _matmul_rs_per_tile(lhs, rhs, error, axis_name, qgz_bits, block,
                               mesh)


def fused_matmul_reduce_scatter(lhs: List[torch.Tensor],
                                rhs: List[torch.Tensor],
                                error: Optional[List[torch.Tensor]],
                                axis_name, qgz_bits: int = 8,
                                block: int = DEFAULT_BLOCK,
                                per_tile: Optional[bool] = None, mesh=None):
    """`reduce_scatter(lhs^T @ rhs, dim=0)` per rank, with the qgZ
    transport fused into the producer GEMM's epilogue.  Returns
    (my_chunk, new_error), per-rank lists: `my_chunk[r]` is rank r's
    [K/W, N] fp32 row chunk of the summed gradient.

    The output tiles of dW = lhs^T @ rhs are computed per DESTINATION in
    ring order (distance-1 neighbour first); as each tile completes it is
    compensated with its `error` rows, blockwise-quantized and sent
    straight to its owner.  Receivers dequantize the full source table and
    reduce in shard-index order, with the error-feedback residual
    new_error = compensated - deq(quant(compensated)).  `error` may be None
    (no feedback; new_error is then None); qgz_bits=0 sends fp32 tiles.

    With qgz_bits=8 the default is the fused route (kernel J); other
    widths, and `per_tile=True`, compute each tile with kernel H and
    quantize with the plain blockwise quantizer."""
    mesh = resolve_mesh(mesh)
    mesh.check_ranked("fused_matmul_reduce_scatter", lhs)
    mesh.check_ranked("fused_matmul_reduce_scatter", rhs)
    if error is not None:
        mesh.check_ranked("fused_matmul_reduce_scatter", error)
    if qgz_bits:
        _check_bits(qgz_bits, "qgz_bits")
    world = mesh.axis_size(axis_name)
    k = lhs[0].shape[1]
    if k % world != 0:
        raise ValueError(
            f"fused_matmul_reduce_scatter: K={k} must be divisible by "
            f"the {axis_name!r} axis size {world}")
    with _fcm_scope(), mesh.forked():
        return _matmul_reduce_scatter(list(lhs), list(rhs), error, axis_name,
                                      qgz_bits, block, per_tile, mesh)
