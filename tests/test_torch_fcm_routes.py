"""Kernels H, I and J pick their route by the dtype of their left operands:
bf16 multiplies on the tensor cores (csrc/tile_mma.cuh), fp32 or a mixed
pair on the CUDA cores (csrc/tile_matmul.cuh).  The choice, the split of K
that fills the card where the output has few tiles (and its workspace), and
the copy-and-count of a left operand that breaks the 16-byte rule of the
tensor-core route's cp.async copies are plain Python, held here on CPU
tensors: the wrappers run up to the launch against a stand-in for the
kernel library that records what it is handed.

The bf16 route's arithmetic is emulated in plain PyTorch on the JAX
package's own payloads (`blockwise_quantize` of
deepspeed_tpu.runtime.comm.low_bandwidth, from a numpy seed): a bf16 x
times the dequantized tile split into bf16 halves hi + lo, summed in fp32,
matches JAX's `_dequant_tile` and fp32 product within 1e-5 relative, and a
single bf16 rounding of the tile does not.  The kernels themselves run only
on the card, where chip_smoke.py holds them against their plain twins."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import collective_matmul as jcm
from deepspeed_tpu.runtime.comm import low_bandwidth as jlb
from deepspeed_tpu_torch.ops import collective_matmul as cm
from deepspeed_tpu_torch.ops import op_builder, realign_counts
from deepspeed_tpu_torch.runtime.comm import low_bandwidth as lb

BF16, FP32 = torch.bfloat16, torch.float32


def _at(ptr, shape, strides, dtype):
    """The tensor of `shape` and element `strides` at CPU address ptr,
    sharing its memory (what a kernel reads there)."""
    extent = 1 + sum((n - 1) * st for n, st in zip(shape, strides))
    size = torch.empty((), dtype=dtype).element_size()
    raw = (ctypes.c_char * (extent * size)).from_address(ptr)
    return torch.frombuffer(raw, dtype=dtype).as_strided(shape, strides)


def _dtype(code):
    return BF16 if code == op_builder.DTYPE_BF16 else FP32


def _snapshot(ptr, rows, cols, ld, code):
    """A copy of the left operand the launch reads (the wrapper may free a
    realigned copy as soon as the launch is enqueued)."""
    return _at(ptr, (rows, cols), (ld, 1), _dtype(code)).clone()


class _Kernels:
    """Stand-in for the kernel library: records each launcher's arguments
    by name, and a copy of the left operand it reads, and returns
    success."""

    def __init__(self):
        self.calls = []

    def ds_fcm_ag_step(self, x, ldx, x_code, w, sc, mode, w_code, bs, acc,
                       out, out_code, read_acc, m, kc, n, stream):
        self.calls.append(dict(fn="ag_step", x=x, ldx=ldx, code=x_code,
                               m=m, kc=kc, n=n,
                               read=_snapshot(x, m, kc, ldx, x_code)))
        return 0

    def ds_fcm_ag_step_t(self, g, ldg, g_code, w, sc, mode, w_code, bs, out,
                         ld_out, out_code, m, kc, n, work, splits, stream):
        self.calls.append(dict(fn="ag_step_t", x=g, ldx=ldg, code=g_code,
                               m=m, kc=kc, n=n, work=work, splits=splits,
                               read=_snapshot(g, m, n, ldg, g_code)))
        return 0

    def ds_fcm_rs_producer(self, a, lda, a_code, b, ldb, b_code, err, q, s,
                           nerr, comp, bdim, kc, n, bs, fused, work, splits,
                           stream):
        self.calls.append(dict(fn="rs_producer", a=a, lda=lda, a_code=a_code,
                               b=b, ldb=ldb, b_code=b_code, comp=comp,
                               fused=fused, work=work, splits=splits,
                               read=_snapshot(a, bdim, kc, lda, a_code)))
        return 0

    def ds_fcm_tile_ag(self, x, ldx, x_code, w, sc, mode, w_code, bs, out, m,
                       kc, n, stream):
        self.calls.append(dict(fn="tile_ag", x=x, ldx=ldx, code=x_code, m=m,
                               kc=kc, n=n,
                               read=_snapshot(x, m, kc, ldx, x_code)))
        return 0

    def ds_fcm_tile_ag_t(self, g, ldg, g_code, w, sc, mode, w_code, bs, out,
                         m, kc, n, work, splits, stream):
        self.calls.append(dict(fn="tile_ag_t", x=g, ldx=ldg, code=g_code,
                               m=m, kc=kc, n=n, work=work, splits=splits,
                               read=_snapshot(g, m, n, ldg, g_code)))
        return 0

    def ds_fcm_tile_rs(self, a, lda, a_code, b, ldb, b_code, out, bdim, kc, n,
                       work, splits, stream):
        self.calls.append(dict(fn="tile_rs", a=a, lda=lda, a_code=a_code,
                               b=b, ldb=ldb, b_code=b_code, work=work,
                               splits=splits,
                               read=_snapshot(a, bdim, kc, lda, a_code)))
        return 0

    def ds_fcm_rs_quantize(self, comp, q, s, nerr, total, bs, stream):
        self.calls.append(dict(fn="rs_quantize", comp=comp))
        return 0


@pytest.fixture
def kernels(monkeypatch):
    """The wrappers of kernels H, I and J with CPU tensors taken as if they
    lay on the card; launches go to a _Kernels stand-in, and every
    workspace the wrappers allocate is recorded by shape."""
    lib = _Kernels()
    lib.partials = []
    monkeypatch.setattr(op_builder, "load", lambda: lib)
    monkeypatch.setattr(cm, "check_cuda", lambda name, *t: 0)
    monkeypatch.setattr(cm, "stream_handle", lambda index: 0)
    allocate = cm._partials

    def spy(*args):
        work = allocate(*args)
        lib.partials.append(tuple(work.shape))
        return work

    monkeypatch.setattr(cm, "_partials", spy)
    for w in (cm.fcm_tile_ag_cuda, cm.fcm_tile_ag_t_cuda, cm.fcm_tile_rs_cuda,
              cm.fcm_ag_step_cuda, cm.fcm_ag_step_t_cuda,
              cm.fcm_rs_producer_cuda):
        monkeypatch.setattr(w, "launches", 0)
        monkeypatch.setattr(w, "realigned", 0)
    yield lib


def _payload(kc, n, dtype=FP32, bits=8, seed=0):
    w = torch.from_numpy(np.random.RandomState(seed).randn(kc, n)
                         .astype(np.float32) / 8).to(dtype)
    q, s = cm._quantize_shard(w, bits, 64)
    return q.contiguous(), s


def _code(dtype):
    return op_builder.DTYPE_BF16 if dtype == BF16 else op_builder.DTYPE_FP32


# --------------------------------------------------------------------- #
# (a) route, split plan, realignment
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtypes,route", [
    ((BF16,), cm.ROUTE_TENSOR_CORES), ((FP32,), cm.ROUTE_CUDA_CORES),
    ((BF16, BF16), cm.ROUTE_TENSOR_CORES), ((BF16, FP32), cm.ROUTE_CUDA_CORES),
    ((FP32, BF16), cm.ROUTE_CUDA_CORES), ((FP32, FP32), cm.ROUTE_CUDA_CORES)])
def test_route_by_operand_dtypes(dtypes, route):
    """bf16 left operands take the tensor cores; fp32 or a mixed pair the
    CUDA cores."""
    assert cm.fcm_route(*(torch.empty(1, 1, dtype=d) for d in dtypes)) == route


@pytest.mark.parametrize("m,n,k,tile,splits", [
    # GPT-2 124M's tiles at W = 4, M = 2048 per rank: I transposed (dx
    # [2048, kc] over K = n) and J's producer ([kc, n] over K = 2048)
    (2048, 192, 3072, cm.AG_T_TILE, 3),   # c_fc
    (2048, 192, 2304, cm.AG_T_TILE, 3),   # c_attn
    (2048, 768, 768, cm.AG_T_TILE, 1),    # c_proj: 384 tiles fill the card
    (192, 3072, 2048, cm.RS_TILE, 4),
    (192, 2304, 2048, cm.RS_TILE, 5),
    (768, 768, 2048, cm.RS_TILE, 4),
    (64, 64, 40, cm.AG_T_TILE, 1)])       # K shorter than one step
def test_split_plan_fills_the_card(m, n, k, tile, splits):
    """The split makes at least SPLIT_MIN_BLOCKS blocks where K allows,
    each part a whole number of K steps, and no part empty."""
    got = cm.split_plan(m, n, k, tile)
    assert got == splits
    bm, bn, bk = tile
    depth = -(-(-(-k // got)) // bk) * bk
    assert -(-k // depth) == got and (got - 1) * depth < k
    tiles = -(-m // bm) * -(-n // bn)
    assert tiles * got >= cm.SPLIT_MIN_BLOCKS or got == -(-k // bk)


def _column_block(m, kc, dtype, offset):
    """x's column block [m, kc] at element `offset` of a [m, 4 kc] matrix."""
    x = torch.randn(m, 4 * kc + offset, generator=torch.Generator()
                    .manual_seed(kc)).to(dtype)
    return x[:, offset:offset + kc]


@pytest.mark.parametrize("dtype", [BF16, FP32])
def test_ag_step_hands_the_column_block_in_place(kernels, dtype):
    """An aligned column block of x goes to the launch as it lies (its
    pointer and pitch), with x's dtype code; nothing is copied."""
    kc, n = 32, 64
    x = _column_block(16, kc, dtype, offset=kc)
    q, s = _payload(kc, n)
    acc = torch.zeros(16, n)
    cm.fcm_ag_step_cuda(x, q, s, 8, kc, n, acc, None, True, False)
    call = kernels.calls[-1]
    assert (call["x"], call["ldx"], call["code"]) == (
        x.data_ptr(), x.stride(0), _code(dtype))
    assert cm.fcm_ag_step_cuda.realigned == 0
    assert cm.fcm_ag_step_cuda.launches == 1


@pytest.mark.parametrize("kind", ["ag_step", "ag_step_t", "rs_producer",
                                  "tile_ag", "tile_ag_t", "tile_rs"])
def test_a_misaligned_bf16_operand_is_copied_once_and_counted(kernels, kind):
    """A bf16 left operand off the 16-byte boundary (a column block one
    element in, an odd pitch) is copied into a buffer with a 16-byte base
    and pitch, the copy holds the same values, and the wrapper's
    `realigned` counts it; fp32 operands take the CUDA cores and are never
    copied."""
    kc, n, m = 24, 48, 16
    q, s = _payload(kc, n)
    x = _column_block(m, n if kind.endswith("ag_step_t") or kind == "tile_ag_t"
                      else kc, BF16, offset=1)
    assert x.data_ptr() % cm.CP_ASYNC_BYTES
    b = torch.randn(m, n).to(BF16)
    if kind == "ag_step":
        wrapper = cm.fcm_ag_step_cuda
        wrapper(x, q, s, 8, kc, n, torch.zeros(m, n), None, True, False)
        ptr, ld = "x", "ldx"
    elif kind == "ag_step_t":
        wrapper = cm.fcm_ag_step_t_cuda
        wrapper(x, q, s, 8, kc, n, torch.empty(m, kc, dtype=BF16))
        ptr, ld = "x", "ldx"
    elif kind in ("tile_ag", "tile_ag_t"):
        wrapper = getattr(cm, f"fcm_{kind}_cuda")
        wrapper(x, q, s, 8, kc, n)
        ptr, ld = "x", "ldx"
    elif kind == "tile_rs":
        wrapper = cm.fcm_tile_rs_cuda
        wrapper(x, b)
        ptr, ld = "a", "lda"
    else:
        wrapper = cm.fcm_rs_producer_cuda
        nb = kc * n // 16
        wrapper(x, b, None, torch.empty(nb, 16, dtype=torch.int8),
                torch.empty(1, nb), None, 16)
        ptr, ld = "a", "lda"
    call = kernels.calls[-1]
    assert call[ptr] != x.data_ptr()
    assert call[ptr] % cm.CP_ASYNC_BYTES == 0
    assert call[ld] * 2 % cm.CP_ASYNC_BYTES == 0 and call[ld] >= x.shape[1]
    assert torch.equal(call["read"], x)
    assert wrapper.realigned == 1 and wrapper.launches == 1
    assert sum(realign_counts().values()) == 1
    # the same values in fp32: no copy, the CUDA-core route
    before = len(kernels.calls)
    if kind == "ag_step":
        wrapper(x.float(), q, s, 8, kc, n, torch.zeros(m, n), None, True,
                False)
    elif kind == "ag_step_t":
        wrapper(x.float(), q, s, 8, kc, n, torch.empty(m, kc))
    elif kind in ("tile_ag", "tile_ag_t"):
        wrapper(x.float(), q, s, 8, kc, n)
    elif kind == "tile_rs":
        wrapper(x.float(), b.float())
    else:
        wrapper(x.float(), b.float(), None,
                torch.empty(nb, 16, dtype=torch.int8), torch.empty(1, nb),
                None, 16)
    assert kernels.calls[before]["read"].dtype == FP32
    assert torch.equal(kernels.calls[before]["read"], x.float())
    assert wrapper.realigned == 1


@pytest.mark.parametrize("kind", ["tile_ag", "tile_ag_t", "tile_rs"])
@pytest.mark.parametrize("left,other", [(BF16, BF16), (FP32, FP32),
                                        (BF16, FP32), (FP32, BF16)])
def test_tile_launches_take_the_route_by_operand_dtypes(kernels, kind, left,
                                                        other):
    """Kernel H routes as I and J do: bf16 x or g (whatever the payload's
    dtype), bf16 a and b, take the tensor cores, where the transposed and
    producer tiles split K by split_plan; fp32 or a mixed pair take the
    CUDA cores, with no split and no workspace.  Each launch passes its
    operands' dtype codes, and one launch is counted either way."""
    m, kc, n = 64, 32, 96
    q, s = _payload(kc, n, dtype=other, bits=0)
    wrapper = getattr(cm, f"fcm_{kind}_cuda")
    if kind == "tile_ag":
        x = torch.randn(m, kc).to(left)
        wrapper(x, q, s, 0, kc, n)
        route, plan = cm.fcm_route(x), None
    elif kind == "tile_ag_t":
        g = torch.randn(m, n).to(left)
        wrapper(g, q, s, 0, kc, n)
        route, plan = cm.fcm_route(g), cm.split_plan(m, kc, n, cm.AG_T_TILE)
    else:
        a, b = torch.randn(m, kc).to(left), torch.randn(m, n).to(other)
        wrapper(a, b)
        route, plan = cm.fcm_route(a, b), cm.split_plan(kc, n, m, cm.RS_TILE)
    tensor_cores = left == BF16 and (kind != "tile_rs" or other == BF16)
    assert route == (cm.ROUTE_TENSOR_CORES if tensor_cores
                     else cm.ROUTE_CUDA_CORES)
    call = kernels.calls[-1]
    if kind == "tile_rs":
        assert (call["a_code"], call["b_code"]) == (_code(left), _code(other))
    else:
        assert call["code"] == _code(left)
    if plan is not None:
        splits = plan if tensor_cores else 1
        assert call["splits"] == splits and (call["work"] != 0) == (splits > 1)
        assert len(kernels.partials) == int(splits > 1)
    assert wrapper.launches == 1 and wrapper.realigned == 0


@pytest.mark.parametrize("kind,splits,workspace", [
    ("tile_ag_t", 3, (3, 2048, 192)), ("tile_rs", 4, (4, 192, 3072))])
def test_tile_split_plan_at_the_c_fc_tile(kernels, kind, splits, workspace):
    """At GPT-2 124M's c_fc tile (m = 2048 rows per rank, kc = 192,
    n = 3072): bf16 g's transposed tile splits K = n in 3 ([3, 2048, 192]
    fp32 workspace) and the producer tile splits K = 2048 rows in 4
    ([4, 192, 3072]), each one counted launch; the forward tile (768
    output tiles) takes no workspace."""
    m, kc, n = 2048, 192, 3072
    q, s = _payload(kc, n, dtype=BF16, bits=8)
    if kind == "tile_ag_t":
        cm.fcm_tile_ag_t_cuda(torch.zeros(m, n, dtype=BF16), q, s, 8, kc, n)
        assert cm.split_plan(m, kc, n, cm.AG_T_TILE) == splits
    else:
        cm.fcm_tile_rs_cuda(torch.zeros(m, kc, dtype=BF16),
                            torch.zeros(m, n, dtype=BF16))
        assert cm.split_plan(kc, n, m, cm.RS_TILE) == splits
    call = kernels.calls[-1]
    assert call["splits"] == splits and call["work"] != 0
    assert kernels.partials == [workspace]
    assert getattr(cm, f"fcm_{kind}_cuda").launches == 1
    cm.fcm_tile_ag_cuda(torch.zeros(m, kc, dtype=BF16), q, s, 8, kc, n)
    assert kernels.partials == [workspace]


@pytest.mark.parametrize("dtype", [BF16, FP32])
def test_ag_step_t_splits_k_on_the_tensor_cores(kernels, dtype):
    """bf16 g: K = n is split by split_plan into a [splits, m, kc] fp32
    workspace handed to the launch, one launch counted; fp32 g: no split,
    no workspace."""
    m, kc, n = 128, 64, 512
    q, s = _payload(kc, n, bits=4)
    g = torch.randn(m, n).to(dtype)
    out = torch.empty(m, 4 * kc, dtype=dtype)[:, kc:2 * kc]
    cm.fcm_ag_step_t_cuda(g, q, s, 4, kc, n, out)
    call = kernels.calls[-1]
    if dtype == BF16:
        splits = cm.split_plan(m, kc, n, cm.AG_T_TILE)
        assert splits == 8
        assert call["splits"] == splits and call["work"] != 0
        assert kernels.partials == [(splits, m, kc)]
    else:
        assert call["splits"] == 1 and call["work"] == 0
        assert kernels.partials == []
    assert cm.fcm_ag_step_t_cuda.launches == 1


def test_ag_step_t_takes_no_workspace_where_the_tiles_fill_the_card(kernels):
    """c_proj's transposed step (dx block 768 wide): no split."""
    m, kc, n = 2048, 768, 64
    q, s = _payload(kc, n, dtype=BF16, bits=0)
    cm.fcm_ag_step_t_cuda(torch.zeros(m, n, dtype=BF16), q, s, 0, kc, n,
                          torch.empty(m, kc, dtype=BF16))
    assert kernels.calls[-1]["splits"] == 1
    assert kernels.calls[-1]["work"] == 0 and kernels.partials == []


@pytest.mark.parametrize("a_dtype,b_dtype,bs", [
    (BF16, BF16, 16), (BF16, BF16, 24), (FP32, FP32, 16), (BF16, FP32, 16),
    (FP32, FP32, 24)])
def test_rs_producer_route_split_and_quantize_pass(kernels, a_dtype,
                                                   b_dtype, bs):
    """bf16 a and b: one launch, K split into a [splits, kc, n] workspace
    (one even unsplit: the second pass quantizes from it), fused for any
    block size.  Otherwise the CUDA-core route as before: fused when bs
    divides n and 256, else a comp workspace and a second, counted,
    quantize launch."""
    bdim, kc, n = 256, 32, 96
    a = torch.randn(bdim, 4 * kc).to(a_dtype)[:, kc:2 * kc]
    b = torch.randn(bdim, n).to(b_dtype)
    nb = kc * n // bs
    cm.fcm_rs_producer_cuda(a, b, torch.zeros(kc, n),
                            torch.empty(nb, bs, dtype=torch.int8),
                            torch.empty(1, nb), torch.empty(kc, n), bs)
    call = kernels.calls[0]
    assert (call["a_code"], call["b_code"]) == (_code(a_dtype),
                                                _code(b_dtype))
    if a_dtype == b_dtype == BF16:
        splits = cm.split_plan(kc, n, bdim, cm.RS_TILE)
        assert call["splits"] == splits and call["fused"] == 1
        assert kernels.partials == [(splits, kc, n)]
        assert [c["fn"] for c in kernels.calls] == ["rs_producer"]
        assert cm.fcm_rs_producer_cuda.launches == 1
    else:
        fused = n % bs == 0 and cm.RS_TILE_COLS % bs == 0
        assert call["splits"] == 0 and call["work"] == 0
        assert call["fused"] == int(fused) and kernels.partials == []
        assert len(kernels.calls) == (1 if fused else 2)
        assert cm.fcm_rs_producer_cuda.launches == len(kernels.calls)
    assert cm.fcm_rs_producer_cuda.realigned == 0


# --------------------------------------------------------------------- #
# (b) the tensor-core route's arithmetic against the JAX package
# --------------------------------------------------------------------- #
def _hi_lo(w):
    """fp32 -> its two bf16 halves hi = bf16(w), lo = bf16(w - hi)."""
    hi = w.to(BF16)
    return hi, (w - hi.float()).to(BF16)


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# a reduced c_fc tile: c_fc's shard is [192, 3072] at W = 4; here [48, 768]
# (the same blocks of 256), 64 rows of x
M_RED, KC_RED, N_RED = 64, 48, 768


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("transposed", [False, True])
def test_hi_lo_split_keeps_the_fp32_dequant(bits, transposed):
    """bf16 x (or g) times hi + lo of the dequantized tile, each product in
    fp32 and both summed into one fp32 result (what the tensor cores do:
    a bf16 x bf16 product is exact in fp32), matches x @ _dequant_tile of
    the JAX package in fp32 within 1e-5 of max|ref|; one bf16 rounding of
    the tile misses that by far."""
    rs = np.random.RandomState(7 + bits)
    w = (rs.randn(KC_RED, N_RED) / 8).astype(np.float32)
    q, s = jlb.blockwise_quantize(jnp.asarray(w), dim=0, bits=bits,
                                  block=lb.DEFAULT_BLOCK)
    deq = jcm._dequant_tile(q, s, KC_RED, N_RED, bits)
    cols = N_RED if transposed else KC_RED
    x = jnp.asarray(rs.randn(M_RED, cols).astype(np.float32)).astype(
        jnp.bfloat16)
    hp = jax.lax.Precision.HIGHEST
    xf = x.astype(jnp.float32)
    ref = np.asarray(jnp.matmul(xf, deq.T if transposed else deq,
                                precision=hp))

    # the port's side: its own dequant of the same payload
    tq = torch.from_numpy(np.array(q))
    ts = torch.from_numpy(np.array(s))
    wt = cm._dequant_tile(tq, ts, KC_RED, N_RED, bits)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(deq))
    hi, lo = _hi_lo(wt)
    tx = torch.from_numpy(np.asarray(xf))
    assert torch.equal(tx.to(BF16).float(), tx)  # x is bf16-exact
    if transposed:
        hi, lo = hi.t(), lo.t()
    split = (tx @ hi.float() + tx @ lo.float()).numpy()
    single = (tx @ hi.float()).numpy()
    assert _rel(split, ref) <= 1e-5
    assert _rel(single, ref) > 1e-4
    # the halves reproduce w to ~2^-17 of itself
    err = (hi.float() + lo.float() - (wt.t() if transposed else wt)).abs()
    assert float(err.max()) <= 2 ** -16 * float(wt.abs().max())


# --------------------------------------------------------------------- #
# (c) kernel J's collect: its launch plan, emulated
# --------------------------------------------------------------------- #
def _collect_chunks(plan, total):
    """The chunks of the collect's grid-stride loop, as the kernel indexes
    them: thread t of block b takes chunk b * threads + t, then strides by
    blocks * threads; every visit in the order of (iteration, thread)."""
    chunks = total // plan.width
    stride = plan.blocks * plan.threads
    visits = np.arange(stride)[None, :] + stride * np.arange(
        -(-chunks // stride))[:, None]
    return visits[visits < chunks]


def _collect_sources(plan, world):
    """The source order of a chunk: all W unrolled, or groups of four."""
    if plan.unrolled:
        assert plan.unrolled == world
        return list(range(world))
    return [s0 + s for s0 in range(0, world, 4)
            for s in range(min(4, world - s0))]


def _emulate_collect(qtab, stab, world, total, bs, plan):
    """The kernel's arithmetic on the plan's chunks, in numpy fp32:
    ((0 + q0 * s0) + q1 * s1) + ..., one scale index a chunk."""
    q = qtab.reshape(world, total).numpy()
    sc = stab.reshape(world, -1).numpy()
    chunks = _collect_chunks(plan, total)
    elems = chunks[:, None] * plan.width + np.arange(plan.width)
    block = chunks // (bs // plan.width)
    acc = np.zeros(elems.shape, np.float32)
    for s in _collect_sources(plan, world):
        acc = acc + q[s][elems].astype(np.float32) * sc[s][block][:, None]
    out = np.empty(total, np.float32)
    out[elems] = acc
    return out


# the three FCM tiles at W = 4 (c_attn, c_fc, c_proj) and the odd tile of
# chip_smoke.py, each at the block sizes that divide it
COLLECT_CASES = [(kc, n, bs) for kc, n in ((192, 2304), (192, 3072),
                                           (768, 768), (33, 50))
                 for bs in (256, 165, 4, 16, 48) if (kc * n) % bs == 0]


@pytest.mark.parametrize("kc,n,bs", COLLECT_CASES)
def test_collect_plan_covers_every_element_once(kc, n, bs):
    """At W = 1-9 and both alignments, the chunks of `collect_plan` (4
    elements where bs % 4 == 0 and the tables allow 4-byte loads and
    16-byte stores, else 1) cover every element of the tile exactly once,
    each chunk inside one scale block; the grid is one chunk a thread up
    to 128 blocks an SM of the H100; W <= 8 unrolls its sources, W = 9
    takes them in groups of four, each source once, in order."""
    total = kc * n
    for alignment in (4, 1):
        width = 4 if bs % 4 == 0 and alignment == 4 else 1
        for world in range(1, 10):
            plan = cm.collect_plan(world, total, bs, alignment)
            assert plan.width == width and plan.threads == 128
            assert plan.blocks == min(-(-(total // width) // 128), 132 * 128)
            assert plan.unrolled == (world if world <= 8 else 0)
            assert _collect_sources(plan, world) == list(range(world))
        chunks = _collect_chunks(plan, total)
        elems = chunks[:, None] * width + np.arange(width)
        assert np.bincount(elems.ravel(), minlength=total).tolist() == \
            [1] * total
        first_block = elems[:, 0] // bs
        assert (elems // bs == first_block[:, None]).all()
        assert (chunks // (bs // width) == first_block).all()


def test_collect_plan_at_the_path_tile():
    """W = 4 tables of c_fc's [192, 3072] tile with blocks of 256: 147,456
    chunks of 4 elements, 1152 blocks of 128 threads, sources unrolled;
    the off-path [2048, 3072] tile takes 12,288 blocks; a tile past 128
    blocks an SM strides.  The alignment: 4-byte q table, 16-byte out."""
    assert cm.collect_plan(4, 192 * 3072, 256) == (4, 128, 1152, 4)
    assert cm.collect_plan(4, 2048 * 3072, 256) == (4, 128, 12288, 4)
    assert cm.collect_plan(2, 2 ** 24, 256).blocks == 132 * 128
    assert cm.collect_alignment(0x1000, 0x2000) == 4
    assert cm.collect_alignment(0x1004, 0x2000) == 4
    assert cm.collect_alignment(0x1002, 0x2000) == 1
    assert cm.collect_alignment(0x1000, 0x2008) == 1


@pytest.mark.parametrize("world", [1, 2, 4, 8, 9])
@pytest.mark.parametrize("kc,n,bs,offset", [
    (192, 3072, 256, 0), (192, 3072, 256, 4), (192, 3072, 256, 2),
    (192, 2304, 48, 1), (33, 50, 165, 0), (24, 64, 16, 0)])
def test_collect_kernel_emulated_on_its_plan_is_bitwise(monkeypatch, world,
                                                        kc, n, bs, offset):
    """The wrapper hands the launcher the q table as it lies (an offset of
    4 bytes keeps the 4-wide route, of 2 or 1 takes the scalar one; the
    plan comes from the pointers), and the kernel's arithmetic emulated on
    that plan's chunks equals fcm_rs_collect_reference (the ordered sum
    that equals the JAX op's collect) bitwise."""
    calls = []

    class Lib:
        def ds_fcm_rs_collect(self, q, s, out, w, total, bs_, stream):
            plan = cm.collect_plan(w, total, bs_,
                                   cm.collect_alignment(q, out))
            qv = _at(q, (w * total,), (1,), torch.int8)
            sv = _at(s, (w * (total // bs_),), (1,), FP32)
            _at(out, (total,), (1,), FP32).copy_(torch.from_numpy(
                _emulate_collect(qv, sv, w, total, bs_, plan)))
            calls.append(plan)
            return 0

    monkeypatch.setattr(op_builder, "load", lambda: Lib())
    monkeypatch.setattr(cm, "check_cuda", lambda name, *t: 0)
    monkeypatch.setattr(cm, "stream_handle", lambda index: 0)
    monkeypatch.setattr(cm.fcm_rs_collect_cuda, "launches", 0)
    total, nb = kc * n, kc * n // bs
    rs = np.random.RandomState(world + kc)
    buf = torch.from_numpy(rs.randint(-127, 128, world * total + 16)
                           .astype(np.int8))
    base = (-buf.data_ptr()) % 16
    qtab = buf[base + offset:base + offset + world * total].view(world, nb,
                                                                 bs)
    stab = torch.from_numpy((rs.rand(world, 1, nb) / 64).astype(np.float32))
    out = cm.fcm_rs_collect_cuda(qtab, stab, kc, n)
    assert cm.fcm_rs_collect_cuda.launches == 1
    assert calls[0].width == (4 if bs % 4 == 0 and offset % 4 == 0 else 1)
    assert torch.equal(out, cm.fcm_rs_collect_reference(qtab, stab, kc, n))
