"""The fused collective-matmul of the PyTorch port
(deepspeed_tpu_torch.ops.collective_matmul) against the JAX package's
(deepspeed_tpu.ops.collective_matmul) on the same numpy inputs.

The JAX side runs under `jax.shard_map` on 4 (or 4 x 2) of the simulated
CPU devices with `interpret=True`, as tests/unit/test_collective_matmul.py
runs it; the port runs on a CPU mesh of the same shape through the kernels'
plain twins, per-rank values as lists, every rank with its own data.

Tolerances: the transports without a product (layer 2) are bitwise (`==`),
the JAX side run op by op (see test_torch_low_bandwidth.sm);
`fused_allgather_matmul` forward rtol = atol = 1e-5, dx 1e-4, dW 1e-3 (the
JAX test's own); a quantizer behind a product is not bitwise across
implementations (two fp32 products that differ in the last bit can flip a
round), so `fused_matmul_reduce_scatter` is held by the one-step rule:
elements that differ by more than 1e-4 relative (of the value, or of the
quantization step where the value is smaller, as an error residual is) are
at most 0.1% (at least one element) of the result and each differs by at
most the steps (scales) of the tiles summed into it."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from deepspeed_tpu.ops import activations as jact
from deepspeed_tpu.ops import collective_matmul as jcm
from deepspeed_tpu.runtime.comm import low_bandwidth as jlb
from deepspeed_tpu_torch import constants as C
from deepspeed_tpu_torch.models import ranked_from_stacked
from deepspeed_tpu_torch.ops import KERNELS, activations
from deepspeed_tpu_torch.ops import collective_matmul as cm
from deepspeed_tpu_torch.runtime.comm import low_bandwidth as lb

from .test_torch_low_bandwidth import (JDT, TDT, f32, jax_mesh, port_mesh,
                                       rows, sm, stacked)

W = 4


def ranked(x, mesh, dtype="float32", grad=False):
    out = ranked_from_stacked(x, mesh, TDT[dtype])
    return [t.requires_grad_() for t in out] if grad else out


# --------------------------------------------------------------------- #
# layer 2: transport drop-ins, bitwise
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qwz,qgz", [(8, 8), (8, 0), (4, 4), (0, 0)])
def test_fcm_all_gather_forward_bitwise(qwz, qgz, dtype):
    x = np.random.RandomState(qwz + qgz).randn(W, 2, 24).astype(np.float32)
    ref = sm(lambda a: jcm.fcm_all_gather(a, ("data",), 0, qwz, qgz, 16),
             jax_mesh(), P("data"), P("data"))(
        jnp.asarray(x.reshape(8, 24)).astype(JDT[dtype]))
    mesh = port_mesh(data=W)
    out = cm.fcm_all_gather(ranked(x, mesh, dtype), ("data",), 0, qwz, qgz,
                            16, mesh=mesh)
    assert out[0].dtype == TDT[dtype]
    assert (stacked(out) == rows(ref, W)).all()
    modular = lb.low_bandwidth_all_gather(ranked(x, mesh, dtype), ("data",),
                                          0, qwz, qgz, 16, mesh=mesh)
    assert (stacked(out) == stacked(modular)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qwz,qgz", [(8, 8), (4, 4)])
def test_fcm_all_gather_backward_bitwise(qwz, qgz, dtype):
    x = np.random.RandomState(qwz + 1).randn(W, 2, 24).astype(np.float32)

    def loss(a):
        y = jcm.fcm_all_gather(a, ("data",), 0, qwz, qgz, 16)
        return jnp.sum(y.astype(jnp.float32) ** 2)

    ref = sm(jax.grad(loss), jax_mesh(), P("data"), P("data"))(
        jnp.asarray(x.reshape(8, 24)).astype(JDT[dtype]))
    mesh = port_mesh(data=W)
    xs = ranked(x, mesh, dtype, grad=True)
    out = cm.fcm_all_gather(xs, ("data",), 0, qwz, qgz, 16, mesh=mesh)
    sum((o.float() ** 2).sum() for o in out).backward()
    assert xs[0].grad.dtype == TDT[dtype]
    assert (stacked([t.grad for t in xs]) == rows(ref, W)).all()


def test_fcm_all_gather_backward_f32_table():
    """qgz_bits=0: the transpose reduces through the per-tile fp32 table in
    shard-index order, bitwise the JAX package's; the modular psum_scatter
    leaves its order open (rtol 1e-6)."""
    x = np.random.RandomState(2).randn(W, 2, 24).astype(np.float32)

    def loss(a):
        return jnp.sum(jcm.fcm_all_gather(a, ("data",), 0, 8, 0, 16) ** 2)

    ref = sm(jax.grad(loss), jax_mesh(), P("data"), P("data"))(
        jnp.asarray(x.reshape(8, 24)))
    mesh = port_mesh(data=W)
    grads = {}
    for name, fn in (("fcm", cm.fcm_all_gather),
                     ("modular", lb.low_bandwidth_all_gather)):
        xs = ranked(x, mesh, grad=True)
        out = fn(xs, ("data",), 0, 8, 0, 16, mesh=mesh)
        sum((o ** 2).sum() for o in out).backward()
        grads[name] = stacked([t.grad for t in xs])
    assert (grads["fcm"] == rows(ref, W)).all()
    np.testing.assert_allclose(grads["fcm"], grads["modular"], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("bits", [8, 4, 0])
def test_fcm_reduce_scatter_bitwise(bits):
    x = np.random.RandomState(3 + bits).randn(W, 16, 8, 12).astype(np.float32)
    ref = sm(lambda a: jcm.fcm_reduce_scatter(a[0], ("data",), 0, bits=bits,
                                              block=16)[None],
             jax_mesh(), P("data"), P("data"))(jnp.asarray(x))
    mesh = port_mesh(data=W)
    out = cm.fcm_reduce_scatter(ranked(x, mesh), ("data",), 0, bits=bits,
                                block=16, mesh=mesh)
    assert (stacked(out) == f32(ref)).all()
    if bits:
        modular = lb.quantized_psum_scatter(ranked(x, mesh), ("data",), 0,
                                            bits=bits, block=16, mesh=mesh)
        assert (stacked(out) == stacked(modular)).all()
    else:
        modular = lb.f32_psum_scatter(ranked(x, mesh), ("data",), 0,
                                      mesh=mesh)
        np.testing.assert_allclose(stacked(out), stacked(modular), rtol=1e-6,
                                   atol=1e-6)


def test_fcm_multi_axis_gather_bitwise():
    """Nested per-axis rings (innermost first) give the joint tiled
    all_gather's axis-major order: rank-dependent data, 4 x 2 mesh."""
    x = np.random.RandomState(4).randn(8, 2, 6).astype(np.float32)
    axes = ("data", "expert")
    ref = sm(lambda a: jcm.fcm_all_gather(a, axes, 0, 8, 0, 8),
             jax_mesh((4, 2), axes), P(axes), P(axes))(
        jnp.asarray(x.reshape(16, 6)))
    mesh = port_mesh(data=4, expert=2)
    out = cm.fcm_all_gather(ranked(x, mesh), axes, 0, 8, 0, 8, mesh=mesh)
    assert (stacked(out) == rows(ref, 8)).all()
    modular = lb.low_bandwidth_all_gather(ranked(x, mesh), axes, 0, 8, 0, 8,
                                          mesh=mesh)
    assert (stacked(out) == stacked(modular)).all()
    native = cm.fcm_all_gather(ranked(x, mesh), axes, 0, 0, 0, 8, mesh=mesh)
    assert all((t.numpy() == x.reshape(16, 6)).all() for t in native)


def test_fcm_qgz_reduce_scatter_inner_six_steps():
    """Six carried steps at 4 bits: reduced chunks and error buffers equal
    the port's modular variant bitwise at every step and the JAX package's
    fused variant at the first two (op by op it is slow); the six-step mean
    converges (err6 < err1 / 2)."""
    signal = np.random.RandomState(5).randn(W, 16, 8).astype(np.float32)

    def one(a, e):
        r, ne = jcm.fcm_qgz_reduce_scatter_inner(a[0], e[0], "data", 0, 4, 8)
        return r[None], ne[None]

    run = sm(one, jax_mesh(), (P("data"), P("data")), (P("data"), P("data")))
    mesh = port_mesh(data=W)
    xs = ranked(signal, mesh)
    jerr = jnp.zeros_like(signal)
    ferr = merr = lb.init_error_feedback(xs)
    acc = None
    for step in range(6):
        fred, ferr = cm.fcm_qgz_reduce_scatter_inner(xs, ferr, "data", 0, 4,
                                                     8, mesh=mesh)
        mred, merr = lb.qgz_reduce_scatter_inner(xs, merr, "data", 0, 4, 8,
                                                 mesh=mesh)
        assert (stacked(fred) == stacked(mred)).all(), step
        assert (stacked(ferr) == stacked(merr)).all(), step
        if step < 2:
            jred, jerr = run(jnp.asarray(signal), jerr)
            assert (stacked(fred) == f32(jred)).all(), step
            assert (stacked(ferr) == f32(jerr)).all(), step
        acc = stacked(fred) if acc is None else acc + stacked(fred)
        if step == 0:
            first = stacked(fred)
    exact = signal.sum(0).reshape(W, 4, 8)
    err6 = np.abs(acc / 6 - exact).max()
    err1 = np.abs(first - exact).max()
    assert err6 < err1 / 2, (err6, err1)


# --------------------------------------------------------------------- #
# layer 1: the GEMM-fused ops
# --------------------------------------------------------------------- #
M, K, N = 8, 32, 16


def ag_inputs(seed, dtype="float32"):
    rng = np.random.RandomState(seed)
    x = rng.randn(W, M, K).astype(np.float32)
    w = (rng.randn(W, K // W, N) / 4).astype(np.float32)
    return x, w


@pytest.mark.parametrize("per_tile", [None, True], ids=["fused", "per_tile"])
@pytest.mark.parametrize("qwz", [8, 4, 0])
def test_fused_allgather_matmul_forward(qwz, per_tile):
    x, w = ag_inputs(6 + qwz)

    def fused(xr, wr):
        return jcm.fused_allgather_matmul(xr[0], wr[0], "data", qwz, 0, 8,
                                          True)[None]

    ref = sm(fused, jax_mesh(), (P("data"), P("data")), P("data"), jit=True)(
        jnp.asarray(x), jnp.asarray(w))
    mesh = port_mesh(data=W)
    out = cm.fused_allgather_matmul(ranked(x, mesh), ranked(w, mesh), "data",
                                    qwz, 0, 8, per_tile, mesh=mesh)
    np.testing.assert_allclose(stacked(out), f32(ref), rtol=1e-5, atol=1e-5)
    # and the plain statement of the function
    if qwz:
        wq = np.concatenate([f32(jlb.blockwise_dequantize(
            *jlb.blockwise_quantize(jnp.asarray(w[i]), dim=0, bits=qwz,
                                    block=8), w[i].shape, dim=0, bits=qwz))
            for i in range(W)])
    else:
        wq = w.reshape(K, N)
    np.testing.assert_allclose(stacked(out), x @ wq, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("per_tile", [None, True], ids=["fused", "per_tile"])
@pytest.mark.parametrize("qwz,qgz", [(8, 0), (8, 8), (4, 4), (0, 0)])
def test_fused_allgather_matmul_grads(qwz, qgz, per_tile):
    """dx (rtol = atol = 1e-4) and dW (1e-3; with qgZ on, the one-step rule)
    against the JAX package, every rank with its own rows of x, so dW is a
    sum of different tiles."""
    x, w = ag_inputs(8 + qwz + qgz)

    def loss(xr, wr):
        return jnp.sum(jcm.fused_allgather_matmul(
            xr[0], wr[0], "data", qwz, qgz, 8, True) ** 2)

    gx, gw = sm(jax.grad(loss, argnums=(0, 1)), jax_mesh(),
                (P("data"), P("data")), (P("data"), P("data")), jit=True)(
        jnp.asarray(x), jnp.asarray(w))
    mesh = port_mesh(data=W)
    xs, ws = ranked(x, mesh, grad=True), ranked(w, mesh, grad=True)
    out = cm.fused_allgather_matmul(xs, ws, "data", qwz, qgz, 8, per_tile,
                                    mesh=mesh)
    sum((o ** 2).sum() for o in out).backward()
    np.testing.assert_allclose(stacked([t.grad for t in xs]), f32(gx),
                               rtol=1e-4, atol=1e-4)
    dw = stacked([t.grad for t in ws])
    if qgz:
        # the W tiles summed into a chunk each move by at most one step
        tiles = np.stack([x[r].T @ (2 * stacked(out)[r]) for r in range(W)])
        assert_one_step(dw, f32(gw), chunk_steps(tiles, qgz, 8))
    else:
        np.testing.assert_allclose(dw, f32(gw), rtol=1e-3, atol=1e-3)


def chunk_steps(tiles, bits, block):
    """[W, kc, n] bound on how far a reduce-scattered chunk may move when a
    round flips: the sum over the W sources of the scale of the element's
    block, from the sources' exact [K, n] fp32 tiles."""
    world, k, n = tiles.shape
    kc = k // world
    steps = np.zeros((world, kc, n), np.float32)
    for src in range(world):
        tab = torch.from_numpy(tiles[src].reshape(world, kc, n))
        _, s = lb.blockwise_quantize(tab, dim=0, bits=bits, block=block)
        bs = kc * n // s.shape[1]
        steps += s.repeat_interleave(bs, dim=1).reshape(world, kc, n).numpy()
    return steps


def assert_one_step(got, ref, steps, rtol=1e-4, magnitude=None):
    """The one-step rule of the module docstring.  An error residual is a
    small difference of the product and its dequantized value, so it is
    held relative to the product, passed as `magnitude`."""
    diff = np.abs(got - ref)
    size = np.abs(ref if magnitude is None else magnitude)
    far = diff > rtol * np.maximum(size, steps)
    assert far.sum() <= max(1, 1e-3 * far.size), far.mean()
    assert (diff[far] <= steps[far] * (1 + 1e-3)).all(), \
        (diff[far] / steps[far]).max()


def rs_inputs(seed, b=16, n=12):
    rng = np.random.RandomState(seed)
    return (rng.randn(W, b, K).astype(np.float32),
            rng.randn(W, b, n).astype(np.float32))


@pytest.mark.parametrize("per_tile", [None, True], ids=["fused", "per_tile"])
@pytest.mark.parametrize("bits", [8, 4, 0])
def test_fused_matmul_reduce_scatter_six_steps(bits, per_tile):
    """The chunk and the carried error over six steps against the JAX
    package fed the same error buffers (so that a flipped round does not
    compound), by the one-step rule; at 0 bits rtol = atol = 1e-4 and the
    error stays zero; the six-step mean converges."""
    lhs, rhs = rs_inputs(10 + bits)
    n = rhs.shape[-1]

    def fused(a, b, e):
        c, ne = jcm.fused_matmul_reduce_scatter(a[0], b[0], e[0], "data",
                                                bits, 16, True)
        return c[None], ne[None]

    run = sm(fused, jax_mesh(), (P("data"),) * 3, (P("data"), P("data")),
             jit=True)
    mesh = port_mesh(data=W)
    tl, tr = ranked(lhs, mesh), ranked(rhs, mesh)
    err = np.zeros((W, K, n), np.float32)
    exact = np.einsum("rbk,rbn->kn", lhs, rhs).reshape(W, K // W, n)
    acc, first = 0, None
    for step in range(6):
        jc, jne = run(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(err))
        tc, tne = cm.fused_matmul_reduce_scatter(
            tl, tr, ranked(err, mesh), "data", bits, 16, per_tile, mesh=mesh)
        assert tc[0].dtype == torch.float32 and tuple(tc[0].shape) == (K // W, n)
        if bits:
            tiles = np.stack([lhs[r].T @ rhs[r] for r in range(W)]) + err
            steps = chunk_steps(tiles, bits, 16)
            assert_one_step(stacked(tc), f32(jc), steps)
            # a rank's new error moves by one step of its own tile
            own = np.stack([chunk_steps(tiles[r:r + 1].repeat(W, 0), bits,
                                        16).reshape(K, n) / W
                            for r in range(W)])
            assert_one_step(stacked(tne), f32(jne), own, magnitude=tiles)
        else:
            np.testing.assert_allclose(stacked(tc), f32(jc), rtol=1e-4,
                                       atol=1e-4)
            assert (stacked(tne) == 0).all()
        acc = acc + stacked(tc)
        first = stacked(tc) if first is None else first
        err = stacked(tne)
    if bits:
        err6 = np.abs(acc / 6 - exact).max()
        err1 = np.abs(first - exact).max()
        assert err6 < err1 / 2, (err6, err1)


@pytest.mark.parametrize("bits", [8, 4])
def test_fused_matmul_reduce_scatter_error_identity(bits):
    """new_error == compensated - deq(quant(compensated)) on the port's own
    tile, bitwise, on both routes; and both routes agree bitwise (on the
    CPU they multiply alike)."""
    lhs, rhs = rs_inputs(20 + bits)
    n = rhs.shape[-1]
    err = (np.random.RandomState(1).randn(W, K, n) * 0.1).astype(np.float32)
    mesh = port_mesh(data=W)
    out = {}
    for per_tile in (None, True):
        out[per_tile] = cm.fused_matmul_reduce_scatter(
            ranked(lhs, mesh), ranked(rhs, mesh), ranked(err, mesh), "data",
            bits, 16, per_tile, mesh=mesh)
        for r in range(W):
            comp = (torch.from_numpy(lhs[r]).t() @ torch.from_numpy(rhs[r])
                    + torch.from_numpy(err[r])).reshape(W, K // W, n)
            q, s = lb.blockwise_quantize(comp, dim=0, bits=bits, block=16)
            deq = lb.blockwise_dequantize(q, s, comp.shape, dim=0, bits=bits)
            assert (out[per_tile][1][r] == (comp - deq).reshape(K, n)).all()
    assert (stacked(out[None][0]) == stacked(out[True][0])).all()
    assert (stacked(out[None][1]) == stacked(out[True][1])).all()


def test_fused_matmul_reduce_scatter_no_error_tracking():
    lhs, rhs = rs_inputs(30)
    mesh = port_mesh(data=W)
    for per_tile in (None, True):
        chunk, new_error = cm.fused_matmul_reduce_scatter(
            ranked(lhs, mesh), ranked(rhs, mesh), None, "data", 8, 16,
            per_tile, mesh=mesh)
        assert new_error is None and len(chunk) == W


# --------------------------------------------------------------------- #
# the slice as a whole
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("per_tile", [None, True], ids=["fused", "per_tile"])
def test_mlp_slice_matches_jax(per_tile):
    """c_fc -> gelu -> c_proj through two fused_allgather_matmul calls on
    four ranks (hidden 32, qwz 8, qgz 0), loss = sum of squares, backward:
    loss rtol 1e-5, dx 1e-4, dW 1e-3 against the JAX composition."""
    hidden, rows_per_rank = 32, 8
    rng = np.random.RandomState(40)
    x = rng.randn(W, rows_per_rank, hidden).astype(np.float32)
    w_fc = (rng.randn(W, hidden // W, 4 * hidden) / 6).astype(np.float32)
    w_proj = (rng.randn(W, 4 * hidden // W, hidden) / 11).astype(np.float32)

    def loss(xr, fc, proj):
        h = jcm.fused_allgather_matmul(xr[0], fc[0], "data", 8, 0, 16, True)
        y = jcm.fused_allgather_matmul(jact.gelu(h), proj[0], "data", 8, 0,
                                       16, True)
        return jnp.sum(y ** 2)

    spec = (P("data"),) * 3
    jloss = sm(lambda *a: loss(*a)[None], jax_mesh(), spec, P("data"),
               jit=True)(*map(jnp.asarray, (x, w_fc, w_proj)))
    jgrads = sm(jax.grad(loss, argnums=(0, 1, 2)), jax_mesh(), spec, spec,
                jit=True)(*map(jnp.asarray, (x, w_fc, w_proj)))
    mesh = port_mesh(data=W)
    xs, fcs, projs = (ranked(a, mesh, grad=True) for a in (x, w_fc, w_proj))
    h = cm.fused_allgather_matmul(xs, fcs, "data", 8, 0, 16, per_tile,
                                  mesh=mesh)
    y = cm.fused_allgather_matmul([activations.gelu(t) for t in h], projs,
                                  "data", 8, 0, 16, per_tile, mesh=mesh)
    losses = [(t ** 2).sum() for t in y]
    sum(losses).backward()
    np.testing.assert_allclose(stacked(losses), f32(jloss), rtol=1e-5)
    for got, ref, tol in ((xs, jgrads[0], 1e-4), (fcs, jgrads[1], 1e-3),
                          (projs, jgrads[2], 1e-3)):
        np.testing.assert_allclose(stacked([t.grad for t in got]), f32(ref),
                                   rtol=tol, atol=tol)


# --------------------------------------------------------------------- #
# host glue without a card
# --------------------------------------------------------------------- #
def test_fused_allgather_schedule():
    """The fused route's ring on a CPU mesh: at step t every rank reads
    slot t % 2, which holds the shard of source (my + t) % W; its copy of
    step t leaves the same slot for the left neighbour's other slot and is
    enqueued right behind the product (so that it runs under it); the
    steps go breadth first over the ranks; the last step sends nothing."""
    x, w = ag_inputs(50)
    mesh = port_mesh(data=W)
    with cm.record_schedule() as sched:
        cm.fused_allgather_matmul(ranked(x, mesh), ranked(w, mesh), "data",
                                  8, 0, 8, mesh=mesh)
    expected = []
    for t in range(W):
        for r in range(W):
            expected.append(("product", t, r, t % 2, (r + t) % W))
            if t < W - 1:
                expected.append(("copy", t, r, t % 2, (r - 1) % W,
                                 (t + 1) % 2))
    assert sched == expected
    with cm.record_schedule() as sched:
        cm.fused_allgather_matmul(ranked(x, mesh), ranked(w, mesh), "data",
                                  8, 0, 8, True, mesh=mesh)
    assert sched == []  # the per-tile route keeps no slots


def test_fused_reduce_scatter_schedule():
    """Rounds 1..W-1 produce the tile for destination (my + t) % W into
    slot t % 2 and send it into row `my` of the destination's table; the
    own tile comes last; then every rank collects."""
    lhs, rhs = rs_inputs(51)
    mesh = port_mesh(data=W)
    with cm.record_schedule() as sched:
        cm.fused_matmul_reduce_scatter(ranked(lhs, mesh), ranked(rhs, mesh),
                                       None, "data", 8, 16, mesh=mesh)
    expected = []
    for t in range(1, W):
        for r in range(W):
            dst = (r + t) % W
            expected += [("produce", t, r, t % 2, dst),
                         ("send", t, r, t % 2, dst, r)]
    expected += [("produce", 0, r, None, r) for r in range(W)]
    expected += [("collect", W, r, None, None) for r in range(W)]
    assert sched == expected


def test_kernel_twins_agree_with_the_plain_statement():
    """Each kernel's plain twin against the function it stands for, int8,
    packed int4 and native payloads."""
    rng = np.random.RandomState(60)
    kc, n, m = 8, 16, 5
    w = torch.from_numpy((rng.randn(kc, n) / 4).astype(np.float32))
    x = torch.from_numpy(rng.randn(m, kc).astype(np.float32))
    g = torch.from_numpy(rng.randn(m, n).astype(np.float32))
    for bits in (8, 4, 0):
        q, s = cm._quantize_shard(w, bits, 8)
        deq = w if not bits else lb.blockwise_dequantize(q, s, w.shape,
                                                         bits=bits)
        if bits == 4:
            assert q.numel() * 2 == kc * n  # packed
        assert torch.equal(cm.fcm_tile_ag_reference(x, q, s, bits, kc, n),
                           x @ deq)
        assert torch.equal(cm.fcm_tile_ag_t_reference(g, q, s, bits, kc, n),
                           g @ deq.t())
        acc = torch.ones(m, n)
        out = torch.empty(m, n, dtype=torch.bfloat16)
        cm.fcm_ag_step_reference(x, q, s, bits, kc, n, acc, out, False, False)
        assert torch.equal(acc, 1 + x @ deq)
        cm.fcm_ag_step_reference(x, q, s, bits, kc, n, acc, out, False, True)
        assert torch.equal(out, (1 + x @ deq + x @ deq).to(torch.bfloat16))
        dx = torch.zeros(m, 3 * kc)
        cm.fcm_ag_step_t_reference(g, q, s, bits, kc, n, dx[:, kc:2 * kc])
        assert torch.equal(dx[:, kc:2 * kc], g @ deq.t())
        assert (dx[:, :kc] == 0).all() and (dx[:, 2 * kc:] == 0).all()
    a = torch.from_numpy(rng.randn(6, kc).astype(np.float32))
    b = torch.from_numpy(rng.randn(6, n).astype(np.float32))
    assert torch.equal(cm.fcm_tile_rs_reference(a, b), a.t() @ b)
    # an odd 4-bit remainder keeps the 8-bit layout
    q, s = cm._quantize_shard(torch.randn(3, 7), 4, 16)
    assert q.numel() == 21
    assert tuple(cm._dequant_tile(q, s, 3, 7, 4).shape) == (3, 7)


def test_refusals_keep_their_words():
    mesh = port_mesh(data=W)
    with pytest.raises(ValueError, match=r"fused_allgather_matmul: x has "
                       r"K=30 but the gathered weight has 32 rows \(8 x 4 "
                       r"shards\)"):
        cm.fused_allgather_matmul([torch.zeros(2, 30)] * W,
                                  [torch.zeros(8, 4)] * W, "data", mesh=mesh)
    with pytest.raises(ValueError, match=r"fused_matmul_reduce_scatter: "
                       r"K=30 must be divisible by the 'data' axis size 4"):
        cm.fused_matmul_reduce_scatter([torch.zeros(2, 30)] * W,
                                       [torch.zeros(2, 4)] * W, None, "data",
                                       mesh=mesh)
    with pytest.raises(ValueError, match=r"fused reduce-scatter: dim 0 "
                       r"\(size 6\) must be divisible by the 'data' axis "
                       r"size 4"):
        cm.fcm_reduce_scatter([torch.zeros(6, 4)] * W, ("data",), 0, bits=8,
                              mesh=mesh)
    with pytest.raises(ValueError, match=r"fused qgz reduce-scatter: dim 0 "
                       r"\(size 6\) must be divisible"):
        cm.fcm_qgz_reduce_scatter_inner([torch.zeros(6, 4)] * W,
                                        [torch.zeros(6, 4)] * W, "data",
                                        mesh=mesh)
    for call in (
            lambda: cm.fcm_qgz_reduce_scatter_inner(
                [torch.zeros(8, 4)] * W, [torch.zeros(8, 4)] * W, "data",
                bits=3, mesh=mesh),
            lambda: cm.fused_allgather_matmul(
                [torch.zeros(2, 32)] * W, [torch.zeros(8, 4)] * W, "data", 5,
                mesh=mesh),
            lambda: cm.fused_matmul_reduce_scatter(
                [torch.zeros(2, 32)] * W, [torch.zeros(2, 4)] * W, None,
                "data", 2, mesh=mesh)):
        with pytest.raises(ValueError, match="unsupported — use 4 or 8"):
            call()
    with pytest.raises(ValueError, match="one value per rank"):
        cm.fused_allgather_matmul([torch.zeros(2, 32)] * 3,
                                  [torch.zeros(8, 4)] * W, "data", mesh=mesh)


def test_scope_marker_and_kernel_rows():
    assert cm.FCM_SCOPE == C.FCM_SCOPE == jcm.FCM_SCOPE
    names = {k.name: k for k in KERNELS}
    for name, line in (("fcm_tile_ag", 398), ("fcm_tile_ag_t", 398),
                       ("fcm_tile_rs", 398), ("fcm_ag_step", 587),
                       ("fcm_ag_step_t", 587), ("fcm_rs_producer", 692),
                       ("fcm_rs_collect", 692)):
        assert names[name].replaces == \
            f"deepspeed_tpu/ops/collective_matmul.py:{line}"
    # the transports show in a profile under the scope marker
    mesh = port_mesh(data=W)
    x = np.random.RandomState(0).randn(W, 2, 8).astype(np.float32)
    with torch.profiler.profile() as prof:
        cm.fcm_all_gather(ranked(x, mesh), ("data",), 0, 8, 0, 8, mesh=mesh)
    assert any(e.name == C.FCM_SCOPE for e in prof.events())
