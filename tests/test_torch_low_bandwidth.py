"""The low-bandwidth collectives of the PyTorch port
(deepspeed_tpu_torch.runtime.comm.low_bandwidth) against the JAX package's
(deepspeed_tpu.runtime.comm.low_bandwidth) on the same numpy inputs.  The
JAX side runs under `jax.shard_map` on 4 (or 4 x 2, or 8) of the simulated
CPU devices; the port on a CPU mesh of the same shape, per-rank values as
lists.  Everything here is plain tensor code on both sides, so every
comparison is bitwise (`==`) unless it says otherwise; for those the JAX
side runs op by op (shard_map without jit, see `sm`)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, PartitionSpec as P

from deepspeed_tpu.runtime.comm import low_bandwidth as jlb
from deepspeed_tpu_torch.models import ranked_from_stacked, stacked_from_ranked
from deepspeed_tpu_torch.ops.quant import matmul_maybe_int8
from deepspeed_tpu_torch.parallel import (MeshContext, get_mesh_context,
                                          initialize_mesh, reset_mesh_context)
from deepspeed_tpu_torch.runtime.comm import low_bandwidth as lb

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def jax_mesh(shape=(4,), names=("data",)):
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, names)


def port_mesh(**axes):
    return MeshContext.create(**{"data": 1, **axes}, devices=["cpu"])


def sm(f, mesh, in_specs, out_specs, jit=False):
    """`f` under shard_map.  Not jitted by default: the bitwise comparisons
    hold the port to the program as written, run op by op.  Under
    `jax.jit`, XLA's CPU compiler rewrites the quantizer's `amax / qmax`
    into a multiplication by the constant's reciprocal, which moves about
    one scale in twenty by one ulp (test_jitted_quantizer_differs_by_an_ulp
    pins that)."""
    fn = jax.shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                       check_vma=False)
    return jax.jit(fn) if jit else fn


def f32(a):
    """A JAX array as float32 numpy (bfloat16 values are kept exactly)."""
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else np.asarray(a)


def stacked(tensors):
    return stacked_from_ranked(tensors)


def rows(a, world):
    """A JAX result gathered along dim 0 over `world` ranks, as the
    [world, ...] stack of per-rank values."""
    a = f32(a)
    return a.reshape((world, a.shape[0] // world) + a.shape[1:])


# --------------------------------------------------------------------- #
# blockwise quantization
# --------------------------------------------------------------------- #
QUANT_CASES = [((8,), 0, 16), ((3, 7), 0, 16), ((2, 5, 9), 0, 16),
               ((4, 96), 0, 32), ((8, 24), 0, 16), ((6, 10), 1, 4),
               ((2, 5, 9), 2, 256), ((4, 8), 0, 256)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape,dim,block", QUANT_CASES)
def test_blockwise_quantize_dequantize_bitwise(shape, dim, block, bits, dtype):
    x = np.random.RandomState(sum(shape) + bits).randn(*shape).astype(
        np.float32)
    jx = jnp.asarray(x).astype(JDT[dtype])
    tx = torch.from_numpy(x).to(TDT[dtype])
    jq, js = jlb.blockwise_quantize(jx, dim=dim, bits=bits, block=block)
    tq, ts = lb.blockwise_quantize(tx, dim=dim, bits=bits, block=block)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(tq.shape) == jq.shape and tuple(ts.shape) == js.shape
    assert (tq.numpy() == np.asarray(jq)).all()
    assert (ts.numpy() == np.asarray(js)).all()
    jy = jlb.blockwise_dequantize(jq, js, shape, dim=dim, dtype=JDT[dtype],
                                  bits=bits)
    ty = lb.blockwise_dequantize(tq, ts, shape, dim=dim, dtype=TDT[dtype],
                                 bits=bits)
    assert ty.dtype == TDT[dtype] and tuple(ty.shape) == shape
    assert (ty.float().numpy() == f32(jy)).all()


def test_jitted_quantizer_differs_by_an_ulp():
    """Why the bitwise tests do not jit the JAX side: jitted, the scale is
    amax * (1 / qmax) and no longer the quotient the program states.  The
    port keeps the quotient; against the jitted function it agrees to one
    ulp of the scale (rtol 2e-7) and to one quantization step."""
    x = np.random.RandomState(8).randn(8, 24).astype(np.float32)
    jq, js = jax.jit(lambda a: jlb.blockwise_quantize(a, 0, 8, 16))(
        jnp.asarray(x))
    tq, ts = lb.blockwise_quantize(torch.from_numpy(x), 0, 8, 16)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2e-7, atol=0)
    assert np.abs(tq.numpy().astype(int) - np.asarray(jq).astype(int)).max() <= 1


def test_blockwise_zero_input_and_gathered_shape():
    z = torch.zeros(4, 8)
    q, s = lb.blockwise_quantize(z, dim=0, bits=8)
    assert (s == 1).all() and (q == 0).all()
    assert (lb.blockwise_dequantize(q, s, z.shape, dim=0) == 0).all()
    # a gathered multiple of the shard along dim
    x = torch.randn(2, 6)
    q, s = lb.blockwise_quantize(x, dim=0, bits=8, block=3)
    y = lb.blockwise_dequantize(torch.cat([q, q]), torch.cat([s, s]), (4, 6),
                                dim=0)
    assert (y[:2] == y[2:]).all()


def test_pack_unpack_int4_bitwise():
    q = np.random.RandomState(2).randint(-7, 8, size=(3, 5, 8)).astype(np.int8)
    jp = jlb.pack_int4(jnp.asarray(q))
    tp = lb.pack_int4(torch.from_numpy(q))
    assert tuple(tp.shape) == (3, 5, 4)
    assert (tp.numpy() == np.asarray(jp)).all()
    assert (lb.unpack_int4(tp).numpy() == q).all()
    assert (lb.unpack_int4(tp).numpy() == np.asarray(jlb.unpack_int4(jp))).all()


@pytest.mark.parametrize("shape,dim,dtype,bits", [
    ((1, 128), 1, "float32", 8), ((2, 128), 1, "float32", 8),
    ((2, 128), 1, "bfloat16", 8), ((256, 128), 1, "bfloat16", 8),
    ((1, 64, 256), 1, "float32", 8), ((128, 512), 0, "float32", 4),
    ((3, 7), 0, "float32", 4), ((16, 1), 0, "bfloat16", 4)])
def test_quantized_gather_saves_bytes(shape, dim, dtype, bits):
    assert lb.quantized_gather_saves_bytes(shape, dim, TDT[dtype], bits) == \
        jlb.quantized_gather_saves_bytes(shape, dim, JDT[dtype], bits)


def test_as_quantized_weight_feeds_the_dequant_matmul():
    """A gathered one-block-per-row payload IS ops/quant.py's per-row
    QuantizedWeight: matmul_maybe_int8 on it equals x @
    blockwise_dequantize(...) (fp32, atol = rtol = 1e-5), and both sides
    carry the JAX package's bits."""
    rng = np.random.RandomState(12)
    w = rng.randn(16, 48).astype(np.float32)
    x = rng.randn(5, 16).astype(np.float32)
    mesh = port_mesh(data=4)
    shards = ranked_from_stacked(w.reshape(4, 4, 48), mesh)
    qs, ss = zip(*(lb.blockwise_quantize(s, dim=0, bits=8, block=48)
                   for s in shards))
    q = mesh.all_gather(list(qs), "data", 0)[0]
    scale = mesh.all_gather(list(ss), "data", 0)[0]
    assert tuple(q.shape) == (16, 1, 48) and tuple(scale.shape) == (16, 1)
    qw = lb.as_quantized_weight(q, scale)
    jq, js = jlb.blockwise_quantize(jnp.asarray(w), dim=0, bits=8, block=48)
    jqw = jlb.as_quantized_weight(jq, js)
    assert (qw.qweight.numpy() == np.asarray(jqw.qweight)).all()
    assert (qw.scale.numpy() == np.asarray(jqw.scale)).all()
    out = matmul_maybe_int8(torch.from_numpy(x), qw)
    ref = torch.from_numpy(x) @ lb.blockwise_dequantize(q, scale, w.shape,
                                                        dim=0)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    q2, s2 = lb.blockwise_quantize(torch.from_numpy(w), dim=0, bits=8,
                                   block=16)
    with pytest.raises(ValueError, match="blockwise"):
        lb.as_quantized_weight(q2, s2)


# --------------------------------------------------------------------- #
# qwZ all-gather
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qwz", [8, 4, 0])
def test_low_bandwidth_all_gather_forward_bitwise(qwz, dtype):
    x = np.random.RandomState(qwz).randn(8, 24).astype(np.float32)
    ref = sm(lambda a: jlb.low_bandwidth_all_gather(a, ("data",), 0, qwz, 0,
                                                    16),
             jax_mesh(), P("data"), P("data"))(
        jnp.asarray(x).astype(JDT[dtype]))
    mesh = port_mesh(data=4)
    out = lb.low_bandwidth_all_gather(
        ranked_from_stacked(x.reshape(4, 2, 24), mesh, TDT[dtype]),
        ("data",), 0, qwz, 0, 16, mesh=mesh)
    assert out[0].dtype == TDT[dtype]
    assert (stacked(out) == rows(ref, 4)).all()


def test_low_bandwidth_all_gather_two_axes_bitwise():
    x = np.random.RandomState(4).randn(16, 6).astype(np.float32)
    spec = P(("data", "expert"))
    ref = sm(lambda a: jlb.low_bandwidth_all_gather(
        a, ("data", "expert"), 0, 8, 0, 8),
        jax_mesh((4, 2), ("data", "expert")), spec, spec)(jnp.asarray(x))
    mesh = port_mesh(data=4, expert=2)
    out = lb.low_bandwidth_all_gather(
        ranked_from_stacked(x.reshape(8, 2, 6), mesh), ("data", "expert"), 0,
        8, 0, 8, mesh=mesh)
    assert (stacked(out) == rows(ref, 8)).all()


@pytest.mark.parametrize("qgz", [8, 4, 0])
def test_low_bandwidth_all_gather_backward(qgz):
    """The transpose: the quantized reduce-scatter when qgZ is on (bitwise),
    the fp32 psum_scatter otherwise (XLA chooses its order: rtol 1e-6)."""
    x = np.random.RandomState(qgz + 1).randn(8, 24).astype(np.float32)

    def loss(a):
        y = jlb.low_bandwidth_all_gather(a, ("data",), 0, 8, qgz, 16)
        return jnp.sum(y.astype(jnp.float32) ** 2)

    ref = sm(jax.grad(loss), jax_mesh(), P("data"), P("data"))(jnp.asarray(x))
    mesh = port_mesh(data=4)
    xs = [t.requires_grad_() for t in
          ranked_from_stacked(x.reshape(4, 2, 24), mesh)]
    out = lb.low_bandwidth_all_gather(xs, ("data",), 0, 8, qgz, 16, mesh=mesh)
    sum((o.float() ** 2).sum() for o in out).backward()
    got = stacked([t.grad for t in xs])
    if qgz:
        assert (got == rows(ref, 4)).all()
    else:
        np.testing.assert_allclose(got, rows(ref, 4), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------- #
# qgZ reduce-scatter
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dim", [0, 1])
def test_quantized_psum_scatter_bitwise(bits, dim):
    x = np.random.RandomState(bits + dim).randn(4, 16, 8, 12).astype(
        np.float32)
    ref = sm(lambda a: jlb.quantized_psum_scatter(a[0], ("data",), dim,
                                                  bits=bits, block=16)[None],
             jax_mesh(), P("data"), P("data"))(jnp.asarray(x))
    mesh = port_mesh(data=4)
    out = lb.quantized_psum_scatter(ranked_from_stacked(x, mesh), ("data",),
                                    dim, bits=bits, block=16, mesh=mesh)
    assert (stacked(out) == f32(ref)).all()


def test_quantized_psum_scatter_two_axes_bitwise():
    x = np.random.RandomState(6).randn(8, 16, 24).astype(np.float32)
    axes = ("data", "expert")
    ref = sm(lambda a: jlb.quantized_psum_scatter(a[0], axes, 0, bits=8,
                                                  block=64)[None],
             jax_mesh((4, 2), axes), P(axes), P(axes))(jnp.asarray(x))
    mesh = port_mesh(data=4, expert=2)
    out = lb.quantized_psum_scatter(ranked_from_stacked(x, mesh), axes, 0,
                                    bits=8, block=64, mesh=mesh)
    assert (stacked(out) == f32(ref)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_f32_psum_scatter(dtype):
    """fp32 accumulation whatever the dtype; XLA chooses the order of its
    psum_scatter, so rtol 1e-6 in fp32 and one bf16 ulp in bf16."""
    x = np.random.RandomState(7).randn(4, 8, 6).astype(np.float32)
    ref = sm(lambda a: jlb.f32_psum_scatter(a[0], ("data",), 0)[None],
             jax_mesh(), P("data"), P("data"))(
        jnp.asarray(x).astype(JDT[dtype]))
    mesh = port_mesh(data=4)
    out = lb.f32_psum_scatter(ranked_from_stacked(x, mesh, TDT[dtype]),
                              ("data",), 0, mesh=mesh)
    assert out[0].dtype == TDT[dtype] and tuple(out[0].shape) == (2, 6)
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(stacked(out), f32(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("bits,steps", [(8, 6), (4, 3)])
def test_qgz_reduce_scatter_inner_six_steps_bitwise(bits, steps):
    """Reduced chunks AND the carried error buffers equal the JAX package's
    over six steps of a persistent signal (three at 4 bits, whose packing
    is slow op by op)."""
    signal = np.random.RandomState(5).randn(4, 16, 8).astype(np.float32)

    def one(a, e):
        r, ne = jlb.qgz_reduce_scatter_inner(a[0], e[0], "data", 0, bits, 8)
        return r[None], ne[None]

    run = sm(one, jax_mesh(), (P("data"), P("data")), (P("data"), P("data")))
    mesh = port_mesh(data=4)
    xs = ranked_from_stacked(signal, mesh)
    jerr = jnp.zeros_like(signal)
    terr = lb.init_error_feedback(xs)
    for step in range(steps):
        jred, jerr = run(jnp.asarray(signal), jerr)
        tred, terr = lb.qgz_reduce_scatter_inner(xs, terr, "data", 0, bits, 8,
                                                 mesh=mesh)
        assert (stacked(tred) == f32(jred)).all(), step
        assert (stacked(terr) == f32(jerr)).all(), step


def test_qgz_reduce_scatter_stacked_bitwise():
    import deepspeed_tpu as ds
    x = np.random.RandomState(8).randn(8, 16, 6).astype(np.float32)
    ds.reset_mesh_context()
    ds.initialize_mesh(data=-1)
    try:
        jred, jerr = jlb.qgz_reduce_scatter(
            jnp.asarray(x), jlb.init_error_feedback(jnp.asarray(x)), bits=8,
            block=48)
    finally:
        ds.reset_mesh_context()
    initialize_mesh(data=8, devices=["cpu"])
    try:
        assert get_mesh_context().world_size == 8
        tx = torch.from_numpy(x)
        tred, terr = lb.qgz_reduce_scatter(tx, lb.init_error_feedback(tx),
                                           bits=8, block=48)
    finally:
        reset_mesh_context()
    assert tuple(tred.shape) == (8, 2, 6) and tuple(terr.shape) == x.shape
    assert (tred.numpy() == f32(jred)).all()
    assert (terr.numpy() == f32(jerr)).all()


# --------------------------------------------------------------------- #
# refusals
# --------------------------------------------------------------------- #
def test_refusals_keep_their_words():
    mesh = port_mesh(data=4)
    with pytest.raises(ValueError, match="unsupported — use 4 or 8"):
        lb.blockwise_quantize(torch.zeros(4, 4), bits=3)
    with pytest.raises(ValueError, match="qgz_bits=2 unsupported"):
        lb.quantized_psum_scatter([torch.zeros(4, 4)] * 4, "data", 0, bits=2,
                                  mesh=mesh)
    with pytest.raises(ValueError, match=r"quantized reduce-scatter: dim 0 "
                       r"\(size 6\) must be divisible by the 'data' axis "
                       r"size 4"):
        lb.quantized_psum_scatter([torch.zeros(6, 4)] * 4, "data", 0,
                                  mesh=mesh)
    with pytest.raises(ValueError, match=r"qgz reduce-scatter: dim 0 "
                       r"\(size 6\) must be divisible"):
        lb.qgz_reduce_scatter_inner([torch.zeros(6, 4)] * 4,
                                    [torch.zeros(6, 4)] * 4, "data",
                                    mesh=mesh)
    with pytest.raises(ValueError, match="one value per rank"):
        lb.low_bandwidth_all_gather([torch.zeros(2, 2)] * 3, "data", 0,
                                    mesh=mesh)
    reset_mesh_context()
    with pytest.raises(RuntimeError, match="Mesh is not initialized"):
        lb.low_bandwidth_all_gather([torch.zeros(2, 2)] * 4, "data", 0)


def test_init_error_feedback_tree():
    tree = {"a": torch.ones(2, 3), "b": [torch.ones(4), (torch.ones(1),)]}
    zeros = lb.init_error_feedback(tree)
    assert (zeros["a"] == 0).all() and tuple(zeros["a"].shape) == (2, 3)
    assert isinstance(zeros["b"][1], tuple) and (zeros["b"][0] == 0).all()
