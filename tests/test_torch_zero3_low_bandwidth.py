"""The low-bandwidth tier inside the port's ZeRO-3 stream (qwZ, qgZ, the
fused collective-matmul transports, hpZ's validation) against the JAX
engine and the JAX context's per-leaf wire decision, at the tiny GPT-2 of
tests/unit/test_zero3_streaming.py.  The port's ranks lie on the CPU."""

from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.config import ZeroLowBandwidthConfig as JaxLowBandwidth
from deepspeed_tpu.parallel import reset_mesh_context as jax_reset_mesh
from deepspeed_tpu.runtime.zero.stage3_streaming import \
    Zero3StreamContext as JaxStream
from deepspeed_tpu_torch.config import ZeroLowBandwidthConfig
from deepspeed_tpu_torch.parallel import initialize_mesh
from deepspeed_tpu_torch.runtime.zero.stage3_streaming import \
    Zero3StreamContext

from .test_torch_zero3 import (_zero_cfg, assert_params_close, jax_run,
                               port_engine, port_run)

QWZ_QGZ = {"qwz_bits": 8, "qgz_bits": 8}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's CPU work, as
    tests/test_torch_zero3.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_registries():
    dst.reset_mesh_context()
    jax_reset_mesh()
    yield
    dst.reset_mesh_context()
    jax_reset_mesh()


def _lb(fcm, **bits):
    return _zero_cfg("carried", {"low_bandwidth": dict(
        bits or QWZ_QGZ, fused_collective_matmul=fcm)})


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(side, fcm, bf16=False):
        key = (side, fcm, bf16)
        if key not in cache:
            fn = jax_run if side == "jax" else port_run
            cache[key] = fn(4, _lb(fcm), bf16)
        return cache[key]
    return get


@pytest.mark.parametrize("fcm", [False, True])
def test_quantized_stream_matches_jax(runs, fcm):
    """qwZ 8 / qgZ 8, carried, 4 layers in groups of 1, 3 steps in fp32,
    with the fused transports off and on: losses rtol 1e-5 and parameters
    rtol 1e-5 plus 1e-3 of each leaf's largest entry (the key bias left
    out), test_torch_zero3.py's fp32 rule.  Quantization leaves them
    there: a jitted JAX quantizer multiplies by the reciprocal of
    amax / qmax and moves about one scale in twenty by an ulp (ROADMAP.md
    C), which moves a dequantized weight by at most one ulp of its scale;
    the port divides, as the JAX ops do unjitted."""
    ref, ref_params, plan = runs("jax", fcm)
    out, params, eng = runs("port", fcm)
    assert eng._zero3_stream.fcm == fcm and plan.mode == "carried"
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    assert_params_close(params, ref_params, 1e-5, 1e-3)


def test_quantized_stream_bf16_matches_jax(runs):
    """The same in bf16 (2e-2 and 5e-2, the port's bf16 tolerance against
    the JAX engine), the fused transports on."""
    ref, ref_params, _ = runs("jax", True, True)
    out, params, _ = runs("port", True, True)
    np.testing.assert_allclose(out, ref, rtol=2e-2)
    assert_params_close(params, ref_params, 0.0, 5e-2)


@pytest.mark.parametrize("bf16", [False, True])
def test_fused_transports_are_bitwise_the_modular_ones(runs, bf16):
    """The port's fused transports move the modular ops' values tile by
    tile (tests/test_torch_collective_matmul.py): the two trajectories
    are equal bit for bit."""
    a, pa, _ = runs("port", False, bf16)
    b, pb, _ = runs("port", True, bf16)
    assert a == b
    for x, y in zip(jax.tree.leaves(pa), jax.tree.leaves(pb)):
        np.testing.assert_array_equal(x, y)


def test_quantized_wire_moves_the_trajectory():
    """qwZ changes the values the layers see (a quantized trajectory is
    not the dense one), and qgZ alone quantizes only the backward."""
    dense = port_run(4, _zero_cfg("carried"), False)[0]
    qwz = port_run(4, _lb(False, qwz_bits=8), False)[0]
    qgz = port_run(4, _lb(False, qgz_bits=8), False)[0]
    assert qwz[0] != dense[0]
    assert qgz[0] == dense[0] and qgz[1:] != dense[1:]


def test_leaf_wire_bits_match_the_jax_context():
    """_leaf_wire_bits over the JAX test's shapes and more, per direction,
    fp32 / bf16 / int leaves, with the tier off, at 8 and 4 bits."""
    jax_mesh = ds.initialize_mesh(data=4, devices=jax.devices()[:4])
    mesh = initialize_mesh(data=4, devices=["cpu"])
    shapes = [((1, 64, 256), 1), ((2, 128), 1), ((1, 128), 1),
              ((2, 32, 24), 2), ((2, 8, 96), 1), ((1, 3072), 1),
              ((2, 768, 576), 2), ((2, 192, 768), 1)]
    dtypes = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
              (jnp.int32, torch.int32)]
    for bits in ({"qwz_bits": 8, "qgz_bits": 8},
                 {"qwz_bits": 4, "qgz_bits": 4}, {"qgz_bits": 8}, None):
        jlbc = JaxLowBandwidth(**bits) if bits else None
        plbc = ZeroLowBandwidthConfig(**bits) if bits else None
        ref = JaxStream(jax_mesh, 10 ** 9, 0, low_bandwidth=jlbc)
        port = Zero3StreamContext(mesh, 10 ** 9, 0, low_bandwidth=plbc)
        for shape, dim in shapes:
            for jdt, pdt in dtypes:
                got = port._leaf_wire_bits(
                    SimpleNamespace(shape=shape, dtype=pdt), dim)
                assert got == ref._leaf_wire_bits(
                    jnp.zeros(shape, jdt), dim), (bits, shape, jdt)


@pytest.mark.parametrize("group", [1, 2, 3, 4, 8])
def test_hpz_group_size_is_validated_as_in_jax(group):
    """hpz_group_size on a data-only mesh of 4: 1 and 4 resolve (no
    secondary partition at either), any other size raises the JAX
    context's ValueError listing the valid sizes, at engine build."""
    jax_mesh = ds.initialize_mesh(data=4, devices=jax.devices()[:4])
    mesh = initialize_mesh(data=4, devices=["cpu"])
    try:
        ref = JaxStream(jax_mesh, 10 ** 9, 0,
                        low_bandwidth=JaxLowBandwidth(hpz_group_size=group))
    except ValueError as e:
        with pytest.raises(ValueError) as port:
            Zero3StreamContext(mesh, 10 ** 9, 0,
                               low_bandwidth=ZeroLowBandwidthConfig(
                                   hpz_group_size=group))
        assert str(port.value) == str(e) and "valid sizes" in str(e)
        dst.reset_mesh_context()
        with pytest.raises(ValueError, match="valid sizes"):
            port_engine(4, _zero_cfg("carried", {
                "low_bandwidth": {"hpz_group_size": group}}), False)
        return
    port = Zero3StreamContext(mesh, 10 ** 9, 0,
                              low_bandwidth=ZeroLowBandwidthConfig(
                                  hpz_group_size=group))
    assert port.param_manual == ref.param_manual == frozenset({"data"})
    dst.reset_mesh_context()
    eng = port_engine(4, _zero_cfg("carried", {
        "low_bandwidth": {"hpz_group_size": group}}), False)
    assert eng._zero3_stream.param_manual == frozenset({"data"})


def test_expert_axis_for_hpz_stays_refused():
    """A real secondary partition needs an expert axis, which the engine
    refuses naming A.10."""
    cfg_mesh = {"data": 2, "expert": 2}
    dst.reset_mesh_context()
    from deepspeed_tpu_torch.models import GPT2Config, GPT2Model
    conf = {"train_micro_batch_size_per_gpu": 2, "mesh": cfg_mesh,
            "zero_optimization": _zero_cfg("carried", {
                "low_bandwidth": {"hpz_group_size": 2}})}
    with pytest.raises(NotImplementedError, match="A.10"):
        dst.initialize(model=GPT2Model(GPT2Config(num_layers=2)),
                       config=conf, device="cpu")
