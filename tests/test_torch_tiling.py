"""TiledLinear in the port (runtime/zero/tiling.py) against the JAX module
(deepspeed_tpu/runtime/zero/tiling.py): `from_dense` in the JAX tile
order, the forward and the grads of the weight tiles, the bias and the
input in fp32, the specs, the layout of `__init__` and its errors, and
the recompute of each input tile's step in the backward."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.runtime.zero import TiledLinear

SHAPES = [(32, 48, 4, 2, True), (32, 48, 1, 1, True), (24, 36, 3, 4, False),
          (64, 16, 8, 1, True)]


def _case(in_f, out_f, bias, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((in_f, out_f)).astype(np.float32)
    b = rng.standard_normal(out_f).astype(np.float32) if bias else None
    x = rng.standard_normal((3, 5, in_f)).astype(np.float32)
    g = rng.standard_normal((3, 5, out_f)).astype(np.float32)
    return w, b, x, g


@pytest.mark.parametrize("in_f,out_f,ins,outs,bias", SHAPES)
def test_from_dense_takes_the_jax_tile_order(in_f, out_f, ins, outs, bias):
    """The tiles of a dense [in, out] weight and [out] bias, bit for bit
    the JAX module's `from_dense`; the layer's shapes its."""
    w, b, _, _ = _case(in_f, out_f, bias)
    ref_lin, ref = ds.zero.TiledLinear.from_dense(w, b, ins, outs)
    lin = TiledLinear.from_dense(w, b, ins, outs)
    assert (lin.tile_in, lin.tile_out) == (ref_lin.tile_in, ref_lin.tile_out)
    np.testing.assert_array_equal(lin.w.detach().numpy(), np.asarray(ref["w"]))
    if bias:
        np.testing.assert_array_equal(lin.b.detach().numpy(),
                                      np.asarray(ref["b"]))
    else:
        assert lin.b is None and "b" not in ref


@pytest.mark.parametrize("in_f,out_f,ins,outs,bias", SHAPES)
def test_forward_and_grads_match_the_jax_module(in_f, out_f, ins, outs,
                                                bias):
    """fp32: the output within 1e-5 of the JAX module's and of x @ W + b;
    the grads of the tiles, the bias and the input (the JAX module's
    jax.grad of <y, g>) within 1e-5."""
    w, b, x, g = _case(in_f, out_f, bias)
    ref_lin, ref = ds.zero.TiledLinear.from_dense(w, b, ins, outs)
    lin = TiledLinear.from_dense(w, b, ins, outs)
    xt = torch.from_numpy(x).requires_grad_()
    y = lin(xt)
    y.backward(torch.from_numpy(g))
    ref_y = np.asarray(ref_lin.apply(ref, jnp.asarray(x)))
    np.testing.assert_allclose(y.detach().numpy(), ref_y, rtol=1e-5,
                               atol=1e-5)
    dense = x @ w + (b if bias else 0.0)
    np.testing.assert_allclose(y.detach().numpy(), dense, rtol=1e-5,
                               atol=1e-5)
    grads = jax.grad(lambda p, v: jnp.sum(ref_lin.apply(p, v) * g),
                     argnums=(0, 1))(ref, jnp.asarray(x))
    np.testing.assert_allclose(lin.w.grad.numpy(),
                               np.asarray(grads[0]["w"]), rtol=1e-5,
                               atol=1e-5)
    if bias:
        np.testing.assert_allclose(lin.b.grad.numpy(),
                                   np.asarray(grads[0]["b"]), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(grads[1]),
                               rtol=1e-5, atol=1e-5)


def test_each_tile_step_is_recomputed_in_the_backward(monkeypatch):
    """The forward runs one step a tile and the backward each again (the
    JAX module's jax.checkpoint(step)); under no_grad there is no
    recompute; the grads equal those without checkpointing bitwise."""
    from deepspeed_tpu_torch.runtime.zero import tiling
    w, b, x, g = _case(32, 48, True)
    lin = TiledLinear.from_dense(w, b, 4, 2)
    calls = []
    step = tiling._step
    monkeypatch.setattr(tiling, "_step",
                        lambda *a: calls.append(1) or step(*a))
    with torch.no_grad():
        lin(torch.from_numpy(x))
    assert len(calls) == 4
    calls.clear()
    xt = torch.from_numpy(x).requires_grad_()
    lin(xt).backward(torch.from_numpy(g))
    assert len(calls) == 8
    plain = TiledLinear.from_dense(w, b, 4, 2)
    xp = torch.from_numpy(x).requires_grad_()
    tiles = xp.reshape(3, 5, 4, 8).movedim(-2, 0)
    acc = torch.zeros(3, 5, 2, 24)
    for i in range(4):
        acc = step(acc, tiles[i], plain.w[i])
    (acc + plain.b).reshape(3, 5, 48).backward(torch.from_numpy(g))
    assert torch.equal(lin.w.grad, plain.w.grad)
    assert torch.equal(xt.grad, xp.grad)


def test_layout_specs_and_errors():
    """__init__'s parameter shapes and the JAX module's init layout, the
    tensor-parallel specs (the JAX module's), a bf16 layer from a bf16
    dense weight, and the JAX module's error on splits that do not divide
    the features; TiledLinear is exported where the JAX package exports
    it."""
    lin = TiledLinear(32, 48, in_splits=4, out_splits=2)
    ref_lin = ds.zero.TiledLinear(32, 48, in_splits=4, out_splits=2)
    ref = ref_lin.init_params(jax.random.PRNGKey(0))
    assert tuple(lin.w.shape) == ref["w"].shape == (4, 2, 8, 24)
    assert tuple(lin.b.shape) == ref["b"].shape == (2, 24)
    lin.init_params(torch.Generator().manual_seed(0))
    assert torch.count_nonzero(lin.b) == 0 and lin.w.std() > 0
    specs = {k: tuple(v) for k, v in lin.param_partition_specs().items()}
    assert specs == {k: tuple(v) for k, v in
                     ref_lin.param_partition_specs().items()}
    half = TiledLinear.from_dense(torch.ones(32, 48, dtype=torch.bfloat16),
                                  None, 4, 2)
    assert half.w.dtype == torch.bfloat16 and half.b is None
    x = torch.ones(2, 32, dtype=torch.bfloat16)
    assert torch.equal(half(x), torch.full((2, 48), 32.0,
                                           dtype=torch.bfloat16))
    for cls in (TiledLinear, ds.zero.TiledLinear):
        with pytest.raises(ValueError, match="must divide features"):
            cls(30, 48, in_splits=4)
    with pytest.raises(ValueError, match="input width"):
        lin(torch.ones(2, 31))
    assert dst.zero.TiledLinear is TiledLinear
