"""Activation checkpointing at ZeRO stage 3 in the port (the stream's
per-layer recompute, runtime/zero/stage3_streaming.py `_RematLayer`)
against the JAX engine, whose model hands `stream.scan` its
`jax.checkpoint`-ed layer body: 3-step trajectories in fp32 at W = 4 in
the `off`, `unrolled` and `carried` plans within tests/test_torch_zero3.py's
tolerances; with dropout a rematted step bitwise the same plan's step
without recompute; the gathered live set at the plan's bound; and each
layer's forward count a step (2 rematted in `off` / `unrolled`, 3 in
`carried`).  The tiny GPT-2 of tests/test_torch_zero3.py, the port's ranks
on the CPU."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models import GPT2Model as JaxGPT2Model
from deepspeed_tpu.parallel import initialize_mesh as jax_initialize_mesh
from deepspeed_tpu.parallel import reset_mesh_context as jax_reset_mesh
from deepspeed_tpu_torch.models import (GPT2Config, GPT2Model,
                                        gpt2_params_from_jax,
                                        gpt2_params_to_jax)

from .test_torch_zero3 import (SMALL, STEPS, _batch, _conf, _tree,
                               _zero_cfg, assert_params_close)

LAYERS = 4
MODES = ("off", "unrolled", "carried")


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


def _jax_run(mode):
    """The JAX engine at stage 3 with activation_checkpointing on four
    simulated devices: the losses, the final parameters, the plan."""
    jax_reset_mesh()
    jax_initialize_mesh(data=4, devices=jax.devices()[:4])
    model = JaxGPT2Model(JaxGPT2Config(num_layers=LAYERS, bf16=False,
                                       activation_checkpointing=True,
                                       **SMALL))
    eng = ds.initialize(model=model, config=_conf(_zero_cfg(mode), False),
                        model_parameters=_tree(LAYERS))[0]
    ids = jnp.asarray(_batch())
    losses = []
    for _ in range(STEPS):
        loss = eng.forward(ids)
        eng.backward(loss)
        eng.step()
        losses.append(float(loss))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), eng.params)
    plan = eng._zero3_stream.last_plan
    jax_reset_mesh()
    return losses, params, plan


def _port_run(mode, remat, dropout=0.0, bf16=False, steps=STEPS):
    """The port's engine at stage 3 on four CPU ranks: the losses, the
    final parameters, the engine, each layer's forward calls."""
    dst.reset_mesh_context()
    cfg = GPT2Config(num_layers=LAYERS, bf16=bf16,
                     activation_checkpointing=remat,
                     **dict(SMALL, embd_dropout=dropout,
                            attn_dropout=dropout, hidden_dropout=dropout))
    conf = dict(_conf(_zero_cfg(mode), bf16), mesh={"data": 4})
    eng = dst.initialize(model=GPT2Model(cfg), config=conf, device="cpu",
                         model_parameters=gpt2_params_from_jax(
                             _tree(LAYERS), cfg))[0]
    calls = [0]
    for layer in eng.module.h:
        # a pre-hook: a recompute may stop before the layer's last op
        layer.register_forward_pre_hook(
            lambda *_: calls.__setitem__(0, calls[0] + 1))
    ids = torch.from_numpy(_batch())
    losses = []
    for _ in range(steps):
        loss = eng.forward(ids)
        eng.backward(loss)
        eng.step()
        losses.append(loss.item())
    params = gpt2_params_to_jax(
        {k: v.numpy() for k, v in eng.module_state_dict().items()}, cfg)
    return losses, params, eng, calls[0]


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(side, mode, *args):
        key = (side, mode) + args
        if key not in cache:
            cache[key] = (_jax_run(mode) if side == "jax"
                          else _port_run(mode, *args))
        return cache[key]
    return get


@pytest.mark.parametrize("mode", MODES)
def test_rematted_stage3_matches_the_jax_engine(runs, mode):
    """3 steps at W = 4, Adam lr 1e-3, fp32, activation_checkpointing on
    both sides: losses rtol 1e-5, parameters rtol 1e-5 plus 1e-3 of each
    leaf's largest entry with the key bias left out
    (tests/test_torch_zero3.py's rule and its reason); the same plan."""
    ref, ref_params, ref_plan = runs("jax", mode)
    out, params, eng, _ = runs("port", mode, True)
    plan = eng._zero3_stream.last_plan
    assert (plan.layers_per_step, plan.prefetch, plan.mode) == (
        ref_plan.layers_per_step, ref_plan.prefetch, ref_plan.mode)
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    assert out[-1] < out[0]
    assert_params_close(params, ref_params, 1e-5, 1e-3)


@pytest.mark.parametrize("mode", MODES)
def test_remat_is_bitwise_the_plan_without_it(mode):
    """bf16 with dropout 0.1: the rematted steps of a plan equal its steps
    without recompute bit for bit (losses, every rank's pieces and Adam
    state, the generators): every recompute redraws its masks from the
    state saved before the layer's forward."""
    out = {}
    for remat in (False, True):
        losses, _, eng, _ = _port_run(mode, remat, dropout=0.1, bf16=True,
                                      steps=2)
        out[remat] = (losses, [f.clone() for f in eng._flats],
                      [{k: v.clone() for k, v in s.items()}
                       for s in eng.opt_states],
                      [g.get_state() for g in eng._rngs])
    assert out[True][0] == out[False][0]
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)
    for a, b in zip(out[True][2], out[False][2]):
        assert all(torch.equal(a[k], b[k]) for k in b)
    for a, b in zip(out[True][3], out[False][3]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", MODES)
def test_live_set_and_recomputes(runs, mode):
    """Rematted, the gathered bytes' high-water mark a rank stays within
    the plan's live parameters x 4 bytes and equals the plan's without
    recompute, and every gathered group is released; each layer runs
    twice a rank-step in `off` and `unrolled`, three times in `carried`
    (its forward, the group's recompute, its own), once more than without
    recompute."""
    _, _, plain, plain_calls = runs("port", mode, False)
    _, _, eng, calls = runs("port", mode, True)
    stream, plan = eng._zero3_stream, eng._zero3_stream.last_plan
    assert 0 < stream.peak_live_bytes <= plan.live_parameters * 4
    assert stream.peak_live_bytes == plain._zero3_stream.peak_live_bytes
    assert stream.live_bytes == [0] * 4
    rank_steps = 4 * STEPS * LAYERS
    per_layer = 3 if mode == "carried" else 2
    assert calls == per_layer * rank_steps
    assert plain_calls == (per_layer - 1) * rank_steps
