"""The training runtime's plain-PyTorch pieces against the JAX package on
the same numpy inputs: the optimizers (optax), the LR schedules, the loss
scaler and the data loader."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepspeed_tpu.runtime import lr_schedules as jax_sched
from deepspeed_tpu.runtime.dataloader import (
    DeepSpeedDataLoader as JaxLoader)
from deepspeed_tpu.runtime.fp16 import loss_scaler as jax_scaler
from deepspeed_tpu.runtime.optimizers import (
    build_optimizer as jax_build_optimizer)
from deepspeed_tpu_torch.runtime import lr_schedules
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                    RepeatingLoader)
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer

SHAPES = [(7, 5), (5,), (3, 4, 2)]


@pytest.mark.parametrize("name,params,clip", [
    ("AdamW", {"lr": 1e-2, "weight_decay": 0.1}, 0.0),
    ("Adam", {"lr": 1e-2, "weight_decay": 0.1, "adam_w_mode": False}, 0.0),
    ("Adam", {"lr": 1e-2, "betas": (0.8, 0.99), "eps": 1e-6}, 0.5),
    ("Lamb", {"lr": 1e-2, "weight_decay": 0.01}, 0.0),
    ("SGD", {"lr": 1e-1, "momentum": 0.9, "nesterov": True}, 1.0),
    ("SGD", {"lr": 1e-1}, 0.0),
])
def test_optimizer_matches_optax(name, params, clip):
    """Four updates of the port's flat optimizer vs the JAX package's optax
    chain on a three-leaf tree, with a WarmupLR schedule on AdamW: every
    parameter within fp32 rtol 1e-5 / atol 1e-6.  Weight decay applies to
    every leaf, as optax does."""
    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.standard_normal(s) * 3).astype(np.float32) for s in SHAPES]
             for _ in range(4)]
    jsched = tsched = None
    if name == "AdamW":
        jsched = jax_sched.WarmupLR(warmup_max_lr=1e-2, warmup_num_steps=3)
        tsched = lr_schedules.WarmupLR(warmup_max_lr=1e-2, warmup_num_steps=3)
    tx = jax_build_optimizer(name, params, learning_rate=jsched,
                             gradient_clipping=clip)
    jp = [jnp.asarray(a) for a in leaves]
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = [p + u for p, u in zip(jp, upd)]

    sizes = [a.size for a in leaves]
    segments = list(zip(np.cumsum([0] + sizes[:-1]).tolist(), sizes))
    opt = build_optimizer(name, params, learning_rate=tsched,
                          gradient_clipping=clip, segments=segments)
    flat = torch.from_numpy(np.concatenate([a.ravel() for a in leaves]))
    ostate = opt.init(flat)
    finite = torch.tensor(True)
    for g in grads:
        opt.step(flat, torch.from_numpy(np.concatenate(
            [a.ravel() for a in g])), ostate, finite)
    ref = np.concatenate([np.asarray(p).ravel() for p in jp])
    np.testing.assert_allclose(flat.numpy(), ref, rtol=1e-5, atol=1e-6)
    assert int(ostate["count"]) == 4


def test_optimizer_skips_a_non_finite_step_entirely():
    opt = build_optimizer("AdamW", {"lr": 1e-2, "weight_decay": 0.1})
    flat = torch.randn(10)
    state = opt.init(flat)
    opt.step(flat, torch.randn(10), state, torch.tensor(True))
    before = flat.clone(), {k: v.clone() for k, v in state.items()}
    grads = torch.randn(10)
    grads[3] = float("inf")
    opt.step(flat, grads, state, torch.isfinite(grads).all())
    assert torch.equal(flat, before[0])
    for k, v in state.items():
        assert torch.equal(v, before[1][k])


def test_onebit_optimizers_are_refused():
    with pytest.raises(NotImplementedError, match="A.8"):
        build_optimizer("OneBitAdam", {"lr": 1e-3})


@pytest.mark.parametrize("name,params", [
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4,
                     "lr_range_test_step_size": 10,
                     "lr_range_test_staircase": True}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2,
                  "cycle_first_step_size": 20, "decay_lr_rate": 0.1,
                  "decay_step_size": 5}),
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3,
                  "warmup_num_steps": 30}),
    ("WarmupDecayLR", {"total_num_steps": 100, "warmup_max_lr": 1e-3,
                       "warmup_num_steps": 30}),
])
def test_lr_schedules_match_jax(name, params):
    """lr_at over steps 0..119 (a Python int and a device-style tensor
    step) and the step()/get_lr() surface, fp32 rtol 1e-6."""
    ref = jax_sched.get_lr_schedule(name, params)
    ours = lr_schedules.get_lr_schedule(name, params)
    steps = np.arange(120)
    want = np.asarray([float(ref.lr_at(s)) for s in steps])
    np.testing.assert_allclose([float(ours.lr_at(int(s))) for s in steps],
                               want, rtol=1e-6)
    np.testing.assert_allclose(
        ours.lr_at(torch.from_numpy(steps).to(torch.int32)).numpy(), want,
        rtol=1e-6)
    for _ in range(7):
        ref.step()
        ours.step()
    assert ours.get_lr() == pytest.approx(ref.get_lr(), rel=1e-6)
    assert ours.state_dict() == ref.state_dict()


def test_dynamic_loss_scaler_matches_jax():
    """The same overflow sequence drives both scalers through halving,
    hysteresis and growth to the same states."""
    class FP16:
        enabled, dynamic_loss_scale = True, True
        loss_scale_window, min_loss_scale, hysteresis = 3, 1.0, 2
        initial_scale_power = 5

    jcfg, jstate = jax_scaler.create_loss_scaler(FP16())
    cfg, state = loss_scaler.create_loss_scaler(FP16())
    for overflow in (False, True, True, True, False, False, False, False,
                     True, False):
        jstate = jax_scaler.update_loss_scale(jcfg, jstate, overflow)
        state = loss_scaler.update_loss_scale(cfg, state, overflow)
        assert [float(x) for x in state] == [float(x) for x in jstate]
    cfg, state = loss_scaler.create_loss_scaler(None)
    assert not cfg.dynamic and float(state.loss_scale) == 1.0
    assert loss_scaler.update_loss_scale(cfg, state, True) is state


def test_dataloader_matches_jax():
    data = [(np.full(3, i, np.int32), np.int32(i)) for i in range(22)]
    for kwargs in ({}, {"shuffle": True, "seed": 4},
                   {"data_parallel_world_size": 2, "data_parallel_rank": 1}):
        ref = list(JaxLoader(data, batch_size=4, **kwargs))
        ours = list(DeepSpeedDataLoader(data, batch_size=4, **kwargs))
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    it = RepeatingLoader(DeepSpeedDataLoader(data, batch_size=10))
    firsts = [next(it)[1][0] for _ in range(5)]
    assert firsts == [0, 10, 0, 10, 0]
