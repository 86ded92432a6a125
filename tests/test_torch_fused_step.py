"""The fused whole step of the port (runtime/fused_step.py, the engine's
`train_batch` under `"fused_step": {"enabled": true}`) on the CPU, where
its body runs eagerly, one call a window: the plain version of the CUDA
graph the card captures.  Held bitwise against the port's own modular
loop (one and two ranks of one controller, dropout on, with and without
activation checkpointing), and against the JAX engine's fused step
(deepspeed_tpu/runtime/fused_step.py) on the same numpy inputs at the tiny
GPT-2 of tests/test_torch_training.py: the trajectory, fp16's overflow
skips, the in-window sentinel's EWMA and verdicts, its state across a
checkpoint in both directions, the fallback matrix's strings, and
`stack_microbatches`.  The JAX engine runs on the conftest's 8-device CPU
mesh at micro-batch 1, the port at one rank and micro-batch 8."""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu.runtime import fused_step as jax_fused
from deepspeed_tpu.runtime.dataloader import (
    stack_microbatches as jax_stack_microbatches)
from deepspeed_tpu.runtime.resilience.sentinel import (
    TrainingSentinel as JaxTrainingSentinel)
from deepspeed_tpu_torch.models import GPT2Config, GPT2Model
from deepspeed_tpu_torch.runtime import fused_step
from deepspeed_tpu_torch.runtime.dataloader import stack_microbatches

from .test_torch_checkpoint import (_conf, _fresh_registries,  # noqa: F401
                                    _jax_engine, _port_engine, _port_params)
from .test_torch_training import TINY, _assert_trees_close, _ids, _jax_params

FUSED = {"enabled": True}


def _sentinel_block(policy="skip_step", k_sigma=2.0, warmup_steps=2,
                    **extra):
    """A resilience block with the loss-only sentinel (the fused path's)."""
    return {"enabled": True, "verify_lockstep_on_resume": False,
            "sentinel": dict({"enabled": True, "policy": policy,
                              "k_sigma": k_sigma,
                              "warmup_steps": warmup_steps,
                              "monitor_grad_norm": False}, **extra)}


def _windows(eng, batches, n, to_device=lambda b: b):
    """n train_batch calls over one iterator of `batches`; the losses."""
    it = iter([(to_device(b),) for b in batches])
    return [float(eng.train_batch(it)) for _ in range(n)]


def _without_key_bias(tree):
    """The key third of attn_qkvb left out (its true gradient is zero:
    test_torch_training.py test_engine_trajectory_matches_jax)."""
    hid = TINY["hidden_size"]
    qkvb = tree["h"]["attn_qkvb"]
    tree["h"]["attn_qkvb"] = np.concatenate(
        [qkvb[:, :hid], qkvb[:, 2 * hid:]], axis=1)
    return tree


# ---------------------------------------------------------------------- #
# the fused body against the port's modular loop
# ---------------------------------------------------------------------- #
def _dropout_engine(fused, world, remat, gas):
    dst.reset_mesh_context()
    cfg = GPT2Config(bf16=False, activation_checkpointing=remat,
                     **dict(TINY, embd_dropout=0.1, attn_dropout=0.1,
                            hidden_dropout=0.1))
    model = GPT2Model(cfg).init_params(torch.Generator().manual_seed(0))
    conf = _conf(2, gradient_accumulation_steps=gas, mesh={"data": world},
                 fused_step={"enabled": fused})
    return dst.initialize(model=model, config=conf, device="cpu")[0]


@pytest.mark.parametrize("world,remat", [(1, False), (2, False), (1, True),
                                         (2, True)])
def test_fused_train_batch_is_the_modular_loop_bitwise(world, remat):
    """Three windows of gas 3 (a different batch [2W, 16] each micro-step),
    dropout 0.1, AdamW, ZeRO-2, at W ranks of one controller, with and
    without activation checkpointing: the fused train_batch gives the
    modular loop's losses, every rank's parameters, Adam's state and the
    generators' states, bitwise."""
    gas, n = 3, 3
    batches = [_ids(2 * world, 16, seed=40 + k) for k in range(gas * n)]
    runs = {}
    for fused in (False, True):
        eng = _dropout_engine(fused, world, remat, gas)
        assert (eng._fused is not None) == fused
        losses = _windows(eng, batches, n)
        runs[fused] = (losses, eng)
    (ref, modular), (out, fused_eng) = runs[False], runs[True]
    assert out == ref
    assert fused_eng.global_steps == modular.global_steps == n
    assert fused_eng.micro_steps == modular.micro_steps == n * gas
    for a, b in zip(modular._flats, fused_eng._flats):
        assert torch.equal(a, b)
    for sa, sb in zip(modular.opt_states, fused_eng.opt_states):
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    for ga, gb in zip(modular._rngs, fused_eng._rngs):
        assert torch.equal(ga.get_state(), gb.get_state())


# ---------------------------------------------------------------------- #
# against the JAX engine's fused step
# ---------------------------------------------------------------------- #
def test_fused_trajectory_matches_the_jax_fused_step():
    """4 windows of gas 2, AdamW, ZeRO-2, fp32, dropout off, a different
    batch [8, 16] each micro-step, through both packages' fused
    train_batch: the losses within rtol 1e-4 and the final parameters
    within 1e-4 of each leaf's largest entry (the key bias left out), the
    tolerances of test_engine_trajectory_matches_jax.  One dispatch a step
    on both (the modular loop's 2 x gas)."""
    _, tree = _jax_params(False)
    batches = [_ids(8, 16, seed=3 + k) for k in range(8)]
    jeng = _jax_engine(tree, _conf(1, gradient_accumulation_steps=2,
                                   fused_step=FUSED))
    assert jeng._fused_step_fn is not None
    ref = _windows(jeng, batches, 4, jnp.asarray)
    ref_params = jax.tree.map(np.asarray, jeng.params)
    eng = _port_engine(tree, _conf(8, gradient_accumulation_steps=2,
                                   fused_step=FUSED))
    out = _windows(eng, batches, 4, torch.from_numpy)
    np.testing.assert_allclose(out, ref, rtol=1e-4)
    assert out[-1] < out[0]
    _assert_trees_close(_without_key_bias(_port_params(eng)),
                        _without_key_bias(ref_params), 0.0, 1e-4)
    assert eng._dispatches_per_step == jeng._dispatches_per_step == 1
    modular = _port_engine(tree, _conf(8, gradient_accumulation_steps=2))
    assert modular._dispatches_per_step == 2 * 2


def test_fused_fp16_overflow_skips_match_the_jax_fused_step():
    """The counterpart of tests/unit/test_fused_step.py's fp16 case on
    GPT-2: the dynamic scaler from 2^24, where the first windows overflow
    (hysteresis 2), 6 windows of gas 2 through both fused steps: after
    every window the scale, the good-step count, the hysteresis and
    skipped_steps equal; the losses of the windows within rtol 1e-4; the
    final parameters within 1e-4 of each leaf's largest entry."""
    block = {"enabled": True, "initial_scale_power": 24}
    _, tree = _jax_params(False)
    batches = [_ids(8, 16, seed=60 + k) for k in range(12)]

    def trajectory(eng, to_device):
        it = iter([(to_device(b),) for b in batches])
        out = []
        for _ in range(6):
            loss = float(eng.train_batch(it))
            s = eng.scaler_state
            out.append((loss, float(s.loss_scale), int(s.good_steps),
                        int(s.hysteresis), eng.skipped_steps))
        return out

    jeng = _jax_engine(tree, _conf(1, gradient_accumulation_steps=2,
                                   fused_step=FUSED, fp16=block))
    ref = trajectory(jeng, jnp.asarray)
    eng = _port_engine(tree, _conf(8, gradient_accumulation_steps=2,
                                   fused_step=FUSED, fp16=block))
    assert eng.compute_dtype == torch.float16 and eng._fused is not None
    out = trajectory(eng, torch.from_numpy)
    assert [o[1:] for o in out] == [r[1:] for r in ref]
    assert out[-1][4] >= 1, "no window overflowed"
    finite = [i for i, r in enumerate(ref) if np.isfinite(r[0])]
    np.testing.assert_allclose([out[i][0] for i in finite],
                               [ref[i][0] for i in finite], rtol=1e-4)
    _assert_trees_close(_without_key_bias(_port_params(eng)),
                        _without_key_bias(jax.tree.map(np.asarray,
                                                       jeng.params)),
                        0.0, 1e-4)


def _sent_state(eng):
    """(mean, var, count) of either engine's in-window sentinel state."""
    st = (eng._fused.sent_state if hasattr(eng, "_fused")
          else eng._fused_sent_state)
    return (float(st.mean), float(st.var), int(st.count))


def _last_flags(eng):
    """The last window's (flagged, nonfinite) verdicts of either engine."""
    if hasattr(eng, "_fused"):
        out = eng._fused.pending[-1][1]
        return (bool(out[fused_step.OUT_FLAGGED]),
                bool(out[fused_step.OUT_NONFINITE]))
    flagged, nonfinite = eng._fused_pending_flags[-1][2]
    return bool(flagged), bool(nonfinite)


def test_in_window_sentinel_matches_the_jax_fused_step():
    """skip_step with k_sigma 8 after 2 warm-up windows and a WarmupLR
    schedule, 8 windows of gas 2 (a different batch each micro-step):
    after every window the EWMA (mean within rtol 1e-5, var 1e-2, count
    exact), the verdicts and skipped_steps equal the JAX engine's
    `_fused_sent_state` and pending flags; a flagged window is counted once
    as skipped, holds the scheduler and leaves the parameters and Adam's
    state as they were; the windows after warmup are flagged and not (the
    z-scores lie 15% or more from k_sigma)."""
    _, tree = _jax_params(False)
    batches = [_ids(8, 16, seed=100 + k) for k in range(16)]
    extra = dict(gradient_accumulation_steps=2, fused_step=FUSED,
                 resilience=_sentinel_block(k_sigma=8.0),
                 scheduler={"type": "WarmupLR",
                            "params": {"warmup_num_steps": 4}})
    jeng = _jax_engine(tree, _conf(1, **extra))
    eng = _port_engine(tree, _conf(8, **extra))
    assert jeng._fused_step_fn is not None and eng._fused is not None
    jit = iter([(jnp.asarray(b),) for b in batches])
    pit = iter([(torch.from_numpy(b),) for b in batches])
    flags = []
    for _ in range(8):
        before = eng._flats[0].clone()
        count = int(eng.opt_state["count"])
        jeng.train_batch(jit)
        eng.train_batch(pit)
        ref, out = _sent_state(jeng), _sent_state(eng)
        np.testing.assert_allclose(out[0], ref[0], rtol=1e-5)
        # the variance is a small difference of the losses' rounding
        np.testing.assert_allclose(out[1], ref[1], rtol=1e-2)
        assert out[2] == ref[2]
        assert _last_flags(eng) == _last_flags(jeng)
        assert eng.skipped_steps == jeng.skipped_steps
        assert (eng.lr_scheduler.last_batch_iteration
                == jeng.lr_scheduler.last_batch_iteration)
        flagged = _last_flags(eng)[0]
        flags.append(flagged)
        assert int(eng.opt_state["count"]) == count + (not flagged)
        if flagged:
            assert torch.equal(eng._flats[0], before)
    assert any(flags[2:]) and not all(flags[2:]), flags
    assert eng.skipped_steps == sum(flags)
    assert eng.sentinel.counters()["steps_skipped"] == sum(flags)
    assert eng.lr_scheduler.last_batch_iteration == 8 - sum(flags) - 1


def test_warmup_zero_never_flags_the_first_window():
    """warmup_steps 0 and a k_sigma of 1e-6: the first window is never a
    spike (the device mean is a placeholder until one observation), the
    EWMA takes its loss; the second window is flagged."""
    eng = _port_engine(_jax_params(False)[1], _conf(
        8, gradient_accumulation_steps=2, fused_step=FUSED,
        resilience=_sentinel_block(k_sigma=1e-6, warmup_steps=0)))
    it = iter([(torch.from_numpy(_ids(8, 16, seed=k)),) for k in range(4)])
    loss = float(eng.train_batch(it))
    assert _last_flags(eng) == (False, False)
    assert _sent_state(eng) == (np.float32(loss), 0.0, 1)
    eng.train_batch(it)
    assert _last_flags(eng) == (True, False)
    assert eng.skipped_steps == 1


def test_sentinel_state_crosses_a_checkpoint_both_ways(tmp_path):
    """The warn policy's EWMA after 3 windows, saved by the port's fused
    engine and loaded by the JAX engine's; then after 3 more windows of
    the JAX engine, saved by it and loaded by a new port engine: each
    time the loader's device state equals the saver's (the host sentinel
    folds it in before the save, and seeds the device state from the file
    after the load)."""
    _, tree = _jax_params(False)
    batches = [_ids(8, 16, seed=200 + k) for k in range(12)]
    extra = dict(gradient_accumulation_steps=2, fused_step=FUSED,
                 resilience=_sentinel_block("warn", k_sigma=6.0))
    jeng = _jax_engine(tree, _conf(1, **extra))
    eng = _port_engine(tree, _conf(8, **extra))
    _windows(eng, batches[:6], 3, torch.from_numpy)
    eng.save_checkpoint(str(tmp_path / "port"), tag="s")
    jeng.load_checkpoint(str(tmp_path / "port"), tag="s")
    assert _sent_state(jeng) == _sent_state(eng)
    assert _sent_state(eng)[2] == jeng.sentinel.loss_stat.count == 3
    _windows(jeng, batches[6:], 3, jnp.asarray)
    jeng.save_checkpoint(str(tmp_path / "jax"), tag="s")
    other = _port_engine(tree, _conf(8, **extra))
    other.load_checkpoint(str(tmp_path / "jax"), tag="s")
    assert _sent_state(other) == _sent_state(jeng)
    assert _sent_state(other)[2] == other.sentinel.loss_stat.count == 6


def _fallback_engines(block):
    """A port engine under fused_step with `block` and the JAX function's
    reason on the same config (a stand-in engine holding the JAX config
    and sentinel)."""
    conf = _conf(8, gradient_accumulation_steps=2, fused_step=FUSED,
                 resilience=block)
    eng = _port_engine(_jax_params(False)[1], conf)
    jcfg = JaxDeepSpeedConfig(_conf(1, gradient_accumulation_steps=2,
                                    fused_step=FUSED, resilience=block),
                              world_size=8)
    s = jcfg.resilience_config.sentinel
    fake = types.SimpleNamespace(
        config=jcfg, _offload_enabled=False,
        sentinel=JaxTrainingSentinel(policy=s.policy,
                                     monitor_grad_norm=s.monitor_grad_norm))
    return eng, jax_fused.fused_fallback_reason(fake)


@pytest.mark.parametrize("block", [
    _sentinel_block("rewind"),
    _sentinel_block("warn", monitor_grad_norm=True)])
def test_fallback_reason_strings_match_the_jax_function(block):
    """The sentinel's rewind policy and its grad-norm monitoring fall back
    to the modular loop with the JAX function's reason, kept on
    fused_step_reason; train_batch then runs the modular loop."""
    eng, reason = _fallback_engines(block)
    assert reason is not None
    assert eng.fused_step_reason == reason
    assert fused_step.fused_fallback_reason(eng) == reason
    assert eng._fused is None and eng._dispatches_per_step == 4
    it = iter([(torch.from_numpy(_ids(8, 16, seed=k)),) for k in range(2)])
    assert isinstance(eng.train_batch(it), float)


# ---------------------------------------------------------------------- #
# stack_microbatches
# ---------------------------------------------------------------------- #
def test_stack_microbatches_matches_the_jax_function():
    """Tuples, lists and dicts of numpy arrays stack to the JAX function's
    leaves ([gas, ...], equal); torch leaves stack as tensors to the same
    values; a micro-batch of another structure raises the JAX function's
    message."""
    rng = np.random.default_rng(0)

    def batch():
        return (rng.integers(0, 9, (2, 3)).astype(np.int32),
                {"labels": rng.standard_normal(4).astype(np.float32),
                 "mask": [rng.integers(0, 2, 3), None]})

    batches = [batch() for _ in range(3)]
    ref = jax_stack_microbatches(batches)
    out = stack_microbatches(batches)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_out = jax.tree_util.tree_flatten_with_path(out)[0]
    assert [p for p, _ in flat_out] == [p for p, _ in flat_ref]
    for (_, o), (_, r) in zip(flat_out, flat_ref):
        assert o.shape == r.shape and o.dtype == r.dtype
        np.testing.assert_array_equal(o, r)
    torch_out = stack_microbatches(
        [(torch.from_numpy(b[0]),) for b in batches])
    assert isinstance(torch_out[0], torch.Tensor)
    np.testing.assert_array_equal(torch_out[0].numpy(), ref[0])
    for bad in ([batches[0], (batches[1][0],)],
                [batches[0], [batches[1][0], batches[1][1]]],
                [{"a": 1}, {"a": 1, "b": None}]):
        msgs = []
        for fn in (jax_stack_microbatches, stack_microbatches):
            with pytest.raises(ValueError) as err:
                fn(bad)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="at least one microbatch"):
        stack_microbatches([])
