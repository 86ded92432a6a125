"""The training slice: the port's fused cross-entropy, GPT2Model.loss with
its parameter grads, and deepspeed_tpu_torch.initialize -> forward /
backward / step, against the JAX package on the tiny GPT-2 of
tests/test_torch_inference.py.  Weights cross by
deepspeed_tpu_torch.models.convert in both directions.  Everything runs on
the CPU: the port takes the plain versions of its kernels there."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models import GPT2Model as JaxGPT2Model
from deepspeed_tpu.ops.fused_cross_entropy import (
    fused_linear_cross_entropy as jax_fused_ce)
from deepspeed_tpu.parallel import reset_mesh_context
from deepspeed_tpu_torch.models import (GPT2Config, GPT2Model,
                                        gpt2_params_from_jax,
                                        gpt2_params_to_jax)
from deepspeed_tpu_torch.ops.fused_cross_entropy import (
    fused_linear_cross_entropy)

TINY = dict(vocab_size=128, n_positions=64, hidden_size=32, num_layers=2,
            num_heads=4, embd_dropout=0.0, attn_dropout=0.0,
            hidden_dropout=0.0)


def _jax_params(bf16, seed=0):
    """The JAX init tree with every leaf perturbed by seeded numpy noise
    (so biases and LayerNorm parameters are not 0/1), as numpy arrays."""
    model = JaxGPT2Model(JaxGPT2Config(bf16=bf16, **TINY))
    tree = jax.tree.map(np.asarray, model.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    return model, jax.tree.map(
        lambda a: (a + rng.standard_normal(a.shape) * 0.05).astype(
            np.float32), tree)


def _ids(batch, seq, seed):
    return np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], (batch, seq)).astype(np.int32)


def _assert_trees_close(out, ref, rtol, atol_rel):
    """Leaf by leaf: |out - ref| <= rtol |ref| + atol_rel * max|ref|."""
    flat_out = jax.tree_util.tree_flatten_with_path(out)[0]
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert len(flat_out) == len(flat_ref)
    for path, o in flat_out:
        r = np.asarray(flat_ref[path], np.float32)
        np.testing.assert_allclose(
            o, r, rtol=rtol, atol=atol_rel * np.abs(r).max(),
            err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------- #
# fused linear cross-entropy
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("chunk,ignore", [(None, None), (48, None), (48, 3)])
def test_fused_cross_entropy_matches_jax(chunk, ignore):
    """Loss, dh and dw vs the JAX custom-VJP op at N=40, H=16, V=100: a
    chunk of 48 leaves a padded last chunk, ignore_index drops the tokens
    labelled 3.  fp32, atol = rtol = 1e-5."""
    rng = np.random.default_rng(0)
    h = rng.standard_normal((40, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 100)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 100, 40).astype(np.int32)
    labels[::5] = 3
    ref_loss, (ref_dh, ref_dw) = jax.value_and_grad(
        lambda h_, w_: jax_fused_ce(h_, w_, jnp.asarray(labels), chunk,
                                    ignore), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    ht, wt = (torch.from_numpy(t).requires_grad_() for t in (h, w))
    loss = fused_linear_cross_entropy(ht, wt, torch.from_numpy(labels),
                                      chunk, ignore)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    for g, r in ((ht.grad, ref_dh), (wt.grad, ref_dw)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------- #
# GPT2Model.loss and every parameter grad
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("bf16,fused", [(False, True), (False, False),
                                        (True, True)])
def test_model_loss_and_grads_match_jax(bf16, fused):
    """jax.value_and_grad(JaxGPT2Model.loss) vs the port's loss.backward()
    on the same weights and ids [3, 16], dropout 0: fp32 rtol 1e-4 (loss)
    and 1e-4 of each grad's largest entry; bf16 at 2e-2 (loss) and 5e-2
    (grads), the chip-lane tolerances."""
    jmodel, tree = _jax_params(bf16)
    jmodel.config.fused_loss = fused
    ids = _ids(3, 16, seed=1)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, None, jnp.asarray(ids))))(tree)
    cfg = GPT2Config(bf16=bf16, fused_loss=fused, **TINY)
    model = GPT2Model(cfg)
    model.load_state_dict(gpt2_params_from_jax(tree, cfg))
    loss = model.loss(torch.from_numpy(ids))
    loss.backward()
    grads = gpt2_params_to_jax(
        {name: p.grad for name, p in model.named_parameters()}, cfg)
    loss_tol, grad_tol = (2e-2, 5e-2) if bf16 else (1e-4, 1e-4)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=loss_tol)
    _assert_trees_close(grads, ref_grads, grad_tol, grad_tol)


@pytest.mark.parametrize("kwargs", [{}, TINY])
def test_num_params_and_flops_per_token_match_jax(kwargs):
    """The MFU accounting: parameter count and training FLOPs per token
    equal the JAX package's, at GPT-2 124M and at the tiny shape."""
    ref, ours = JaxGPT2Config(**kwargs), GPT2Config(**kwargs)
    assert ours.num_params() == ref.num_params()
    assert ours.num_params(False) == ref.num_params(False)
    assert ours.flops_per_token() == ref.flops_per_token()


def test_param_bridge_round_trips():
    _, tree = _jax_params(False)
    cfg = GPT2Config(**TINY)
    back = gpt2_params_to_jax(gpt2_params_from_jax(tree, cfg), cfg)
    _assert_trees_close(back, tree, 0.0, 0.0)


def test_training_dropout_draws_from_the_generator():
    """With dropout configured, a generator makes the loss stochastic and
    repeatable from its seed (both attention modes); without one the model
    is deterministic, and a layer called in training mode without one
    refuses."""
    ids = torch.from_numpy(_ids(2, 16, seed=2))
    for impl in ("kernel", "ctx"):
        cfg = GPT2Config(**dict(TINY, embd_dropout=0.1, attn_dropout=0.1,
                                hidden_dropout=0.1), attn_dropout_impl=impl)
        model = GPT2Model(cfg).init_params(torch.Generator().manual_seed(0))
        with torch.no_grad():
            a = model.loss(ids, generator=torch.Generator().manual_seed(3))
            b = model.loss(ids, generator=torch.Generator().manual_seed(3))
            c = model.loss(ids, generator=torch.Generator().manual_seed(4))
            d = model.loss(ids)
            e = model.loss(ids)
        assert a.item() == b.item() and a.item() != c.item()
        assert d.item() == e.item() and d.item() != a.item()
    with pytest.raises(ValueError, match="generator"):
        model.h[0](torch.zeros(1, 4, TINY["hidden_size"]))


# ---------------------------------------------------------------------- #
# the engine: an 8-step trajectory against the JAX engine
# ---------------------------------------------------------------------- #
def _engine_config(micro, bf16):
    return {"train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": 1,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-3, "weight_decay": 0.1}},
            "bf16": {"enabled": bf16}, "zero_optimization": {"stage": 2}}


@pytest.mark.parametrize("bf16", [False, True])
def test_engine_trajectory_matches_jax(bf16):
    """8 steps of initialize -> forward / backward / step, AdamW lr 1e-3,
    wd 0.1, ZeRO-2, dropout 0, one fixed batch [8, 16]: the JAX engine on
    the conftest's 8-device CPU mesh at micro-batch 1 vs the port at
    micro-batch 8 and world 1 (the same global batch).  fp32: losses rtol
    1e-4, final parameters within 1e-4 of each leaf's largest entry.
    bf16: losses rtol 2e-2; parameters within 5e-2 of each leaf's largest
    entry (grads round through bf16 on both sides).  The key third of
    attn_qkvb is left out of the comparison: its true gradient is zero
    (softmax is shift-invariant along the keys), so its grads are rounding
    noise, which Adam's normalised step turns into updates of order lr that
    differ between any two summation orders."""
    jmodel, tree = _jax_params(bf16)
    ids = _ids(8, 16, seed=3)
    reset_mesh_context()
    try:
        jeng, _, _, _ = ds.initialize(model=jmodel,
                                      config=_engine_config(1, bf16),
                                      model_parameters=tree)
        ref = []
        for _ in range(8):
            loss = jeng.forward(jnp.asarray(ids))
            jeng.backward(loss)
            jeng.step()
            ref.append(float(loss))
        ref_params = jax.tree.map(np.asarray, jeng.params)
    finally:
        reset_mesh_context()
    cfg = GPT2Config(bf16=bf16, **TINY)
    eng, _, _, _ = dst.initialize(
        model=GPT2Model(cfg), config=_engine_config(8, bf16),
        model_parameters=gpt2_params_from_jax(tree, cfg), device="cpu")
    out = []
    for _ in range(8):
        loss = eng.forward(torch.from_numpy(ids))
        eng.backward(loss)
        eng.step()
        out.append(loss.item())
    assert eng.global_steps == 8 and int(eng.opt_state["count"]) == 8
    assert out[-1] < out[0]
    tol = 2e-2 if bf16 else 1e-4
    np.testing.assert_allclose(out, ref, rtol=tol)
    params = gpt2_params_to_jax(dict(eng.module.named_parameters()), cfg)
    hid = TINY["hidden_size"]
    for tree_ in (params, ref_params):
        qkvb = tree_["h"]["attn_qkvb"]
        tree_["h"]["attn_qkvb"] = np.concatenate(
            [qkvb[:, :hid], qkvb[:, 2 * hid:]], axis=1)
    _assert_trees_close(params, ref_params, 0.0, 5e-2 if bf16 else 1e-4)


def _tiny_engine(extra=None, **cfg_overrides):
    conf = dict(_engine_config(4, False), **(extra or {}))
    cfg = GPT2Config(bf16=False, **TINY)
    model = GPT2Model(cfg).init_params(torch.Generator().manual_seed(0))
    return dst.initialize(model=model, config=conf, device="cpu",
                          **cfg_overrides)[0]


def test_engine_accumulates_into_the_flat_buffers():
    """Parameters and grads are views into the engine's flat fp32 buffers;
    gradient accumulation over gas = 2 equals one step on the two batches'
    mean loss, and step() acts only at the boundary."""
    ids = torch.from_numpy(_ids(8, 16, seed=4))
    eng = _tiny_engine({"gradient_accumulation_steps": 2,
                        "train_micro_batch_size_per_gpu": 4})
    for name, p in eng.module.named_parameters():
        assert p.data_ptr() >= eng._flat.data_ptr() and p.dtype == torch.float32
    for half in (ids[:4], ids[4:]):
        eng.backward(eng.forward(half))
        eng.step()
    assert eng.global_steps == 1
    acc_params = eng._flat.clone()

    ref = _tiny_engine({"train_micro_batch_size_per_gpu": 8})
    ref.backward(ref.forward(ids))
    ref.step()
    # atol: the key-bias grads are rounding noise, which Adam scales to ~lr
    torch.testing.assert_close(acc_params, ref._flat, rtol=1e-5, atol=1e-5)


def test_non_finite_step_leaves_params_and_state_unchanged():
    """A step whose grads are not finite applies nothing: parameters,
    Adam moments and the step count stay bitwise as they were, and
    `overflow` reports it; the next finite step proceeds."""
    ids = torch.from_numpy(_ids(4, 16, seed=5))
    eng = _tiny_engine()
    eng.backward(eng.forward(ids))
    eng.step()
    before = (eng._flat.clone(), {k: v.clone()
                                  for k, v in eng.opt_state.items()})
    loss = eng.forward(ids)
    eng.backward(loss * float("nan"))
    eng.step()
    assert eng.overflow and not eng.was_step_applied()
    assert torch.equal(eng._flat, before[0])
    for k, v in eng.opt_state.items():
        assert torch.equal(v, before[1][k]), k
    eng.backward(eng.forward(ids))
    eng.step()
    assert not eng.overflow and int(eng.opt_state["count"]) == 2


def test_engine_takes_a_client_optimizer_and_scheduler():
    """A client FlatOptimizer (Lamb, whose trust ratio needs each
    parameter's place in the flat buffer) and a client schedule drive the
    steps: the engine hands the optimizer its segments, and the lr follows
    the schedule on the device step count."""
    from deepspeed_tpu_torch.runtime.lr_schedules import WarmupLR
    from deepspeed_tpu_torch.runtime.optimizers import build_optimizer
    sched = WarmupLR(warmup_max_lr=1e-2, warmup_num_steps=4)
    opt = build_optimizer("Lamb", {"weight_decay": 0.01}, learning_rate=sched)
    eng = _tiny_engine(optimizer=opt, lr_scheduler=sched)
    assert eng.optimizer is opt and opt.segments == eng._segments
    ids = torch.from_numpy(_ids(4, 16, seed=7))
    losses = []
    for _ in range(3):
        loss = eng.forward(ids)
        eng.backward(loss)
        eng.step()
        losses.append(loss.item())
    assert losses[-1] < losses[0]
    assert eng.get_lr() == [pytest.approx(0.0075)]


def test_engine_grads_in_compute_dtype_and_train_batch():
    """bf16.grads_in_compute_dtype accumulates the micro-steps in bf16 and
    still trains; train_batch runs gas micro-steps and one step from a
    data iterator."""
    ids = _ids(8, 16, seed=6)
    conf = dict(_engine_config(4, True), gradient_accumulation_steps=2,
                bf16={"enabled": True, "grads_in_compute_dtype": True})
    cfg = GPT2Config(bf16=True, **TINY)
    model = GPT2Model(cfg).init_params(torch.Generator().manual_seed(0))
    eng = dst.initialize(model=model, config=conf, device="cpu")[0]
    batches = iter([(torch.from_numpy(ids[:4]),),
                    (torch.from_numpy(ids[4:]),)] * 3)
    losses = [eng.train_batch(batches) for _ in range(3)]
    assert eng.global_steps == 3 and losses[-1] < losses[0]
