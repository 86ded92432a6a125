"""Activation checkpointing in the port
(deepspeed_tpu_torch.runtime.activation_checkpointing and GPT2Config's
`activation_checkpointing`) against the JAX package on the tiny GPT-2 of
tests/test_torch_training.py, and against the port without recompute.

Dropout draws from an explicit torch.Generator, which
`torch.utils.checkpoint` does not save: the layer wrapper recomputes on a
generator restored to the state the forward started from, so recompute
changes no bit of the loss or the grads with every dropout on."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import deepspeed_tpu_torch as dst
from deepspeed_tpu.ops.transformer import (
    DeepSpeedTransformerConfig as JaxLayerConfig)
from deepspeed_tpu.ops.transformer import DeepSpeedTransformerLayer as JaxLayer
from deepspeed_tpu.runtime.activation_checkpointing import (
    checkpointing as jax_ckpt)
from deepspeed_tpu_torch.config import DeepSpeedConfig
from deepspeed_tpu_torch.models import (GPT2Config, GPT2Model,
                                        gpt2_params_from_jax,
                                        gpt2_params_to_jax)
from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig
from deepspeed_tpu_torch.ops.transformer import (DeepSpeedTransformerConfig,
                                                 DeepSpeedTransformerLayer)
from deepspeed_tpu_torch.parallel import MeshContext
from deepspeed_tpu_torch.runtime import activation_checkpointing as ckpt
from deepspeed_tpu_torch.runtime.activation_checkpointing import (
    checkpointing as ckpt_mod)

from .test_torch_training import (TINY, _assert_trees_close, _ids,
                                  _jax_params)

DROPOUT = dict(TINY, embd_dropout=0.1, attn_dropout=0.1, hidden_dropout=0.1)


@pytest.fixture(autouse=True)
def _fresh_state():
    ckpt.reset()
    jax_ckpt.reset()
    dst.reset_mesh_context()
    yield
    ckpt.reset()
    jax_ckpt.reset()
    dst.reset_mesh_context()


def _loss_and_grads(cfg, ids, generator_seed=None, state=None):
    """The port's loss of ids, every parameter's grad, the generator's state
    after the forward, and how often each layer's forward ran."""
    model = GPT2Model(cfg)
    if state is None:
        model.init_params(torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(state)
    runs = []
    for layer in model.h:
        layer.register_forward_pre_hook(lambda *_: runs.append(1))
    gen = (None if generator_seed is None
           else torch.Generator().manual_seed(generator_seed))
    loss = model.loss(torch.from_numpy(ids), generator=gen)
    after = None if gen is None else gen.get_state()
    loss.backward()
    return (loss.detach(), {n: p.grad for n, p in model.named_parameters()},
            after, len(runs))


def _assert_bitwise(a, b):
    assert torch.equal(a[0], b[0])
    for name in a[1]:
        assert torch.equal(a[1][name], b[1][name]), name
    assert a[2] is None or torch.equal(a[2], b[2])


# ---------------------------------------------------------------------- #
# the model
# ---------------------------------------------------------------------- #
def test_remat_model_matches_jax_remat_model():
    """The port's GPT-2 with activation_checkpointing against the JAX
    model's (jax.checkpoint around each layer's scan body, as
    tests/unit/test_models.py runs it) on the same weights and ids [3, 16],
    dropout 0, fp32: the loss at rtol 1e-4 and every grad within 1e-4 of
    its largest entry; each layer's forward runs twice (the recompute)."""
    jmodel, tree = _jax_params(False)
    jmodel.config.activation_checkpointing = True
    ids = _ids(3, 16, seed=1)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, None, jnp.asarray(ids))))(tree)
    cfg = GPT2Config(bf16=False, activation_checkpointing=True, **TINY)
    loss, grads, _, runs = _loss_and_grads(
        cfg, ids, state=gpt2_params_from_jax(tree, cfg))
    assert runs == 2 * cfg.num_layers
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    _assert_trees_close(gpt2_params_to_jax(grads, cfg), ref_grads, 1e-4, 1e-4)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("impl", ["kernel", "ctx"])
def test_remat_is_bitwise_with_dropout(impl, bf16):
    """Every dropout on (embedding 0.1, attention 0.1 in kernel B or on the
    attention output, hidden 0.1): with and without recompute the loss,
    every grad and the generator's state after the forward are bitwise
    equal, while each layer's forward runs twice under recompute."""
    cfg = GPT2Config(bf16=bf16, attn_dropout_impl=impl, **DROPOUT)
    ids = _ids(2, 16, seed=2)
    plain = _loss_and_grads(cfg, ids, generator_seed=5)
    remat = _loss_and_grads(
        GPT2Config(bf16=bf16, attn_dropout_impl=impl,
                   activation_checkpointing=True, **DROPOUT), ids,
        generator_seed=5)
    assert (plain[3], remat[3]) == (cfg.num_layers, 2 * cfg.num_layers)
    _assert_bitwise(plain, remat)


def test_remat_is_bitwise_on_bigbird():
    """The same on a BigBird sparse_attention config (block 16, S = 64):
    its layers drop out on the attention output, through the same
    wrapper."""
    def cfg(remat):
        return GPT2Config(bf16=False, activation_checkpointing=remat,
                          sparse_attention=BigBirdSparsityConfig(
                              num_heads=TINY["num_heads"], block=16),
                          **DROPOUT)
    ids = _ids(2, 64, seed=3)
    plain = _loss_and_grads(cfg(False), ids, generator_seed=6)
    remat = _loss_and_grads(cfg(True), ids, generator_seed=6)
    assert remat[3] == 2 * plain[3]
    _assert_bitwise(plain, remat)


@pytest.mark.parametrize("bf16", [False, True])
def test_remat_engine_at_two_ranks_is_bitwise(bf16):
    """The engine at W = 2 ranks of one process (ZeRO-2, AdamW, every
    dropout on, each rank its own generator): three steps with and without
    recompute give bitwise equal losses, master buffers and Adam moments
    on both ranks.  In bf16 the recompute must read the layer's bf16 casts
    of this forward, which the engine's functional_call has taken away
    again by the time the backward runs."""
    ids = torch.from_numpy(_ids(8, 16, seed=4))
    conf = {"train_micro_batch_size_per_gpu": 4,
            "gradient_accumulation_steps": 1, "bf16": {"enabled": bf16},
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-3, "weight_decay": 0.1}},
            "zero_optimization": {"stage": 2}, "mesh": {"data": 2}}
    runs = []
    for remat in (False, True):
        dst.reset_mesh_context()
        model = GPT2Model(GPT2Config(bf16=bf16, activation_checkpointing=remat,
                                     **DROPOUT))
        model.init_params(torch.Generator().manual_seed(0))
        eng = dst.initialize(model=model, config=conf, device="cpu")[0]
        assert eng.world_size == 2
        losses = []
        for _ in range(3):
            loss = eng.forward(ids)
            eng.backward(loss)
            eng.step()
            losses.append(loss.detach())
        runs.append((torch.stack(losses), [f.clone() for f in eng._flats],
                     [{k: v.clone() for k, v in s.items()}
                      for s in eng.opt_states]))
    (la, fa, sa), (lb, fb, sb) = runs
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(fa, fb))
    for a, b in zip(sa, sb):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_a_plain_torch_checkpoint_wrap_breaks_dropout():
    """The trap the wrapper exists for: torch.utils.checkpoint around a
    layer that drops out from an explicit generator recomputes with fresh
    masks (preserve_rng_state saves the default generators only), so its
    grads differ from the layer's without recompute; the wrapper's equal
    them bitwise."""
    cfg = DeepSpeedTransformerConfig(hidden_size=32, heads=4, bf16=False,
                                     causal=True, attn_dropout_ratio=0.1,
                                     hidden_dropout_ratio=0.1)
    layer = DeepSpeedTransformerLayer(cfg)
    layer.init_params(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 16, 32)).astype(np.float32))

    def grads(wrap):
        xr = x.clone().requires_grad_()
        gen = torch.Generator().manual_seed(11)
        wrap(xr, gen).square().sum().backward()
        out = [xr.grad] + [p.grad.clone() for p in layer.parameters()]
        layer.zero_grad()
        return out

    plain = grads(lambda xr, g: layer(xr, generator=g))
    naive = grads(lambda xr, g: torch.utils.checkpoint.checkpoint(
        functools.partial(layer, generator=g), xr, use_reentrant=False))
    ours = grads(lambda xr, g: ckpt.checkpoint_with_generator(layer, g, xr))
    assert not all(torch.equal(a, b) for a, b in zip(plain, naive))
    assert all(torch.equal(a, b) for a, b in zip(plain, ours))


# ---------------------------------------------------------------------- #
# checkpoint() under the three policies, against the JAX package's
# ---------------------------------------------------------------------- #
class _DotCount(TorchDispatchMode):
    """Counts the products (mm, addmm, bmm) that actually run."""

    def __init__(self):
        super().__init__()
        self.dots = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in ckpt_mod.DOT_OPS:
            self.dots += 1
        return func(*args, **(kwargs or {}))


POLICIES = {"nothing_saveable": {},
            "partition_activations": {"partition_activations": True},
            "cpu_checkpointing": {"checkpoint_in_cpu": True}}


@pytest.mark.parametrize("policy", list(POLICIES))
def test_checkpoint_policies_match_jax(policy, monkeypatch):
    """checkpoint() around one transformer layer (hidden 32, 4 heads,
    causal, fp32, dropout 0) under each configured policy against the JAX
    package's checkpoint() configured the same way: the output and the
    grads of x and of every parameter within 1e-5.  What each policy
    saves, by the products its backward runs again: nothing_saveable
    recomputes every product of the forward the backward needs (all but
    the last projection); partition_activations saves them all (none run
    again); cpu_checkpointing saves those without batch dims (the four
    projections, copied to host memory in the forward) and recomputes the
    attention's batched ones."""
    kw = dict(hidden_size=32, heads=4, attn_dropout_ratio=0.0,
              hidden_dropout_ratio=0.0, bf16=False, causal=True)
    jlayer = JaxLayer(JaxLayerConfig(**kw))
    params = jax.tree.map(np.asarray, jlayer.init_params(
        jax.random.PRNGKey(0)))
    x = np.random.default_rng(8).standard_normal((2, 16, 32)).astype(
        np.float32)
    jax_ckpt.configure(**POLICIES[policy])
    ref_out, ref_vjp = jax.vjp(lambda p, x_: jax_ckpt.checkpoint(
        lambda p_, xx: jlayer(p_, xx, deterministic=True), p, x_), params,
        jnp.asarray(x))
    ref_dp, ref_dx = ref_vjp(jnp.ones_like(ref_out))

    layer = DeepSpeedTransformerLayer(DeepSpeedTransformerConfig(**kw))
    layer.load_state_dict({n: torch.from_numpy(a) for n, a in params.items()})
    stores = []
    offload = ckpt_mod._offload_contexts

    def spy():
        modes = offload()
        stores.append(modes[0].store)
        return modes
    monkeypatch.setattr(ckpt_mod, "_offload_contexts", spy)
    ckpt.configure(**POLICIES[policy])
    xt = torch.from_numpy(x).requires_grad_()
    counted = _DotCount()
    with counted:
        layer(xt.detach(), deterministic=True)
    forward_dots = counted.dots
    out = ckpt.checkpoint(functools.partial(layer, deterministic=True), xt)
    plain_bwd = _DotCount()
    with plain_bwd:
        layer(xt, deterministic=True).backward(torch.ones_like(out))
    layer.zero_grad()
    xt.grad = None
    bwd = _DotCount()
    with bwd:
        out.backward(torch.ones_like(out))
    recomputed = bwd.dots - (plain_bwd.dots - forward_dots)
    batched = forward_dots - 4
    # the recompute stops once it has what the backward needs: before the
    # last projection, whose output no backward reads (JAX saves no
    # residual for it either)
    expected = {"nothing_saveable": forward_dots - 1,
                "partition_activations": 0,
                "cpu_checkpointing": batched}[policy]
    assert forward_dots > 4 and recomputed == expected
    if policy == "cpu_checkpointing":
        assert len(stores) == 1 and len(stores[0]) == 4
        assert all(t.device.type == "cpu" for t in stores[0])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx),
                               atol=1e-5, rtol=1e-5)
    for name, p in layer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_dp[name]),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def test_configure_matches_jax_and_model_parallel_rng():
    """configure / is_configured / reset leave the same knobs as the JAX
    module's from flags, a config dict and a DeepSpeedConfig, and pick the
    same policy; model_parallel_rng returns the generator itself at a model
    axis of 1 and, at 2, a fork a rank that leaves the generator as it
    was."""
    section = {"partition_activations": True, "cpu_checkpointing": False,
               "number_checkpoints": 4, "profile": True}
    for args in ({"partition_activations": True, "num_checkpoints": 2},
                 {"deepspeed_config": {"activation_checkpointing": section}},
                 {"deepspeed_config": DeepSpeedConfig(
                     {"train_batch_size": 1,
                      "activation_checkpointing": section})},
                 {"checkpoint_in_cpu": True, "synchronize": True}):
        ckpt.reset()
        jax_ckpt.reset()
        assert not ckpt.is_configured()
        ckpt.configure(**args)
        jax_ckpt.configure(**args)
        assert ckpt.is_configured() and ckpt_mod._CONFIG == jax_ckpt._CONFIG
        names = {jax.checkpoint_policies.nothing_saveable: "nothing",
                 jax.checkpoint_policies.dots_saveable: "dots"}
        jax_name = names.get(jax_ckpt.get_partition_policy(), "offload")
        ours = {ckpt_mod.nothing_saveable: "nothing",
                ckpt_mod.dots_saveable: "dots",
                ckpt_mod.offload_dots_to_pinned_host: "offload"}
        assert ours[ckpt.get_partition_policy()] == jax_name
    gen = torch.Generator().manual_seed(3)
    one = MeshContext.create(data=2, devices=["cpu"])
    assert ckpt.model_parallel_rng(gen, mesh=one) is gen
    assert ckpt.model_parallel_rng(gen) is gen
    two = MeshContext.create(data=1, model=2, devices=["cpu"])
    state = gen.get_state()
    forks = [ckpt.model_parallel_rng(gen, rank=r, mesh=two) for r in (0, 1)]
    assert torch.equal(gen.get_state(), state)
    draws = [torch.rand(4, generator=f) for f in forks]
    assert not torch.equal(draws[0], draws[1])
    again = ckpt.model_parallel_rng(gen, rank=1, mesh=two)
    assert torch.equal(torch.rand(4, generator=again), draws[1])
