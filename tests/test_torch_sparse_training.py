"""The sparse-attention training slice on the CPU: a tiny GPT-2 with
block-sparse attention (GPT2Config.sparse_attention) against the JAX
package's GPT2Model(sparse_attention=...), loss and every parameter grad,
and an 8-step AdamW engine trajectory against the JAX engine, as
tests/test_torch_training.py does for the dense model.  The port runs the
plain twins of kernels F and G here."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models import GPT2Model as JaxGPT2Model
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.parallel import reset_mesh_context
from deepspeed_tpu_torch.models import (GPT2Config, GPT2Model,
                                        gpt2_params_from_jax,
                                        gpt2_params_to_jax)
from deepspeed_tpu_torch.ops import launch_counts, reset_launch_counts
from deepspeed_tpu_torch.ops import sparse_attention as tsa

TINY = dict(vocab_size=128, n_positions=64, hidden_size=32, num_layers=2,
            num_heads=4, embd_dropout=0.0, attn_dropout=0.0,
            hidden_dropout=0.0)
SEQ = 64
SPARSE = {
    "bigbird": ("BigBirdSparsityConfig",
                dict(num_random_blocks=1, num_sliding_window_blocks=3,
                     num_global_blocks=1)),
    "fixed_unidirectional": ("FixedSparsityConfig",
                             dict(num_local_blocks=2,
                                  attention="unidirectional")),
    "bslongformer": ("BSLongformerSparsityConfig",
                     dict(num_sliding_window_blocks=3,
                          global_block_indices=[0])),
}


def _sparse(pkg, which):
    name, kw = SPARSE[which]
    return getattr(pkg, name)(num_heads=TINY["num_heads"], block=16, **kw)


def _jax_model(bf16, which, seed=0):
    """The JAX sparse model and its init tree with every leaf perturbed by
    seeded numpy noise, as numpy arrays."""
    model = JaxGPT2Model(JaxGPT2Config(bf16=bf16, sparse_attention=_sparse(
        jsa, which), **TINY))
    tree = jax.tree.map(np.asarray, model.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    return model, jax.tree.map(
        lambda a: (a + rng.standard_normal(a.shape) * 0.05).astype(
            np.float32), tree)


def _port_config(bf16, which, **kw):
    return GPT2Config(bf16=bf16, sparse_attention=_sparse(tsa, which),
                      **dict(TINY, **kw))


def _ids(batch, seed):
    return np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], (batch, SEQ)).astype(np.int32)


def _assert_trees_close(out, ref, rtol, atol_rel):
    flat_out = jax.tree_util.tree_flatten_with_path(out)[0]
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert len(flat_out) == len(flat_ref)
    for path, o in flat_out:
        r = np.asarray(flat_ref[path], np.float32)
        np.testing.assert_allclose(
            o, r, rtol=rtol, atol=atol_rel * np.abs(r).max(),
            err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("bf16,which", [(False, "bigbird"),
                                        (False, "fixed_unidirectional"),
                                        (False, "bslongformer"),
                                        (True, "bigbird")])
def test_sparse_model_loss_and_grads_match_jax(bf16, which):
    """jax.value_and_grad(JaxGPT2Model.loss) vs the port's loss.backward()
    at S=64, block 16, dropout off: fp32 loss within 1e-5 relative and
    every grad within 1e-4 of its largest entry; bf16 at the chip-lane
    2e-2 / 5e-2."""
    jmodel, tree = _jax_model(bf16, which)
    ids = _ids(2, seed=1)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, None, jnp.asarray(ids))))(tree)
    cfg = _port_config(bf16, which)
    model = GPT2Model(cfg)
    model.load_state_dict(gpt2_params_from_jax(tree, cfg))
    reset_launch_counts()
    loss = model.loss(torch.from_numpy(ids))
    loss.backward()
    assert set(launch_counts().values()) == {0}  # the twins ran
    grads = gpt2_params_to_jax(
        {name: p.grad for name, p in model.named_parameters()}, cfg)
    loss_tol, grad_tol = (2e-2, 5e-2) if bf16 else (1e-5, 1e-4)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=loss_tol)
    _assert_trees_close(grads, ref_grads, grad_tol, grad_tol)


def test_sparse_layers_use_output_dropout_drawn_once():
    """A sparse layer drops its attention output whatever attn_dropout_impl
    says (the JAX layer's rule), so 'kernel' and 'ctx' give the same loss
    from one generator seed; the loss is stochastic in the seed and the
    model deterministic without a generator."""
    ids = torch.from_numpy(_ids(2, seed=2))
    drop = dict(embd_dropout=0.1, attn_dropout=0.1, hidden_dropout=0.1)
    losses = {}
    for impl in ("kernel", "ctx"):
        cfg = _port_config(False, "bigbird", attn_dropout_impl=impl, **drop)
        model = GPT2Model(cfg).init_params(torch.Generator().manual_seed(0))
        with torch.no_grad():
            losses[impl] = [model.loss(ids, generator=torch.Generator()
                                       .manual_seed(s)).item()
                            for s in (3, 3, 4)]
            plain = model.loss(ids).item()
    assert losses["kernel"] == losses["ctx"]
    a, b, c = losses["ctx"]
    assert a == b and a != c and plain not in (a, c)


def _engine_config(micro, bf16):
    return {"train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": 1,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-3, "weight_decay": 0.1}},
            "bf16": {"enabled": bf16}, "zero_optimization": {"stage": 2}}


@pytest.mark.parametrize("bf16", [False, True])
def test_sparse_engine_trajectory_matches_jax(bf16):
    """8 steps of initialize -> forward / backward / step on the BigBird
    model, AdamW lr 1e-3 wd 0.1, ZeRO-2, one fixed batch [8, 64]: the JAX
    engine on the conftest's 8-device CPU mesh at micro-batch 1 vs the port
    at micro-batch 8 and world 1.  fp32: losses rtol 1e-4, parameters
    within 1e-4 of each leaf's largest entry; bf16: 2e-2 and 5e-2.  The
    key third of attn_qkvb is left out, as in test_torch_training.py: its
    true grad is zero and Adam turns its rounding noise into updates of
    order lr."""
    jmodel, tree = _jax_model(bf16, "bigbird")
    ids = _ids(8, seed=3)
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
    cfg = _port_config(bf16, "bigbird")
    eng, _, _, _ = dst.initialize(
        model=GPT2Model(cfg), config=_engine_config(8, bf16),
        model_parameters=gpt2_params_from_jax(tree, cfg), device="cpu")
    out = []
    for _ in range(8):
        loss = eng.forward(torch.from_numpy(ids))
        eng.backward(loss)
        eng.step()
        out.append(loss.item())
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
