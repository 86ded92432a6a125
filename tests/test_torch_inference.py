"""The serving slice: deepspeed_tpu_torch.init_inference -> InferenceEngine
(forward, generate, int8) against the JAX package's InferenceEngine on the
tiny GPT-2 of tests/unit/test_inference.py, with the same weights carried
over by deepspeed_tpu_torch.models.convert.  Everything runs on the CPU:
the port takes the plain versions of its kernels there."""

import numpy as np
import pytest

import jax
import torch
from torch import nn

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models import GPT2Model as JaxGPT2Model
from deepspeed_tpu.parallel import initialize_mesh, reset_mesh_context
from deepspeed_tpu_torch.models import (GPT2Config, GPT2Model,
                                        gpt2_params_from_jax)
from deepspeed_tpu_torch.ops.quant import QuantizedWeight

TINY = dict(vocab_size=128, n_positions=64, hidden_size=32, num_layers=2,
            num_heads=4, bf16=False, embd_dropout=0.0, attn_dropout=0.0,
            hidden_dropout=0.0)
PROMPT = np.array([[5, 9, 23, 40], [7, 7, 100, 2]], np.int32)


@pytest.fixture
def dp_mesh():
    reset_mesh_context()
    yield initialize_mesh(data=-1)
    reset_mesh_context()


def _jax_params(seed=0):
    """The JAX init tree with every leaf perturbed by seeded numpy noise
    (so biases and LayerNorm parameters are not 0/1), as numpy arrays."""
    model = JaxGPT2Model(JaxGPT2Config(**TINY))
    tree = jax.tree.map(np.asarray, model.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    return model, jax.tree.map(
        lambda a: (a + rng.standard_normal(a.shape) * 0.1).astype(np.float32),
        tree)


def _pair(mesh, quantization_setting=None):
    """(JAX engine, port engine) over the same weights."""
    jmodel, tree = _jax_params()
    jeng = ds.init_inference(jmodel, model_parameters=tree, mesh=mesh,
                             quantization_setting=quantization_setting)
    cfg = GPT2Config(**TINY)
    teng = dst.init_inference(GPT2Model(cfg),
                              model_parameters=gpt2_params_from_jax(tree, cfg),
                              quantization_setting=quantization_setting,
                              device="cpu")
    return jeng, teng


def test_forward_logits_match_jax(dp_mesh):
    """fp32 logits, rtol 1e-4, atol 1e-5."""
    jeng, teng = _pair(dp_mesh.mesh)
    ref = np.asarray(jeng.forward(PROMPT))
    out = teng.forward(PROMPT)
    assert out.dtype == torch.float32 and out.shape == (2, 4, 128)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_greedy_generate_matches_jax(dp_mesh):
    """Greedy tokens equal exactly (prefill + 11 KV-cache decode steps)."""
    jeng, teng = _pair(dp_mesh.mesh)
    ref = np.asarray(jeng.generate(PROMPT, max_new_tokens=12))
    out = teng.generate(PROMPT, max_new_tokens=12)
    assert out.shape == (2, 12)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("setting", [2, (True, 2)])
def test_int8_engine_matches_jax(dp_mesh, setting):
    """quantization_setting: same int8 bytes on both sides, logits at
    rtol 1e-4, atol 1e-5, and the same greedy tokens."""
    jeng, teng = _pair(dp_mesh.mesh, quantization_setting=setting)
    layer = teng.module.h[0]
    assert isinstance(layer.attn_qkvw, QuantizedWeight)
    jq = jeng.params["h"]["inter_w"]
    np.testing.assert_array_equal(layer.inter_w.qweight.numpy(),
                                  np.asarray(jq.qweight)[0])
    np.testing.assert_allclose(teng.forward(PROMPT).numpy(),
                               np.asarray(jeng.forward(PROMPT)), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(
        teng.generate(PROMPT, max_new_tokens=6).numpy(),
        np.asarray(jeng.generate(PROMPT, max_new_tokens=6)))


def test_kv_cache_decode_matches_full_recompute():
    """Greedy KV-cache decode equals argmax over a full re-forward."""
    cfg = GPT2Config(**TINY)
    model = GPT2Model(cfg).init_params(torch.Generator().manual_seed(3))
    eng = dst.init_inference(model, device="cpu")
    out = eng.generate(PROMPT, max_new_tokens=8)
    ids = torch.as_tensor(PROMPT).long()
    for step in range(8):
        nxt = eng.forward(ids)[:, -1].argmax(-1)
        assert torch.equal(nxt, out[:, step])
        ids = torch.cat([ids, nxt[:, None]], dim=1)


def test_teacher_forced_decode_logits_match_full_recompute():
    """prefill + decode_step head logits at every position equal the
    forward's logits of the whole sequence; fp32, rtol 1e-4, atol 1e-5."""
    cfg = GPT2Config(**TINY)
    model = GPT2Model(cfg).init_params(torch.Generator().manual_seed(5))
    eng = dst.init_inference(model, device="cpu")
    ids = torch.as_tensor(np.concatenate(
        [PROMPT, np.random.default_rng(6).integers(0, 128, (2, 6))], 1)).long()
    full = eng.forward(ids)
    prompt_len = PROMPT.shape[1]
    caches = eng.init_caches(2, ids.shape[1])
    steps = [eng.prefill(ids[:, :prompt_len], caches)]
    for pos in range(prompt_len, ids.shape[1]):
        steps.append(eng.decode_step(ids[:, pos], pos, caches))
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(),
                               full[:, prompt_len - 1:].numpy(),
                               rtol=1e-4, atol=1e-5)


def test_sampled_generate_shapes_and_determinism():
    cfg = GPT2Config(**TINY)
    model = GPT2Model(cfg).init_params(torch.Generator().manual_seed(4))
    eng = dst.init_inference(model, device="cpu")
    a = eng.generate(PROMPT[:1], max_new_tokens=5, temperature=1.0,
                     generator=torch.Generator().manual_seed(7))
    b = eng.generate(PROMPT[:1], max_new_tokens=5, temperature=1.0,
                     generator=torch.Generator().manual_seed(7))
    assert a.shape == (1, 5) and a.dtype == torch.int64
    assert ((a >= 0) & (a < cfg.vocab_size)).all()
    assert torch.equal(a, b)


def test_generate_rejects_more_than_n_positions():
    eng = dst.init_inference(GPT2Model(GPT2Config(**TINY)), device="cpu")
    with pytest.raises(ValueError, match="n_positions"):
        eng.generate(PROMPT, max_new_tokens=61)


def test_init_inference_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dst.init_inference(GPT2Model(GPT2Config(**TINY)))


class _HFLikeModule(nn.Module):
    def __init__(self):
        super().__init__()
        self.proj = nn.Linear(4, 4)


@pytest.mark.parametrize("kwargs,match", [
    (dict(mp_size=2), "tensor parallel"),
    (dict(model=_HFLikeModule()), "module_inject"),
])
def test_unported_arguments_raise(kwargs, match):
    kwargs.setdefault("model", GPT2Model(GPT2Config(**TINY)))
    with pytest.raises(NotImplementedError, match=match):
        dst.init_inference(device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(checkpoint="missing_ckpt_dir"), FileNotFoundError, "latest"),
])
def test_bad_arguments_raise(tmp_path, kwargs, error, match):
    """A checkpoint directory with no `latest` raises rather than serving
    the model's own weights."""
    kwargs = {k: str(tmp_path / v) if k == "checkpoint" else v
              for k, v in kwargs.items()}
    with pytest.raises(error, match=match):
        dst.init_inference(GPT2Model(GPT2Config(**TINY)), device="cpu",
                           **kwargs)


def test_dtype_int8_is_refused():
    """int8 comes from quantization_setting; dtype="int8" must not
    silently serve the dense weights."""
    with pytest.raises(ValueError, match="quantization_setting"):
        dst.init_inference(GPT2Model(GPT2Config(**TINY)), dtype="int8",
                           device="cpu")


def test_bridge_rejects_a_mismatched_config():
    _, tree = _jax_params()
    with pytest.raises(ValueError, match="wte"):
        gpt2_params_from_jax(tree, GPT2Config(**dict(TINY, vocab_size=96)))
