"""The offload tier's host Adam: the port's DeepSpeedCPUAdam and its native
library (deepspeed_tpu_torch/csrc/host/host_adam.cpp, built by
CPUAdamBuilder) against the JAX package's DeepSpeedCPUAdam on the same
seeded numpy leaves, bit for bit, Adam and AdamW, the bf16 copy-out
included; the plain PyTorch twin against the library at rtol 1e-6; the
builder reads only the port's own sources."""

import os

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.adam.cpu_adam import DeepSpeedCPUAdam as JaxCPUAdam
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.adam import (DeepSpeedCPUAdam, adam_step_buffers,
                                          adam_step_plain, num_threads)
from deepspeed_tpu_torch.utils.tree import tree_leaves


def _tree(rng):
    return {"w": rng.standard_normal((7, 13)).astype(np.float32),
            "b": {"x": rng.standard_normal(1001).astype(np.float32),
                  "a": rng.standard_normal((3, 4, 5)).astype(np.float32)}}


def _bits(x):
    arr = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return arr.view(np.uint8)


@pytest.mark.parametrize("adamw,wd", [(True, 0.1), (False, 0.1),
                                      (True, 0.0)])
def test_native_adam_matches_jax_bitwise(adamw, wd):
    """Four steps of both packages' host Adam on the same tree (lr 1e-2,
    betas (0.8, 0.95), eps 1e-6): the fp32 masters, both moments and the
    bf16 copy-out of every step equal bit for bit."""
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    kw = dict(lr=1e-2, betas=(0.8, 0.95), eps=1e-6, weight_decay=wd,
              adamw_mode=adamw)
    ref = JaxCPUAdam(tree, **kw)
    assert ref.using_native
    ours = DeepSpeedCPUAdam(tree, **kw)
    for _ in range(4):
        grads = _tree(rng)
        ref_out = ref.step(grads, emit_bf16=True)
        out = ours.step(grads, emit_bf16=True)
        for a, b in zip(tree_leaves(out), tree_leaves(ref_out)):
            assert np.array_equal(_bits(a.view(torch.int16)),
                                  np.asarray(b).view(np.uint8))
    for a, b in zip(tree_leaves(ours.params), tree_leaves(ref.params)):
        assert np.array_equal(_bits(a), _bits(b))
    for mine, theirs in ((ours.exp_avg, ref.exp_avg),
                         (ours.exp_avg_sq, ref.exp_avg_sq)):
        for a, b in zip(mine, theirs):
            assert np.array_equal(_bits(a), _bits(b))
    assert ours.step_count == ref.step_count == 4


def test_state_dict_is_the_jax_layout():
    """state_dict keys and leaf numbering are the JAX class's, and a state
    loaded from the JAX class continues bit for bit."""
    rng = np.random.default_rng(1)
    tree = _tree(rng)
    ref = JaxCPUAdam(tree, lr=1e-3, weight_decay=0.01)
    ref.step(_tree(rng))
    sd = ref.state_dict()
    ours = DeepSpeedCPUAdam(tree, lr=1e-3, weight_decay=0.01)
    assert set(ours.state_dict()) == set(sd)
    assert set(ours.state_dict()["exp_avg"]) == set(sd["exp_avg"])
    ours.load_state_dict(sd)
    grads = _tree(rng)
    ref.step(grads)
    ours.step(grads)
    for a, b in zip(tree_leaves(ours.params), tree_leaves(ref.params)):
        assert np.array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("adamw", [True, False])
def test_plain_twin_matches_the_library(adamw):
    """adam_step_plain (PyTorch) against the native update on 100003
    elements over three steps, rtol 1e-6, the bf16 copy-out within one
    bf16 rounding."""
    g = torch.Generator().manual_seed(2)
    p = torch.randn(100003, generator=g)
    states = [[p.clone(), torch.zeros_like(p), torch.zeros_like(p)]
              for _ in range(2)]
    outs = [torch.empty(p.numel(), dtype=torch.bfloat16) for _ in range(2)]
    for step in range(1, 4):
        grad = torch.randn(p.numel(), generator=g)
        args = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8,
                    weight_decay=0.05, step=step, adamw_mode=adamw)
        adam_step_buffers(*states[0], grad, bf16_out=outs[0], **args)
        adam_step_plain(*states[1], grad, bf16_out=outs[1], **args)
    for a, b in zip(states[0], states[1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(outs[0].float(), outs[1].float(), rtol=8e-3,
                               atol=0)


def test_buffers_are_checked_and_threads_set():
    """A strided, short or non-fp32 span is refused before the library
    sees its pointer; the OpenMP thread count is set (at least 1)."""
    p = torch.zeros(8)
    with pytest.raises(ValueError, match="contiguous"):
        adam_step_buffers(torch.zeros(16)[::2], p.clone(), p.clone(),
                          p.clone(), lr=1e-3, beta1=0.9, beta2=0.999,
                          eps=1e-8, weight_decay=0.0, step=1,
                          adamw_mode=True)
    with pytest.raises(ValueError, match="8 elements"):
        adam_step_buffers(p.clone(), p.clone(), p.clone(), torch.zeros(4),
                          lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                          weight_decay=0.0, step=1, adamw_mode=True)
    assert num_threads() >= 1


def test_builders_read_only_the_ports_sources():
    """CPUAdamBuilder and AsyncIOBuilder compile and key their builds on
    files under deepspeed_tpu_torch/csrc/host/ only, into build/torch_host/,
    and a failing compile raises with the compiler's message."""
    port = os.path.dirname(os.path.dirname(os.path.abspath(
        op_builder.__file__)))
    host = os.path.join(port, "csrc", "host")
    for builder in (op_builder.CPUAdamBuilder(), op_builder.AsyncIOBuilder()):
        files = builder.sources() + builder.headers()
        assert files and all(os.path.dirname(f) == host for f in files)
        assert os.path.basename(os.path.dirname(builder.lib_path())) == \
            "torch_host"

    class Broken(op_builder.HostOpBuilder):
        NAME = "broken"

        def sources(self):
            return [os.path.join(host, "aio_backend.h")]

        def cxx_flags(self):
            return super().cxx_flags() + ["-DDS_FORCE_ERROR", "-x", "c++",
                                          "-include", "no_such_header.h"]

    with pytest.raises(RuntimeError, match="failed to build"):
        Broken().build()
