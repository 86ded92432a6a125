"""fp16 training in the port (`"fp16": {"enabled": true}`) against the JAX
engine on the tiny GPT-2 of tests/test_torch_training.py: the losses, the
loss-scale trajectory, `skipped_steps` and the parameters, under the dynamic
scaler (overflowing first steps, hysteresis, the doubling after the window)
and the static scale; fp16 checkpoints crossing between the packages; and
kernels A's and D's host glue for fp16 gamma and beta, which no other
kernel takes.

Under both packages fp16 rounds every parameter through fp16 and scales the
loss, while the model computes in its own dtype (bf16 by default, fp32
here where the trajectory is held tight); the grads that come back through
the fp16 casts are where the overflow happens."""

import importlib

import numpy as np
import pytest

import jax
import torch

from deepspeed_tpu_torch.ops import normalize as nz
from deepspeed_tpu_torch.ops import op_builder, quant
from deepspeed_tpu_torch.ops.normalize import (layer_norm_bwd_cuda,
                                               layer_norm_bwd_reference,
                                               layer_norm_cuda,
                                               layer_norm_reference)
from deepspeed_tpu_torch.ops.sparse_attention import block_sparse_flash as bsf

from .test_torch_checkpoint import (_conf, _jax_engine, _port_engine,
                                    _port_params, _steps)
from .test_torch_normalize import _bwd_inputs, ln_kernels  # noqa: F401
from .test_torch_training import _assert_trees_close, _ids, _jax_params

# the module (ops/__init__.py exports the function under the same name)
fa = importlib.import_module("deepspeed_tpu_torch.ops.flash_attention")

STEPS = 8
# (name, fp16 block): the dynamic scaler from a scale at which the first
# steps overflow, with two and with four tolerated overflows, the doubling
# after a window of 2 clean steps, and the static scale
FP16_ROWS = {
    "dynamic": {"enabled": True, "initial_scale_power": 24},
    "hysteresis": {"enabled": True, "initial_scale_power": 24,
                   "hysteresis": 4},
    "window": {"enabled": True, "initial_scale_power": 8,
               "loss_scale_window": 2},
    "static": {"enabled": True, "loss_scale": 128},
}


def _fp16_conf(block):
    return _conf(8, fp16=block)


def _jax_fp16_conf(block):
    return _conf(1, fp16=block)


def _scaler(eng):
    """(scale, good steps, hysteresis) of either engine's scaler."""
    s = eng.scaler_state
    return (float(s.loss_scale), int(s.good_steps), int(s.hysteresis))


def _trajectory(eng, ids, n):
    """Per step: the loss, the scaler after it, skipped_steps."""
    out = []
    for loss in (_steps(eng, ids, 1)[0] for _ in range(n)):
        out.append((loss, _scaler(eng), eng.skipped_steps))
    return out


def _jax_run(tree, block, ids, bf16):
    jeng = _jax_engine(tree, _jax_fp16_conf(block), bf16=bf16)
    traj = _trajectory(jeng, jax.numpy.asarray(ids), STEPS)
    return jeng, traj


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("row", list(FP16_ROWS))
def test_fp16_trajectory_matches_jax(row, bf16):
    """8 steps of both engines from the same weights on one fixed batch
    [8, 16], AdamW, ZeRO-2, dropout 0 (the JAX engine at micro-batch 1 on
    the conftest's 8-device mesh, the port at one rank): the loss scale,
    the good-step count, the hysteresis and skipped_steps equal after every
    step; the losses within rtol 1e-4 (fp32 model) or 2e-2 (bf16 model,
    the default); the final parameters within 1e-4 (fp32) or 5e-2 (bf16)
    of each leaf's largest entry, the key third of attn_qkvb left out as
    in tests/test_torch_training.py (its true gradient is zero)."""
    block = FP16_ROWS[row]
    _, tree = _jax_params(bf16)
    ids = _ids(8, 16, seed=3)
    jeng, ref = _jax_run(tree, block, ids, bf16)
    ref_params = jax.tree.map(np.asarray, jeng.params)
    eng = _port_engine(tree, _fp16_conf(block), bf16=bf16)
    assert eng.compute_dtype == torch.float16
    assert eng.dynamic_loss_scale() == (row != "static")
    out = _trajectory(eng, torch.from_numpy(ids), STEPS)
    assert [o[1:] for o in out] == [r[1:] for r in ref]
    tol = 2e-2 if bf16 else 1e-4
    np.testing.assert_allclose([o[0] for o in out], [r[0] for r in ref],
                               rtol=tol)
    if row in ("dynamic", "hysteresis"):
        assert out[-1][2] > 0, "no step overflowed"
    if row == "window":
        assert out[-1][1][0] > 2.0 ** 8, "the scale never doubled"
    params = _port_params(eng)
    hid = eng.module.config.hidden_size
    for tree_ in (params, ref_params):
        qkvb = tree_["h"]["attn_qkvb"]
        tree_["h"]["attn_qkvb"] = np.concatenate(
            [qkvb[:, :hid], qkvb[:, 2 * hid:]], axis=1)
    _assert_trees_close(params, ref_params, 0.0, 5e-2 if bf16 else 1e-4)


def test_a_skipped_step_leaves_params_and_optimizer_state_bitwise():
    """Under the dynamic scaler an overflowing step changes nothing but the
    scaler and skipped_steps: the flat master, Adam's moments and its count
    stay bitwise, and the LR scheduler does not advance."""
    _, tree = _jax_params(False)
    conf = dict(_fp16_conf(FP16_ROWS["dynamic"]),
                scheduler={"type": "WarmupLR",
                           "params": {"warmup_num_steps": 4}})
    eng = _port_engine(tree, conf)
    ids = torch.from_numpy(_ids(8, 16, seed=3))
    before = (eng._flat.clone(),
              {k: v.clone() for k, v in eng.opt_state.items()},
              eng.lr_scheduler.state_dict())
    _steps(eng, ids, 1)
    assert eng.overflow and eng.skipped_steps == 1
    assert torch.equal(eng._flat, before[0])
    for k, v in eng.opt_state.items():
        assert torch.equal(v, before[1][k]), k
    assert eng.lr_scheduler.state_dict() == before[2]


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_fp16_checkpoint_crosses_and_the_scale_goes_on(tmp_path, direction):
    """An fp16 run saved after 3 steps by one package and loaded by the
    other: the scale, the good-step count, the hysteresis and skipped_steps
    load as saved, and 4 more steps continue the uninterrupted run's scale
    trajectory exactly (its losses at rtol 1e-4, fp32 model)."""
    block = dict(FP16_ROWS["dynamic"], loss_scale_window=3)
    _, tree = _jax_params(False)
    ids = _ids(8, 16, seed=3)
    jeng = _jax_engine(tree, _jax_fp16_conf(block))
    whole = _trajectory(jeng, jax.numpy.asarray(ids), 7)
    port = _port_engine(tree, _fp16_conf(block))
    if direction == "port_to_jax":
        _trajectory(port, torch.from_numpy(ids), 3)
        port.save_checkpoint(str(tmp_path), tag="t3")
        other = _jax_engine(tree, _jax_fp16_conf(block))
        other.load_checkpoint(str(tmp_path), tag="t3")
        rest = _trajectory(other, jax.numpy.asarray(ids), 4)
    else:
        jsave = _jax_engine(tree, _jax_fp16_conf(block))
        _trajectory(jsave, jax.numpy.asarray(ids), 3)
        jsave.save_checkpoint(str(tmp_path), tag="t3")
        port.load_checkpoint(str(tmp_path), tag="t3")
        other = port
        rest = _trajectory(other, torch.from_numpy(ids), 4)
    assert [r[1:] for r in rest] == [w[1:] for w in whole[3:]]
    np.testing.assert_allclose([r[0] for r in rest],
                               [w[0] for w in whole[3:]], rtol=1e-4)


# ---------------------------------------------------------------------- #
# kernels A and D: fp16 gamma and beta; every other kernel refuses fp16
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float32])
def test_ln_wrappers_pass_fp16_gamma_and_beta_as_they_are(ln_kernels, xdt):
    """Kernel A's and D's wrappers hand the launch an fp16 gamma's and
    beta's own memory with the fp16 code, make no cast, copy or fill on the
    way, and D returns dgamma and dbeta in fp16; the results are the plain
    twins' (gamma read in fp32, the sums rounded once into fp16)."""
    x, g, b, dy = (torch.from_numpy(t) for t in _bwd_inputs((8, 768),
                                                             seed=21))
    x, dy = x.to(xdt), dy.to(xdt)
    g, b = g.to(torch.float16), b.to(torch.float16)
    ln_kernels.made.clear()
    out = layer_norm_cuda(x, g, b)
    dx, dg, db = layer_norm_bwd_cuda(x, g, dy)
    assert ln_kernels.made == []
    fwd, bwd = ln_kernels.calls
    assert (fwd["gamma"], fwd["beta"], bwd["gamma"]) == (
        g.data_ptr(), b.data_ptr(), g.data_ptr())
    assert fwd["pcode"] == bwd["pcode"] == op_builder.DTYPE_FP16
    assert dg.dtype == db.dtype == torch.float16 and dx.dtype == xdt
    assert torch.equal(out, layer_norm_reference(x, g, b))
    ref = layer_norm_bwd_reference(x, g, dy)
    assert torch.equal(dx, ref[0])
    assert torch.equal(dg, ref[1].half()) and torch.equal(db, ref[2].half())


def test_fused_layer_norm_returns_fp16_param_grads(ln_kernels):
    """fused_layer_norm's autograd with bf16 x and fp16 gamma / beta (an
    fp16 run's layer): one launch each way with the fp16 code, no cast or
    fill, and the parameter grads come back in fp16, as the JAX op's
    dgamma.astype(gamma.dtype)."""
    x, g, b, dy = (torch.from_numpy(t) for t in _bwd_inputs((4, 6, 768),
                                                             seed=22))
    xt = x.to(torch.bfloat16).requires_grad_()
    gt, bt = (t.half().requires_grad_() for t in (g, b))
    dy = dy.to(torch.bfloat16)
    ln_kernels.made.clear()
    nz.fused_layer_norm(xt, gt, bt).backward(dy)
    assert ln_kernels.made == []
    assert [(c["fn"], c["pcode"]) for c in ln_kernels.calls] == [
        ("fwd", op_builder.DTYPE_FP16), ("bwd", op_builder.DTYPE_FP16)]
    assert gt.grad.dtype == bt.grad.dtype == torch.float16


def test_ln_refuses_an_fp16_activation(ln_kernels):
    """The fp16 code is for gamma and beta only: an fp16 x raises the same
    TypeError as before, forward and backward."""
    x, g, b, dy = (torch.from_numpy(t).half()
                   for t in _bwd_inputs((8, 64), seed=23))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        layer_norm_cuda(x, g, b)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        layer_norm_bwd_cuda(x, g, dy)
    assert ln_kernels.calls == []


def _on_card(monkeypatch, *modules):
    for mod in modules:
        for name, stub in (("check_cuda", lambda name, *t: 0),
                           ("stream_handle", lambda index: 0)):
            monkeypatch.setattr(mod, name, stub, raising=False)

    def no_library():
        raise AssertionError("an fp16 operand reached a launch")
    monkeypatch.setattr(op_builder, "load", no_library)


def test_every_other_kernel_refuses_fp16(monkeypatch):
    """Kernels B, C, E, F and G (and with them every other wrapper, which
    reads its dtype code through dispatch.kernel_dtype_code) raise
    TypeError for fp16 operands before anything is launched."""
    _on_card(monkeypatch, fa, quant, bsf)
    q = torch.randn(1, 2, 64, 64).half()
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.flash_attention_cuda(q, q, q, causal=True)
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.flash_attention_bwd_dq_cuda(q, q, q, q, lse, lse, causal=True)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.flash_attention_bwd_dkdv_cuda(q, q, q, q, lse, lse, causal=True)
    w = quant.QuantizedWeight(torch.zeros(64, 64, dtype=torch.int8),
                              torch.ones(1, 1))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        quant.fused_dequant_matmul(torch.randn(8, 64).half(), w)
    idx = torch.zeros(1, 2, 1, 1, dtype=torch.int32)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        bsf.block_sparse_flash_fwd_cuda(q, q, q, idx, idx, 64, causal=True)
    from deepspeed_tpu_torch.ops import dispatch
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        dispatch.kernel_dtype_code(q)
