"""ZeRO-Offload on the port's stage-2 engine (offload_optimizer "cpu" and
"nvme": runtime/zero/offload.py, runtime/swap_tensor/optimizer_swapper.py
and the engine's offload step) against the JAX engine with the same
config, on the CPU: the losses and the fp32 master at rtol 1e-5; the NVMe
tier bitwise the host tier; checkpoints that cross between the packages;
a module-only load, an overflow skip, the data-parallel ranks of one
process, and the refusals.  Tiny GPT-2, fp32 unless stated, dropout off,
the JAX engine on one CPU device."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models import GPT2Model as JaxGPT2Model
from deepspeed_tpu_torch.config import DeepSpeedConfig
from deepspeed_tpu_torch.models import (GPT2Config, GPT2Model,
                                        gpt2_params_from_jax)
from deepspeed_tpu_torch.runtime.engine import refuse_unported
from deepspeed_tpu_torch.utils.tree import tree_flatten

TINY = dict(vocab_size=128, n_positions=32, hidden_size=32, num_layers=2,
            num_heads=4, embd_dropout=0.0, attn_dropout=0.0,
            hidden_dropout=0.0)
HID = TINY["hidden_size"]


def _tree(bf16=False):
    model = JaxGPT2Model(JaxGPT2Config(bf16=bf16, **TINY))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda a: (np.asarray(a) + rng.standard_normal(a.shape) * 0.05)
        .astype(np.float32), model.init_params(jax.random.PRNGKey(0)))
    return model, tree


def _ids(seed=1, rows=4):
    return np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], (rows, TINY["n_positions"])).astype(np.int32)


def _conf(device, path=None, gas=1, bf16=False, micro=4, **extra):
    oo = {"device": device}
    if path is not None:
        oo["nvme_path"] = str(path)
    return dict({"train_micro_batch_size_per_gpu": micro,
                 "gradient_accumulation_steps": gas,
                 "optimizer": {"type": "AdamW",
                               "params": {"lr": 1e-3, "weight_decay": 0.1}},
                 "bf16": {"enabled": bf16},
                 "zero_optimization": {"stage": 2, "offload_optimizer": oo},
                 "steps_per_print": 10 ** 9}, **extra)


def _jax_engine(model, tree, conf):
    ds.reset_mesh_context()
    mesh = ds.initialize_mesh(data=1, devices=jax.devices()[:1])
    return ds.initialize(model=model, config=conf, model_parameters=tree,
                         mesh=mesh)[0]


def _port_engine(tree, conf, bf16=False, mesh=None):
    dst.reset_mesh_context()
    cfg = GPT2Config(bf16=bf16, **TINY)
    return dst.initialize(model=GPT2Model(cfg), config=conf, device="cpu",
                          model_parameters=gpt2_params_from_jax(tree, cfg),
                          mesh=mesh)[0]


def _run(engine, ids, steps, jax_side=False):
    out = []
    for _ in range(steps):
        x = jnp.asarray(ids) if jax_side else torch.from_numpy(ids)
        loss = engine.forward(x)
        engine.backward(loss)
        engine.step()
        out.append(float(loss) if jax_side else loss.item())
    return out


def _without_key_bias(tree):
    """The key third of attn_qkvb left out: its true gradient is zero, so
    its grads are rounding noise that Adam's normalised step turns into
    updates of order lr (tests/test_torch_training.py)."""
    tree = jax.tree.map(np.asarray, tree)
    qkvb = tree["h"]["attn_qkvb"]
    tree["h"]["attn_qkvb"] = np.concatenate([qkvb[:, :HID],
                                             qkvb[:, 2 * HID:]], axis=1)
    return tree


def _assert_master_close(out, ref, tol=1e-5):
    """Leaf by leaf: |out - ref| <= tol |ref| + tol max|ref|."""
    paths = jax.tree_util.tree_flatten_with_path(_without_key_bias(ref))[0]
    got = jax.tree_util.tree_leaves(_without_key_bias(out))
    assert len(got) == len(paths)
    for (path, r), o in zip(paths, got):
        np.testing.assert_allclose(o, r, rtol=tol,
                                   atol=tol * np.abs(r).max(),
                                   err_msg=jax.tree_util.keystr(path))


def _tier_bits(engine):
    """The tier's master and moments by JAX leaf, as raw bytes."""
    tier = engine.optimizer
    sd = tier.state_dict()
    n = len(tier.leaf_map.leaves)
    if "exp_avg" in sd:
        rows = [(tier.leaf_map.tree_leaf(sd["params"], k),
                 sd["exp_avg"][str(k)], sd["exp_avg_sq"][str(k)])
                for k in range(n)]
    else:
        rows = [tuple(sd[f"leaf{k}_{kind}"] for kind in
                      ("param", "exp_avg", "exp_avg_sq")) for k in range(n)]
    return [np.asarray(x).tobytes() for row in rows for x in row]


@pytest.mark.parametrize("device,gas", [("cpu", 1), ("nvme", 1), ("cpu", 2)])
def test_trajectory_matches_the_jax_engine(tmp_path, device, gas):
    """4 micro-steps (gas 1: 4 steps; gas 2: 2) of AdamW lr 1e-3 wd 0.1
    through both packages' offload tier: the losses at rtol 1e-5, the fp32
    master within 1e-5 of each leaf's largest entry."""
    model, tree = _tree()
    ids = _ids()
    jeng = _jax_engine(model, tree, _conf(device, tmp_path / "jax", gas))
    ref = _run(jeng, ids, 4, jax_side=True)
    ref_master = jax.tree.map(np.asarray, jeng.optimizer.master_params)
    ds.reset_mesh_context()
    eng = _port_engine(tree, _conf(device, tmp_path / "port", gas))
    out = _run(eng, ids, 4)
    assert eng.global_steps == 4 // gas == eng.optimizer.step_count()
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    _assert_master_close(eng.optimizer.master_params, ref_master)
    if device == "nvme":
        # the tiers' files are the same: the port's read back in the JAX
        # tier's layout name for name
        names = sorted(p.name for p in (tmp_path / "port").rglob("*.bin"))
        assert names == sorted(p.name for p in
                               (tmp_path / "jax").rglob("*.bin"))


def test_nvme_tier_equals_cpu_tier_bitwise(tmp_path):
    """bf16 with gradient clipping (the global norm's fixed block sums,
    offload.py `square_sums`), 3 steps: the NVMe tier's losses, device
    parameters, master and moments equal the host tier's bit for bit."""
    _, tree = _tree(bf16=True)
    ids = _ids()
    runs = {}
    for device in ("cpu", "nvme"):
        eng = _port_engine(tree, _conf(device, tmp_path, bf16=True,
                                       gradient_clipping=0.05), bf16=True)
        runs[device] = (_run(eng, ids, 3), eng._flats[0].clone(),
                        _tier_bits(eng))
    assert runs["cpu"][0] == runs["nvme"][0]
    assert torch.equal(runs["cpu"][1], runs["nvme"][1])
    assert runs["cpu"][2] == runs["nvme"][2]


@pytest.mark.parametrize("bf16", [False, True])
def test_checkpoints_cross_between_the_packages(tmp_path, bf16):
    """A port save after 2 steps loads in the JAX engine and a JAX save in
    the port (bf16: the JAX module tree holds bf16 arrays), each with its
    host tier's state; the next step agrees with the saving engine's at
    rtol 1e-5 (fp32) or 2e-2 (bf16)."""
    model, tree = _tree(bf16)
    ids = _ids()
    tol = 2e-2 if bf16 else 1e-5
    port = _port_engine(tree, _conf("cpu", bf16=bf16), bf16=bf16)
    _run(port, ids, 2)
    port.save_checkpoint(str(tmp_path / "p"), tag="t")
    jeng = _jax_engine(model, tree, _conf("cpu", bf16=bf16))
    _run(jeng, ids, 2, jax_side=True)
    jeng.save_checkpoint(str(tmp_path / "j"), tag="t")
    # each loads the other's save and steps once; so does the saver
    jeng.load_checkpoint(str(tmp_path / "p"), tag="t")
    assert jeng.optimizer.step_count() == 2
    j_next = _run(jeng, ids, 1, jax_side=True)
    ds.reset_mesh_context()
    p_next = _run(port, ids, 1)
    np.testing.assert_allclose(j_next, p_next, rtol=tol)
    _assert_master_close(jax.tree.map(np.asarray,
                                      jeng.optimizer.master_params),
                         port.optimizer.master_params, tol)
    fresh = _port_engine(tree, _conf("cpu", bf16=bf16), bf16=bf16)
    fresh.load_checkpoint(str(tmp_path / "j"), tag="t")
    assert fresh.optimizer.step_count() == 2 and fresh.global_steps == 2
    np.testing.assert_allclose(_run(fresh, ids, 1), p_next, rtol=tol)


def test_module_only_load_and_overflow_skip(tmp_path):
    """A module-only load puts the checkpoint's weights into the device
    parameters and the host master, moments and count untouched; a
    non-finite grad skips the step: master, moments, count and device
    parameters as they were, `overflow` set; the next step applies."""
    _, tree = _tree()
    ids = _ids()
    saver = _port_engine(tree, _conf("cpu"))
    _run(saver, ids, 2)
    saver.save_checkpoint(str(tmp_path), tag="t")
    eng = _port_engine(tree, _conf("cpu"))
    eng.load_checkpoint(str(tmp_path), tag="t", load_module_only=True)
    assert eng.optimizer.step_count() == 0
    want = tree_flatten(saver.optimizer.master_params)[0]
    got = tree_flatten(eng.optimizer.master_params)[0]
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert torch.equal(eng._flats[0], saver._flats[0])
    assert not eng.optimizer.exp_avg.any()
    before = (_tier_bits(eng), eng._flats[0].clone())
    loss = eng.forward(torch.from_numpy(ids))
    eng.backward(loss * float("nan"))
    eng.step()
    assert eng.overflow and not eng.was_step_applied()
    assert _tier_bits(eng) == before[0]
    assert torch.equal(eng._flats[0], before[1])
    assert eng.optimizer.step_count() == 0 and eng.global_steps == 1
    _run(eng, ids, 1)
    assert not eng.overflow and eng.optimizer.step_count() == 1


def test_data_parallel_ranks_of_one_process():
    """data = 2 ranks of one process: the ranks' reduced grads go to one
    host tier and the new parameters back to both ranks; the trajectory
    equals one rank's on the same global batch at rtol 1e-5."""
    _, tree = _tree()
    ids = _ids(rows=8)
    one = _port_engine(tree, _conf("cpu", micro=8))
    ref = _run(one, ids, 3)
    two = _port_engine(tree, _conf("cpu", micro=4, mesh={"data": 2}))
    assert two.world_size == 2
    np.testing.assert_allclose(_run(two, ids, 3), ref, rtol=1e-5)
    assert torch.equal(two._flats[0], two._flats[1])
    _assert_master_close(two.optimizer.master_params,
                         one.optimizer.master_params)


def test_refusals_and_the_fused_fallback():
    """A client optimizer is refused as in the JAX engine; the tier at
    stage 3 under a process group is refused with ZeRO-3 there, naming
    ROADMAP.md A.4c (under a process group at stages 1-2, at stage 3 over
    several ranks and with the sentinel the tier runs:
    tests/test_torch_offload_dp.py); offload_param is the streaming
    engine's; fused_step falls back to the modular loop with its
    reason."""
    from deepspeed_tpu_torch.runtime.optimizers import build_optimizer
    _, tree = _tree()
    dst.reset_mesh_context()
    with pytest.raises(ValueError, match="client optimizer"):
        dst.initialize(model=GPT2Model(GPT2Config(bf16=False, **TINY)),
                       config=_conf("cpu"), device="cpu",
                       optimizer=build_optimizer("adam", {}))
    model = GPT2Model(GPT2Config(bf16=False, **TINY))
    flat = {a: 1 for a in ("pipe", "data", "expert", "seq", "model")}
    grouped = types.SimpleNamespace(axis_sizes=dict(flat, data=2),
                                    process_group=object(),
                                    axis_size=lambda a: 2 if a == "data"
                                    else 1)
    conf = dict(_conf("cpu", micro=2), zero_optimization={
        "stage": 3, "offload_optimizer": {"device": "cpu"}})
    with pytest.raises(NotImplementedError, match=r"A\.4c"):
        refuse_unported(DeepSpeedConfig(conf, world_size=2), model, grouped)
    for conf in (dict(_conf("cpu", micro=2), zero_optimization={
            "stage": 2, "offload_optimizer": {"device": "cpu"}}),
            dict(_conf("cpu"), resilience={"sentinel": {"enabled": True}})):
        refuse_unported(DeepSpeedConfig(conf, world_size=2), model, grouped)
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    dst.reset_mesh_context()
    with pytest.raises(ValueError, match="ZeroInfinityEngine"):
        DeepSpeedEngine(model=model, device="cpu", config=dict(
            _conf("cpu"), zero_optimization={
                "stage": 3, "offload_param": {"device": "cpu"}}))
    eng = _port_engine(tree, dict(_conf("cpu"),
                                  fused_step={"enabled": True}))
    assert eng._fused is None and "offload" in eng.fused_step_reason
