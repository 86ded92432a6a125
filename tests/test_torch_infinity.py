"""ZeRO-Infinity's layer-streaming engine in the port
(runtime/zero/infinity.py over models/gpt2.py's layerwise_api and
runtime/swap_tensor/partitioned_param_swapper.py) against the JAX
package's ZeroInfinityEngine on the CPU: parameters on the host and on
NVMe (files), 4 steps and gas 2, the losses at rtol 1e-5 and the master
at rtol 1e-5 plus 1e-4 of each leaf's largest entry (the reason in
_assert_master_close); prefetch depth 2 against 0 bit
for bit (dropout on); the legacy cpu_offload_params key; a checkpoint
round trip; a truncated group file and a crash in the middle of a swap
write fail loudly; layerwise_api's split and join against the JAX
split.  Tiny GPT-2 (4 layers), fp32 unless stated."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models import GPT2Model as JaxGPT2Model
from deepspeed_tpu_torch.models import (GPT2Config, GPT2Model,
                                        gpt2_params_from_jax)
from deepspeed_tpu_torch.runtime.swap_tensor.aio_handle import AsyncIOHandle
from deepspeed_tpu_torch.runtime.swap_tensor.partitioned_param_swapper import (
    PartitionedParamSwapper)
from deepspeed_tpu_torch.runtime.zero.infinity import (ZeroInfinityEngine,
                                                       load_sweep_ceiling)
from deepspeed_tpu_torch.utils.tree import tree_flatten

TINY = dict(vocab_size=128, n_positions=32, hidden_size=32, num_layers=4,
            num_heads=4, embd_dropout=0.0, attn_dropout=0.0,
            hidden_dropout=0.0)
HID = TINY["hidden_size"]
DROPOUT = dict(embd_dropout=0.1, attn_dropout=0.1, hidden_dropout=0.1)


def _tree():
    model = JaxGPT2Model(JaxGPT2Config(bf16=False, **TINY))
    return model, jax.tree.map(np.asarray,
                               model.init_params(jax.random.PRNGKey(0)))


def _ids():
    return np.random.default_rng(5).integers(
        0, TINY["vocab_size"], (4, TINY["n_positions"])).astype(np.int32)


def _conf(path, params="cpu", optimizer=None, depth=2, gas=1, bf16=False,
          **zero):
    zo = {"stage": 3, "offload_param": {
        "device": params, "nvme_path": str(path), "buffer_count": 2,
        "prefetch_depth": depth}, **zero}
    if optimizer is not None:
        zo["offload_optimizer"] = {"device": optimizer,
                                   "nvme_path": str(path)}
    return {"train_micro_batch_size_per_gpu": 4,
            "gradient_accumulation_steps": gas,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            "bf16": {"enabled": bf16}, "zero_optimization": zo,
            "steps_per_print": 10 ** 9}


def _port(tree, conf, **cfg):
    dst.reset_mesh_context()
    config = GPT2Config(**dict(TINY, bf16=conf["bf16"]["enabled"], **cfg))
    return dst.initialize(model=GPT2Model(config), config=conf, device="cpu",
                          model_parameters=gpt2_params_from_jax(
                              tree, config))[0]


def _run(engine, steps, jax_side=False):
    out = []
    for _ in range(steps):
        ids = jnp.asarray(_ids()) if jax_side else torch.from_numpy(_ids())
        loss = engine.forward(ids)
        engine.backward(loss)
        engine.step()
        out.append(float(loss))
    return out


def _assert_master_close(out, ref, rtol=1e-5, atol_rel=1e-4):
    """Leaf by leaf: |out - ref| <= rtol |ref| + atol_rel max|ref|, the key
    third of attn_qkvb left out (its grads are rounding noise:
    tests/test_torch_training.py).  atol_rel is 1e-4: the streamed grads
    sum in another order (a layer's recomputed backward at a time, the tied
    wte's two parts on the host), and Adam's normalised step turns that
    noise in a near-zero grad into a visible share of a small bias's
    update (the JAX package's own Infinity-against-resident test allows
    2e-5 absolute)."""
    def cut(tree):
        tree = jax.tree.map(np.asarray, tree)
        b = tree["h"]["attn_qkvb"]
        tree["h"]["attn_qkvb"] = np.concatenate([b[:, :HID], b[:, 2 * HID:]],
                                                axis=1)
        return tree
    for o, r in zip(jax.tree.leaves(cut(out)), jax.tree.leaves(cut(ref))):
        np.testing.assert_allclose(o, r, rtol=rtol,
                                   atol=atol_rel * np.abs(r).max())


@pytest.mark.parametrize("params,optimizer,gas", [
    ("cpu", None, 1), ("nvme", "nvme", 1), ("cpu", None, 2)])
def test_streaming_matches_the_jax_engine(tmp_path, params, optimizer, gas):
    """4 micro-steps through both packages' streaming engines: losses at
    rtol 1e-5, the fp32 master as _assert_master_close holds it, at
    most two groups on the device; the group files are the JAX engine's
    (same names, same bytes before the first step)."""
    model, tree = _tree()
    ds.reset_mesh_context()
    mesh = ds.initialize_mesh(data=1, devices=jax.devices()[:1])
    jeng = ds.initialize(model=model, config=_conf(tmp_path / "jax", params,
                                                   optimizer, gas=gas),
                         model_parameters=tree, mesh=mesh)[0]
    if params == "nvme":
        jfiles = {p.name: p.read_bytes() for p in
                  (tmp_path / "jax" / "zero_stage_3" / "params").iterdir()}
    ref = _run(jeng, 4, jax_side=True)
    ref_master = jeng.optimizer.master_params
    ds.reset_mesh_context()
    eng = _port(tree, _conf(tmp_path / "port", params, optimizer, gas=gas))
    assert isinstance(eng, ZeroInfinityEngine)
    if params == "nvme":
        pdir = tmp_path / "port" / "zero_stage_3" / "params"
        assert {p.name: p.read_bytes() for p in pdir.iterdir()} == jfiles
    out = _run(eng, 4)
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    _assert_master_close(eng.optimizer.master_params, ref_master)
    assert eng.global_steps == 4 // gas and eng.micro_steps == 4
    assert eng.max_live_param_groups <= 2
    mem = eng.estimate_memory()
    assert mem["hbm_param_window"] < mem["host_or_nvme_params"]


def test_prefetch_depths_equal_bitwise_with_dropout(tmp_path):
    """Dropout 0.1 everywhere, parameters and optimizer in files: depth 2
    (reads issued ahead, carried across the sweeps) and depth 0 give the
    same losses and master bit for bit; depth 2 hides most read bytes
    under compute and reports no serialized swap-in, depth 0 reads every
    group where it is used."""
    _, tree = _tree()
    runs = {}
    for depth in (2, 0):
        eng = _port(tree, _conf(tmp_path / f"d{depth}", "nvme", "nvme",
                                depth=depth), **DROPOUT)
        losses = _run(eng, 3)
        runs[depth] = (losses, [np.asarray(x) for x in tree_flatten(
            eng.optimizer.master_params)[0]], eng.swap_stats())
    assert runs[2][0] == runs[0][0]
    assert all(np.array_equal(a, b) for a, b in zip(runs[2][1], runs[0][1]))
    assert runs[2][2]["prefetch_depth"] == 2 and \
        runs[0][2]["prefetch_depth"] == 0
    assert runs[2][2]["read_bytes"] == runs[0][2]["read_bytes"] > 0
    assert runs[2][2]["overlap_fraction"] > runs[0][2]["overlap_fraction"]


def test_legacy_cpu_offload_params_key_dispatches(tmp_path):
    """The flat cpu_offload_params key reaches the streaming engine as the
    offload_param block does."""
    _, tree = _tree()
    conf = _conf(tmp_path)
    conf["zero_optimization"] = {"stage": 3, "cpu_offload_params": True}
    eng = _port(tree, conf)
    assert isinstance(eng, ZeroInfinityEngine) and not eng._use_nvme_params
    _run(eng, 1)
    assert eng.global_steps == 1


def test_checkpoint_round_trip(tmp_path):
    """Saved after 2 steps (parameters and optimizer in files, dropout on),
    loaded into a new engine: the master and the next 2 steps' losses
    equal the saving engine's bit for bit."""
    _, tree = _tree()
    a = _port(tree, _conf(tmp_path / "a", "nvme", "nvme"), **DROPOUT)
    _run(a, 2)
    a.save_checkpoint(str(tmp_path / "ckpt"), tag="t")
    cont = _run(a, 2)
    b = _port(tree, _conf(tmp_path / "b", "nvme", "nvme"), **DROPOUT)
    b.load_checkpoint(str(tmp_path / "ckpt"), tag="t")
    assert b.global_steps == 2
    assert _run(b, 2) == cont
    for x, y in zip(tree_flatten(a.module_state_dict())[0],
                    tree_flatten(b.module_state_dict())[0]):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_truncated_group_file_fails_loudly(tmp_path):
    """A group file truncated under the engine raises OSError at the next
    swap-in instead of training on stale bytes."""
    _, tree = _tree()
    eng = _port(tree, _conf(tmp_path, "nvme"))
    _run(eng, 1)
    victim = tmp_path / "zero_stage_3" / "params" / "param_group_layer2.bin"
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    with pytest.raises(OSError):
        _run(eng, 2)


def test_crash_mid_swap_write_fails_loudly(tmp_path, monkeypatch):
    """A write-back that dies half way through a group file (its write
    cut after half the bytes) raises out of step(), and the torn file then
    refuses to be read."""
    _, tree = _tree()
    eng = _port(tree, _conf(tmp_path, "nvme"))
    handle = eng._swapper.write_handle
    real, plain = handle.pwrite, AsyncIOHandle(backend="python")

    def torn(buffer, path, async_op=False):
        if path.endswith("param_group_layer1.bin"):
            raw = buffer.reshape(-1).view(torch.uint8)
            plain.pwrite(raw[:raw.numel() // 2], path)
            raise OSError(5, "injected crash mid write")
        return real(buffer, path, async_op)

    monkeypatch.setattr(handle, "pwrite", torn)
    loss = eng.forward(torch.from_numpy(_ids()))
    eng.backward(loss)
    with pytest.raises(OSError, match="injected"):
        eng.step()
    monkeypatch.setattr(handle, "pwrite", real)
    with pytest.raises(OSError):
        _run(eng, 2)


def test_layerwise_split_and_join_against_the_jax_split():
    """The port's split of a state dict equals the JAX split of the same
    weights group by group, key by key; join (and join_consuming, which
    empties its input) gives the state dict back."""
    jmodel, tree = _tree()
    jgroups = jmodel.layerwise_api()["split"](tree)
    cfg = GPT2Config(bf16=False, **TINY)
    model = GPT2Model(cfg)
    state = gpt2_params_from_jax(tree, cfg)
    api = model.layerwise_api()
    groups = api["split"](state)
    assert list(groups) == list(jgroups) and api["num_layers"] == 4
    for name in groups:
        ours, treedef = tree_flatten(groups[name])
        paths = jax.tree_util.tree_flatten_with_path(jgroups[name])[0]
        assert len(ours) == len(paths)
        for o, (_, ref) in zip(ours, paths):
            assert np.array_equal(o.numpy(), np.asarray(ref))
    joined = api["join"](groups)
    assert list(joined) == list(state)
    assert all(torch.equal(joined[k], state[k]) for k in state)
    consumed = api["join_consuming"](groups)
    assert all(v is None for v in groups.values())
    assert all(torch.equal(consumed[k], state[k]) for k in state)


def test_swapper_write_during_a_pending_read_and_the_sweep_ceiling(
        tmp_path, monkeypatch):
    """write() to a group whose read is in flight completes the read first,
    then the window and the file hold the new bytes; the sweep ceiling
    comes only from DS_AIO_SWEEP_RESULTS (None when unset)."""
    g = torch.Generator().manual_seed(0)
    groups = {"a": {"w": torch.randn(64, 64, generator=g)},
              "b": {"w": torch.randn(64, 64, generator=g)}}
    sw = PartitionedParamSwapper(str(tmp_path), groups, buffer_count=2)
    for name, tree in groups.items():
        sw.write(name, tree)
    sw.prefetch("a")
    new = {"w": torch.randn(64, 64, generator=g)}
    sw.write("a", new, async_op=True)
    sw.flush_writes()
    assert torch.equal(sw.get("a")["w"], new["w"])
    sw.release("a")
    assert torch.equal(sw.get("a")["w"], new["w"])
    monkeypatch.delenv("DS_AIO_SWEEP_RESULTS", raising=False)
    assert load_sweep_ceiling("batched") is None
    art = tmp_path / "sweep.txt"
    art.write_text('{"metric": "aio_best_config", "ceilings": {"batched": '
                   '{"read_gbps": 2.5, "write_gbps": 1.5}}}\n')
    monkeypatch.setenv("DS_AIO_SWEEP_RESULTS", str(art))
    assert load_sweep_ceiling("batched") == {"read_gbps": 2.5,
                                             "write_gbps": 1.5}
    assert load_sweep_ceiling("io_uring") is None


def test_the_monitor_swap_lanes(tmp_path, monkeypatch):
    """With the monitor on, the streaming engine feeds the swap lanes the
    JAX engine feeds: every step record carries its swap stats, the trace
    holds the groups' swap-in spans and the write-back swap-out spans,
    and a read rate far below the sweep ceiling that DS_AIO_SWEEP_RESULTS
    names raises reconciliation's swap_below_ceiling_band flag."""
    import json
    art = tmp_path / "sweep.txt"
    art.write_text('{"metric": "aio_best_config", "ceilings": {"%s": '
                   '{"read_gbps": 1e6, "write_gbps": 1e6}}}\n'
                   % AsyncIOHandle().backend_name)
    monkeypatch.setenv("DS_AIO_SWEEP_RESULTS", str(art))
    _, tree = _tree()
    conf = dict(_conf(tmp_path / "swap", "nvme", "nvme"), monitor={
        "enabled": True, "output_path": str(tmp_path / "mon"),
        "writers": ["jsonl"], "trace": True, "write_interval": 3})
    eng = _port(tree, conf)
    assert eng.sweep_ceiling == {"read_gbps": 1e6, "write_gbps": 1e6}
    _run(eng, 3)
    eng.monitor.close()
    out = tmp_path / "mon"
    recs = [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in recs if r.get("kind") == "step"]
    assert len(steps) == 3 and all(
        r.get("swap_read_gbps", 0) > 0 for r in steps), steps
    recon = [r for r in recs if r.get("kind") == "reconcile"]
    assert recon and "swap_below_ceiling_band" in recon[-1]["flags"]
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    cats = {e.get("cat") for e in events}
    assert {"swap_in", "swap_out"} <= cats, cats
