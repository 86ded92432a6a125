"""Checkpoints of the port's training engine in the JAX package's layout
(deepspeed_tpu_torch.runtime.checkpoint, runtime/resilience/, the engine's
save_checkpoint / load_checkpoint, init_inference(checkpoint=)) against the
JAX engine's, file by file and step by step, at the tiny GPT-2 of
tests/test_torch_training.py.  The JAX engine runs on the conftest's
8-device CPU mesh at micro-batch 1 and the port on the CPU at one rank and
micro-batch 8 (the same global batch), or at W ranks on the CPU."""

import json
import os

import numpy as np
import pytest

import jax
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models import GPT2Model as JaxGPT2Model
from deepspeed_tpu.parallel import reset_mesh_context as jax_reset_mesh
from deepspeed_tpu.runtime import checkpoint as jax_ckpt
from deepspeed_tpu.runtime.resilience import atomic as jax_atomic
from deepspeed_tpu.runtime.resilience import recovery as jax_recovery
from deepspeed_tpu_torch.models import (GPT2Config, GPT2Model,
                                        gpt2_params_from_jax,
                                        gpt2_params_to_jax)
from deepspeed_tpu_torch.runtime import checkpoint as ckpt
from deepspeed_tpu_torch.runtime.engine import TORCH_RNG_KEY
from deepspeed_tpu_torch.runtime.resilience import (cleanup_tmp_dirs,
                                                    gc_checkpoints, list_tags,
                                                    resolve_intact_tag,
                                                    retry_io, tag_problems,
                                                    verify_manifest)

from .test_torch_training import TINY, _ids, _jax_params

MODEL_FILE = "mp_rank_00_model_states.npz"
OPTIM_FILE = "zero_pp_rank_0_mp_rank_00_optim_states.npz"
ADAMW = {"optimizer": {"type": "AdamW",
                       "params": {"lr": 1e-3, "weight_decay": 0.1}}}
WARMUP = {"scheduler": {"type": "WarmupLR",
                        "params": {"warmup_num_steps": 4}}}
# the rows of the optimizer-state layout: each a different optax chain in
# the JAX package (runtime/optimizers.py build_optimizer)
ROWS = {
    "adam": {"optimizer": {"type": "Adam", "params": {"lr": 1e-3}}},
    "adam_l2": {"optimizer": {"type": "Adam", "params": {
        "lr": 1e-3, "weight_decay": 0.1, "adam_w_mode": False}}},
    "adam_decoupled": {"optimizer": {"type": "Adam", "params": {
        "lr": 1e-3, "weight_decay": 0.1}}},
    "adamw_clip": dict(ADAMW, gradient_clipping=0.5),
    "adamw_warmup": dict(ADAMW, **WARMUP),
    "lamb": {"optimizer": {"type": "Lamb", "params": {
        "lr": 1e-2, "weight_decay": 0.01}}},
    "sgd": {"optimizer": {"type": "SGD", "params": {"lr": 1e-2}}},
}
JAX_RNG_KEYS = {"engine_rng", "engine_rng_impl"}


@pytest.fixture(autouse=True)
def _fresh_registries():
    dst.reset_mesh_context()
    jax_reset_mesh()
    yield
    dst.reset_mesh_context()
    jax_reset_mesh()


def _conf(micro, bf16=False, opt=ADAMW, **extra):
    return {"train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": 1, "bf16": {"enabled": bf16},
            "zero_optimization": {"stage": 2}, "steps_per_print": 10 ** 9,
            **opt, **extra}


def _jax_engine(tree, conf, bf16=False):
    jmodel, _ = _jax_params(bf16)
    jax_reset_mesh()
    return ds.initialize(model=jmodel, config=conf, model_parameters=tree)[0]


def _port_engine(tree, conf, bf16=False, dropout=0.0):
    dst.reset_mesh_context()
    cfg = GPT2Config(bf16=bf16, **dict(TINY, embd_dropout=dropout,
                                       attn_dropout=dropout,
                                       hidden_dropout=dropout))
    return dst.initialize(model=GPT2Model(cfg), config=conf, device="cpu",
                          model_parameters=gpt2_params_from_jax(tree, cfg))[0]


def _steps(eng, ids, n):
    """n forward / backward / step calls of either engine; the losses."""
    out = []
    for _ in range(n):
        loss = eng.forward(ids)
        eng.backward(loss)
        eng.step()
        out.append(float(loss.detach() if isinstance(loss, torch.Tensor)
                         else loss))
    return out


def _port_params(eng):
    return gpt2_params_to_jax(dict(eng.module.named_parameters()),
                              eng.module.config)


def _read(path, tag):
    d = os.path.join(path, tag)
    files = {}
    for name in (MODEL_FILE, OPTIM_FILE):
        with np.load(os.path.join(d, name)) as z:
            files[name] = {k: z[k] for k in z.files}
    with open(os.path.join(d, "ds_meta.json")) as f:
        files["client_state"] = json.load(f)["client_state"]
    return files


def _drop_key_bias(key, arr):
    """The key third of attn_qkvb (and of its moments) left out: its true
    gradient is zero, so its grads are rounding noise that Adam turns into
    updates of order lr (test_torch_training.py
    test_engine_trajectory_matches_jax)."""
    if key.endswith("['attn_qkvb']"):
        hid = TINY["hidden_size"]
        return np.concatenate([arr[:, :hid], arr[:, 2 * hid:]], axis=1)
    return arr


def _assert_arrays_close(out, ref, atol_rel):
    """Same keys, shapes and dtypes; each float array within atol_rel of
    its largest entry, the key bias left out; other arrays equal."""
    assert sorted(out) == sorted(ref)
    for key in ref:
        o, r = out[key], ref[key]
        assert o.shape == r.shape and o.dtype == r.dtype, key
        if np.issubdtype(r.dtype, np.floating) and r.ndim:
            o, r = _drop_key_bias(key, o), _drop_key_bias(key, r)
            np.testing.assert_allclose(o, r, rtol=0,
                                       atol=atol_rel * np.abs(r).max(),
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(o, r, err_msg=key)


def _assert_trees_within(out, ref, atol_rel):
    _assert_arrays_close(ckpt.flatten(out),
                         ckpt.flatten(jax.tree.map(np.asarray, ref)),
                         atol_rel)


# ---------------------------------------------------------------------- #
# the layout, file by file, for every optax chain
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("row", sorted(ROWS))
def test_layout_matches_the_jax_engine(tmp_path, row):
    """The same weights, 2 steps on both engines, then a save: the same
    file names, .npz key sets, shapes and dtypes, the same client-state
    keys (each engine's generator key aside), the arrays within 1e-4 of
    each leaf's largest entry (the key bias left out)."""
    _, tree = _jax_params(False)
    ids = _ids(8, 16, seed=3)
    jeng = _jax_engine(tree, _conf(1, opt=ROWS[row]))
    _steps(jeng, ids, 2)
    jeng.save_checkpoint(str(tmp_path / "jax"), tag="t")
    eng = _port_engine(tree, _conf(8, opt=ROWS[row]))
    _steps(eng, ids, 2)
    eng.save_checkpoint(str(tmp_path / "port"), tag="t")
    for side in ("jax", "port"):
        assert sorted(os.listdir(tmp_path / side)) == ["latest", "t"]
        assert sorted(os.listdir(tmp_path / side / "t")) == sorted(
            [MODEL_FILE, OPTIM_FILE, "ds_meta.json"])
    ref, out = _read(tmp_path / "jax", "t"), _read(tmp_path / "port", "t")
    for name in (MODEL_FILE, OPTIM_FILE):
        _assert_arrays_close(out[name], ref[name], 1e-4)
    client, ref_client = out["client_state"], ref["client_state"]
    assert set(client) - {TORCH_RNG_KEY} == set(ref_client) - JAX_RNG_KEYS
    for key in ("global_steps", "micro_steps", "skipped_steps",
                "lr_scheduler", "quantizer", "curriculum"):
        assert client[key] == ref_client[key], key
    topo, ref_topo = (c["partition_topology"] for c in (client, ref_client))
    assert set(topo) == set(ref_topo) and topo["layout"] == "consolidated"


# ---------------------------------------------------------------------- #
# a run moves between the packages
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_across_the_packages(tmp_path, writer, bf16):
    """One engine takes 3 steps from the shared weights, saves, and takes
    3 more; the other package's engine, built from other weights, loads
    the files (strictly) and takes the same 3 steps.  Losses rtol 1e-4 and
    parameters within 1e-4 of each leaf's largest entry in fp32; 2e-2 and
    5e-2 in bf16 (test_engine_trajectory_matches_jax's tolerances)."""
    _, tree = _jax_params(bf16)
    _, other = _jax_params(bf16, seed=7)
    ids = _ids(8, 16, seed=3)
    make = {"jax": lambda t: _jax_engine(t, _conf(1, bf16), bf16),
            "port": lambda t: _port_engine(t, _conf(8, bf16), bf16)}
    params = {"jax": lambda e: e.params, "port": _port_params}
    reader = "port" if writer == "jax" else "jax"
    first = make[writer](tree)
    _steps(first, ids, 3)
    first.save_checkpoint(str(tmp_path), tag="mid")
    ref = _steps(first, ids, 3)
    ref_params = params[writer](first)
    second = make[reader](other)
    path, client = second.load_checkpoint(str(tmp_path))
    assert path.endswith("mid") and client["global_steps"] == 3
    assert second.global_steps == 3
    out = _steps(second, ids, 3)
    loss_tol, param_tol = (2e-2, 5e-2) if bf16 else (1e-4, 1e-4)
    np.testing.assert_allclose(out, ref, rtol=loss_tol)
    _assert_trees_within(jax.tree.map(np.asarray, params[reader](second)),
                         ref_params, param_tol)


def test_resume_is_bitwise_with_dropout(tmp_path):
    """3 steps, save, 3 more; a fresh engine from other weights loads and
    takes the same 3 steps: losses and parameters equal bitwise, dropout
    0.1 on (the generators are restored).  Mirrors JAX
    test_checkpointing.py::test_resume_is_bit_exact_with_dropout."""
    _, tree = _jax_params(False)
    _, other = _jax_params(False, seed=9)
    ids = _ids(8, 16, seed=4)
    first = _port_engine(tree, _conf(8, opt=ROWS["adam"]), dropout=0.1)
    _steps(first, ids, 3)
    first.save_checkpoint(str(tmp_path), tag="mid")
    cont = _steps(first, ids, 3)
    second = _port_engine(other, _conf(8, opt=ROWS["adam"]), dropout=0.1)
    second.load_checkpoint(str(tmp_path), tag="mid")
    resumed = _steps(second, ids, 3)
    assert resumed == cont, (resumed, cont)
    assert torch.equal(second._flat, first._flat)
    for key in ("mu", "nu", "count"):
        assert torch.equal(second.opt_state[key], first.opt_state[key])
    # without the generators the draws (and so the losses) differ
    third = _port_engine(other, _conf(8, opt=ROWS["adam"]), dropout=0.1)
    third.load_checkpoint(str(tmp_path), tag="mid")
    third._rngs[0].manual_seed(1234)
    assert _steps(third, ids, 3) != cont


# ---------------------------------------------------------------------- #
# a load at another data-parallel world
# ---------------------------------------------------------------------- #
def _full_state(eng):
    n = eng.num_params
    return {"params": eng._flat[:n].clone(),
            **{k: torch.from_numpy(eng._gathered(k)[:n].copy())
               for k in ("mu", "nu")},
            "count": eng.opt_state["count"].clone()}


@pytest.mark.parametrize("stage", [1, 2])
def test_save_at_three_ranks_loads_at_one_and_four(tmp_path, stage):
    """The port at W = 3 takes 2 steps, saves and takes 2 more.  Loads at
    W = 1 and W = 4 hold the same full parameters and optimizer state
    bitwise, and their next 2 steps match W = 3's within 1e-4 of each
    leaf's largest entry (the ranks' sums run in another order).  The JAX
    engine at data 8 loads the file too.  Mirrors JAX
    test_checkpointing.py::test_zero_resharding_on_load."""
    _, tree = _jax_params(False)
    ids = _ids(12, 16, seed=5)
    conf = lambda world: _conf(12 // world, mesh={"data": world},  # noqa: E731
                               zero_optimization={"stage": stage})
    first = _port_engine(tree, conf(3))
    assert first.world_size == 3
    _steps(first, ids, 2)
    first.save_checkpoint(str(tmp_path), tag="w3")
    saved = _full_state(first)
    saved_tree = _port_params(first)
    ref = _steps(first, ids, 2)
    for world in (1, 4):
        _, other = _jax_params(False, seed=world)
        eng = _port_engine(other, conf(world))
        assert eng.world_size == world
        eng.load_checkpoint(str(tmp_path))
        for key, value in _full_state(eng).items():
            assert torch.equal(value, saved[key]), (world, key)
        for flat in eng._flats[1:]:
            assert torch.equal(flat, eng._flat)
        np.testing.assert_allclose(_steps(eng, ids, 2), ref, rtol=1e-4)
        _assert_trees_within(_port_params(eng), _port_params(first), 1e-4)
    jeng = _jax_engine(tree, _conf(1, zero_optimization={"stage": stage}))
    jeng.load_checkpoint(str(tmp_path), tag="w3")
    _assert_trees_within(jax.tree.map(np.asarray, jeng.params), saved_tree,
                         0.0)


# ---------------------------------------------------------------------- #
# the entry points
# ---------------------------------------------------------------------- #
def test_load_module_only_optimizer_and_scheduler_switches(tmp_path):
    """AdamW + WarmupLR, 3 steps, saved.  load_module_only: the weights
    and the schedule, no optimizer state, no counters.  Without optimizer
    and schedule states: weights and counters only.  A full load restores
    the moments too.  Mirrors JAX test_checkpointing.py::
    test_load_module_only."""
    _, tree = _jax_params(False)
    ids = _ids(8, 16, seed=3)
    conf = _conf(8, opt=ROWS["adamw_warmup"])
    first = _port_engine(tree, conf)
    _steps(first, ids, 3)
    first.save_checkpoint(str(tmp_path), tag="m")
    _, other = _jax_params(False, seed=2)

    only = _port_engine(other, conf)
    only.load_checkpoint(str(tmp_path), tag="m", load_module_only=True,
                         load_optimizer_states=False)
    assert torch.equal(only._flat, first._flat)
    assert only.global_steps == 0 and int(only.opt_state["count"]) == 0
    assert not only.opt_state["mu"].any()
    assert only.lr_scheduler.last_batch_iteration == \
        first.lr_scheduler.last_batch_iteration == 2

    bare = _port_engine(other, conf)
    bare.load_checkpoint(str(tmp_path), tag="m", load_optimizer_states=False,
                         load_lr_scheduler_states=False)
    assert torch.equal(bare._flat, first._flat) and bare.global_steps == 3
    assert not bare.opt_state["mu"].any()
    assert bare.lr_scheduler.last_batch_iteration == -1

    full = _port_engine(other, conf)
    full.load_checkpoint(str(tmp_path), tag="m")
    for key in ("mu", "nu", "count"):
        assert torch.equal(full.opt_state[key], first.opt_state[key])
    assert full.lr_scheduler.last_batch_iteration == 2


def test_latest_and_explicit_tags(tmp_path):
    """`latest` names the newest save; an explicit tag loads an older one.
    Mirrors JAX test_checkpointing.py::test_latest_tag."""
    _, tree = _jax_params(False)
    ids = _ids(8, 16, seed=3)
    eng = _port_engine(tree, _conf(8))
    _steps(eng, ids, 2)
    eng.save_checkpoint(str(tmp_path))
    _steps(eng, ids, 2)
    eng.save_checkpoint(str(tmp_path))
    assert ckpt.read_latest_tag(str(tmp_path)) == "global_step4"
    assert list_tags(str(tmp_path)) == ["global_step4", "global_step2"]
    path, _ = eng.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step4") and eng.global_steps == 4
    path, client = eng.load_checkpoint(str(tmp_path), tag="global_step2")
    assert path.endswith("global_step2") and eng.global_steps == 2
    assert client["global_steps"] == 2


def test_missing_and_partial_tags_name_the_available_ones(tmp_path):
    """No `latest`, an unknown tag and a tag without its model file each
    raise FileNotFoundError; the last two name the tags that are there.
    Mirrors JAX test_checkpointing.py::test_load_missing_dir."""
    _, tree = _jax_params(False)
    eng = _port_engine(tree, _conf(8))
    with pytest.raises(FileNotFoundError, match="latest"):
        eng.load_checkpoint(str(tmp_path / "nope"))
    eng.save_checkpoint(str(tmp_path), tag="good")
    with pytest.raises(FileNotFoundError, match=r"available tags: \['good'\]"):
        eng.load_checkpoint(str(tmp_path), tag="gone")
    eng.save_checkpoint(str(tmp_path), tag="part")
    os.remove(tmp_path / "part" / MODEL_FILE)
    with pytest.raises(FileNotFoundError, match="partial save"):
        eng.load_checkpoint(str(tmp_path), tag="part")


def test_reserved_tags_and_the_sharded_layout_are_refused(tmp_path):
    """Reserved tags are refused and write nothing.  The sharded layout,
    refused until ROADMAP.md A.5b ported it, now saves: `checkpoint.sharded:
    true` at one rank writes the JAX engine's index and shard files and a
    topology that reads "sharded", and loads back bitwise
    (tests/test_torch_sharded_checkpoint.py holds it against the JAX
    engine)."""
    _, tree = _jax_params(False)
    eng = _port_engine(tree, _conf(8))
    for tag in ("a.tmp.b", "a.old.b"):
        with pytest.raises(ValueError, match="reserved marker"):
            eng.save_checkpoint(str(tmp_path), tag=tag)
    assert not os.listdir(tmp_path)
    sharded = _port_engine(tree, _conf(8, checkpoint={"sharded": True}))
    _steps(sharded, torch.from_numpy(_ids(8, TINY["n_positions"], 3)), 1)
    path = sharded.save_checkpoint(str(tmp_path))
    assert sorted(os.listdir(path)) == [
        "ds_meta.json", "model_index.json", "model_shards_p00000.npz",
        "optim_index.json", "optim_shards_p00000.npz"]
    with open(os.path.join(path, "ds_meta.json")) as f:
        topo = json.load(f)["client_state"]["partition_topology"]
    assert topo["layout"] == "sharded"
    other = _port_engine(_jax_params(False, seed=1)[1],
                         _conf(8, checkpoint={"sharded": True}))
    other.load_checkpoint(str(tmp_path))
    assert torch.equal(other._flat, sharded._flat)
    for key in ("mu", "nu", "count"):
        assert torch.equal(other.opt_state[key], sharded.opt_state[key])


def test_fp16_export_and_consolidation_match_jax(tmp_path):
    """save_fp16_model and consolidate_to_fp32 write what the JAX
    functions write for the same weights: the same keys, bitwise.  Mirrors
    JAX test_checkpointing.py::test_consolidate_to_fp32."""
    _, tree = _jax_params(False)
    jeng = _jax_engine(tree, _conf(1))
    eng = _port_engine(tree, _conf(8))
    out = {}
    for side, e in (("jax", jeng), ("port", eng)):
        path = e.save_fp16_model(str(tmp_path / side))
        with np.load(path) as z:
            fp16 = {k: z[k] for k in z.files}
        e.save_checkpoint(str(tmp_path / side), tag="c")
        out[side] = (fp16, (ckpt if side == "port" else jax_ckpt)
                     .consolidate_to_fp32(str(tmp_path / side)))
    for mine, ref in zip(out["port"], out["jax"]):
        assert sorted(mine) == sorted(ref)
        for key in ref:
            assert mine[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(mine[key], ref[key], err_msg=key)
    assert all(v.dtype == np.float16 for v in out["port"][0].values())
    assert sum(v.size for v in out["port"][1].values()) == eng.num_params


def test_atomic_commit_manifests_pass_both_checks(tmp_path):
    """save_checkpoint_state(atomic=True) of each package writes a
    manifest that the other package's verify_manifest accepts; nothing is
    left under a .tmp. name, and a flipped byte fails both checks."""
    rng = np.random.default_rng(0)
    tree = {"module": {"w": rng.standard_normal((4, 8)).astype(np.float32),
                       "n": np.arange(3, dtype=np.int32)}}
    ckpt.save_checkpoint_state(str(tmp_path / "port"), "a", tree,
                               client_state={"step": np.int64(3)},
                               atomic=True)
    jax_ckpt.save_checkpoint_state(str(tmp_path / "jax"), "a", tree,
                                   client_state={"step": 3}, atomic=True)
    for side in ("port", "jax"):
        d = str(tmp_path / side / "a")
        assert sorted(os.listdir(tmp_path / side)) == ["a", "latest"]
        assert verify_manifest(d) == [] and jax_atomic.verify_manifest(d) == []
        assert tag_problems(str(tmp_path / side), "a") == []
    # a re-save of the same tag renames the old copy aside, then drops it
    ckpt.save_checkpoint_state(str(tmp_path / "port"), "a", tree,
                               client_state={"step": 3}, atomic=True)
    assert sorted(os.listdir(tmp_path / "port")) == ["a", "latest"]
    with open(tmp_path / "port" / "a" / "manifest.json") as f:
        mine = json.load(f)
    with open(tmp_path / "jax" / "a" / "manifest.json") as f:
        ref = json.load(f)
    assert mine == ref
    path = tmp_path / "port" / "a" / MODEL_FILE
    data = bytearray(path.read_bytes())
    data[-1] ^= 0xFF
    path.write_bytes(bytes(data))
    for check in (verify_manifest, jax_atomic.verify_manifest):
        assert check(str(tmp_path / "port" / "a")) == [
            f"CRC32 mismatch {MODEL_FILE}"]


def test_recovery_resolves_and_collects_tags_as_jax_does(tmp_path):
    """Four atomic saves, the newest corrupted, a stale staging dir: both
    packages' resolve_intact_tag fall back to the same intact tag, and
    gc_checkpoints (keep 2, never `latest`) and cleanup_tmp_dirs remove the
    same entries from two copies of the directory."""
    tree = {"module": {"w": np.arange(6, dtype=np.float32)}}
    for side in ("port", "jax"):
        d = str(tmp_path / side)
        for step in range(1, 5):
            ckpt.save_checkpoint_state(d, f"global_step{step}", tree,
                                       atomic=True)
        with open(os.path.join(d, "global_step4", MODEL_FILE), "ab") as f:
            f.write(b"x")
        os.makedirs(os.path.join(d, "global_step5.tmp.dead"))
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    got = resolve_intact_tag(port, None, latest_tag="global_step4")
    assert got == jax_recovery.resolve_intact_tag(ref, None,
                                                  latest_tag="global_step4")
    assert got[0] == "global_step3" and "size mismatch" in got[1][0]
    assert cleanup_tmp_dirs(port) == jax_atomic.cleanup_tmp_dirs(ref) == 1
    assert gc_checkpoints(port, 2, latest_tag="global_step1") == \
        jax_recovery.gc_checkpoints(ref, 2, latest_tag="global_step1") == \
        ["global_step2"]
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    # retry_io: transient OSErrors are retried with backoff, others raise
    calls, waits = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "done"
    assert retry_io(flaky, retries=3, backoff_seconds=0.5,
                    sleep=waits.append) == "done"
    assert waits == [0.5, 1.0]
    with pytest.raises(OSError):
        retry_io(lambda: (_ for _ in ()).throw(OSError("down")), retries=1,
                 sleep=waits.append)


def test_load_module_state_dict_sets_every_rank(tmp_path):
    """load_module_state_dict copies a module state dict into every rank's
    fp32 master (W = 3); strict refuses a missing parameter."""
    _, tree = _jax_params(False)
    _, other = _jax_params(False, seed=5)
    eng = _port_engine(tree, _conf(4, mesh={"data": 3}))
    src = _port_engine(other, _conf(8)).module_state_dict()
    eng.load_module_state_dict(src)
    for flat in eng._flats:
        assert torch.equal(flat, eng._flat)
    for name, p in eng.module.named_parameters():
        assert torch.equal(p, src[name]), name
    del src["wte"]
    with pytest.raises(KeyError, match="wte"):
        eng.load_module_state_dict(src)
    eng.load_module_state_dict(src, strict=False)


def test_template_shapes_and_bf16_leaves_are_checked(tmp_path):
    """A stored array of another shape than the template's raises; a bf16
    tensor is refused rather than written as another dtype; a missing key
    raises when strict and keeps the template's leaf otherwise."""
    tree = {"module": {"w": np.ones((2, 3), np.float32)}}
    ckpt.save_checkpoint_state(str(tmp_path), "s", tree)
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_checkpoint_state(str(tmp_path), "s",
                                   {"module": {"w": np.ones((3, 2),
                                                            np.float32)}})
    extra = {"module": {"w": np.zeros((2, 3), np.float16),
                        "v": np.full(2, 5.0, np.float32)}}
    with pytest.raises(KeyError, match="v"):
        ckpt.load_checkpoint_state(str(tmp_path), "s", extra)
    state, _, _ = ckpt.load_checkpoint_state(str(tmp_path), "s", extra,
                                             strict=False)
    assert state["module"]["w"].dtype == np.float16
    np.testing.assert_array_equal(state["module"]["v"], [5.0, 5.0])
    with pytest.raises(ValueError, match="bfloat16"):
        ckpt.flatten({"w": torch.ones(2, dtype=torch.bfloat16)})


# ---------------------------------------------------------------------- #
# serving from a checkpoint
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """A checkpoint of each package: 2 AdamW steps from the shared
    weights, fp32."""
    root = tmp_path_factory.mktemp("written")
    _, tree = _jax_params(False)
    ids = _ids(8, 16, seed=3)
    dst.reset_mesh_context()
    jax_reset_mesh()
    for side, eng in (("jax", _jax_engine(tree, _conf(1))),
                      ("port", _port_engine(tree, _conf(8)))):
        _steps(eng, ids, 2)
        eng.save_checkpoint(str(root / side))
    jax_reset_mesh()
    return root


PROMPT = np.array([[5, 9, 23, 40], [7, 7, 100, 2]], np.int32)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_serving_from_a_checkpoint_matches_jax(written, writer, mode):
    """init_inference(model, checkpoint=dir) against the JAX
    InferenceEngine(model, checkpoint=dir): bf16 logits within 2e-2
    (the chip lane's bf16 tolerance); int8 weights (quantization_setting
    2, fp32 compute) within rtol 1e-4, atol 1e-5
    (tests/test_torch_inference.py's), and the same greedy tokens.
    model_parameters= wins over checkpoint= (the JAX precedence)."""
    bf16 = mode == "bf16"
    quant = 2 if mode == "int8" else None
    inf = dict(TINY, bf16=bf16)
    path = str(written / writer)
    jeng = ds.init_inference(JaxGPT2Model(JaxGPT2Config(**inf)),
                             checkpoint=path, quantization_setting=quant)
    teng = dst.init_inference(GPT2Model(GPT2Config(**inf)), checkpoint=path,
                              quantization_setting=quant, device="cpu")
    ref = np.asarray(jeng.forward(PROMPT), np.float32)
    out = teng.forward(PROMPT).numpy()
    if bf16:
        np.testing.assert_allclose(out, ref, rtol=2e-2,
                                   atol=2e-2 * np.abs(ref).max())
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(
            teng.generate(PROMPT, max_new_tokens=4).numpy(),
            np.asarray(jeng.generate(PROMPT, max_new_tokens=4)))
    cfg = GPT2Config(**inf)
    _, tree = _jax_params(False, seed=11)
    given = dst.init_inference(GPT2Model(cfg), checkpoint=path,
                               model_parameters=gpt2_params_from_jax(tree,
                                                                     cfg),
                               device="cpu")
    expected = torch.from_numpy(tree["wpe"]).to(cfg.dtype).float()
    assert torch.equal(given.module.wpe.float(), expected)


def test_save_latest_false_moves_latest_as_the_jax_engine_does(tmp_path):
    """A gap of the JAX package kept on purpose (ROADMAP.md C): in the
    consolidated layout save_checkpoint(save_latest=False) still moves
    `latest`, in both packages, so that both write the same files."""
    _, tree = _jax_params(False)
    for side, eng in (("jax", _jax_engine(tree, _conf(1))),
                      ("port", _port_engine(tree, _conf(8)))):
        eng.save_checkpoint(str(tmp_path / side), tag="a")
        eng.save_checkpoint(str(tmp_path / side), tag="b", save_latest=False)
        assert ckpt.read_latest_tag(str(tmp_path / side)) == "b", side
