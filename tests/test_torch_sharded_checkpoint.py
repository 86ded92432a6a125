"""The sharded checkpoint layout in the port
(deepspeed_tpu_torch/runtime/sharded_checkpoint.py and the engine's
`_sharded_checkpoints`, `_save_sharded`, `_load_sharded`) against the JAX
package: the unit cases of tests/unit/test_sharded_checkpoint.py on the
port (a round trip under another cut, bf16, consolidation), the JAX
engine's files at one process and W = 4 ranks at stages 1, 2 and 3 file
for file, resumes across the packages in both directions, loads at
another world or stage (bitwise), the atomic staging directory and its
manifest, and the offload tier's state.  The tiny GPT-2 of
tests/test_torch_zero3.py at 4 layers, fp32, AdamW; the JAX engine on four
of the conftest's simulated devices, the port's ranks on the CPU."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models import GPT2Model as JaxGPT2Model
from deepspeed_tpu.runtime import sharded_checkpoint as jsc
from deepspeed_tpu_torch.models import GPT2Config
from deepspeed_tpu_torch.models.convert import (_named_shapes,
                                                gpt2_tree_from_flat)
from deepspeed_tpu_torch.runtime import sharded_checkpoint as sc
from deepspeed_tpu_torch.runtime.resilience import atomic as patomic
from deepspeed_tpu_torch.runtime.resilience import verify_manifest
from deepspeed_tpu_torch.runtime.sharded_checkpoint import Sliced

from .test_torch_zero3 import SMALL, assert_params_close
from .test_torch_zero3_checkpoint import (PER_LAYER, _tree, params_of,
                                          port_engine, steps)

LAYERS, WORLD = 4, 4
SAVED_STEPS, RESUMED_STEPS = 2, 2
STAGE3 = {"stage": 3, "stage3_param_persistence_threshold": 0,
          "stage3_max_live_parameters": 2 * PER_LAYER,
          "stage3_prefetch_bucket_size": 2 * PER_LAYER,
          "stage3_prefetch_mode": "carried"}
SHARDED = {"sharded": True}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's CPU work, as
    tests/test_torch_zero3.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_registries():
    dst.reset_mesh_context()
    ds.reset_mesh_context()
    yield
    dst.reset_mesh_context()
    ds.reset_mesh_context()


def _zero(stage):
    return dict(STAGE3) if stage == 3 else {"stage": stage}


def _jax(stage, **extra):
    """The JAX engine of tests/test_torch_zero3_checkpoint.py `jax_engine`
    at W = 4 with `extra` config blocks."""
    from .test_torch_zero3_checkpoint import _conf
    _jax_mesh(WORLD)
    model = JaxGPT2Model(JaxGPT2Config(num_layers=LAYERS, bf16=False,
                                       **SMALL))
    return ds.initialize(model=model, config=_conf(_zero(stage), 8 // WORLD,
                                                   **extra),
                         model_parameters=_tree(LAYERS))[0]


def _jax_mesh(n):
    ds.reset_mesh_context()
    return ds.initialize_mesh(data=n, devices=jax.devices()[:n])


def _files(tag_dir):
    """{file name: {key: array}} of a sharded tag's shard files, and its
    index files parsed."""
    out = {}
    for name in sorted(os.listdir(tag_dir)):
        path = os.path.join(tag_dir, name)
        if name.endswith(".npz"):
            with np.load(path) as z:
                out[name] = {k: z[k] for k in z.files}
        elif name.endswith("_index.json"):
            with open(path) as f:
                out[name] = json.load(f)
    return out


def _assert_same_layout(got, want, exact):
    """The same files, keys, shapes and dtypes, and index files; arrays
    bitwise (`exact`) or within 1e-5 of themselves plus 1e-3 of their
    largest entry (the key third of attn_qkvb left out: rounding noise
    that Adam turns into updates of order lr)."""
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        out = got[name]
        if name.endswith(".json"):
            assert out == ref, name
            continue
        assert sorted(out) == sorted(ref), name
        for key, r in ref.items():
            o = out[key]
            assert o.shape == r.shape and o.dtype == r.dtype, key
            if exact or not (np.issubdtype(r.dtype, np.floating) and r.ndim):
                np.testing.assert_array_equal(o, r, err_msg=key)
                continue
            if "['attn_qkvb']" in key:
                hid = SMALL["hidden_size"]
                lo, hi = (int(v) for v in key.rsplit("|", 1)[1].split(
                    ",")[1].split(":"))
                keep = [c - lo for c in range(lo, hi)
                        if not hid <= c < 2 * hid]
                o, r = o[:, keep], r[:, keep]
            np.testing.assert_allclose(o, r, rtol=1e-5,
                                       atol=1e-3 * np.abs(r).max(),
                                       err_msg=key)


def _whole_state(eng):
    """The port engine's whole masters and Adam moments (host fp32) and
    its count."""
    n = eng.num_params
    if eng._zero3:
        full = {k: eng._whole_flat([s[k] for s in eng.opt_states])
                for k in ("mu", "nu")}
        flat = eng._whole_flat(eng._flats)
    else:
        full = {k: eng._gathered(k)[:n] for k in ("mu", "nu")}
        flat = eng._flats[0][:n].detach().cpu().numpy().copy()
    return {"flat": flat, **full, "count": int(eng.opt_state["count"])}


def _assert_state_equal(got, want):
    for key in ("flat", "mu", "nu"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["count"] == want["count"]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """By stage: each package's engine at W = 4 after SAVED_STEPS steps,
    saved sharded, then RESUMED_STEPS more: (tag dir, losses after the
    save, final parameters, the state at the save for the port)."""
    root = tmp_path_factory.mktemp("sharded")
    cache = {}

    def get(side, stage):
        if (side, stage) in cache:
            return cache[side, stage]
        path = str(root / f"{side}{stage}")
        eng = (_jax(stage, checkpoint=SHARDED) if side == "jax" else
               port_engine(_zero(stage), WORLD, LAYERS, checkpoint=SHARDED))
        steps(eng, SAVED_STEPS)
        tag_dir = eng.save_checkpoint(path, tag="t")
        state = None if side == "jax" else _whole_state(eng)
        losses = steps(eng, RESUMED_STEPS)
        cache[side, stage] = (tag_dir, losses, params_of(eng), state)
        ds.reset_mesh_context()
        dst.reset_mesh_context()
        return cache[side, stage]
    return get


# ---------------------------------------------------------------------- #
# the unit cases of tests/unit/test_sharded_checkpoint.py
# ---------------------------------------------------------------------- #
def _row_blocks(arr, n):
    c = arr.shape[0] // n
    return [(((i * c, (i + 1) * c),) + tuple((0, d) for d in arr.shape[1:]),
             arr[i * c:(i + 1) * c]) for i in range(n)]


def test_round_trip_under_another_cut(tmp_path):
    """Blocks written under one cut reassemble exactly under another: the
    port's 8 row blocks of a [64, 6] leaf (and a host leaf written whole)
    read back as 4 blocks and whole, by the port and by the JAX loader on
    a 4-device mesh; the JAX writer's blocks read back by the port under
    a 2-way cut."""
    x = np.arange(64 * 6, dtype=np.float32).reshape(64, 6)
    sc.save_sharded(str(tmp_path / "p"), "model", {
        "w": Sliced(x.shape, "float32", _row_blocks(x, 8)),
        "b": np.arange(3)})
    with np.load(tmp_path / "p" / "model_shards_p00000.npz") as z:
        assert sorted(z.files) == sorted(
            ["['b']|:"] + [f"['w']|{i * 8}:{(i + 1) * 8},0:6"
                           for i in range(8)])
    out = sc.load_sharded(str(tmp_path / "p"), "model", {
        "w": Sliced(x.shape, "float32", [(r, None) for r, _ in
                                         _row_blocks(x, 4)]),
        "b": np.zeros(3, np.int64)})
    for (region, got), (_, want) in zip(out["w"].slices, _row_blocks(x, 4)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(out["b"], np.arange(3))
    whole = sc.load_sharded(str(tmp_path / "p"), "model",
                            {"w": torch.zeros(64, 6), "b": np.zeros(3)})
    assert torch.equal(whole["w"], torch.from_numpy(x))
    mesh4 = _jax_mesh(4)
    tmpl = {"w": jax.device_put(jnp.zeros((64, 6)),
                                NamedSharding(mesh4.mesh, P("data", None))),
            "b": np.zeros(3, np.int64)}
    ref = jsc.load_sharded(str(tmp_path / "p"), "model", tmpl)
    np.testing.assert_array_equal(np.asarray(ref["w"]), x)
    np.testing.assert_array_equal(ref["b"], np.arange(3))
    mesh8 = _jax_mesh(8)
    xs = jax.device_put(jnp.asarray(x),
                        NamedSharding(mesh8.mesh, P("data", None)))
    jsc.save_sharded(str(tmp_path / "j"), "model", {"w": xs,
                                                    "b": np.arange(3)})
    out = sc.load_sharded(str(tmp_path / "j"), "model", {
        "w": Sliced(x.shape, "float32", [(r, None) for r, _ in
                                         _row_blocks(x, 2)]),
        "b": np.zeros(3, np.int64)})
    for (_, got), (_, want) in zip(out["w"].slices, _row_blocks(x, 2)):
        np.testing.assert_array_equal(got, want)


def test_bfloat16_round_trip(tmp_path):
    """A bf16 leaf is stored as the JAX writer stores it (2-byte void
    items, "bfloat16" in the index): the port's save reads back bitwise in
    the port and in the JAX loader, the JAX save in the port, and the
    consolidation upcasts to fp32."""
    vals = torch.arange(32 * 4, dtype=torch.float32).reshape(32, 4) / 7
    x = vals.to(torch.bfloat16)
    blocks = [(r, x[a[0]:a[1]]) for (r, _), a in zip(
        _row_blocks(np.zeros((32, 4)), 8),
        [(i * 4, (i + 1) * 4) for i in range(8)])]
    sc.save_sharded(str(tmp_path / "p"), "model",
                    {"w": Sliced(x.shape, "bfloat16", blocks)})
    with open(tmp_path / "p" / "model_index.json") as f:
        assert json.load(f) == {"['w']": {"shape": [32, 4],
                                          "dtype": "bfloat16"}}
    out = sc.load_sharded(str(tmp_path / "p"), "model",
                          {"w": torch.zeros(32, 4, dtype=torch.bfloat16)})
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16), x.view(torch.int16))
    mesh8 = _jax_mesh(8)
    tmpl = {"w": jax.device_put(jnp.zeros((32, 4), jnp.bfloat16),
                                NamedSharding(mesh8.mesh, P("data", None)))}
    ref = jsc.load_sharded(str(tmp_path / "p"), "model", tmpl)
    np.testing.assert_array_equal(
        np.asarray(ref["w"]).view(np.uint16),
        x.view(torch.int16).numpy().view(np.uint16))
    jx = jax.device_put(jnp.asarray(vals.numpy(), jnp.bfloat16),
                        NamedSharding(mesh8.mesh, P("data", None)))
    jsc.save_sharded(str(tmp_path / "j"), "model", {"w": jx})
    back = sc.load_sharded(str(tmp_path / "j"), "model",
                           {"w": torch.zeros(32, 4, dtype=torch.bfloat16)})
    assert torch.equal(back["w"].view(torch.int16), x.view(torch.int16))
    for side in ("p", "j"):
        cons = sc.consolidate_sharded_to_fp32(str(tmp_path / side))
        assert cons["['w']"].dtype == np.float32
        np.testing.assert_array_equal(cons["['w']"], x.float().numpy())


def test_missing_shard_file_is_reported(tmp_path):
    """Two processes' files: the union covers the leaf and reads back; a
    missing file leaves a region uncovered, which the reader reports."""
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    blocks = _row_blocks(x, 4)
    for proc in (0, 1):
        sc.save_sharded(str(tmp_path), "model", {"w": Sliced(
            x.shape, "float32", blocks[2 * proc:2 * proc + 2])}, proc)
    np.testing.assert_array_equal(
        sc.load_sharded(str(tmp_path), "model", {"w": np.zeros((16, 3))})
        ["w"], x)
    os.remove(tmp_path / "model_shards_p00001.npz")
    with pytest.raises(ValueError, match="do not cover"):
        sc.load_sharded(str(tmp_path), "model", {"w": np.zeros((16, 3))})


@pytest.mark.parametrize("world,lo,hi", [(4, 0, 37), (4, 91, 300),
                                          (2, 150, 151), (3, 0, None)])
def test_flat_plan_indices_take_and_place_agree(world, lo, hi):
    """FlatPlan at stages 1-2: a stacked leaf, a leaf cut along its second
    dimension, a whole one and a scalar laid out flat; each writer's
    indices in [lo, hi) are those of its slices, cut from the whole buffer
    (`take`), that fall in the range, and `place` of the indexed elements
    gives `take`'s slices."""
    leaves = [sc.FlatLeaf("h.w", (2, 6, 6), 2, (0, 36), True),
              sc.FlatLeaf("wte", (9, 12), 1, (72,), False),
              sc.FlatLeaf("ln.b", (5,), None, (180,), False),
              sc.FlatLeaf("s", (), None, (185,), False)]
    grid = np.arange(186, dtype=np.float32)
    plan = sc.FlatPlan(leaves, world)
    for index in range(world):
        whole = index == 0
        taken = plan.take(grid, [index], whole)
        flat = np.concatenate([arr.ravel() for name in taken
                               for _, arr in taken[name].slices])
        assert np.array_equal(plan.indices([index], whole), flat)
        end = grid.size if hi is None else hi
        mine = flat[(flat >= lo) & (flat < end)]
        assert np.array_equal(plan.indices([index], whole, lo, hi), mine)
        placed = plan.place(grid[plan.indices([index], whole)], [index],
                            whole)
        for name in taken:
            assert [(r, a.tolist()) for r, a in placed[name].slices] == \
                [(r, a.tolist()) for r, a in taken[name].slices]
        assert [r for r, _ in taken["h.w"].slices] == [
            ((0, 2), (0, 6), (index * (6 // world), (index + 1)
                              * (6 // world)))]


@pytest.mark.parametrize("stage", [2, 3])
def test_consolidation_equals_the_masters(saved, stage):
    """consolidate_sharded_to_fp32 of an engine's save at W = 4 holds the
    engine's masters at the save, leaf for leaf, and equals the JAX
    function's consolidation of the same files."""
    tag_dir, _, _, state = saved("port", stage)
    out = sc.consolidate_sharded_to_fp32(tag_dir)
    ref = jsc.consolidate_sharded_to_fp32(tag_dir)
    assert sorted(out) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(out[key], ref[key])
    cfg = GPT2Config(num_layers=LAYERS, bf16=False, **SMALL)
    masters = sc.leaf_paths({"module": gpt2_tree_from_flat(
        state["flat"], _named_shapes(cfg), cfg)})
    assert sorted(masters) == sorted(out)
    for key, arr in masters.items():
        np.testing.assert_array_equal(out[key], arr)


# ---------------------------------------------------------------------- #
# the JAX engine's files, and resumes across the packages
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_sharded_files_match_the_jax_engine(saved, tmp_path, stage):
    """At one process and W = 4 (the leaves cut along the dimension
    zero_partition_spec picks: the parameters at stage 3, the optimizer's
    parameter-shaped leaves from stage 1; attn_qkvb [4, 96] along its
    layers), the port's save after the same steps holds the JAX engine's
    files: names, keys, shapes, dtypes and index files, the arrays within
    the fp32 trajectory tolerance.  The port loading the JAX save and
    saving again writes the JAX files bit for bit."""
    jax_dir = saved("jax", stage)[0]
    port_dir = saved("port", stage)[0]
    want = _files(jax_dir)
    assert sorted(want) == ["model_index.json", "model_shards_p00000.npz",
                            "optim_index.json", "optim_shards_p00000.npz"]
    _assert_same_layout(_files(port_dir), want, exact=False)
    if stage == 3:
        assert "['module']['h']['attn_qkvb']|0:1,0:96" in \
            want["model_shards_p00000.npz"]
    eng = port_engine(_zero(stage), WORLD, LAYERS,
                      tree=_tree(LAYERS), checkpoint=SHARDED)
    eng.load_checkpoint(os.path.dirname(jax_dir), tag="t")
    again = eng.save_checkpoint(str(tmp_path), tag="t")
    _assert_same_layout(_files(again), want, exact=True)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_resume_across_the_packages(saved, stage):
    """Each package resumes the other's sharded save: RESUMED_STEPS steps
    after the load follow the saving package's own continuation (losses
    rtol 1e-5, parameters tests/test_torch_zero3.py's fp32 rule)."""
    jax_dir, jax_losses, jax_params, _ = saved("jax", stage)
    port_dir, port_losses, port_params, _ = saved("port", stage)
    eng = port_engine(_zero(stage), WORLD, LAYERS, checkpoint=SHARDED,
                      tree=jax.tree.map(np.zeros_like, _tree(LAYERS)))
    eng.load_checkpoint(os.path.dirname(jax_dir))
    np.testing.assert_allclose(steps(eng, RESUMED_STEPS), jax_losses,
                               rtol=1e-5)
    assert_params_close(params_of(eng), jax_params, 1e-5, 1e-3)
    dst.reset_mesh_context()
    jeng = _jax(stage)
    jeng.load_checkpoint(os.path.dirname(port_dir))
    np.testing.assert_allclose(steps(jeng, RESUMED_STEPS), port_losses,
                               rtol=1e-5)
    assert_params_close(params_of(jeng), port_params, 1e-5, 1e-3)


@pytest.mark.parametrize("saved_stage,stage,world", [
    (3, 2, 1), (3, 2, 2), (3, 3, 2), (3, 1, 4), (2, 3, 2), (2, 2, 1)])
def test_load_at_another_world_or_stage_is_bitwise(saved, saved_stage,
                                                   stage, world):
    """A rank reads the regions its pieces or its range touch: the port's
    W = 4 save loads at W 1 and 2 and at another stage with the masters,
    Adam's moments and the count bitwise the saved ones."""
    tag_dir, _, _, state = saved("port", saved_stage)
    eng = port_engine(_zero(stage), world, LAYERS, checkpoint=SHARDED,
                      tree=jax.tree.map(np.zeros_like, _tree(LAYERS)))
    eng.load_checkpoint(os.path.dirname(tag_dir))
    _assert_state_equal(_whole_state(eng), state)


def test_atomic_save_stages_and_commits_with_a_manifest(tmp_path,
                                                        monkeypatch):
    """Under resilience.atomic_checkpoints a sharded save stages into the
    JAX engine's deterministic `<tag>.tmp.g<global_steps>`, sweeps an
    orphan staging dir first, and commits with a manifest that verifies;
    the committed files are the JAX engine's atomic save's; a verified
    load takes it back bitwise."""
    res = {"resilience": {"enabled": True, "atomic_checkpoints": True,
                          "verify_on_load": True}}
    staged = []
    commit = patomic.commit_tag_dir

    def spy(save_dir, tag, tmp_dir):
        staged.append((os.path.basename(tmp_dir), sorted(os.listdir(
            tmp_dir))))
        return commit(save_dir, tag, tmp_dir)
    monkeypatch.setattr(patomic, "commit_tag_dir", spy)
    orphan = tmp_path / "port" / "old.tmp.dead"
    orphan.mkdir(parents=True)
    eng = port_engine(_zero(2), WORLD, LAYERS, checkpoint=SHARDED, **res)
    steps(eng, 1)
    tag_dir = eng.save_checkpoint(str(tmp_path / "port"), tag="a")
    assert staged == [("a.tmp.g1", [
        "ds_meta.json", "model_index.json", "model_shards_p00000.npz",
        "optim_index.json", "optim_shards_p00000.npz"])]
    assert sorted(os.listdir(tmp_path / "port")) == ["a", "latest"]
    assert verify_manifest(tag_dir) == []
    jeng = _jax(2, checkpoint=SHARDED, **res)
    steps(jeng, 1)
    jdir = jeng.save_checkpoint(str(tmp_path / "jax"), tag="a")
    assert sorted(os.listdir(tag_dir)) == sorted(os.listdir(jdir))
    with open(os.path.join(tag_dir, "manifest.json")) as f:
        mine = json.load(f)
    with open(os.path.join(jdir, "manifest.json")) as f:
        ref = json.load(f)
    assert sorted(mine["files"]) == sorted(ref["files"])
    other = port_engine(_zero(2), WORLD, LAYERS, checkpoint=SHARDED,
                        tree=jax.tree.map(np.zeros_like, _tree(LAYERS)),
                        **res)
    other.load_checkpoint(str(tmp_path / "port"))
    _assert_state_equal(_whole_state(other), _whole_state(eng))


def test_offload_tier_state_is_stored_whole(tmp_path):
    """Under offload_optimizer the tier's state is written whole from
    process 0 (host leaves, `<path>|:`), as the JAX engine stores its host
    numpy state: the port's files hold the JAX engine's keys and index
    after the same step, the port reloads the tier's state bitwise and
    each package resumes the other's save (losses rtol 1e-5)."""
    from .test_torch_offload import (_conf, _ids, _jax_engine,
                                     _port_engine, _run)
    from .test_torch_offload import _tree as offload_tree
    model, tree = offload_tree()
    conf = _conf("cpu", checkpoint=SHARDED)
    ids = _ids()
    port = _port_engine(tree, conf)
    jeng = _jax_engine(model, tree, conf)
    _run(port, ids, 1)
    _run(jeng, ids, 1, jax_side=True)
    pdir = port.save_checkpoint(str(tmp_path / "port"), tag="o")
    jdir = jeng.save_checkpoint(str(tmp_path / "jax"), tag="o")
    got, want = _files(pdir), _files(jdir)
    assert sorted(got) == sorted(want)
    for name in want:
        if name.endswith(".json"):
            assert got[name] == want[name], name
        else:
            assert sorted(got[name]) == sorted(want[name]), name
    assert all(k.endswith("|:") for k in want["optim_shards_p00000.npz"])
    again = _port_engine(tree, conf)
    again.load_checkpoint(str(tmp_path / "port"))
    for a, b in zip(sc.leaf_paths(again._offload.tier.state_dict()).items(),
                    sc.leaf_paths(port._offload.tier.state_dict()).items()):
        assert a[0] == b[0]
        np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))
    cont = _run(port, ids, 2)
    jcont = _run(jeng, ids, 2, jax_side=True)
    np.testing.assert_allclose(_run(again, ids, 2), cont, rtol=1e-5)
    jback = _jax_engine(model, tree, conf)
    jback.load_checkpoint(str(tmp_path / "port"))
    np.testing.assert_allclose(_run(jback, ids, 2, jax_side=True), cont,
                               rtol=1e-5)
    pback = _port_engine(tree, conf)
    pback.load_checkpoint(str(tmp_path / "jax"))
    np.testing.assert_allclose(_run(pback, ids, 2), jcont, rtol=1e-5)
