"""ZeRO-3 checkpoints, zero.Init / GatheredParameters and the fused step
at stage 3 in the port, against the JAX package: a stage-3 save is the
JAX engine's consolidated layout file for file and moves between the
packages and the stages in both directions (JAX
tests/unit/test_checkpointing.py:36 and :88-110 hold the same for the JAX
engine), the API round trip of tests/unit/test_zero_api_utils.py, and gas
2 under fused_step at the config of tests/unit/test_fused_step.py
`test_fused_zero3_streaming_parity`.  The port's ranks lie on the CPU."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models import GPT2Model as JaxGPT2Model
from deepspeed_tpu.parallel import initialize_mesh as jax_initialize_mesh
from deepspeed_tpu.parallel import reset_mesh_context as jax_reset_mesh
from deepspeed_tpu_torch.models import (GPT2Config, GPT2Model,
                                        gpt2_params_from_jax,
                                        gpt2_params_to_jax)
from deepspeed_tpu_torch.parallel import initialize_mesh

from .test_torch_checkpoint import MODEL_FILE, OPTIM_FILE, _read
from .test_torch_zero3 import PER_LAYER, SMALL, _batch, _tree

STAGE3 = {"stage": 3, "stage3_param_persistence_threshold": 0,
          "stage3_max_live_parameters": 2 * PER_LAYER,
          "stage3_prefetch_bucket_size": 2 * PER_LAYER,
          "stage3_prefetch_mode": "carried"}


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
    jax_reset_mesh()
    yield
    dst.reset_mesh_context()
    jax_reset_mesh()


def _conf(zero, micro=2, **extra):
    return {"train_micro_batch_size_per_gpu": micro,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-3, "weight_decay": 0.1}},
            "zero_optimization": zero, "steps_per_print": 10 ** 9, **extra}


def jax_engine(zero, world=4, layers=4):
    jax_reset_mesh()
    jax_initialize_mesh(data=world, devices=jax.devices()[:world])
    model = JaxGPT2Model(JaxGPT2Config(num_layers=layers, bf16=False,
                                       **SMALL))
    return ds.initialize(model=model, config=_conf(zero, 8 // world),
                         model_parameters=_tree(layers))[0]


def port_engine(zero, world=4, layers=4, tree=None, dropout=0.0, **extra):
    dst.reset_mesh_context()
    cfg = GPT2Config(num_layers=layers, bf16=False, **dict(
        SMALL, embd_dropout=dropout, attn_dropout=dropout,
        hidden_dropout=dropout))
    conf = dict(_conf(zero, 8 // world, **extra), mesh={"data": world})
    return dst.initialize(model=GPT2Model(cfg), config=conf, device="cpu",
                          model_parameters=gpt2_params_from_jax(
                              _tree(layers) if tree is None else tree,
                              cfg))[0]


def steps(eng, n):
    ids = _batch()
    ids = torch.from_numpy(ids) if isinstance(eng, dst.runtime.engine
                                              .DeepSpeedEngine) \
        else jnp.asarray(ids)
    out = []
    for _ in range(n):
        loss = eng.forward(ids)
        eng.backward(loss)
        eng.step()
        out.append(float(loss.detach() if isinstance(loss, torch.Tensor)
                         else loss))
    return out


def params_of(eng):
    if isinstance(eng, dst.runtime.engine.DeepSpeedEngine):
        return gpt2_params_to_jax(eng.module_state_dict(), eng.module.config)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), eng.params)


def assert_params_close(out, ref):
    """tests/test_torch_zero3.py's rule for the port against the JAX
    engine in fp32: rtol 1e-5 plus 1e-3 of each leaf's largest entry, the
    key bias left out."""
    from .test_torch_zero3 import assert_params_close as close
    close(out, ref, 1e-5, 1e-3)


def assert_files_close(out, ref):
    """Two consolidated checkpoints' arrays: the same keys, shapes and
    dtypes; each float array within 1e-5 of itself plus 1e-3 of its
    largest entry, the key bias left out; the rest equal."""
    from .test_torch_zero3 import SMALL as small
    assert sorted(out) == sorted(ref)
    for key in ref:
        o, r = out[key], ref[key]
        assert o.shape == r.shape and o.dtype == r.dtype, key
        if not (np.issubdtype(r.dtype, np.floating) and r.ndim):
            np.testing.assert_array_equal(o, r, err_msg=key)
            continue
        if key.endswith("['attn_qkvb']"):
            hid = small["hidden_size"]
            o = np.concatenate([o[:, :hid], o[:, 2 * hid:]], axis=1)
            r = np.concatenate([r[:, :hid], r[:, 2 * hid:]], axis=1)
        np.testing.assert_allclose(o, r, rtol=1e-5,
                                   atol=1e-3 * np.abs(r).max(), err_msg=key)


# ---------------------------------------------------------------------- #
# the layout and the packages
# ---------------------------------------------------------------------- #
def test_stage3_save_matches_the_jax_engine_file_for_file(tmp_path):
    """2 steps at stage 3, W = 4, on both engines, then a save: the same
    files, keys, shapes and dtypes, whole leaves, the arrays within
    `assert_files_close`'s bounds, the topology at stage 3."""
    jeng = jax_engine(STAGE3)
    steps(jeng, 2)
    jeng.save_checkpoint(str(tmp_path / "jax"), tag="t")
    eng = port_engine(STAGE3)
    steps(eng, 2)
    eng.save_checkpoint(str(tmp_path / "port"), tag="t")
    assert sorted(os.listdir(tmp_path / "port" / "t")) == sorted(
        os.listdir(tmp_path / "jax" / "t"))
    ref, out = _read(tmp_path / "jax", "t"), _read(tmp_path / "port", "t")
    for name in (MODEL_FILE, OPTIM_FILE):
        assert_files_close(out[name], ref[name])
    topo = out["client_state"]["partition_topology"]
    ref_topo = ref["client_state"]["partition_topology"]
    for key in ("zero_stage", "zero_world_size", "layout"):
        assert topo[key] == ref_topo[key], key


@pytest.mark.parametrize("stage", [0, 3])
def test_port_stage3_save_resumes_in_the_jax_engine(tmp_path, stage):
    """The port saves after 3 steps at stage 3 and takes 2 more; the JAX
    engine at stage `stage` (world 4) loads the files and takes the same
    2: losses rtol 1e-5, parameters as `assert_params_close`."""
    eng = port_engine(STAGE3)
    steps(eng, 3)
    eng.save_checkpoint(str(tmp_path), tag="mid")
    ref = steps(eng, 2)
    jeng = jax_engine(dict(STAGE3, stage=stage))
    _, client = jeng.load_checkpoint(str(tmp_path), tag="mid")
    assert client["global_steps"] == 3
    out = steps(jeng, 2)
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    assert_params_close(params_of(jeng), params_of(eng))


@pytest.mark.parametrize("stage", [0, 3])
def test_jax_stage3_save_resumes_in_the_port(tmp_path, stage):
    """The reverse: the JAX engine saves at stage 3 after 3 steps and takes
    2 more; the port at stage `stage` (W = 4) loads and takes the same
    2."""
    jeng = jax_engine(STAGE3)
    steps(jeng, 3)
    jeng.save_checkpoint(str(tmp_path), tag="mid")
    ref = steps(jeng, 2)
    eng = port_engine(dict(STAGE3, stage=stage), tree=_tree(4))
    _, client = eng.load_checkpoint(str(tmp_path), tag="mid")
    assert client["global_steps"] == 3 and eng.global_steps == 3
    out = steps(eng, 2)
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    assert_params_close(params_of(eng), params_of(jeng))


def test_stage3_resume_is_bitwise_and_crosses_stages(tmp_path):
    """Dropout 0.1: a stage-3 run saved after 3 steps resumes at stage 3
    bitwise (losses, every rank's pieces and Adam state); a stage-2 engine
    at W = 1 loads the same files with the saved masters and optimizer
    state bit for bit, and a stage-3 engine loads a stage-2 save bit for
    bit."""
    eng = port_engine(STAGE3, dropout=0.1)
    steps(eng, 3)
    eng.save_checkpoint(str(tmp_path), tag="s3")
    saved = eng.module_state_dict()
    saved_mu = eng._gathered("mu").copy()
    cont = steps(eng, 2)
    again = port_engine(STAGE3, dropout=0.1, tree=jax.tree.map(
        np.zeros_like, _tree(4)))
    again.load_checkpoint(str(tmp_path), tag="s3")
    assert steps(again, 2) == cont
    for a, b in zip(again._flats + [s["nu"] for s in again.opt_states],
                    eng._flats + [s["nu"] for s in eng.opt_states]):
        assert torch.equal(a, b)
    one = port_engine({"stage": 2}, world=1, dropout=0.1)
    one.load_checkpoint(str(tmp_path), tag="s3")
    for name, value in one.module_state_dict().items():
        assert torch.equal(value, saved[name]), name
    np.testing.assert_array_equal(one._gathered("mu")[:one.num_params],
                                  saved_mu)
    one.save_checkpoint(str(tmp_path), tag="s2")
    back = port_engine(STAGE3, dropout=0.1)
    back.load_checkpoint(str(tmp_path), tag="s2")
    for name, value in back.module_state_dict().items():
        assert torch.equal(value, saved[name]), name


def test_module_state_dict_and_placeholders(tmp_path):
    """At stage 3 `engine.module` holds empty placeholders;
    `module_state_dict` gives whole leaves, which `load_module_state_dict`
    cuts back into every rank's piece."""
    eng = port_engine(STAGE3)
    whole = eng.module_state_dict()
    for name, p in eng.module.named_parameters():
        assert p.numel() == 0 and tuple(whole[name].shape) == p.ds_shape
    bumped = {k: v + 1 for k, v in whole.items()}
    eng.load_module_state_dict(bumped)
    for name, value in eng.module_state_dict().items():
        assert torch.equal(value, bumped[name])


# ---------------------------------------------------------------------- #
# zero.Init / GatheredParameters
# ---------------------------------------------------------------------- #
def test_init_materializes_pieces_only():
    """Init.materialize: each rank holds only its piece of each leaf (the
    whole leaves the init function made are gone), and the pieces put
    together are the leaves (JAX test_zero_init_materializes_sharded)."""
    mesh = initialize_mesh(data=4, devices=["cpu"])
    made = {}

    def init_fn(gen):
        tree = {"w": torch.randn(64, 32, generator=gen),
                "b": torch.zeros(32)}
        made.update({k: v.clone() for k, v in tree.items()})
        return tree

    with dst.zero.Init(mesh_ctx=mesh) as zinit:
        params = zinit.materialize(init_fn, torch.Generator().manual_seed(0))
    assert [tuple(s.shape) for s in params["w"].shards] == [(16, 32)] * 4
    assert [tuple(s.shape) for s in params["b"].shards] == [(8,)] * 4
    np.testing.assert_array_equal(params["w"].full(), made["w"].numpy())


def test_gathered_parameters_roundtrip_matches_jax():
    """JAX test_gathered_parameters_roundtrip on both packages: gather,
    edit under modifier_rank, re-scatter; the port's doubled pieces put
    together equal the JAX engine's doubled array, cut as the JAX spec
    cuts it."""
    value = np.arange(64, dtype=np.float32).reshape(8, 8)
    jmesh = jax_initialize_mesh(data=4, devices=jax.devices()[:4])
    with ds.zero.Init(stage=3, mesh_ctx=jmesh) as zinit:
        jparams = zinit.shard_existing({"w": value})
    gp = ds.zero.GatheredParameters(jparams, modifier_rank=0)
    with gp as full:
        full["w"][...] = full["w"] * 2
    mesh = initialize_mesh(data=4, devices=["cpu"])
    with dst.zero.Init(mesh_ctx=mesh) as zinit:
        params = zinit.shard_existing({"w": value})
    pgp = dst.zero.GatheredParameters(params, modifier_rank=0)
    with pgp as full:
        assert isinstance(full["w"], np.ndarray)
        full["w"][...] = full["w"] * 2
    np.testing.assert_array_equal(pgp.updated["w"].full(),
                                  np.asarray(gp.updated["w"]))
    dim = [i for i, e in enumerate(gp.updated["w"].sharding.spec)
           if e is not None][0]
    assert pgp.updated["w"].leaf.dim == dim
    with dst.zero.GatheredParameters(params) as full:  # no modifier: kept
        full["w"][...] = 0
    np.testing.assert_array_equal(params["w"].full(), value)


def test_gathered_parameters_on_an_engines_placeholders():
    """Inside GatheredParameters an engine's placeholders hold whole fp32
    values; edits under modifier_rank reach every rank's piece, and the
    placeholders are empty again after."""
    eng = port_engine(STAGE3)
    w = eng.module.wte
    before = eng.module_state_dict()["wte"]
    with dst.zero.GatheredParameters(w, modifier_rank=0):
        assert torch.equal(w.data, before)
        w.data[0].fill_(3.0)
    assert w.numel() == 0
    after = eng.module_state_dict()["wte"]
    assert torch.all(after[0] == 3.0) and torch.equal(after[1:], before[1:])
    with dst.zero.GatheredParameters([w]):
        w.data.zero_()
    assert torch.equal(eng.module_state_dict()["wte"], after)


# ---------------------------------------------------------------------- #
# fused_step at stage 3
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("stream", [
    {"stage3_max_live_parameters": 10 ** 9, "stage3_prefetch_bucket_size": 0,
     "stage3_prefetch_mode": "off"},
    {"stage3_max_live_parameters": 100_000,
     "stage3_prefetch_bucket_size": 100_000,
     "stage3_prefetch_mode": "carried"}], ids=["at_use", "carried"])
def test_fused_zero3_window_matches_modular_and_jax(stream):
    """test_fused_zero3_streaming_parity's config (batch 8, seq 16, gas 2,
    2 steps, 2 layers of width 32, 2 heads, Adam lr 1e-3) at W = 4: the
    fused window (eager on the CPU) is bitwise the modular loop, and
    within the JAX file's tolerances (losses rtol 2e-4) of the JAX fused
    engine."""
    cfg_kw = dict(vocab_size=64, n_positions=16, hidden_size=32,
                  num_layers=2, num_heads=2, embd_dropout=0.0,
                  attn_dropout=0.0, hidden_dropout=0.0)
    rng = np.random.RandomState(0)
    batches = [(rng.randint(0, 64, size=(8, 16)).astype(np.int32),)
               for _ in range(4)]
    zero = dict({"stage": 3}, **stream)

    def conf(fused):
        return {"train_micro_batch_size_per_gpu": 2,
                "gradient_accumulation_steps": 2,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                "zero_optimization": zero, "steps_per_print": 10 ** 9,
                "fused_step": {"enabled": fused}}

    jmodel = JaxGPT2Model(JaxGPT2Config(**cfg_kw))
    tree = jax.tree.map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(0)))
    out = {}
    for fused in (False, True):
        dst.reset_mesh_context()
        cfg = GPT2Config(**cfg_kw)
        eng = dst.initialize(model=GPT2Model(cfg),
                             config=dict(conf(fused), mesh={"data": 4}),
                             model_parameters=gpt2_params_from_jax(tree, cfg),
                             device="cpu")[0]
        assert (eng._fused is not None) == fused
        it = iter(batches)
        out[fused] = ([float(eng.train_batch(it)) for _ in range(2)],
                      eng.module_state_dict())
    assert out[True][0] == out[False][0]
    for k, v in out[True][1].items():
        assert torch.equal(v, out[False][1][k]), k
    jax_initialize_mesh(data=4, devices=jax.devices()[:4])
    jconf = conf(True)
    jconf["train_micro_batch_size_per_gpu"] = 2
    jeng = ds.initialize(model=jmodel, config=jconf,
                         model_parameters=tree)[0]
    it = iter(batches)
    ref = [float(jeng.train_batch(it)) for _ in range(2)]
    np.testing.assert_allclose(out[True][0], ref, rtol=2e-4)
