"""ZeRO-1/2 data parallelism in the port's training engine
(deepspeed_tpu_torch.runtime.engine over the ranks of a single-controller
mesh, runtime/zero/partition.py, the mesh's flat collectives and
parallel/groups.py) against the JAX engine on the conftest's simulated
CPU devices, at the tiny GPT-2 of tests/test_torch_training.py.  Every
port rank lies on the CPU, where the kernels' plain versions run; the JAX
engine at data W runs on W of the simulated devices.  Weights cross by
models.convert."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.parallel import groups as jgroups
from deepspeed_tpu.parallel import initialize_mesh as jax_initialize_mesh
from deepspeed_tpu.parallel import reset_mesh_context as jax_reset_mesh
from deepspeed_tpu_torch.models import (GPT2Config, GPT2Model,
                                        gpt2_params_from_jax,
                                        gpt2_params_to_jax)
from deepspeed_tpu_torch.parallel import MeshContext
from deepspeed_tpu_torch.parallel import groups as pgroups

from .test_torch_training import TINY, _assert_trees_close, _ids, _jax_params

STEPS = 8


@pytest.fixture(autouse=True)
def _fresh_registries():
    """Every engine registers its mesh: start and end each test with
    neither package's registry holding one."""
    dst.reset_mesh_context()
    jax_reset_mesh()
    yield
    dst.reset_mesh_context()
    jax_reset_mesh()


def _config(world, micro, stage, bf16=False, gas=1, **extra):
    return {"train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": gas,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-3, "weight_decay": 0.1}},
            "bf16": {"enabled": bf16}, "zero_optimization": {"stage": stage},
            "mesh": {"data": world}, **extra}


def _drop_key_bias(tree):
    """The key third of attn_qkvb left out: its true gradient is zero, so
    its grads are rounding noise that Adam turns into updates of order lr
    (test_torch_training.py test_engine_trajectory_matches_jax)."""
    hid = TINY["hidden_size"]
    qkvb = tree["h"]["attn_qkvb"]
    tree["h"]["attn_qkvb"] = np.concatenate([qkvb[:, :hid],
                                             qkvb[:, 2 * hid:]], axis=1)
    return tree


def _jax_run(tree, conf, world, batches, bf16=False):
    """The JAX engine on a data-`world` mesh of the simulated devices:
    forward / backward / step over `batches` (one a micro-step).  Returns
    the losses, the final parameters (numpy) and the engine."""
    jmodel, _ = _jax_params(bf16)
    jax_reset_mesh()
    jax_initialize_mesh(data=world, devices=jax.devices()[:world])
    conf = {k: v for k, v in conf.items() if k != "mesh"}
    jeng = ds.initialize(model=jmodel, config=conf, model_parameters=tree)[0]
    losses = []
    for ids in batches:
        loss = jeng.forward(jnp.asarray(ids))
        jeng.backward(loss)
        jeng.step()
        losses.append(float(loss))
    params = jax.tree.map(np.asarray, jeng.params)
    jax_reset_mesh()
    return losses, params, jeng


def _port_engine(tree, conf, bf16=False, optimizer=None):
    dst.reset_mesh_context()
    cfg = GPT2Config(bf16=bf16, **TINY)
    return dst.initialize(model=GPT2Model(cfg), config=conf,
                          model_parameters=gpt2_params_from_jax(tree, cfg),
                          optimizer=optimizer, device="cpu")[0]


def _port_run(tree, conf, batches, bf16=False):
    eng = _port_engine(tree, conf, bf16)
    losses = []
    for ids in batches:
        loss = eng.forward(torch.from_numpy(ids))
        eng.backward(loss)
        eng.step()
        losses.append(loss.item())
    return losses, eng


def _params(eng, bf16=False):
    cfg = GPT2Config(bf16=bf16, **TINY)
    return gpt2_params_to_jax(dict(eng.module.named_parameters()), cfg)


def _assert_params_within(a, b, atol):
    """Two engines' parameters within `atol` of each other, the key bias
    left out (_drop_key_bias)."""
    flat_a = jax.tree_util.tree_leaves(_drop_key_bias(_params(a)))
    flat_b = jax.tree_util.tree_leaves(_drop_key_bias(_params(b)))
    for x, y in zip(flat_a, flat_b):
        np.testing.assert_allclose(x, y, rtol=0, atol=atol)


# ---------------------------------------------------------------------- #
# 1. the trajectory against the JAX engine at data 4
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("stage", [1, 2])
def test_trajectory_matches_jax_at_data_4(stage, bf16):
    """8 steps, W = 4, micro-batch 2 a rank, one fixed global batch [8, 16],
    AdamW lr 1e-3 wd 0.1, dropout 0: the port's ranks on the CPU against
    the JAX engine on four simulated devices.  fp32: losses rtol 1e-4,
    parameters within 1e-4 of each leaf's largest entry; bf16: 2e-2 and
    5e-2 (test_engine_trajectory_matches_jax's tolerances and its reason
    for leaving out the key third of attn_qkvb).  Every rank ends with the
    same parameters."""
    _, tree = _jax_params(bf16)
    ids = _ids(8, 16, seed=3)
    conf = _config(4, 2, stage, bf16)
    ref, ref_params, _ = _jax_run(tree, conf, 4, [ids] * STEPS, bf16)
    out, eng = _port_run(tree, conf, [ids] * STEPS, bf16)
    assert eng.world_size == 4 and eng.global_steps == STEPS
    assert all(int(s["count"]) == STEPS for s in eng.opt_states)
    assert out[-1] < out[0]
    tol = 2e-2 if bf16 else 1e-4
    np.testing.assert_allclose(out, ref, rtol=tol)
    _assert_trees_close(_drop_key_bias(_params(eng, bf16)),
                        _drop_key_bias(ref_params), 0.0,
                        5e-2 if bf16 else 1e-4)
    for flat in eng._flats[1:]:
        assert torch.equal(flat, eng._flat)


# ---------------------------------------------------------------------- #
# 2. the data parallelism is only layout
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_layout_only_across_worlds_and_stages(world):
    """The same global batch [12, 16] (W = 3 cuts ranges through
    parameters and pads the buffer) for 4 steps at stages 0, 1 and 2, fp32:
    parameters within 1e-5 of the W = 1 stage-0 run's, and stages 1 and 2
    bitwise equal at the same W."""
    _, tree = _jax_params(False)
    ids = _ids(12, 16, seed=4)
    _, ref = _port_run(tree, _config(1, 12, 0), [ids] * 4)
    flats = {}
    for stage in (0, 1, 2):
        _, eng = _port_run(tree, _config(world, 12 // world, stage),
                           [ids] * 4)
        assert eng.world_size == world
        flats[stage] = eng._flat
        _assert_params_within(eng, ref, 1e-5)
    assert torch.equal(flats[1], flats[2])


# ---------------------------------------------------------------------- #
# 3. the global reductions: clipping and Lamb
# ---------------------------------------------------------------------- #
def test_gradient_clipping_sums_the_norm_over_the_ranks():
    """gradient_clipping 0.05, which binds (the first step's norm is ~1):
    W = 4 at stage 2 against W = 1 within 1e-6 and against the JAX engine
    at data 4 (losses rtol 1e-4, parameters 1e-4 of each leaf's largest
    entry), 4 steps, the key bias left out."""
    _, tree = _jax_params(False)
    ids = _ids(8, 16, seed=5)
    clip = {"gradient_clipping": 0.05}
    _, one = _port_run(tree, _config(1, 8, 2, **clip), [ids] * 4)
    out, four = _port_run(tree, _config(4, 2, 2, **clip), [ids] * 4)
    ref, ref_params, _ = _jax_run(tree, _config(4, 2, 2, **clip), 4,
                                  [ids] * 4)
    _assert_params_within(four, one, 1e-6)
    np.testing.assert_allclose(out, ref, rtol=1e-4)
    _assert_trees_close(_drop_key_bias(_params(four)),
                        _drop_key_bias(ref_params), 0.0, 1e-4)
    # the clip bound: with it off the parameters move further
    _, free = _port_run(tree, _config(4, 2, 2), [ids])
    assert (free._flat - four._flat).abs().max() > 0


def test_lamb_sums_each_parameters_norms_over_the_ranks():
    """Lamb (a trust ratio a parameter, whose norms a range cut through the
    parameter only half holds) at W = 3, stage 1, against W = 1 within
    1e-6 and against the JAX engine at data 3, 4 steps on [12, 16]."""
    _, tree = _jax_params(False)
    ids = _ids(12, 16, seed=6)
    lamb = {"optimizer": {"type": "Lamb", "params": {"lr": 1e-2,
                                                     "weight_decay": 0.01}}}
    _, one = _port_run(tree, _config(1, 12, 1, **lamb), [ids] * 4)
    out, three = _port_run(tree, _config(3, 4, 1, **lamb), [ids] * 4)
    cut = [o for o, _ in three._segments if o % three._ranges[0][1]]
    assert len(cut) < len(three._segments)  # some parameter straddles
    ref, ref_params, _ = _jax_run(tree, _config(3, 4, 1, **lamb), 3,
                                  [ids] * 4)
    _assert_params_within(three, one, 1e-6)
    np.testing.assert_allclose(out, ref, rtol=1e-4)
    _assert_trees_close(_params(three), ref_params, 0.0, 1e-4)


# ---------------------------------------------------------------------- #
# 4. an overflow on one rank skips the step on every rank
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("stage", [1, 2])
def test_overflow_on_one_rank_skips_the_step_everywhere(stage):
    """inf written into rank 2's accumulated grads only (its range of the
    stage-2 accumulator; its full grad buffer at stage 1), after backward
    and before step: every rank's parameters, optimizer state and count
    stay bitwise as they were, `overflow` says so, and the next step
    proceeds."""
    _, tree = _jax_params(False)
    ids = torch.from_numpy(_ids(8, 16, seed=7))
    eng = _port_engine(tree, _config(4, 2, stage))
    eng.backward(eng.forward(ids))
    eng.step()
    before = ([f.clone() for f in eng._flats],
              [{k: v.clone() for k, v in s.items()} for s in eng.opt_states])
    eng.backward(eng.forward(ids))
    lo = eng._ranges[2][0]
    if stage == 2:
        eng._acc[2][5] = float("inf")
    else:
        eng._flat_grads[2][lo + 5] = float("inf")
    eng.step()
    assert eng.overflow and not eng.was_step_applied()
    for flat, old in zip(eng._flats, before[0]):
        assert torch.equal(flat, old)
    for state, old in zip(eng.opt_states, before[1]):
        for k, v in state.items():
            assert torch.equal(v, old[k]), k
    eng.backward(eng.forward(ids))
    eng.step()
    assert not eng.overflow
    assert all(int(s["count"]) == 2 for s in eng.opt_states)


# ---------------------------------------------------------------------- #
# 5. held bytes
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("stage", [1, 2])
def test_each_rank_holds_its_range(stage):
    """At W = 3 (n = 31616 parameters, so one element of padding): each
    rank's Adam moments and, at stage 2, its grad accumulator hold
    ceil(n / 3) elements; the padding of every buffer is zero and stays
    zero over 3 steps; the parameters stay whole on every rank."""
    _, tree = _jax_params(False)
    eng = _port_engine(tree, _config(3, 4, stage))
    n, chunk = eng.num_params, math.ceil(eng.num_params / 3)
    assert 3 * chunk > n
    for r in range(3):
        assert eng._ranges[r] == (r * chunk, (r + 1) * chunk)
        assert eng._flats[r].numel() == 3 * chunk
        for k in ("mu", "nu"):
            assert eng.opt_states[r][k].numel() == chunk
        if stage == 2:
            assert eng._acc[r].numel() == chunk
        else:
            assert eng._acc[r] is None
    ids = torch.from_numpy(_ids(12, 16, seed=8))
    for _ in range(3):
        eng.backward(eng.forward(ids))
        assert all(bool((g[n:] == 0).all()) for g in eng._flat_grads)
        if stage == 2:
            assert bool((eng._acc[2][n - 2 * chunk:] == 0).all())
        eng.step()
    pad = n - 2 * chunk  # where the padding starts in rank 2's range
    for r in range(3):
        assert bool((eng._flats[r][n:] == 0).all())
        assert torch.equal(eng._flats[r], eng._flat)
    for k in ("mu", "nu"):
        assert bool((eng.opt_states[2][k][pad:] == 0).all())


def test_estimate_memory_matches_jax():
    """engine.estimate_memory() equals the JAX engine's at data 4 for
    stages 0-2, and the partitioner's topology its keys and values."""
    _, tree = _jax_params(False)
    for stage in (0, 1, 2):
        conf = _config(4, 2, stage)
        eng = _port_engine(tree, conf)
        jax_reset_mesh()
        jax_initialize_mesh(data=4, devices=jax.devices()[:4])
        jmodel, _ = _jax_params(False)
        jeng = ds.initialize(model=jmodel, model_parameters=tree,
                             config={k: v for k, v in conf.items()
                                     if k != "mesh"})[0]
        assert eng.estimate_memory() == jeng.estimate_memory()
        assert eng.zero_partitioner.topology() == \
            jeng.zero_partitioner.topology()
        jax_reset_mesh()


# ---------------------------------------------------------------------- #
# 6. the batch rule
# ---------------------------------------------------------------------- #
def test_rows_w_does_not_divide_go_whole_to_every_rank():
    """A batch of 6 rows at W = 4 is replicated: every rank's loss is the
    whole batch's, and the losses of 3 steps equal the JAX engine's on
    the same replicated batch (rtol 1e-5)."""
    _, tree = _jax_params(False)
    ids = _ids(6, 16, seed=9)
    conf = _config(4, 2, 2)
    ref, _, _ = _jax_run(tree, conf, 4, [ids] * 3)
    out, eng = _port_run(tree, conf, [ids] * 3)
    eng.forward(torch.from_numpy(ids))
    ranks = [loss.item() for loss in eng._rank_losses]
    assert ranks == [ranks[0]] * 4
    np.testing.assert_allclose(out, ref, rtol=1e-5)


# ---------------------------------------------------------------------- #
# 7. accumulation
# ---------------------------------------------------------------------- #
def test_accumulation_at_w2_equals_one_micro_step_at_w4():
    """gas 2 at W = 2 (micro-batch 2) equals gas 1 at W = 4 (micro-batch 2)
    on the same global batch of 8 rows, 3 steps, stage 2: parameters
    within 1e-5 (the counterpart of tests/unit/test_engine.py's
    accumulation test)."""
    _, tree = _jax_params(False)
    ids = _ids(8, 16, seed=10)
    # at W = 2 each micro-step takes 4 rows; rank r's rows over the two
    # micro-steps are the rows rank r and r + 2 take at W = 4
    first = np.concatenate([ids[0:2], ids[4:6]])
    second = np.concatenate([ids[2:4], ids[6:8]])
    _, two = _port_run(tree, _config(2, 2, 2, gas=2),
                       [first, second] * 3)
    _, four = _port_run(tree, _config(4, 2, 2), [ids] * 3)
    assert two.global_steps == four.global_steps == 3
    _assert_params_within(two, four, 1e-5)


# ---------------------------------------------------------------------- #
# 8. dropout streams
# ---------------------------------------------------------------------- #
def test_each_rank_draws_its_own_dropout():
    """With dropout on, two ranks given the same rows draw different masks
    (their losses differ); with it off they agree bitwise."""
    ids = _ids(2, 16, seed=11)
    both = torch.from_numpy(np.concatenate([ids, ids]))
    for rate in (0.1, 0.0):
        cfg = GPT2Config(bf16=False, **dict(TINY, embd_dropout=rate,
                                            attn_dropout=rate,
                                            hidden_dropout=rate))
        model = GPT2Model(cfg).init_params(torch.Generator().manual_seed(0))
        dst.reset_mesh_context()
        eng = dst.initialize(model=model, config=_config(2, 2, 2),
                             device="cpu")[0]
        eng.forward(both)
        a, b = (loss.item() for loss in eng._rank_losses)
        assert (a != b) if rate else (a == b)


# ---------------------------------------------------------------------- #
# 9. groups
# ---------------------------------------------------------------------- #
ACCESSORS = [name for name in dir(jgroups) if name.startswith("get_")]


@pytest.mark.parametrize("shape", [
    dict(), dict(ep_size=2), dict(model_parallel_size=2),
    dict(ep_size=2, pipe_parallel_size=2), dict(seq_parallel_size=4)])
def test_groups_match_jax(shape):
    """parallel/groups.py's accessors (groups, world sizes, ranks) equal
    the JAX module's on the same 8-rank mesh shapes."""
    assert ACCESSORS == sorted(n for n in dir(pgroups)
                               if n.startswith("get_"))
    assert not pgroups.is_initialized()
    jgroups.initialize(devices=jax.devices(), **shape)
    pgroups.initialize(devices=["cpu"] * 8, **shape)
    assert pgroups.is_initialized() and jgroups.is_initialized()
    for name in ACCESSORS:
        assert getattr(pgroups, name)() == getattr(jgroups, name)(), name


# ---------------------------------------------------------------------- #
# the mesh's flat collectives and the engine's mesh
# ---------------------------------------------------------------------- #
def test_flat_collectives_sum_and_concatenate_in_rank_order():
    """reduce_scatter_flat sums the group's chunks in group order (bitwise
    the left-to-right sum); all_gather_flat concatenates in group order,
    into `out` when given; all_sum gives every rank the same ordered sum;
    on a data x expert mesh the groups follow the ZeRO axes."""
    mesh = MeshContext.create(data=3, devices=["cpu"])
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(12, generator=g) * 10 ** r for r in range(3)]
    parts = mesh.reduce_scatter_flat(xs)
    for r, part in enumerate(parts):
        want = (xs[0][4 * r:4 * r + 4] + xs[1][4 * r:4 * r + 4]) \
            + xs[2][4 * r:4 * r + 4]
        assert torch.equal(part, want)
    out = [torch.full((12,), -1.0) for _ in range(3)]
    gathered = mesh.all_gather_flat(parts, out=out)
    assert all(t is o for t, o in zip(gathered, out))
    assert all(torch.equal(t, torch.cat(parts)) for t in gathered)
    sums = mesh.all_sum([x[:2] for x in xs])
    assert all(torch.equal(s, (xs[0][:2] + xs[1][:2]) + xs[2][:2])
               for s in sums)
    with pytest.raises(ValueError, match="divisible"):
        mesh.reduce_scatter_flat([torch.zeros(4)] * 3)
    mesh = MeshContext.create(data=2, expert=2, devices=["cpu"])
    parts = mesh.reduce_scatter_flat([torch.full((4,), float(r))
                                      for r in range(4)])
    assert [p.tolist() for p in parts] == [[6.0]] * 4


def test_engine_mesh_sources_and_refusals(monkeypatch):
    """The mesh comes from mesh=, else the registry, else the config; a
    config block that disagrees with the mesh in use raises; model, pipe,
    seq and expert axes above 1 are refused naming A.9 / A.10, and a mesh
    whose data axis one process drives under a torch.distributed world of
    2 processes raises naming both counts."""
    _, tree = _jax_params(False)
    conf = _config(2, 4, 2)
    eng = _port_engine(tree, conf)
    assert dst.get_mesh_context() is eng.mesh and eng.world_size == 2
    mesh = MeshContext.create(data=4, devices=["cpu"])
    cfg = GPT2Config(bf16=False, **TINY)
    eng = dst.initialize(model=GPT2Model(cfg), mesh=mesh, device="cpu",
                         config=dict(conf, mesh={"data": -1},
                                     train_micro_batch_size_per_gpu=2))[0]
    assert eng.mesh is mesh and eng.world_size == 4
    with pytest.raises(ValueError, match="disagree"):
        dst.initialize(model=GPT2Model(cfg), config=conf, device="cpu")
    dst.reset_mesh_context()
    for axes, item in (({"model": 2}, "A.9"), ({"pipe": 2}, "A.9"),
                       ({"seq": 2}, "A.9"), ({"expert": 2}, "A.10")):
        with pytest.raises(NotImplementedError, match=rf"ROADMAP\.md {item}"):
            dst.initialize(model=GPT2Model(cfg), device="cpu",
                           config=dict(conf, mesh=dict(data=2, **axes)))
        with pytest.raises(NotImplementedError, match=rf"ROADMAP\.md {item}"):
            dst.initialize(model=GPT2Model(cfg), device="cpu", config=conf,
                           mesh=MeshContext.create(data=2, **axes,
                                                   devices=["cpu"]))
    from deepspeed_tpu_torch.runtime import engine as engine_mod
    monkeypatch.setattr(engine_mod, "_torch_distributed_world", lambda: 2)
    with pytest.raises(ValueError, match=r"data axis of 2 from 1 process.*"
                       r"torch\.distributed world of 2 processes"):
        dst.initialize(model=GPT2Model(cfg), config=conf, device="cpu")
