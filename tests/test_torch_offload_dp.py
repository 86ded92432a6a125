"""The rest of the offload tier and ZeRO-3 remat under the fused step, on
the CPU, against the JAX package:

- ZeRO-Offload at stage 3 over W = 2 and 4 ranks of one process (the host
  tier over each rank's pieces, runtime/zero/offload.py
  `JaxLeafMap.pieces`; "cpu" and "nvme", gas 1 and 2) against the JAX
  engine at `initialize_mesh(data=W)`: losses at rtol 1e-5, the fp32
  master as tests/test_torch_offload.py holds it; the NVMe tier bitwise
  the host tier.
- The training-health sentinel with the tier, at stages 2 and 3, against
  the JAX engine with the sentinel and offload: each step's grad norm at
  rtol 1e-5, the verdicts and counters equal; a NaN written into the
  accumulated grads skips the step with the tier bitwise untouched, and a
  rewind restores the tier bitwise.
- ZeRO-Infinity over W = 2 ranks against the JAX streaming engine at data
  2 on the same global batch (tests/test_torch_infinity.py's
  `_assert_master_close`).
- The fused whole step with stage-3 activation checkpointing (its window
  eager on the CPU) against the modular loop, bitwise.

W gloo processes against W ranks of one process are in
tests/test_torch_distributed.py.  One intra-op thread, fp32, dropout off
but where stated."""

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models import (GPT2Config, GPT2Model,
                                        gpt2_params_from_jax)
from deepspeed_tpu_torch.runtime.resilience.sentinel import SentinelAbort

from .test_torch_offload import (TINY, _assert_master_close, _conf, _ids,
                                 _port_engine, _run, _tree)

ROWS = 8  # the global batch of a micro-step
SENTINEL = {"enabled": True, "warmup_steps": 3, "k_sigma": 0.01,
            "anomaly_budget": 3}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's CPU work (restored after):
    the tiny models gain nothing from more, and the suite's parallel
    workers share the cores."""
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


def _z3_conf(world, device, gas=1, path=None, threshold=0, **extra):
    """tests/test_torch_offload.py's config at stage 3 over `world` ranks,
    ROWS global rows a micro-step."""
    conf = _conf(device, path, gas=gas, micro=ROWS // world, **extra)
    conf["zero_optimization"] = dict(
        conf["zero_optimization"], stage=3,
        stage3_param_persistence_threshold=threshold)
    conf["mesh"] = {"data": world}
    return conf


def _jax_engine(conf, world, tree=None, model=None):
    ds.reset_mesh_context()
    if model is None:
        model, tree = _tree()
    mesh = ds.initialize_mesh(data=world, devices=jax.devices()[:world])
    conf = {k: v for k, v in conf.items() if k != "mesh"}
    return ds.initialize(model=model, config=conf, model_parameters=tree,
                         mesh=mesh)[0]


def _tier_local(engine):
    """Clones of the tier's flat buffers and its step count."""
    tier = engine.optimizer
    return ({k: v.clone() for k, v in tier.local_state().items()},
            tier.step_count())


def _same_tier(a, b):
    return a[1] == b[1] and all(torch.equal(a[0][k], b[0][k]) for k in a[0])


# ---------------------------------------------------------------------- #
# stage 3 with the host tier over W ranks
# ---------------------------------------------------------------------- #
STAGE3 = {(2, 1): 0, (4, 1): 200, (2, 2): 200, (4, 2): 0}


@pytest.fixture(scope="module")
def jax_stage3(tmp_path_factory):
    """The JAX engine's stage-3 offload runs, once a (world, gas): (losses,
    master); 4 micro-steps on the same global batches."""
    cache = {}

    def run(world, gas):
        if (world, gas) not in cache:
            path = tmp_path_factory.mktemp(f"jax{world}{gas}")
            jeng = _jax_engine(_z3_conf(world, "cpu", gas, path,
                                        STAGE3[world, gas]), world)
            losses = [_run(jeng, _ids(seed=10 + i, rows=ROWS), 1,
                           jax_side=True)[0] for i in range(4)]
            cache[world, gas] = (losses, jeng.optimizer.master_params)
        return cache[world, gas]
    return run


@pytest.mark.parametrize("world,gas", sorted(STAGE3))
def test_stage3_tier_over_ranks_matches_the_jax_engine(tmp_path, jax_stage3,
                                                       world, gas):
    """Stage 3 with offload_optimizer at W ranks of one process (leaves
    cut over the ranks, and with a persistence threshold of 200 the small
    ones whole on every rank): the host tier holds every rank's pieces;
    4 micro-steps against the JAX engine at data W: losses rtol 1e-5, the
    master leaf by leaf; the NVMe tier over the same pieces bitwise the
    host tier (losses, master and moments, device pieces)."""
    _, tree = _tree()
    ref, ref_master = jax_stage3(world, gas)
    runs = {}
    for device in ("cpu", "nvme"):
        eng = _port_engine(tree, _z3_conf(world, device, gas,
                                          tmp_path / device,
                                          STAGE3[world, gas]))
        assert eng._zero3 and eng.world_size == world
        losses = [_run(eng, _ids(seed=10 + i, rows=ROWS), 1)[0]
                  for i in range(4)]
        runs[device] = (losses, _tier_local(eng), eng)
    np.testing.assert_allclose(runs["cpu"][0], ref, rtol=1e-5)
    _assert_master_close(runs["cpu"][2]._module_tree(), ref_master)
    assert runs["nvme"][0] == runs["cpu"][0]
    assert _same_tier(runs["nvme"][1], runs["cpu"][1])
    for a, b in zip(runs["nvme"][2]._flats, runs["cpu"][2]._flats):
        assert torch.equal(a, b)
    assert runs["cpu"][1][1] == 4 // gas


def test_stage3_tier_checkpoint_round_trip_and_the_jax_load(tmp_path):
    """Stage 3 offload at W = 2, 2 steps, saved consolidated and sharded:
    each loads into a fresh engine at W = 2 (the next 2 steps bitwise the
    saving engine's), into the stage-2 tier at one rank (the tier's state
    bitwise), and into the JAX engine (its master the port's)."""
    _, tree = _tree()
    ids = [_ids(seed=20 + i, rows=ROWS) for i in range(4)]

    def steps(eng, batches):
        return [_run(eng, b, 1)[0] for b in batches]
    eng = _port_engine(tree, _z3_conf(2, "cpu", threshold=200))
    steps(eng, ids[:2])
    for sharded in (False, True):
        eng.config.checkpoint_config.sharded = sharded
        eng.save_checkpoint(str(tmp_path / f"s{sharded}"), tag="t")
    master, state = eng._module_tree(), eng._offload.view.state()
    cont = steps(eng, ids[2:])
    for sharded in (False, True):
        path = str(tmp_path / f"s{sharded}")
        again = _port_engine(_tree()[1], _z3_conf(2, "cpu", threshold=200))
        again.load_checkpoint(path, tag="t")
        assert steps(again, ids[2:]) == cont
        one = _port_engine(_tree()[1], _conf("cpu", micro=ROWS))
        one.load_checkpoint(path, tag="t")
        got = one._offload.view.state()
        assert got["step"] == state["step"] == 2
        for kind in ("exp_avg", "exp_avg_sq"):
            for k, v in state[kind].items():
                assert torch.equal(torch.as_tensor(got[kind][k]), v)
        for a, b in zip(jax.tree.leaves(one._module_tree()),
                        jax.tree.leaves(master)):
            np.testing.assert_array_equal(a, b)
        jeng = _jax_engine(_conf("cpu", micro=ROWS), 1)
        jeng.load_checkpoint(path, tag="t")
        for a, b in zip(jax.tree.leaves(jeng.optimizer.master_params),
                        jax.tree.leaves(master)):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_gathered_parameters_edit_reaches_the_stage3_tier():
    """GatheredParameters under modifier_rank on a stage-3 offload
    engine's placeholder: the edit reaches every rank's compute-dtype
    pieces and the host tier's master (a step would otherwise write the
    old master back), and the next step starts from it."""
    _, tree = _tree()
    eng = _port_engine(tree, _z3_conf(2, "cpu", threshold=200))
    _run(eng, _ids(seed=30, rows=ROWS), 1)
    w = eng.module.wte
    with dst.zero.GatheredParameters(w, modifier_rank=0):
        w.data[0].fill_(3.0)
    assert torch.all(eng.module_state_dict()["wte"][0] == 3.0)
    np.testing.assert_array_equal(np.asarray(eng._module_tree()["wte"])[0],
                                  np.full(TINY["hidden_size"], 3.0,
                                          np.float32))
    _run(eng, _ids(seed=31, rows=ROWS), 1)
    assert float(np.abs(np.asarray(eng._module_tree()["wte"])[0]
                        - 3.0).max()) < 0.01


# ---------------------------------------------------------------------- #
# the sentinel with the tier
# ---------------------------------------------------------------------- #
def _sentinel_conf(stage, policy):
    res = {"enabled": True, "io_backoff_seconds": 0.001,
           "verify_lockstep_on_resume": False,
           "sentinel": dict(SENTINEL, policy=policy)}
    if stage == 3:
        return _z3_conf(2, "cpu", threshold=200, resilience=res)
    return _conf("cpu", micro=ROWS, resilience=res)


@pytest.fixture(scope="module")
def jax_sentinel(tmp_path_factory):
    """One JAX engine a stage with the sentinel and the host tier, and a
    save of its first state: each policy's run loads it and takes a new
    sentinel of its policy."""
    cache = {}

    def get(stage):
        if stage not in cache:
            path = str(tmp_path_factory.mktemp(f"sentinel{stage}"))
            jeng = _jax_engine(_sentinel_conf(stage, "warn"),
                               2 if stage == 3 else 1)
            jeng.save_checkpoint(path, tag="start")
            cache[stage] = (jeng, path)
        return cache[stage]
    return get


@pytest.mark.parametrize("stage", [2, 3])
@pytest.mark.parametrize("policy", ["skip_step", "rewind"])
def test_sentinel_with_the_tier_matches_the_jax_engine(tmp_path,
                                                       jax_sentinel, stage,
                                                       policy):
    """The sentinel (loss and grad norm, warmup 3, k_sigma 0.01, a budget
    of 3) with the host tier on one fixed batch: after the warmup every
    step is an anomaly.  skip_step never runs the tier until the abort;
    rewind loads the checkpoint saved after step 2 until the budget is
    spent.  Every step's grad norm (the port's from the host grads the
    tier would step, the JAX engine's from its device grads) at rtol
    1e-5, and both engines' steps, skipped steps and sentinel counters
    equal after every step, the abort at the same step."""
    from deepspeed_tpu.runtime.resilience.sentinel import (
        SentinelAbort as JaxSentinelAbort)
    from deepspeed_tpu.runtime.resilience.sentinel import (
        TrainingSentinel as JaxTrainingSentinel)
    jeng, start = jax_sentinel(stage)
    jeng.load_checkpoint(start, tag="start")
    # the last case's abort left its window's grads accumulated
    jeng._grad_acc = None
    jeng.sentinel = JaxTrainingSentinel(**{
        k: v for k, v in SENTINEL.items() if k != "enabled"}, policy=policy)
    _, tree = _tree()
    eng = _port_engine(tree, _sentinel_conf(stage, policy))
    ids = _ids(seed=3, rows=ROWS)
    history, norms = [], []
    for name, e in (("jax", jeng), ("port", eng)):
        seen, norm = [], []
        for step in range(8):
            if step == 2 and policy == "rewind":
                e.save_checkpoint(str(tmp_path / name), tag="good")
            try:
                _run(e, ids, 1, jax_side=name == "jax")
            except (SentinelAbort, JaxSentinelAbort) as abort:
                seen.append(("abort", abort.diagnostic["step"],
                             abort.diagnostic["anomalies_seen"]))
                break
            seen.append((e.global_steps, e.skipped_steps,
                         e.sentinel.counters()))
            norm.append(e._last_grad_norm_host)
        history.append(seen)
        norms.append(norm)
    assert history[0] == history[1]
    assert history[1][-1][0] == "abort"
    np.testing.assert_allclose(norms[1], norms[0], rtol=1e-5)
    assert eng.sentinel.counters()["rewinds" if policy == "rewind"
                                   else "steps_skipped"] >= 2


@pytest.mark.parametrize("stage", [2, 3])
def test_a_nan_grad_skips_and_the_rewind_restores_the_tier_bitwise(
        tmp_path, stage):
    """A NaN written into the accumulated grads before a step: the
    sentinel's norm is NaN, the skip_step policy skips the step and the
    tier's master, moments and step count stay bitwise, as do the ranks'
    parameters; the next step proceeds.  Under rewind the step after a
    save and a healthy step restores the tier bitwise to the save's.  The
    sentinel's norm of a healthy step equals the norm of the same host
    grads computed here, divided by loss scale x gas x W."""
    _, tree = _tree()
    ids = _ids(seed=4, rows=ROWS)

    def poisoned(eng):
        loss = eng.forward(torch.from_numpy(ids))
        eng.backward(loss)
        buf = eng._acc[0] if eng._acc[0] is not None else eng._flat_grads[0]
        buf[5] = float("nan")
        eng.step()

    res = {"enabled": True, "io_backoff_seconds": 0.001,
           "verify_lockstep_on_resume": False}
    for policy in ("skip_step", "rewind"):
        conf = _sentinel_conf(stage, policy)
        conf["resilience"] = dict(res, sentinel=dict(
            enabled=True, policy=policy, warmup_steps=100))
        eng = _port_engine(tree, conf)
        _run(eng, ids, 2)
        if policy == "rewind":
            eng.save_checkpoint(str(tmp_path / f"r{stage}"), tag="good")
        before = _tier_local(eng)
        flats = [f.clone() for f in eng._flats]
        if policy == "rewind":
            # a healthy step moves the tier; its norm against the norm of
            # the same host grads (whole leaves, each once) taken here
            seen, norm = [], eng._offload_grad_norm

            def spy():
                seen.append(eng._tier_flat(
                    eng._offload.host_grads.clone()).double())
                return norm()
            eng._offload_grad_norm = spy
            _run(eng, ids, 1)
            want = float(torch.sqrt((seen[0] * seen[0]).sum())) \
                / eng.world_size
            np.testing.assert_allclose(eng._last_grad_norm_host, want,
                                       rtol=1e-6)
            assert not _same_tier(_tier_local(eng), before)
        poisoned(eng)
        assert not np.isfinite(eng._last_grad_norm_host)
        assert _same_tier(_tier_local(eng), before)
        assert all(torch.equal(a, b) for a, b in zip(eng._flats, flats))
        if policy == "skip_step":
            assert eng.skipped_steps == 1 and eng.global_steps == 3
            assert eng.sentinel.counters()["steps_skipped"] == 1
            _run(eng, ids, 1)
            assert eng.optimizer.step_count() == 3
        else:
            assert eng.global_steps == 2
            assert eng.sentinel.counters()["rewinds"] == 1


# ---------------------------------------------------------------------- #
# ZeRO-Infinity over two ranks
# ---------------------------------------------------------------------- #
def test_infinity_over_two_ranks_matches_the_jax_engine(tmp_path):
    """The streaming engine at data 2 (each rank streams the groups and
    runs its 2 rows; each group's grads summed over the ranks in rank
    order before the host tier) against the JAX streaming engine at data
    2 on test_torch_infinity.py's 4-row global batch, 4 steps: losses rtol
    1e-5, the master as test_torch_infinity.py holds it; the NVMe tiers
    (parameters and optimizer in files, prefetch depth 0) bitwise the
    host's."""
    from .test_torch_infinity import TINY as INF_TINY
    from .test_torch_infinity import _assert_master_close as inf_close
    from .test_torch_infinity import _conf as inf_conf
    from .test_torch_infinity import _ids as inf_ids
    from .test_torch_infinity import _tree as inf_tree
    model, tree = inf_tree()
    # test_torch_infinity.py's run: its 4-row batch, 4 steps
    batches = [inf_ids()] * 4

    def conf(path, params="cpu", optimizer=None, depth=2):
        c = inf_conf(path, params, optimizer, depth=depth)
        c["train_micro_batch_size_per_gpu"] = 2
        return c
    jeng = _jax_engine(conf(tmp_path / "jax"), 2, tree, model)
    ref = [_run(jeng, b, 1, jax_side=True)[0] for b in batches]
    ref_master = jeng.optimizer.master_params
    runs = {}
    for key, args in (("cpu", ()), ("nvme", ("nvme", "nvme", 0))):
        dst.reset_mesh_context()
        cfg = GPT2Config(**dict(INF_TINY, bf16=False))
        eng = dst.initialize(
            model=GPT2Model(cfg), config=dict(conf(tmp_path / key, *args),
                                              mesh={"data": 2}),
            device="cpu", model_parameters=gpt2_params_from_jax(tree, cfg))[0]
        assert eng.world_size == 2 and eng.local_ranks == [0, 1]
        runs[key] = ([_run(eng, b, 1)[0] for b in batches],
                     eng.optimizer.master_params)
    np.testing.assert_allclose(runs["cpu"][0], ref, rtol=1e-5)
    inf_close(runs["cpu"][1], ref_master)
    assert runs["nvme"][0] == runs["cpu"][0]
    for a, b in zip(jax.tree.leaves(runs["nvme"][1]),
                    jax.tree.leaves(runs["cpu"][1])):
        np.testing.assert_array_equal(a, b)


def _adam_replay(w0, grads, hyper):
    """The host tier's Adam (ops/adam/cpu_adam.py `adam_step_plain`, the
    JAX tier's `_adam_step_numpy`) replayed in float64 from `w0` over each
    step's grads (arrays of one shape)."""
    w = np.asarray(w0, np.float64).copy()
    m, v = np.zeros_like(w), np.zeros_like(w)
    b1, b2 = hyper.betas
    for t, g in enumerate(grads, 1):
        g = np.asarray(g, np.float64)
        if not hyper.adamw_mode and hyper.weight_decay > 0:
            g = g + hyper.weight_decay * w
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        denom = np.sqrt(v) / np.sqrt(1 - b2 ** t) + hyper.eps
        if hyper.adamw_mode and hyper.weight_decay > 0:
            w = w * (1 - hyper.lr * hyper.weight_decay)
        w = w - hyper.lr / (1 - b1 ** t) * m / denom
    return w


@pytest.mark.parametrize("world", [1, 2])
def test_infinity_on_fresh_batches_departs_only_by_adam_over_the_grads(
        tmp_path, world):
    """The streaming engine at data W against the JAX streaming engine at
    data W on four fresh 8-row batches (TINY of test_torch_infinity.py,
    fp32, the host tiers): losses rtol 1e-5; the first step's grads the
    tiers step, leaf by leaf, within 1e-5 of the leaf's largest (a later
    step's follow the parameters); and every entry of the master outside
    test_torch_infinity.py's `_assert_master_close` bound (a few a run on
    such batches: ROADMAP C.5) explained by the grads -- Adam replayed in
    float64 from the start over each engine's own grads gives the two
    masters' difference there within 1e-2 of it.  Adam's normalised step
    turns a near-zero grad's rounding in another summation order into a
    share of lr."""
    from .test_torch_infinity import HID
    from .test_torch_infinity import TINY as INF_TINY
    from .test_torch_infinity import _conf as inf_conf
    from .test_torch_infinity import _tree as inf_tree
    model, tree = inf_tree()
    rng = np.random.default_rng(2)
    batches = [rng.integers(0, INF_TINY["vocab_size"],
                            (8, INF_TINY["n_positions"])).astype(np.int32)
               for _ in range(4)]

    def conf(path):
        c = inf_conf(path)
        c["train_micro_batch_size_per_gpu"] = 8 // world
        return c

    def paths(t, prefix=""):
        return [q for k in sorted(t) for q in (
            paths(t[k], f"{prefix}{k}.") if isinstance(t[k], dict)
            else [prefix + k])]

    def by_path(t):
        t = jax.tree.map(np.asarray, t)
        return {q: np.asarray(v, np.float64)
                for q, v in zip(paths(t), jax.tree.leaves(t))}

    jeng = _jax_engine(conf(tmp_path / "jax"), world, tree, model)
    jax_grads, apply = [], jeng._opt.apply

    def spy(box, *args, **kwargs):  # the grads the JAX tier steps
        jax_grads.append({q: g.copy() for q, g in by_path(box[0]).items()})
        return apply(box, *args, **kwargs)
    jeng._opt.apply = spy
    ref = [_run(jeng, b, 1, jax_side=True)[0] for b in batches]
    dst.reset_mesh_context()
    cfg = GPT2Config(**dict(INF_TINY, bf16=False))
    eng = dst.initialize(model=GPT2Model(cfg),
                         config=dict(conf(tmp_path / "port"),
                                     mesh={"data": world}),
                         device="cpu",
                         model_parameters=gpt2_params_from_jax(tree, cfg))[0]
    assert eng.world_size == world
    losses, grads = [], []
    for b in batches:
        loss = eng.forward(torch.from_numpy(b))
        eng.backward(loss)
        lm = eng._leaf_map
        grads.append({".".join(leaf.path): lm.gather(eng._host_grads, k)
                      .double().numpy() / world
                      for k, leaf in enumerate(lm.leaves)})
        eng.step()
        losses.append(float(loss))
    np.testing.assert_allclose(losses, ref, rtol=1e-5)
    for q, r in jax_grads[0].items():
        g = grads[0][q]
        if q == "h.attn_qkvb":  # its key third is rounding noise
            g, r = (np.concatenate([x[:, :HID], x[:, 2 * HID:]], 1)
                    for x in (g, r))
        assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max(), q
    out, want = by_path(eng.optimizer.master_params), by_path(
        jeng.optimizer.master_params)
    start = by_path(tree)
    for q, r in want.items():
        o = out[q]
        bound = 1e-5 * np.abs(r) + 1e-4 * np.abs(r).max()
        bad = np.abs(o - r) > bound
        if q == "h.attn_qkvb":
            bad[:, HID:2 * HID] = False
        if not bad.any():
            continue
        replayed = (_adam_replay(start[q][bad], [g[q][bad] for g in grads],
                                 eng.optimizer.hyper)
                    - _adam_replay(start[q][bad],
                                   [g[q][bad] for g in jax_grads],
                                   eng.optimizer.hyper))
        actual = o[bad] - r[bad]
        np.testing.assert_allclose(replayed, actual, rtol=1e-2, err_msg=q)


# ---------------------------------------------------------------------- #
# stage-3 remat under the fused step
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["off", "carried"])
def test_fused_step_with_stage3_remat_equals_the_modular_loop(mode):
    """GPT2Config(activation_checkpointing=True) at stage 3 over 2 ranks,
    dropout 0.1, gas 2, with fused_step (the window eager on the CPU, the
    graph's plain version) and without: 3 windows' losses, every rank's
    pieces and Adam state and the generators bitwise, in the `off` and
    `carried` plans."""
    _, tree = _tree()
    cfg = GPT2Config(**dict(TINY, bf16=False, activation_checkpointing=True,
                            embd_dropout=0.1, attn_dropout=0.1,
                            hidden_dropout=0.1))
    zc = {"stage": 3, "stage3_param_persistence_threshold": 0,
          "stage3_prefetch_mode": mode}
    if mode == "carried":
        zc.update(stage3_max_live_parameters=10 ** 9,
                  stage3_prefetch_bucket_size=10 ** 9)
    batches = [(torch.from_numpy(_ids(seed=40 + i, rows=4)),)
               for i in range(6)]
    out = {}
    for fused in (False, True):
        dst.reset_mesh_context()
        conf = {"train_micro_batch_size_per_gpu": 2,
                "gradient_accumulation_steps": 2,
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
                "zero_optimization": zc, "mesh": {"data": 2},
                "fused_step": {"enabled": fused},
                "steps_per_print": 10 ** 9}
        eng = dst.initialize(model=GPT2Model(cfg), config=conf, device="cpu",
                             model_parameters=gpt2_params_from_jax(tree,
                                                                   cfg))[0]
        assert (eng._fused is not None) == fused and eng._zero3
        it = iter(batches)
        losses = [float(eng.train_batch(it)) for _ in range(3)]
        out[fused] = (losses, [f.clone() for f in eng._flats],
                      [{k: v.clone() for k, v in s.items()}
                       for s in eng.opt_states],
                      [g.get_state() for g in eng._rngs])
    assert out[True][0] == out[False][0]
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)
    for a, b in zip(out[True][2], out[False][2]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for a, b in zip(out[True][3], out[False][3]):
        assert torch.equal(a, b)
