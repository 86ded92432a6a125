"""ZeRO-3 in the port (runtime/zero/partition.py's stage-3 half,
runtime/zero/stage3_streaming.py, the engine at stage 3) against the JAX
package: the stream plans and partition specs, and 3-step trajectories of
the port's engine at data 4 against the JAX engine on four of the
conftest's simulated devices, in every prefetch mode, in fp32 and bf16,
at the tiny GPT-2 of tests/unit/test_zero3_streaming.py.  Every port rank
lies on the CPU, where the kernels' plain versions run."""

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
from deepspeed_tpu.runtime.zero import partition as jpart
from deepspeed_tpu.runtime.zero import stage3_streaming as jstream
from deepspeed_tpu_torch.models import (GPT2Config, GPT2Model,
                                        gpt2_params_from_jax,
                                        gpt2_params_to_jax)
from deepspeed_tpu_torch.runtime.zero import partition as ppart
from deepspeed_tpu_torch.runtime.zero import stage3_streaming as pstream

from .test_torch_training import _assert_trees_close

SMALL = dict(vocab_size=64, n_positions=16, hidden_size=32, num_heads=4,
             embd_dropout=0.0, attn_dropout=0.0, hidden_dropout=0.0)
PER_LAYER = 12704
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's CPU work (restored after):
    its tiny models gain nothing from more, and the suite's parallel
    workers share the cores."""
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


# ---------------------------------------------------------------------- #
# plans and specs
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["carried", "unrolled", "off"])
def test_stream_plans_match_jax(mode):
    """plan_layer_streaming over a grid of (layers, per-layer, max_live,
    bucket): the same plan and forfeit string as the JAX function."""
    for layers in (1, 2, 3, 4, 5, 6, 12):
        for per in (100, 7087872):
            for live in (0, 1, 2, 3, 4, 5, 8):
                for bucket in (0, 1, 2):
                    args = (layers, per, live * per, bucket * per, mode)
                    assert pstream.plan_layer_streaming(*args).__dict__ == \
                        jstream.plan_layer_streaming(*args).__dict__, args
    with pytest.raises(ValueError, match="stage3_prefetch_mode") as port:
        pstream.plan_layer_streaming(4, 10, 100, 10, "eager")
    with pytest.raises(ValueError) as ref:
        jstream.plan_layer_streaming(4, 10, 100, 10, "eager")
    assert str(port.value) == str(ref.value)


def test_bench_rows_plan_groups_of_two():
    """bench.py's zero3_stream rows at GPT-2 124M: 6 groups of 2 layers,
    off for `zero3_stream`, carried for `_carried` (and `_fcm`)."""
    per = 7087872
    assert GPT2Config(num_layers=1).num_params(False) - 2 * 768 == per
    off = pstream.plan_layer_streaming(12, per, 2 * per, 0, "off")
    car = pstream.plan_layer_streaming(12, per, 4 * per, 2 * per, "carried")
    assert (off.layers_per_step, off.mode, off.prefetch) == (2, "off", False)
    assert (car.layers_per_step, car.mode, car.prefetch) == (2, "carried",
                                                              True)
    assert car.live_parameters == 4 * per and off.live_parameters == 2 * per


@pytest.mark.parametrize("sizes", [{"data": 4}, {"data": 2, "expert": 2},
                                   {"data": 1}, {"data": 8, "expert": 1}])
def test_partition_specs_match_jax(sizes):
    """zero_partition_spec over shapes and persistence thresholds, with and
    without an existing spec; filter_spec_axes; resolve_hpz_axes over
    group sizes, the errors' messages included."""
    shapes = [(), (7,), (8,), (32, 96), (96, 32), (64, 64), (3, 8, 12),
              (50304, 768), (5, 7)]
    for shape in shapes:
        for thr in (0, 10, 10 ** 6):
            ref = jpart.zero_partition_spec(shape, sizes, thr)
            assert tuple(ppart.zero_partition_spec(shape, sizes, thr)) == \
                tuple(ref), (shape, thr)
            if len(shape) == 2:
                ex_j = jax.sharding.PartitionSpec("model", None)
                ex_p = ppart.PartitionSpec("model", None)
                assert tuple(ppart.zero_partition_spec(
                    shape, sizes, thr, ex_p)) == tuple(
                        jpart.zero_partition_spec(shape, sizes, thr, ex_j))
    spec = (None, ("data", "expert"), "model")
    for keep in (lambda a: a != "expert", lambda a: a == "model",
                 lambda a: False):
        assert tuple(ppart.filter_spec_axes(ppart.PartitionSpec(*spec),
                                            keep)) == tuple(
            jpart.filter_spec_axes(jax.sharding.PartitionSpec(*spec), keep))
    for group in (1, 2, 3, 4, 8):
        try:
            ref = jpart.resolve_hpz_axes(sizes, group)
        except ValueError as e:
            with pytest.raises(ValueError) as port:
                ppart.resolve_hpz_axes(sizes, group)
            assert str(port.value) == str(e)
            continue
        assert ppart.resolve_hpz_axes(sizes, group) == ref


def test_stage3_layout_cuts_each_leaf_as_the_jax_spec():
    """Each leaf of the port's GPT-2 is cut along the dimension the JAX
    spec shards (a layer leaf on its own shape, the stream's per-layer
    spec), or kept whole under the threshold; the layout round-trips."""
    cfg = GPT2Config(num_layers=2, **SMALL)
    model = GPT2Model(cfg)
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    sizes = {"data": 4, "expert": 1}
    layout = ppart.Stage3Layout(shapes, sizes, 100, GPT2Model.layer_index,
                                GPT2Model.param_partition_spec)
    jspecs = JaxGPT2Model(JaxGPT2Config(num_layers=2, **SMALL)) \
        .param_partition_specs()
    for name, shape in shapes:
        parts = name.split(".")
        base = (jspecs["h"][parts[2]][1:] if parts[0] == "h" else
                jspecs[parts[0]] if parts[0] != "ln_f" else
                jspecs["ln_f"][parts[1]])
        spec = jpart.zero_partition_spec(shape, sizes, 100,
                                         jax.sharding.PartitionSpec(*base))
        dims = [i for i, e in enumerate(spec)
                if e is not None and e != "model"]
        assert layout.by_name[name].dim == (dims[0] if dims else None), name
    assert layout.by_name["h.0.attn_qkvb"].dim is None
    assert layout.by_name["h.0.attn_qkvw"].dim == 0
    assert layout.regions[0] == (0, layout.by_name["h.0.attn_qkvw"].offset)
    full = np.random.default_rng(0).standard_normal(
        sum(int(np.prod(s)) for _, s in shapes)).astype(np.float32)
    locals_ = [layout.local_from_whole(full, shapes, i) for i in range(4)]
    np.testing.assert_array_equal(layout.whole_from_locals(locals_, shapes),
                                  full)


# ---------------------------------------------------------------------- #
# trajectories against the JAX engine at data 4
# ---------------------------------------------------------------------- #
def _zero_cfg(mode, extra=None):
    cfg = {"stage": 3, "stage3_param_persistence_threshold": 0,
           "stage3_max_live_parameters": 2 * PER_LAYER,
           "stage3_prefetch_bucket_size": 2 * PER_LAYER,
           "stage3_prefetch_mode": mode}
    cfg.update(extra or {})
    return cfg


def _conf(zero_cfg, bf16):
    return {"train_micro_batch_size_per_gpu": 2,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            "zero_optimization": zero_cfg, "bf16": {"enabled": bf16},
            "steps_per_print": 10 ** 9}


def _tree(layers):
    """The JAX init tree with every leaf perturbed by seeded numpy noise, so
    that biases and LayerNorm parameters are not 0 / 1
    (tests/test_torch_training.py `_jax_params`)."""
    model = JaxGPT2Model(JaxGPT2Config(num_layers=layers, **SMALL))
    tree = jax.tree.map(np.asarray, model.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda a: (a + rng.standard_normal(a.shape) * 0.05)
                        .astype(np.float32), tree)


def _batch():
    return np.random.default_rng(1).integers(0, 64, (8, 16)).astype(np.int32)


def jax_run(layers, zero_cfg, bf16, steps=STEPS):
    """The JAX engine on four simulated devices: losses, final parameters,
    the stream plan."""
    jax_reset_mesh()
    jax_initialize_mesh(data=4, devices=jax.devices()[:4])
    model = JaxGPT2Model(JaxGPT2Config(num_layers=layers, bf16=bf16,
                                       **SMALL))
    eng = ds.initialize(model=model, config=_conf(zero_cfg, bf16),
                        model_parameters=_tree(layers))[0]
    ids = jnp.asarray(_batch())
    losses = []
    for _ in range(steps):
        loss = eng.forward(ids)
        eng.backward(loss)
        eng.step()
        losses.append(float(loss))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), eng.params)
    plan = eng._zero3_stream.last_plan
    jax_reset_mesh()
    return losses, params, plan


def port_engine(layers, zero_cfg, bf16, device="cpu"):
    dst.reset_mesh_context()
    cfg = GPT2Config(num_layers=layers, bf16=bf16, **SMALL)
    conf = dict(_conf(zero_cfg, bf16), mesh={"data": 4})
    return dst.initialize(model=GPT2Model(cfg), config=conf,
                          model_parameters=gpt2_params_from_jax(
                              _tree(layers), cfg), device=device)[0]


def port_run(layers, zero_cfg, bf16, steps=STEPS):
    eng = port_engine(layers, zero_cfg, bf16)
    ids = torch.from_numpy(_batch())
    losses = []
    for _ in range(steps):
        loss = eng.forward(ids)
        eng.backward(loss)
        eng.step()
        losses.append(loss.item())
    cfg = GPT2Config(num_layers=layers, bf16=bf16, **SMALL)
    params = gpt2_params_to_jax(
        {k: v.numpy() for k, v in eng.module_state_dict().items()}, cfg)
    return losses, params, eng


def drop_key_bias(tree):
    """The key third of attn_qkvb left out: its true gradient is zero, so
    Adam turns its rounding noise into updates of order lr
    (tests/test_torch_data_parallel.py)."""
    hid = SMALL["hidden_size"]
    tree = dict(tree, h=dict(tree["h"]))
    qkvb = tree["h"]["attn_qkvb"]
    tree["h"]["attn_qkvb"] = np.concatenate([qkvb[:, :hid],
                                             qkvb[:, 2 * hid:]], axis=1)
    return tree


def assert_params_close(params, ref, rtol, atol_rel):
    """Leaf by leaf, the key bias left out: |out - ref| <= rtol |ref| +
    atol_rel * max|ref| (tests/test_torch_training.py's rule)."""
    _assert_trees_close(drop_key_bias(params), drop_key_bias(ref), rtol,
                        atol_rel)


@pytest.fixture(scope="module")
def runs():
    """Trajectories shared by the tests below, by (side, layers, mode,
    bf16)."""
    cache = {}

    def get(side, layers, mode, bf16):
        if side == "jax" and (layers, mode) == (5, "unrolled"):
            # 5 groups: the JAX plan forfeits to off's, the same program
            mode = "off"
        key = (side, layers, mode, bf16)
        if key not in cache:
            fn = jax_run if side == "jax" else port_run
            cache[key] = fn(layers, _zero_cfg(mode), bf16)
        return cache[key]
    return get


@pytest.mark.parametrize("layers", [4, 5])
@pytest.mark.parametrize("mode", ["off", "carried", "unrolled"])
def test_trajectory_matches_jax_fp32(runs, layers, mode):
    """3 steps, W = 4, micro-batch 2 a rank, Adam lr 1e-3, dropout off:
    losses rtol 1e-5 (the JAX file's tolerance between its modes);
    parameters rtol 1e-5 plus 1e-3 of each leaf's largest entry, the key
    bias left out.  The JAX file's atol of 1e-7 holds between runs of one
    package only: Adam moves an entry by up to lr a step whatever its
    gradient's size, so the fp32 reassociation of a gradient near zero
    (the two packages sum in other orders) moves single entries by up to
    6e-5 here (one of 20480 in output_w), which the port's own modes do not
    show: they agree bit for bit (test_modes_are_bitwise_equal), and stage
    3 with stage 2 (test_stage3_equals_stage2_in_fp32_and_holds_shards).
    The plans agree (5 layers: unrolled forfeits to off)."""
    ref, ref_params, ref_plan = runs("jax", layers, mode, False)
    out, params, eng = runs("port", layers, mode, False)
    plan = eng._zero3_stream.last_plan
    assert plan.__dict__ == jstream.plan_layer_streaming(
        layers, PER_LAYER, 2 * PER_LAYER, 2 * PER_LAYER, mode).__dict__
    assert (plan.layers_per_step, plan.prefetch) == (
        ref_plan.layers_per_step, ref_plan.prefetch)
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    assert out[-1] < out[0]
    assert_params_close(params, ref_params, 1e-5, 1e-3)


@pytest.mark.parametrize("layers", [4, 5])
@pytest.mark.parametrize("mode", ["off", "carried", "unrolled"])
def test_trajectory_matches_jax_bf16(runs, layers, mode):
    """bf16: losses rtol 2e-2, parameters within 5e-2 of each leaf's
    largest entry (the tolerance the port's bf16 trajectories hold against
    the JAX engine, tests/test_torch_data_parallel.py)."""
    ref, ref_params, _ = runs("jax", layers, mode, True)
    out, params, _ = runs("port", layers, mode, True)
    np.testing.assert_allclose(out, ref, rtol=2e-2)
    assert_params_close(params, ref_params, 0.0, 5e-2)


@pytest.mark.parametrize("bf16", [False, True])
def test_modes_are_bitwise_equal(runs, bf16):
    """The three modes run the same ops on the same values: the port's
    losses and parameters agree bit for bit (4 layers: off gathers groups
    of 2, carried and unrolled groups of 1)."""
    out = {m: runs("port", 4, m, bf16) for m in ("off", "carried",
                                                 "unrolled")}
    for mode in ("carried", "unrolled"):
        assert out[mode][0] == out["off"][0]
        for a, b in zip(jax.tree.leaves(out[mode][1]),
                        jax.tree.leaves(out["off"][1])):
            np.testing.assert_array_equal(a, b)


def test_stage3_equals_stage2_in_fp32_and_holds_shards(runs):
    """In fp32 the gather and the rank-order fp32 reduce-scatter change no
    bit: stage 3 trains as stage 2 does.  Each rank holds only its pieces
    (a quarter of every leaf that a free dimension lets it cut; attn_qkvb
    and inter_b, whose one dimension the tensor-parallel spec claims, stay
    whole, as in the JAX engine), and `engine.module`'s parameters are
    placeholders."""
    out, params, eng = runs("port", 4, "off", False)
    conf = _zero_cfg("off")
    conf["stage"] = 2
    ref, ref_params, _ = port_run(4, conf, False)
    assert out == ref
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(ref_params)):
        np.testing.assert_array_equal(a, b)
    total = sum(int(np.prod(s)) for _, s in eng._shapes)
    whole = {leaf.name.split(".")[-1] for leaf in eng._layout.leaves
             if leaf.dim is None}
    assert whole == {"attn_qkvb", "inter_b"}
    held = sum(leaf.numel for leaf in eng._layout.leaves)
    assert all(f.numel() == held for f in eng._flats)
    assert held * 4 == total + 3 * sum(
        leaf.numel for leaf in eng._layout.leaves if leaf.dim is None)
    for name, p in eng.module.named_parameters():
        assert p.numel() == 0 and tuple(p.ds_shape) == eng._layout.by_name[
            name].shape
    mem = eng.estimate_memory()
    assert mem["params"] == total and mem["grads"] == total


def test_live_set_stays_within_the_plan(runs):
    """The gathered bytes' high-water mark a rank: at most the plan's
    live parameters x 4 bytes (fp32); off holds one group, carried two."""
    for mode in ("off", "carried", "unrolled"):
        _, _, eng = runs("port", 4, mode, False)
        stream = eng._zero3_stream
        plan = stream.last_plan
        assert 0 < stream.peak_live_bytes <= plan.live_parameters * 4
        assert stream.live_bytes == [0] * 4


def test_dropout_modes_are_bitwise_equal():
    """With dropout 0.1 in bf16, carried recomputes each group with the
    masks redrawn from the saved generator states: bitwise off's."""
    out = {}
    for mode in ("off", "carried"):
        dst.reset_mesh_context()
        cfg = GPT2Config(num_layers=4, bf16=True,
                         **dict(SMALL, embd_dropout=0.1, attn_dropout=0.1,
                                hidden_dropout=0.1))
        conf = dict(_conf(_zero_cfg(mode), True), mesh={"data": 4})
        eng = dst.initialize(model=GPT2Model(cfg), config=conf,
                             model_parameters=gpt2_params_from_jax(
                                 _tree(4), cfg), device="cpu")[0]
        ids = torch.from_numpy(_batch())
        losses = []
        for _ in range(2):
            loss = eng.forward(ids)
            eng.backward(loss)
            eng.step()
            losses.append(loss.item())
        out[mode] = (losses, [f.clone() for f in eng._flats],
                     [g.get_state() for g in eng._rngs])
    assert out["carried"][0] == out["off"][0]
    for a, b in zip(out["carried"][1], out["off"][1]):
        assert torch.equal(a, b)
    for a, b in zip(out["carried"][2], out["off"][2]):
        assert torch.equal(a, b)


def test_persistent_leaves_stay_whole_and_sum_over_ranks():
    """A persistence threshold above the biases keeps them whole on every
    rank (their grads summed over the ranks at the step, counted once in
    the clipped norm); the trajectory matches the JAX engine's."""
    zc = _zero_cfg("carried", {"stage3_param_persistence_threshold": 200})
    ref, ref_params, _ = jax_run(4, zc, False)
    conf = dict(zc)
    eng = port_engine(4, conf, False)
    assert eng._whole_segments
    ids = torch.from_numpy(_batch())
    out = []
    for _ in range(STEPS):
        loss = eng.forward(ids)
        eng.backward(loss)
        eng.step()
        out.append(loss.item())
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    cfg = GPT2Config(num_layers=4, **SMALL)
    params = gpt2_params_to_jax(
        {k: v.numpy() for k, v in eng.module_state_dict().items()}, cfg)
    assert_params_close(params, ref_params, 1e-5, 1e-3)


def test_low_bandwidth_below_stage3_warns_and_is_ignored(monkeypatch):
    """At stage 2 the low_bandwidth block is ignored with the JAX engine's
    warning: the run is plain stage 2's, bit for bit."""
    from deepspeed_tpu_torch.runtime import engine as engine_mod
    warned = []
    monkeypatch.setattr(engine_mod.logger, "warning", warned.append)
    zc = {"stage": 2, "low_bandwidth": {"qwz_bits": 8, "qgz_bits": 8}}
    out, params, _ = port_run(4, zc, False)
    assert any("only apply to the stage-3" in w for w in warned)
    ref, ref_params, _ = port_run(4, {"stage": 2}, False)
    assert out == ref
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(ref_params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("optimizer", [
    {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}},
    {"type": "Lamb", "params": {"lr": 1e-3, "weight_decay": 0.01}}])
def test_adamw_and_lamb_over_shards_match_stage2(optimizer):
    """AdamW and Lamb (per-leaf trust ratios over the ranks' pieces) with
    gradient clipping at stage 3 give stage 2's parameters (fp32; Lamb's
    norms sum in another order: rtol 1e-6)."""
    out = {}
    for stage in (2, 3):
        dst.reset_mesh_context()
        cfg = GPT2Config(num_layers=4, **SMALL)
        conf = dict(_conf(_zero_cfg("carried"), False), mesh={"data": 4},
                    optimizer=optimizer, gradient_clipping=0.05)
        conf["zero_optimization"]["stage"] = stage
        eng = dst.initialize(model=GPT2Model(cfg), config=conf,
                             model_parameters=gpt2_params_from_jax(
                                 _tree(4), cfg), device="cpu")[0]
        ids = torch.from_numpy(_batch())
        for _ in range(2):
            eng.backward(eng.forward(ids))
            eng.step()
        out[stage] = eng.module_state_dict()
    for k in out[2]:
        np.testing.assert_allclose(out[3][k].numpy(), out[2][k].numpy(),
                                   rtol=1e-6, atol=1e-8, err_msg=k)


@pytest.mark.parametrize("mode", ["off", "carried"])
def test_steps_leave_no_pass_and_the_engine_is_freed(mode):
    """A step's gathers, graph and pass are gone after it (no cycle runs
    through the autograd graph), and a deleted stage-3 engine is freed
    with its buffers (its placeholders hold it weakly)."""
    import gc
    import weakref
    eng = port_engine(4, _zero_cfg(mode), True)
    ids = torch.from_numpy(_batch())
    for _ in range(2):
        eng.backward(eng.forward(ids))
        eng.step()
    eng._last_loss = eng._rank_losses = None
    gc.collect()
    assert not [o for o in gc.get_objects() if isinstance(o, pstream._Pass)
                and o.stream is eng._zero3_stream]
    refs = [weakref.ref(x) for x in (eng, eng._flats[0], eng._zero3_stream)]
    del eng
    gc.collect()
    assert all(r() is None for r in refs)


def test_forfeited_prefetch_is_recorded_as_a_degradation():
    """unrolled at 5 layers cannot pair its groups: the plan forfeits to
    off with the JAX string, and the degradation registry holds the
    `zero3_prefetch` overlapped -> serialized event with it."""
    from deepspeed_tpu_torch.runtime.resilience.degradation import \
        get_registry
    get_registry().clear()
    eng = port_engine(5, _zero_cfg("unrolled"), False)
    plan = eng._zero3_stream.last_plan
    assert plan.mode == "off" and plan.forfeited
    events = [e for e in get_registry().events()
              if e["subsystem"] == "zero3_prefetch"]
    assert len(events) == 1 and events[0]["reason"] == plan.forfeited
    assert (events[0]["from_tier"], events[0]["to_tier"]) == (
        "overlapped", "serialized")
    get_registry().clear()
