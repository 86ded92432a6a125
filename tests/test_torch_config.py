"""Config and refusals of the port's training entry point: the port's copy
of the config module parses every example config and the flagship config
to the same values as the JAX package, raises the same errors, and
`initialize` refuses what is not ported yet with the ROADMAP.md item that
ports it."""

import dataclasses
import glob
import os

import pytest
import torch

from deepspeed_tpu.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu.config import DeepSpeedConfigError as JaxConfigError
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.config import DeepSpeedConfig, DeepSpeedConfigError
from deepspeed_tpu_torch.models import GPT2Config, GPT2Model
from deepspeed_tpu_torch.ops.transformer import (DeepSpeedTransformerConfig,
                                                 DeepSpeedTransformerLayer)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(REPO, "docs", "examples", "*.json")))
# bench.py::bench_gpt2's config (bench.py:501-509), the flagship row
FLAGSHIP = {"train_micro_batch_size_per_gpu": 8,
            "gradient_accumulation_steps": 1,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 6e-4, "weight_decay": 0.1}},
            "bf16": {"enabled": True}, "zero_optimization": {"stage": 2}}


def _values(obj):
    """Plain values of a parsed config: dataclasses by field, dicts and
    sequences element-wise (the two packages' classes differ, their values
    must not)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _values(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _values(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_values(v) for v in obj]
    return obj


@pytest.mark.parametrize("config", EXAMPLES + [FLAGSHIP],
                         ids=[os.path.basename(p) for p in EXAMPLES]
                         + ["flagship"])
@pytest.mark.parametrize("world_size", [1, 8])
def test_config_parses_to_the_jax_values(config, world_size):
    """Every attribute of the parsed config, batch triple included, equals
    the JAX package's at data-parallel world 1 and 8."""
    ours = vars(DeepSpeedConfig(config, world_size=world_size))
    ref = vars(JaxDeepSpeedConfig(config, world_size=world_size))
    assert ours.keys() == ref.keys()
    for key in ref:
        assert _values(ours[key]) == _values(ref[key]), key
    assert len(EXAMPLES) == 11


@pytest.mark.parametrize("config", [
    {"train_batch_size": 10, "train_micro_batch_size_per_gpu": 3,
     "gradient_accumulation_steps": 2},
    {"gradient_accumulation_steps": 2},
    {},
    {"train_batch_size": 8,
     "zero_optimization": {"stage": 3, "low_bandwidth": {"qwz_bits": 5}}},
])
def test_config_errors_match_jax(config):
    """Inconsistent batch triples and out-of-range values raise
    DeepSpeedConfigError in both packages, with the same message."""
    with pytest.raises(JaxConfigError) as ref:
        JaxDeepSpeedConfig(config)
    with pytest.raises(DeepSpeedConfigError) as ours:
        DeepSpeedConfig(config)
    assert str(ours.value) == str(ref.value)


def test_duplicate_keys_are_refused_as_by_jax(tmp_path):
    path = tmp_path / "dup.json"
    path.write_text('{"train_batch_size": 8, "train_batch_size": 4}')
    for cls in (JaxDeepSpeedConfig, DeepSpeedConfig):
        with pytest.raises(ValueError, match="train_batch_size"):
            cls(str(path))


TINY = dict(vocab_size=128, n_positions=64, hidden_size=32, num_layers=2,
            num_heads=4, bf16=False)


@pytest.mark.parametrize("block,item", [
    ({"monitor": {"enabled": True, "moe": {"enabled": True}}}, "A.10"),
    ({"optimizer": {"type": "OneBitAdam", "params": {"lr": 1e-3}},
      "zero_optimization": {"stage": 2, "low_bandwidth": {"onebit": True}}},
     "A.8"),
    ({"zero_optimization": {"stage": 3}, "mesh": {"expert": 2}}, "A.10"),
    ({"sequence_parallel": {"size": 2}}, "A.9"),
    ({"mesh": {"model": 2}}, "A.9"),
    ({"resilience": {"enabled": True, "chaos": {"enabled": True}}}, "A.13"),
    ({"flops_profiler": {"enabled": True}}, "A.13"),
    ({"analysis": {"mode": "warn"}}, "A.14"),
    ({"progressive_layer_drop": {"enabled": True}}, "A.13"),
    ({"curriculum_learning": {"enabled": True, "curriculum_type": "seqlen",
                              "min_difficulty": 8, "max_difficulty": 64,
                              "schedule_type": "fixed_linear",
                              "schedule_config": {"total_curriculum_step": 10,
                                                  "difficulty_step": 8}}},
     "A.13"),
    ({"quantize_training": {"enabled": True}}, "A.13"),
    ({"eigenvalue": {"enabled": True}}, "A.13"),
    ({"sparse_gradients": True}, "A.13"),
])
def test_unported_config_blocks_are_refused(block, item):
    conf = dict(FLAGSHIP, bf16={"enabled": False})
    conf.update(block)
    dst.reset_mesh_context()  # the case's own mesh block, not the last one
    with pytest.raises(NotImplementedError, match=rf"ROADMAP\.md .*{item}"):
        dst.initialize(model=GPT2Model(GPT2Config(**TINY)), config=conf,
                       device="cpu")
    dst.reset_mesh_context()


@pytest.mark.parametrize("block", [
    {"zero_optimization": {"stage": 3, "offload_optimizer":
                           {"device": "cpu"}}, "mesh": {"data": 2}},
    {"zero_optimization": {"stage": 2, "offload_optimizer":
                           {"device": "cpu"}},
     "resilience": {"sentinel": {"enabled": True}}},
    {"zero_optimization": {"stage": 3, "offload_param":
                           {"device": "cpu"}}, "mesh": {"data": 2}},
    {"zero_optimization": {"stage": 2, "offload_optimizer":
                           {"device": "nvme"}},
     "resilience": {"sentinel": {"enabled": True}}},
    {"zero_optimization": {"stage": 3, "offload_optimizer":
                           {"device": "nvme"}}, "mesh": {"data": 2}},
])
def test_offload_tier_config_blocks_now_run(tmp_path, block):
    """The five offload-tier cases that left the refusal list with
    ROADMAP.md A.7b: the tier at stage 3 over two ranks (cpu and nvme),
    with the sentinel (cpu and nvme), and the streaming engine over two
    ranks, each initialized and stepped (the swap files under tmp_path;
    tests/test_torch_offload_dp.py holds them against the JAX engine)."""
    conf = dict(FLAGSHIP, bf16={"enabled": False})
    conf.update(block)
    zo = dict(conf["zero_optimization"])
    for key in ("offload_optimizer", "offload_param"):
        if key in zo:
            zo[key] = dict(zo[key], nvme_path=str(tmp_path))
    conf["zero_optimization"] = zo
    world = conf.get("mesh", {}).get("data", 1)
    dst.reset_mesh_context()
    model = GPT2Model(GPT2Config(**TINY))
    model.init_params(torch.Generator().manual_seed(0))
    eng = dst.initialize(model=model, config=conf, device="cpu")[0]
    assert eng.world_size == world
    ids = torch.zeros(FLAGSHIP["train_micro_batch_size_per_gpu"] * world,
                      TINY["n_positions"], dtype=torch.long)
    loss = eng.forward(ids)
    eng.backward(loss)
    eng.step()
    assert torch.isfinite(loss) and eng.global_steps == 1
    assert eng.optimizer.step_count() == 1
    dst.reset_mesh_context()


def test_zero3_with_activation_checkpointing_is_refused():
    """Refused until ROADMAP.md A.5b ported per-layer recompute inside the
    streamed layer groups: GPT2Config(activation_checkpointing=True) at
    stage 3 now initializes, with `checkpoint.sharded` set too, and steps
    (tests/test_torch_zero3_remat.py holds it against the JAX engine)."""
    dst.reset_mesh_context()
    conf = dict(FLAGSHIP, bf16={"enabled": False},
                zero_optimization={"stage": 3}, mesh={"data": 2},
                checkpoint={"sharded": True})
    model = GPT2Model(GPT2Config(**dict(TINY, activation_checkpointing=True)))
    eng = dst.initialize(model=model, config=conf, device="cpu")[0]
    assert eng._zero3 and eng._sharded_checkpoints()
    ids = torch.zeros(FLAGSHIP["train_micro_batch_size_per_gpu"] * 2,
                      TINY["n_positions"], dtype=torch.long)
    loss = eng.forward(ids)
    eng.backward(loss)
    eng.step()
    assert torch.isfinite(loss)
    dst.reset_mesh_context()


def test_zero3_remat_under_fused_step_is_refused():
    """Refused until ROADMAP.md A.5c let the fused step's window hold the
    stage-3 recompute with its dropout redraws: stage 3 with activation
    checkpointing and the fused step now initializes and runs its windows
    (eager on the CPU; tests/test_torch_offload_dp.py holds them bitwise
    against the modular loop)."""
    dst.reset_mesh_context()
    conf = dict(FLAGSHIP, bf16={"enabled": False},
                zero_optimization={"stage": 3}, mesh={"data": 2},
                fused_step={"enabled": True})
    model = GPT2Model(GPT2Config(**dict(TINY, activation_checkpointing=True)))
    eng = dst.initialize(model=model, config=conf, device="cpu")[0]
    assert eng._zero3 and eng._fused is not None
    ids = torch.zeros(FLAGSHIP["train_micro_batch_size_per_gpu"] * 2,
                      TINY["n_positions"], dtype=torch.long)
    loss = eng.train_batch(iter([(ids,)]))
    assert torch.isfinite(loss) and eng.global_steps == 1
    dst.reset_mesh_context()


@pytest.mark.parametrize("stage", [2, 3])
def test_zero3_and_low_bandwidth_blocks_now_run(stage):
    """The cases that left the refusal list: stage 3, and the
    low_bandwidth block at stages 2 and 3, build an engine that trains."""
    dst.reset_mesh_context()
    conf = dict(FLAGSHIP, bf16={"enabled": False}, mesh={"data": 2},
                zero_optimization={"stage": stage, "low_bandwidth": {
                    "qwz_bits": 8, "qgz_bits": 8}})
    eng = dst.initialize(model=GPT2Model(GPT2Config(**TINY)), config=conf,
                         device="cpu")[0]
    ids = torch.randint(0, TINY["vocab_size"], (
        eng.train_micro_batch_size_per_gpu() * 2, 16))
    eng.backward(eng.forward(ids))
    eng.step()
    assert eng.global_steps == 1
    assert (eng._zero3_stream is not None) == (stage == 3)
    dst.reset_mesh_context()


@pytest.mark.parametrize("section", [{"mode": "fixed"},
                                     {"mode": "bigbird", "block": 16}])
def test_sparse_attention_section_is_accepted(section):
    """The JSON `sparse_attention` section is parsed and stored, as the JAX
    engine does; the model's SparsityConfig routes the attention."""
    conf = dict(FLAGSHIP, bf16={"enabled": False}, sparse_attention=section)
    eng = dst.initialize(model=GPT2Model(GPT2Config(**TINY)), config=conf,
                         device="cpu")[0]
    assert eng.config.sparse_attention == section
    assert JaxDeepSpeedConfig(conf, world_size=1).sparse_attention == section


def test_unported_model_features_are_refused():
    with pytest.raises(NotImplementedError, match="post-LN"):
        DeepSpeedTransformerLayer(DeepSpeedTransformerConfig(
            hidden_size=32, heads=4, pre_layer_norm=False))
    with pytest.raises(NotImplementedError, match="A.9-A.10"):
        dst.initialize(model=torch.nn.Linear(2, 2), config=FLAGSHIP,
                       device="cpu")
    eng = dst.initialize(model=GPT2Model(GPT2Config(**TINY)),
                         config=dict(FLAGSHIP, bf16={"enabled": False}),
                         device="cpu")[0]
    with pytest.raises(FileNotFoundError):
        eng.load_checkpoint("/nonexistent")


def test_initialize_defaults_to_cuda_and_raises_without_a_gpu():
    """device=None means "cuda": with no GPU it raises instead of falling
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dst.initialize(model=GPT2Model(GPT2Config(**TINY)), config=FLAGSHIP)


def test_initialize_returns_the_four_tuple():
    data = [torch.randint(0, 128, (16,)) for _ in range(8)]
    conf = dict(FLAGSHIP, bf16={"enabled": False},
                train_micro_batch_size_per_gpu=4,
                scheduler={"type": "WarmupLR",
                           "params": {"warmup_num_steps": 10}})
    engine, opt, loader, sched = dst.initialize(
        model=GPT2Model(GPT2Config(**TINY)), config=conf, training_data=data,
        device="cpu")
    assert opt is engine.optimizer and sched is engine.lr_scheduler
    assert len(loader) == 2 and next(iter(loader)).shape == (4, 16)
    assert sched.lr_at(5) == pytest.approx(0.0005)
