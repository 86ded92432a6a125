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
    ({"zero_optimization": {"stage": 3}}, "A.5"),
    ({"zero_optimization": {"stage": 2, "offload_optimizer":
                            {"device": "cpu"}}}, "A.7"),
    ({"zero_optimization": {"stage": 3, "offload_param":
                            {"device": "cpu"}}}, "A.5"),
    ({"zero_optimization": {"stage": 2, "offload_optimizer":
                            {"device": "nvme"}}}, "A.7"),
    ({"monitor": {"enabled": True, "moe": {"enabled": True}}}, "A.10"),
    ({"optimizer": {"type": "OneBitAdam", "params": {"lr": 1e-3}},
      "zero_optimization": {"stage": 2, "low_bandwidth": {"onebit": True}}},
     "A.8"),
    ({"zero_optimization": {"stage": 3, "low_bandwidth": {"qwz_bits": 8}}},
     "A.5"),
    ({"zero_optimization": {"stage": 2, "low_bandwidth": {"qgz_bits": 8}}},
     "A.5"),
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
    with pytest.raises(NotImplementedError, match=rf"ROADMAP\.md .*{item}"):
        dst.initialize(model=GPT2Model(GPT2Config(**TINY)), config=conf,
                       device="cpu")


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
