"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu for NVIDIA
Hopper (H100).

It mirrors the JAX package's module paths and names; every TPU (Pallas)
kernel on a ported path is a hand-written CUDA kernel here
(deepspeed_tpu_torch/csrc/), and what the JAX package leaves to XLA is
plain PyTorch.  This package imports torch and numpy, never jax and
nothing of deepspeed_tpu.

Ported so far: serving, and training with ZeRO-1/2 data parallelism over
the ranks of a single-controller mesh or over one process a card
(`init_distributed`, then `initialize` in every process).  `init_inference` ->
`InferenceEngine` (`forward`, `generate`) over GPT-2, with int8 weights
under `quantization_setting`; `initialize` -> `DeepSpeedEngine`
(`forward`, `backward`, `step`, `train_batch`, `save_checkpoint`,
`load_checkpoint`) over GPT-2 in bf16 or fp32, on the data-parallel ranks
of the config's "mesh" block, of `mesh=` or of the mesh `initialize_mesh`
registered.  Checkpoints are the JAX package's layout, so a run moves
between the packages; `init_inference(checkpoint=...)` serves one.
"""

import torch

from .version import __version__
from .parallel import (MeshContext, get_mesh_context, groups,
                       initialize_mesh, reset_mesh_context)
from .utils import init_distributed, logger, log_dist


_DTYPE_NAMES = {torch.float32: ("fp32", "float32"),
                torch.bfloat16: ("bf16", "bfloat16")}


def _is_torch_module(model) -> bool:
    return hasattr(model, "named_parameters") and hasattr(model, "children")


def _resolve_device(device, entry: str) -> torch.device:
    """None means "cuda", which must be present: the port does not fall
    back to the CPU unless the caller asks for it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{entry}: no CUDA device is available; the port runs on "
            "the GPU and does not fall back to the CPU (pass device='cpu' "
            "explicitly for the plain PyTorch path)")
    return device


def initialize(model=None, config=None, config_params=None, optimizer=None,
               model_parameters=None, lr_scheduler=None, training_data=None,
               collate_fn=None, device=None, mesh=None):
    """Create a training engine (deepspeed_tpu.initialize).  Returns
    (engine, optimizer, dataloader, lr_scheduler).

    model: a deepspeed_tpu_torch GPT2Model.  config (or config_params): the
    DeepSpeed JSON config, a dict or a path.  model_parameters: the model's
    state dict (e.g. from models.convert.gpt2_params_from_jax); None keeps
    the model's own weights.  optimizer: None (the config's) or a
    runtime.optimizers.FlatOptimizer; lr_scheduler: None (the config's) or
    an object with lr_at(step).  device: None means "cuda", which must be
    present; pass device="cpu" to run the plain PyTorch versions of the
    kernels.  mesh: None (the registered mesh, else the config's "mesh"
    block over every visible card, or over the one device that `device`
    names when it is "cpu" or "cuda:k") or a parallel.MeshContext; its data
    axis is the data-parallel world.

    One process a card: call `init_distributed()` first in every process
    (torchrun's, dslaunch's or OpenMPI's env), then `initialize` with the
    same config; device None means this process's card, the mesh holds one
    rank a process, and each process passes `forward` its own rows.
    Features not ported yet raise NotImplementedError naming their
    ROADMAP.md item."""
    from .config import DeepSpeedConfigError
    from .runtime.engine import DeepSpeedEngine

    cfg = config if config is not None else config_params
    if cfg is None:
        raise DeepSpeedConfigError("DeepSpeed requires a config (dict or path)")
    device = _resolve_device(device, "initialize")
    engine = DeepSpeedEngine(model=model, config=cfg, optimizer=optimizer,
                             model_parameters=model_parameters,
                             lr_scheduler=lr_scheduler,
                             training_data=training_data,
                             collate_fn=collate_fn, device=device, mesh=mesh)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)


def init_inference(model, mp_size=1, checkpoint=None, dtype=None,
                   quantization_setting=None, model_parameters=None,
                   device=None):
    """Create an inference engine (deepspeed_tpu.init_inference).

    model: a deepspeed_tpu_torch GPT2Model.  model_parameters: its state
    dict (e.g. from models.convert.gpt2_params_from_jax).  checkpoint: a
    training checkpoint's directory (either package's layout), whose
    `latest` tag's module weights are served when model_parameters is
    None; with neither, the model keeps its own weights.  dtype: None or the model's compute dtype
    (config.bf16 sets it; int8 weights come from quantization_setting, an
    int group count or (mlp_extra_grouping, groups)).  device: None means
    "cuda", which must be present; pass device="cpu" to run the plain
    PyTorch versions of the kernels."""
    from .inference.engine import InferenceEngine
    from .models.gpt2 import GPT2Model

    if mp_size > 1:
        raise NotImplementedError(
            f"mp_size={mp_size}: tensor-parallel serving over NCCL is not "
            "ported yet (ROADMAP.md A.12, inference: tensor parallelism, on "
            "A.4b's process groups)")
    if not isinstance(model, GPT2Model):
        if _is_torch_module(model):
            raise NotImplementedError(
                f"{type(model).__name__}: injecting a Hugging Face / torch "
                "module is not ported yet (ROADMAP.md A.12, inference: "
                "module_inject); build a deepspeed_tpu_torch GPT2Model")
        raise TypeError(f"init_inference takes a GPT2Model, got "
                        f"{type(model).__name__}")
    compute = model.config.dtype
    if dtype is not None and dtype != compute and \
            dtype not in _DTYPE_NAMES[compute]:
        raise ValueError(
            f"dtype={dtype!r} differs from the model's compute dtype "
            f"{compute} (set GPT2Config.bf16); int8 weights come from "
            "quantization_setting, not dtype")
    device = _resolve_device(device, "init_inference")
    return InferenceEngine(model, quantization_setting=quantization_setting,
                           model_parameters=model_parameters, device=device,
                           checkpoint=checkpoint)
