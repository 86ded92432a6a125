"""Static and dynamic loss scaling on device scalars (counterpart of
deepspeed_tpu/runtime/fp16/loss_scaler.py; reference:
deepspeed/runtime/fp16/loss_scaler.py:221).

The scaler is split as in the JAX package: a static config and a state of
three 0-dim tensors on the engine's device, updated with selects
(`torch.where`) so that the step reads nothing back to the host.  bf16 and
fp32 runs keep the static scale 1.0; an fp16 run (`"fp16": {"enabled":
true}`) takes the dynamic scaler, or the static `loss_scale`, from its
config, and the engine reads the overflow flag once a step to count a
skipped step, as the JAX engine does.
"""

from dataclasses import dataclass
from typing import NamedTuple

import torch


@dataclass(frozen=True)
class LossScalerConfig:
    """Static scaler configuration (not part of the state)."""
    dynamic: bool = False
    scale_window: int = 1000
    scale_factor: float = 2.0
    min_loss_scale: float = 1.0
    init_hysteresis: int = 2
    init_scale: float = 1.0


class LossScaleState(NamedTuple):
    loss_scale: torch.Tensor   # fp32 0-dim: the current scale
    good_steps: torch.Tensor   # int32 0-dim: consecutive overflow-free steps
    hysteresis: torch.Tensor   # int32 0-dim: overflows still tolerated


def create_loss_scaler(fp16_config=None, static_scale: float = 1.0,
                       device=None):
    """(config, state) from an FP16Config (keys loss_scale /
    initial_scale_power / loss_scale_window / hysteresis / min_loss_scale);
    without an enabled fp16 config, the static `static_scale`."""
    if fp16_config is not None and fp16_config.enabled:
        if fp16_config.dynamic_loss_scale:
            cfg = LossScalerConfig(
                dynamic=True,
                scale_window=int(fp16_config.loss_scale_window),
                min_loss_scale=float(fp16_config.min_loss_scale),
                init_hysteresis=int(fp16_config.hysteresis),
                init_scale=2.0 ** fp16_config.initial_scale_power)
        else:
            cfg = LossScalerConfig(dynamic=False,
                                   init_scale=float(fp16_config.loss_scale))
    else:
        cfg = LossScalerConfig(dynamic=False, init_scale=static_scale)
    state = LossScaleState(
        loss_scale=torch.tensor(cfg.init_scale, dtype=torch.float32,
                                device=device),
        good_steps=torch.tensor(0, dtype=torch.int32, device=device),
        hysteresis=torch.tensor(cfg.init_hysteresis, dtype=torch.int32,
                                device=device))
    return cfg, state


def update_loss_scale(cfg: LossScalerConfig, state: LossScaleState,
                      overflow) -> LossScaleState:
    """One scaler transition (reference: loss_scaler.py update_scale):

    - overflow, hysteresis exhausted: scale = max(scale / factor, min) and
      the good-step count resets;
    - overflow, hysteresis left: one hysteresis credit is burnt;
    - clean step: good_steps += 1; every scale_window clean steps the scale
      grows by the factor and the hysteresis resets.
    """
    if not cfg.dynamic:
        return state
    overflow = torch.as_tensor(overflow, device=state.loss_scale.device)
    exhausted = state.hysteresis <= 1
    of_scale = torch.where(
        exhausted,
        torch.clamp(state.loss_scale / cfg.scale_factor,
                    min=cfg.min_loss_scale),
        state.loss_scale)
    of_hyst = torch.where(exhausted, state.hysteresis, state.hysteresis - 1)
    grow = (state.good_steps + 1) % cfg.scale_window == 0
    clean_scale = torch.where(grow, state.loss_scale * cfg.scale_factor,
                              state.loss_scale)
    clean_hyst = torch.where(grow, torch.full_like(state.hysteresis,
                                                   cfg.init_hysteresis),
                             state.hysteresis)
    return LossScaleState(
        loss_scale=torch.where(overflow, of_scale, clean_scale),
        good_steps=torch.where(overflow, torch.zeros_like(state.good_steps),
                               state.good_steps + 1),
        hysteresis=torch.where(overflow, of_hyst, clean_hyst))
