"""Int8 weight quantization for inference (counterpart of
deepspeed_tpu/runtime/weight_quantizer.py).

The same numpy algorithm as the JAX package, so the int8 bytes and the
scales come out bit-identical: symmetric per-group int8 along the rows,
scale = max|w| / 127 per group (at least 1e-12), round half to even.
"""

import numpy as np
import torch

from ..ops.quant import QuantizedWeight, dequant
from ..utils.logging import logger


def quantize_weight(w, num_groups: int = 1, device=None) -> QuantizedWeight:
    """Symmetric per-group int8 quantization along the first (row) axis.
    A group count that does not divide the rows falls back to one group."""
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().float().numpy()
    w = np.asarray(w, dtype=np.float32)
    if w.ndim != 2:
        raise ValueError(f"only 2-D weights quantize, got shape {w.shape}")
    rows = w.shape[0]
    if rows % num_groups != 0:
        logger.warning(
            f"quantize groups {num_groups} does not divide {rows} rows — "
            f"falling back to a single scale group for this weight")
        num_groups = 1
    grouped = w.reshape(num_groups, rows // num_groups, -1)
    scale = np.abs(grouped).max(axis=(1, 2), keepdims=True) / 127.0
    scale = np.maximum(scale, 1e-12)
    q = np.clip(np.round(grouped / scale), -127, 127).astype(np.int8)
    return QuantizedWeight(
        torch.from_numpy(q.reshape(rows, -1)).to(device),
        torch.from_numpy(scale.reshape(num_groups, 1).astype(np.float32)).to(device))


def dequantize_weight(qw: QuantizedWeight) -> torch.Tensor:
    return dequant(qw, torch.float32)


class WeightQuantization:
    """Quantize the matmul weights of a transformer layer's parameters."""

    # the per-layer matmul weights worth quantizing (bias/LN stay fp)
    LAYER_TARGETS = ("attn_qkvw", "attn_ow", "inter_w", "output_w")

    def __init__(self, mlp_extra_grouping: bool = False,
                 quantize_groups: int = 1):
        self.quantize_groups = quantize_groups
        self.mlp_extra_grouping = mlp_extra_grouping

    def _groups_for(self, name: str) -> int:
        if self.mlp_extra_grouping and name in ("inter_w", "output_w"):
            return self.quantize_groups * 2
        return self.quantize_groups

    def quantize_layer_params(self, layer_params: dict, device=None) -> dict:
        """A copy of one layer's parameter dict with the four matmul weights
        replaced by QuantizedWeights on `device`."""
        out = dict(layer_params)
        for name in self.LAYER_TARGETS:
            if name in out:
                out[name] = quantize_weight(out[name], self._groups_for(name),
                                            device)
        return out
