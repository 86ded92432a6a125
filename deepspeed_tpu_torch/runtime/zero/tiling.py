"""TiledLinear: a linear layer split into memory-bounded tiles
(counterpart of deepspeed_tpu/runtime/zero/tiling.py).

The JAX module keeps the tile grid as a leading [in_splits, out_splits]
pair of axes on the weight and scans over the input tiles, accumulating
partial outputs, each scan step under `jax.checkpoint`, so that one tile's
product is live at a time in the forward and in the backward.  Here the
weight is one parameter [in_splits, out_splits, tile_in, tile_out] and
the bias [out_splits, tile_out]; the forward loops over the input tiles
and each step is a non-reentrant `torch.utils.checkpoint`, recomputed in
the backward.  `from_dense` cuts a dense [in, out] weight in the JAX tile
order.  Plain PyTorch: no kernel stands behind it.
"""

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint


def _step(acc, x_tile, w_tile):
    """One input tile's partial output added to the accumulator:
    x_tile [..., tile_in] by w_tile [out_splits, tile_in, tile_out]."""
    return acc + torch.einsum("...i,oij->...oj", x_tile,
                              w_tile.to(x_tile.dtype))


class TiledLinear(nn.Module):
    """x [..., in_features] -> [..., out_features] over an in_splits x
    out_splits grid of tiles (parameters `w` and `b`, the JAX module's
    names and layouts)."""

    def __init__(self, in_features: int, out_features: int,
                 in_splits: int = 1, out_splits: int = 1, bias: bool = True,
                 init_scale: float = 0.02, dtype=torch.float32, device=None):
        super().__init__()
        if in_features % in_splits or out_features % out_splits:
            raise ValueError(
                f"splits ({in_splits},{out_splits}) must divide features "
                f"({in_features},{out_features})")
        self.in_features, self.out_features = in_features, out_features
        self.in_splits, self.out_splits = in_splits, out_splits
        self.tile_in = in_features // in_splits
        self.tile_out = out_features // out_splits
        self.init_scale = init_scale
        self.w = nn.Parameter(torch.zeros(
            in_splits, out_splits, self.tile_in, self.tile_out, dtype=dtype,
            device=device))
        self.b = (nn.Parameter(torch.zeros(out_splits, self.tile_out,
                                           dtype=dtype, device=device))
                  if bias else None)

    @torch.no_grad()
    def init_params(self, generator: Optional[torch.Generator] = None):
        """w ~ N(0, init_scale) from `generator`, b 0 (the JAX module's
        init; its draws come from a JAX key, so the values differ)."""
        self.w.normal_(0.0, self.init_scale, generator=generator)
        if self.b is not None:
            self.b.zero_()
        return self

    @staticmethod
    def param_partition_specs():
        """The JAX module's tensor-parallel specs: the tiles' output
        columns over the model axis."""
        from ...parallel.mesh import MODEL_AXIS
        from .partition import PartitionSpec as P
        return {"w": P(None, None, None, MODEL_AXIS), "b": P(None, MODEL_AXIS)}

    def forward(self, x):
        *lead, d = x.shape
        if d != self.in_features:
            raise ValueError(f"input width {d}, the layer takes "
                             f"{self.in_features}")
        tiles = x.reshape(*lead, self.in_splits, self.tile_in).movedim(-2, 0)
        acc = torch.zeros(*lead, self.out_splits, self.tile_out,
                          dtype=x.dtype, device=x.device)
        for i in range(self.in_splits):
            if torch.is_grad_enabled():
                acc = torch_checkpoint.checkpoint(
                    _step, acc, tiles[i], self.w[i], use_reentrant=False)
            else:
                acc = _step(acc, tiles[i], self.w[i])
        if self.b is not None:
            acc = acc + self.b.to(acc.dtype)
        return acc.reshape(*lead, self.out_features)

    @staticmethod
    def from_dense(weight, bias, in_splits: int,
                   out_splits: int) -> "TiledLinear":
        """The tiled layer of a dense [in, out] weight (and [out] bias, or
        None), in the JAX tile order: w[i, o] = weight[i-th input tile,
        o-th output tile].  A tensor keeps its dtype and device; a numpy
        array becomes fp32 on the CPU."""
        weight = torch.as_tensor(np.asarray(weight) if not isinstance(
            weight, torch.Tensor) else weight)
        if not weight.is_floating_point():
            weight = weight.float()
        in_f, out_f = weight.shape
        lin = TiledLinear(in_f, out_f, in_splits, out_splits,
                          bias=bias is not None, dtype=weight.dtype,
                          device=weight.device)
        with torch.no_grad():
            lin.w.copy_(weight.reshape(in_splits, lin.tile_in, out_splits,
                                       lin.tile_out).permute(0, 2, 1, 3))
            if bias is not None:
                lin.b.copy_(torch.as_tensor(np.asarray(bias) if not isinstance(
                    bias, torch.Tensor) else bias).reshape(out_splits,
                                                           lin.tile_out))
        return lin
