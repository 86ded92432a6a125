"""Weight bridge between the JAX package's GPT-2 parameter tree and the port.

The JAX tree (deepspeed_tpu/models/gpt2.py GPT2Model.init_params) holds
`wte` [V, H], `wpe` [P, H], the layer leaves stacked [L, ...] under `h`,
`ln_f` {`w`, `b`} and, when the embeddings are untied, `lm_head` [H, V].
Both packages keep the [in, out] weight layout (`x @ W`), so the bridge
only copies and (un)stacks.  It takes and returns numpy arrays (or
anything `np.asarray` reads) and imports nothing of JAX.
"""

from collections import OrderedDict

import numpy as np
import torch

from ..ops.transformer import DeepSpeedTransformerLayer
from .gpt2 import GPT2Config


def _tensor(a, shape, name):
    arr = np.array(a, dtype=np.float32)
    if arr.shape != tuple(shape):
        raise ValueError(f"{name}: shape {arr.shape}, config wants "
                         f"{tuple(shape)}")
    return torch.from_numpy(arr)


def gpt2_params_from_jax(tree, config: GPT2Config) -> "OrderedDict[str, torch.Tensor]":
    """The port's GPT2Model state dict (fp32 CPU tensors) from the JAX
    parameter tree."""
    h, n_layers = config.hidden_size, config.num_layers
    layer_shapes = DeepSpeedTransformerLayer.param_shapes(config.layer_config())
    out = OrderedDict()
    out["wte"] = _tensor(tree["wte"], (config.vocab_size, h), "wte")
    out["wpe"] = _tensor(tree["wpe"], (config.n_positions, h), "wpe")
    stacked = {name: _tensor(tree["h"][name], (n_layers,) + shape, f"h/{name}")
               for name, shape in layer_shapes.items()}
    for i in range(n_layers):
        for name in layer_shapes:
            out[f"h.{i}.{name}"] = stacked[name][i].clone()
    out["ln_f.w"] = _tensor(tree["ln_f"]["w"], (h,), "ln_f/w")
    out["ln_f.b"] = _tensor(tree["ln_f"]["b"], (h,), "ln_f/b")
    if not config.tie_word_embeddings:
        out["lm_head"] = _tensor(tree["lm_head"], (h, config.vocab_size),
                                 "lm_head")
    return out


def gpt2_params_to_jax(state, config: GPT2Config) -> dict:
    """The JAX parameter tree (fp32 numpy arrays, layer leaves stacked
    [L, ...]) of a port state dict or of anything with the same keys, such
    as a dict of parameter grads: the inverse of gpt2_params_from_jax."""
    def arr(name):
        return np.array(state[name].detach().float().cpu().numpy(),
                        dtype=np.float32)

    layer_names = DeepSpeedTransformerLayer.param_shapes(config.layer_config())
    tree = {
        "wte": arr("wte"), "wpe": arr("wpe"),
        "h": {name: np.stack([arr(f"h.{i}.{name}")
                              for i in range(config.num_layers)])
              for name in layer_names},
        "ln_f": {"w": arr("ln_f.w"), "b": arr("ln_f.b")},
    }
    if not config.tie_word_embeddings:
        tree["lm_head"] = arr("lm_head")
    return tree


def ranked_from_stacked(stacked, mesh, dtype=None) -> list:
    """The port's per-rank list (rank r's tensor on rank r's device) from a
    worker-stacked array [W, ...]: the JAX package's layout of a row-sharded
    weight, a per-rank batch or an error-feedback buffer under
    `shard_map` over the mesh's ranks."""
    arr = np.asarray(stacked)
    if arr.shape[0] != mesh.world_size:
        raise ValueError(f"stacked array has {arr.shape[0]} rows, the mesh "
                         f"{mesh.world_size} ranks")
    out = []
    for r in range(mesh.world_size):
        t = torch.from_numpy(np.array(arr[r]))
        if dtype is not None:
            t = t.to(dtype)
        out.append(t.to(mesh.device_of(r)))
    return out


def stacked_from_ranked(tensors) -> np.ndarray:
    """The worker-stacked numpy array [W, ...] of a per-rank list: the
    inverse of ranked_from_stacked (bfloat16, which numpy lacks, comes back
    as float32 with the same values)."""
    rows = []
    for t in tensors:
        t = t.detach().cpu()
        rows.append((t.float() if t.dtype == torch.bfloat16 else t).numpy())
    return np.stack(rows)
