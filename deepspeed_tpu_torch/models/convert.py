"""Weight bridge between the JAX package's GPT-2 parameter tree and the port.

The JAX tree (deepspeed_tpu/models/gpt2.py GPT2Model.init_params) holds
`wte` [V, H], `wpe` [P, H], the layer leaves stacked [L, ...] under `h`,
`ln_f` {`w`, `b`} and, when the embeddings are untied, `lm_head` [H, V].
Both packages keep the [in, out] weight layout (`x @ W`), so the bridge
only copies and (un)stacks.  The training engine's flat master buffer
crosses the same way (`gpt2_tree_from_flat`, `gpt2_flat_from_tree`), which
is how a checkpoint holds the parameters and the optimizer's moments.  It takes and returns numpy arrays (or
anything `np.asarray` reads) and imports nothing of JAX.
"""

from collections import OrderedDict

import numpy as np
import torch

from ..ops.transformer import DeepSpeedTransformerLayer
from .gpt2 import GPT2Config


def _named_shapes(config: GPT2Config):
    """(port parameter name, shape) of every GPT2Model parameter."""
    h = config.hidden_size
    out = [("wte", (config.vocab_size, h)), ("wpe", (config.n_positions, h))]
    layer_shapes = DeepSpeedTransformerLayer.param_shapes(config.layer_config())
    out += [(f"h.{i}.{name}", tuple(shape))
            for i in range(config.num_layers)
            for name, shape in layer_shapes.items()]
    out += [("ln_f.w", (h,)), ("ln_f.b", (h,))]
    if not config.tie_word_embeddings:
        out.append(("lm_head", (h, config.vocab_size)))
    return out


def _jax_leaf(tree, name: str, shape, config: GPT2Config) -> np.ndarray:
    """The JAX tree's array of port parameter `name` (shape `shape`): a
    layer parameter `h.<i>.<leaf>` is row i of the stacked leaf."""
    parts = name.split(".")
    if parts[0] == "h":
        label, shape = f"h/{parts[2]}", (config.num_layers,) + tuple(shape)
        arr = np.asarray(tree["h"][parts[2]])
    elif parts[0] == "ln_f":
        label, arr = f"ln_f/{parts[1]}", np.asarray(tree["ln_f"][parts[1]])
    else:
        label, arr = name, np.asarray(tree[name])
    if arr.shape != tuple(shape):
        raise ValueError(f"{label}: shape {arr.shape}, config wants "
                         f"{tuple(shape)}")
    return arr[int(parts[1])] if parts[0] == "h" else arr


def gpt2_params_from_jax(tree, config: GPT2Config) -> "OrderedDict[str, torch.Tensor]":
    """The port's GPT2Model state dict (fp32 CPU tensors) from the JAX
    parameter tree."""
    return OrderedDict(
        (name, torch.from_numpy(np.array(_jax_leaf(tree, name, shape, config),
                                         dtype=np.float32)))
        for name, shape in _named_shapes(config))


def gpt2_params_to_jax(state, config: GPT2Config) -> dict:
    """The JAX parameter tree (fp32 numpy arrays, layer leaves stacked
    [L, ...]) of a port state dict or of anything with the same keys, such
    as a dict of parameter grads or of numpy arrays: the inverse of
    gpt2_params_from_jax."""
    def arr(name, copy=True):
        value = state[name]
        if isinstance(value, torch.Tensor):
            value = value.detach().float().cpu().numpy()
        return (np.array if copy else np.asarray)(value, dtype=np.float32)

    layer_names = DeepSpeedTransformerLayer.param_shapes(config.layer_config())
    tree = {
        "wte": arr("wte"), "wpe": arr("wpe"),
        # np.stack copies: each layer's part is read in place
        "h": {name: np.stack([arr(f"h.{i}.{name}", copy=False)
                              for i in range(config.num_layers)])
              for name in layer_names},
        "ln_f": {"w": arr("ln_f.w"), "b": arr("ln_f.b")},
    }
    if not config.tie_word_embeddings:
        tree["lm_head"] = arr("lm_head")
    return tree


def gpt2_tree_from_flat(flat, named_shapes, config: GPT2Config) -> dict:
    """The JAX parameter tree of a flat vector laid out as the training
    engine's master buffer: the parameters of `named_shapes` ((name, shape)
    in the buffer's order) one after another, each in C order; entries past
    the last parameter (the ZeRO padding) are ignored.  The optimizer's
    `mu`, `nu` and `trace` share the layout."""
    flat = np.asarray(flat)
    state, off = {}, 0
    for name, shape in named_shapes:
        n = int(np.prod(shape))
        state[name] = flat[off:off + n].reshape(shape)
        off += n
    return gpt2_params_to_jax(state, config)


def gpt2_flat_from_tree(tree, named_shapes, config: GPT2Config,
                        size: int = 0) -> np.ndarray:
    """The inverse of gpt2_tree_from_flat: an fp32 vector of max(`size`,
    the parameters' count) entries, zero past the last parameter."""
    total = sum(int(np.prod(shape)) for _, shape in named_shapes)
    out = np.zeros(max(size, total), dtype=np.float32)
    off = 0
    for name, shape in named_shapes:
        n = int(np.prod(shape))
        out[off:off + n] = _jax_leaf(tree, name, shape, config).reshape(-1)
        off += n
    return out


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
