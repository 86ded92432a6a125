"""Checkpoints in the JAX package's layout (counterpart of
deepspeed_tpu/runtime/checkpoint.py).

  <dir>/<tag>/mp_rank_00_model_states.npz                module weights
  <dir>/<tag>/zero_pp_rank_0_mp_rank_00_optim_states.npz  optimizer and scaler
  <dir>/<tag>/ds_meta.json                               {"client_state": ...}
  <dir>/latest                                           the newest tag

The JAX module flattens a pytree to {path string: array} with
`jax.tree_util.keystr` and writes it with `np.savez`.  This module writes
the same keys without JAX: a tree is nested dicts, lists / tuples and
named tuples whose leaves are numpy arrays, torch tensors or Python
scalars, and a leaf's key is its path with a dict key as `['name']`, a
sequence index as `[i]` and a named-tuple field as `.name`, the dict keys
taken in sorted order as JAX flattens them; None and empty containers hold
no leaf.  So the files of either package load in the other.  numpy has no
bfloat16, and the engines keep their state in fp32 and int32: a bf16 leaf
is refused rather than written as something else.  The JAX package's
offload engine writes its module tree in bf16 (ml_dtypes), which reads
back here as 2-byte void items: a load takes those as bf16 bits.  Loading maps the
arrays back onto a template tree of the same structure, each cast to its
template leaf's dtype.
"""

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

LATEST_FILE = "latest"
META_FILE = "ds_meta.json"


def model_file_name(mp_rank: int = 0) -> str:
    return f"mp_rank_{mp_rank:02d}_model_states.npz"


def optim_file_name(dp_rank: int = 0, mp_rank: int = 0) -> str:
    return f"zero_pp_rank_{dp_rank}_mp_rank_{mp_rank:02d}_optim_states.npz"


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """(key suffix, child) of a tree node in JAX's flattening order, or
    None for a leaf."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise ValueError("a bfloat16 tensor has no numpy dtype; the "
                             "checkpoint layout holds fp32 / int32 state")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def leaf_paths(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{keystr path: leaf} of every leaf of `tree`, the leaves as they
    are."""
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    flat = {}
    for key, child in kids:
        flat.update(leaf_paths(child, prefix + key))
    return flat


def flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """{keystr path: numpy array} of every leaf of `tree`."""
    return {key: _to_numpy(leaf)
            for key, leaf in leaf_paths(tree, prefix).items()}


def _leaf_dtype(leaf):
    if isinstance(leaf, torch.Tensor):
        return _to_numpy(torch.empty((), dtype=leaf.dtype)).dtype
    return getattr(leaf, "dtype", None)


def _from_bf16_bits(arr: np.ndarray) -> np.ndarray:
    """A bf16 array as the JAX package writes it (ml_dtypes' bfloat16,
    which np.load reads back as 2-byte void items) in fp32; any other
    array as it is."""
    if arr.dtype.kind != "V" or arr.dtype.itemsize != 2:
        return arr
    bits = arr.view(np.uint16).astype(np.uint32) << 16
    return bits.view(np.float32)


def unflatten_into(template: Any, flat: Dict[str, np.ndarray],
                   strict: bool = True) -> Any:
    """`template`'s structure with each leaf replaced by the array stored
    under its path, cast to the template leaf's dtype.  A path missing from
    `flat` raises KeyError when `strict`, else keeps the template's leaf; a
    stored array whose shape differs from the template leaf's raises
    ValueError."""
    missing = []

    def rebuild(node, path):
        kids = _children(node)
        if kids is None:
            if path not in flat:
                missing.append(path)
                return node
            arr = _from_bf16_bits(np.asarray(flat[path]))
            shape = getattr(node, "shape", None)
            if shape is not None and tuple(arr.shape) != tuple(shape):
                raise ValueError(f"checkpoint {path}: shape {arr.shape}, "
                                 f"the model wants {tuple(shape)}")
            dtype = _leaf_dtype(node)
            return arr.astype(dtype, copy=False) if dtype is not None else arr
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: rebuild(node[k], f"{path}[{k!r}]") for k in node}
        rebuilt = [rebuild(child, path + key) for key, child in kids]
        return type(node)(*rebuilt) if _is_namedtuple(node) \
            else type(node)(rebuilt)

    out = rebuild(template, "")
    if missing and strict:
        raise KeyError(f"Checkpoint missing {len(missing)} keys, e.g. "
                       f"{missing[:5]}")
    return out


def save_checkpoint_state(save_dir: str, tag: str, module_state: Any,
                          optimizer_state: Any = None,
                          client_state: Optional[Dict] = None,
                          mp_rank: int = 0, dp_rank: int = 0,
                          atomic: bool = False) -> str:
    """Write one checkpoint under <save_dir>/<tag>/ and move `latest` to it
    (always by a temporary file and a rename).  With `atomic` the files are
    staged in a `<tag>.tmp.<nonce>` directory, recorded in a size and CRC32
    manifest and renamed into place before `latest` moves
    (resilience/atomic.py).  Returns the tag's directory."""
    from .resilience.atomic import (commit_tag_dir, tmp_tag_dir,
                                    write_latest_atomic)
    final_dir = os.path.join(save_dir, str(tag))
    if atomic:
        os.makedirs(save_dir, exist_ok=True)
        ckpt_dir = tmp_tag_dir(save_dir, str(tag))
    else:
        ckpt_dir = final_dir
        os.makedirs(ckpt_dir, exist_ok=True)
    np.savez(os.path.join(ckpt_dir, model_file_name(mp_rank)),
             **flatten(module_state))
    if optimizer_state is not None:
        np.savez(os.path.join(ckpt_dir, optim_file_name(dp_rank, mp_rank)),
                 **flatten(optimizer_state))
    with open(os.path.join(ckpt_dir, META_FILE), "w") as f:
        json.dump({"client_state": jsonable(client_state or {})}, f)
    if atomic:
        commit_tag_dir(save_dir, str(tag), ckpt_dir)
    write_latest_atomic(save_dir, str(tag), LATEST_FILE)
    return final_dir


def read_latest_tag(load_dir: str) -> Optional[str]:
    latest_path = os.path.join(load_dir, LATEST_FILE)
    if os.path.isfile(latest_path):
        with open(latest_path) as f:
            return f.read().strip()
    return None


def _read_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def load_checkpoint_state(load_dir: str, tag: Optional[str],
                          module_template: Any,
                          optimizer_template: Any = None,
                          mp_rank: int = 0, dp_rank: int = 0,
                          strict: bool = True) -> Tuple[Any, Any, Dict]:
    """(module state, optimizer state, client state) of <load_dir>/<tag>/
    (tag None: the one `latest` names) on the templates' structure.  The
    optimizer state is None without a template or an optimizer file.  A
    missing or partial tag raises FileNotFoundError naming the tags that
    are there."""
    if tag is None:
        tag = read_latest_tag(load_dir)
        if tag is None:
            raise FileNotFoundError(
                f"Unable to find '{LATEST_FILE}' file at {load_dir}")
    ckpt_dir = os.path.join(load_dir, str(tag))
    model_file = os.path.join(ckpt_dir, model_file_name(mp_rank))
    if not os.path.isdir(ckpt_dir) or not os.path.isfile(model_file):
        from .resilience.recovery import list_tags
        missing = ("tag dir is missing" if not os.path.isdir(ckpt_dir)
                   else f"tag dir exists but {os.path.basename(model_file)} "
                        f"is missing (partial save?)")
        raise FileNotFoundError(
            f"checkpoint tag {tag!r} not loadable from {load_dir}: "
            f"{missing}; available tags: {list_tags(load_dir) or 'none'}")
    module_state = unflatten_into(module_template, _read_npz(model_file),
                                  strict=strict)
    optimizer_state = None
    optim_file = os.path.join(ckpt_dir, optim_file_name(dp_rank, mp_rank))
    if optimizer_template is not None and os.path.isfile(optim_file):
        optimizer_state = unflatten_into(optimizer_template,
                                         _read_npz(optim_file), strict=strict)
    client_state = {}
    meta_file = os.path.join(ckpt_dir, META_FILE)
    if os.path.isfile(meta_file):
        with open(meta_file) as f:
            client_state = json.load(f).get("client_state", {})
    return module_state, optimizer_state, client_state


def consolidate_to_fp32(ckpt_dir: str, tag: Optional[str] = None,
                        output_file: Optional[str] = None
                        ) -> Dict[str, np.ndarray]:
    """One fp32 weight dict from a checkpoint's model file (the reference's
    zero_to_fp32: the consolidated layout already holds whole leaves), also
    written to `output_file` when given."""
    if tag is None:
        tag = read_latest_tag(ckpt_dir)
    weights = {k: np.asarray(v, dtype=np.float32) for k, v in _read_npz(
        os.path.join(ckpt_dir, str(tag), model_file_name())).items()}
    if output_file:
        np.savez(output_file, **weights)
    return weights


def jsonable(obj):
    """Best-effort JSON coercion for client-state metadata."""
    if isinstance(obj, dict):
        return {str(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if hasattr(obj, "item") and getattr(obj, "ndim", 1) == 0:
        return obj.item()
    return obj
