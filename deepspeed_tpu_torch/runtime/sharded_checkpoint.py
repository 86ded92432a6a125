"""The sharded (per-process) checkpoint layout with resize on load
(counterpart of deepspeed_tpu/runtime/sharded_checkpoint.py).

  <dir>/<tag>/<name>_index.json              {leaf path: {"shape", "dtype"}}
  <dir>/<tag>/<name>_shards_p{proc:05d}.npz  {"<leaf path>|<slice>": array}
  <dir>/<tag>/ds_meta.json                   {"client_state": ...}

The JAX module keys each stored block by the GLOBAL slice it covers: for
every pytree leaf, a process writes the distinct (`replica_id == 0`)
device shards it can address, as `<keystr path>|<start:stop,...>`, and
process 0 writes the index.  A host array (a numpy leaf) is written whole
by process 0 under `<path>|:`.  This module writes the same files without
JAX.  A tree's leaves are:

- `Sliced(shape, dtype, slices)`: a leaf that lies on the devices, with
  the slices this process writes, each ((start, stop) a dimension, array);
  a leaf every rank holds whole is one slice of the whole leaf, given by
  process 0 alone (the JAX writer's replicated jax.Array);
- anything else (numpy arrays, torch tensors, Python scalars): a host
  leaf, written whole by process 0.

Paths come from runtime/checkpoint.py (`leaf_paths`), so a leaf's key is
the JAX one.  numpy has no bfloat16: a bf16 leaf is stored as the JAX
writer's npz holds it, 2-byte void items of its bits, and the index keeps
"bfloat16"; reading takes those bits back (`_from_bf16_bits`), with no
ml_dtypes.

A load reads, for each region a rank needs, exactly that region from
whichever stored blocks overlap it (`_ShardCatalog.read_region`), so a
checkpoint saved at one world, stage or process count loads at another.
"""

import glob
import json
import os
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .checkpoint import (LATEST_FILE, META_FILE, _from_bf16_bits, jsonable,
                         leaf_paths)

BF16 = "bfloat16"
Region = Tuple[Tuple[int, int], ...]


class Sliced:
    """A device leaf: its whole shape, its dtype name and the slices this
    process writes, [(region, array)], a region one (start, stop) a
    dimension."""

    def __init__(self, shape: Sequence[int], dtype: str,
                 slices: List[Tuple[Region, Any]]):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = str(dtype)
        self.slices = slices


def whole_region(shape: Sequence[int]) -> Region:
    return tuple((0, int(d)) for d in shape)


def _slice_key(region: Region) -> str:
    return ",".join(f"{a}:{b}" for a, b in region) if region else ":"


def _parse_slice_key(key: str) -> Region:
    if key == ":":
        return ()
    return tuple(tuple(int(v) for v in part.split(":"))
                 for part in key.split(","))


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return BF16 if leaf.dtype == torch.bfloat16 else str(
            leaf.new_empty(()).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def _stored(leaf) -> np.ndarray:
    """A leaf as the npz holds it: bf16 as 2-byte void items of its bits."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.contiguous().view(torch.int16).numpy().view("V2")
        return leaf.numpy()
    return np.asarray(leaf)


def save_sharded(ckpt_dir: str, name: str, tree: Any,
                 process_index: int = 0) -> None:
    """Write this process's slices of `tree`'s `Sliced` leaves and, from
    process 0, its host leaves whole and the index."""
    os.makedirs(ckpt_dir, exist_ok=True)
    shards: Dict[str, np.ndarray] = {}
    index: Dict[str, Dict] = {}
    for key, leaf in leaf_paths(tree).items():
        if isinstance(leaf, Sliced):
            index[key] = {"shape": list(leaf.shape), "dtype": leaf.dtype}
            for region, arr in leaf.slices:
                shards.setdefault(f"{key}|{_slice_key(region)}",
                                  _stored(arr))
            continue
        arr = _stored(leaf)
        index[key] = {"shape": list(arr.shape), "dtype": _dtype_name(leaf)}
        if process_index == 0:
            shards[f"{key}|:"] = arr
    np.savez(os.path.join(ckpt_dir, f"{name}_shards_p{process_index:05d}"
                                    ".npz"), **shards)
    if process_index == 0:
        with open(os.path.join(ckpt_dir, f"{name}_index.json"), "w") as f:
            json.dump(index, f)


def finalize_checkpoint(save_dir: str, tag: str, client_state: Dict,
                        save_latest: bool = True,
                        tmp_dir: Optional[str] = None, group=None) -> None:
    """A barrier until every process's shard files are written, then
    process 0 writes ds_meta.json and, with `tmp_dir` (the atomic protocol:
    every process wrote into the shared `<tag>.tmp.<nonce>/`), the
    manifest and the commit rename, and moves `latest`; then a second
    barrier, so that no process returns before the commit is visible.
    `group`: the torch.distributed process group (None: one process).  A
    re-entry after the commit (a retry whose `latest` write failed) does
    not write the committed tag again."""
    from .resilience.atomic import commit_tag_dir, write_latest_atomic
    if group is not None:
        import torch.distributed as dist
        dist.barrier(group=group)
        rank = dist.get_rank(group)
    else:
        rank = 0
    if rank == 0:
        final_dir = os.path.join(save_dir, str(tag))
        committed = (tmp_dir is not None and not os.path.isdir(tmp_dir)
                     and os.path.isdir(final_dir))
        if not committed:
            ckpt_dir = tmp_dir if tmp_dir is not None else final_dir
            with open(os.path.join(ckpt_dir, META_FILE), "w") as f:
                json.dump({"client_state": jsonable(client_state or {})}, f)
            if tmp_dir is not None:
                commit_tag_dir(save_dir, str(tag), tmp_dir)
        if save_latest:
            write_latest_atomic(save_dir, str(tag), LATEST_FILE)
    if group is not None:
        dist.barrier(group=group)


def cut_region(shape: Sequence[int], dim: Optional[int], index: int,
               world: int) -> Region:
    """The region of a leaf of `shape` that ZeRO index `index` of `world`
    holds when the leaf is cut evenly along `dim` (None: the whole leaf)."""
    region = list(whole_region(shape))
    if dim is not None:
        c = int(shape[dim]) // world
        region[dim] = (index * c, (index + 1) * c)
    return tuple(region)


class FlatLeaf(NamedTuple):
    """A leaf of state laid out in one flat buffer (ZeRO stages 0-2): its
    name; its shape, a layer leaf stacked [L, ...] of one part a layer; the
    dimension the sharded save cuts it along (None: written whole); and
    the flat offset of each part."""
    name: str
    shape: Tuple[int, ...]
    dim: Optional[int]
    offsets: Tuple[int, ...]
    stacked: bool

    @property
    def part_shape(self) -> Tuple[int, ...]:
        return self.shape[1:] if self.stacked else self.shape


def _runs(shape: Sequence[int], region: Region, offset: int):
    """(starts, length): the runs of the flat buffer that hold `region` of
    a C-ordered array of `shape` at `offset`, in C order."""
    strides = [int(np.prod(shape[i + 1:], dtype=np.int64))
               for i in range(len(shape))]
    cut = [i for i, (a, b) in enumerate(region) if (a, b) != (0, shape[i])]
    if not cut:
        return (np.array([offset], np.int64),
                int(np.prod(shape, dtype=np.int64)))
    k = cut[-1]
    starts = np.array([offset + region[k][0] * strides[k]], np.int64)
    for j in range(k - 1, -1, -1):
        starts = (np.arange(*region[j], dtype=np.int64)[:, None] * strides[j]
                  + starts[None, :]).ravel()
    return starts, (region[k][1] - region[k][0]) * strides[k]


class FlatPlan:
    """The sharded layout of state laid out flat (ZeRO stages 0-2): each
    ZeRO index writes every cut leaf's slice at that index, and one writer
    (process 0) every whole leaf.  Built once a save or load and used for
    every state key.  `take` cuts the slices from a whole flat buffer that
    lies in this process; under a process group, where a process holds
    only its range, `indices` names the elements of a range that a writer
    writes and `place` lays out the elements a writer received as its
    slices; `read_ranges` is the load."""

    def __init__(self, leaves: Sequence[FlatLeaf], world: int):
        self.leaves, self.world = list(leaves), world
        self._indices: Dict[Tuple, np.ndarray] = {}

    def regions(self, indices: Sequence[int], whole: bool
                ) -> List[Tuple[FlatLeaf, Region]]:
        """[(leaf, region)] a writer of ZeRO `indices` writes, leaf by
        leaf: each cut leaf at each index, each whole leaf when `whole`."""
        out = []
        for leaf in self.leaves:
            if leaf.dim is None:
                if whole:
                    out.append((leaf, whole_region(leaf.shape)))
                continue
            out += [(leaf, cut_region(leaf.shape, leaf.dim, i, self.world))
                    for i in indices]
        return out

    def _parts(self, leaf: FlatLeaf, region: Region):
        """(flat offset, region of the part) of each part `region` spans."""
        if not leaf.stacked:
            return [(leaf.offsets[0], region)]
        return [(leaf.offsets[i], region[1:]) for i in range(*region[0])]

    def _sliced(self, slices) -> Dict[str, Sliced]:
        out = {leaf.name: Sliced(leaf.shape, "float32", [])
               for leaf in self.leaves}
        for leaf, region, arr in slices:
            out[leaf.name].slices.append((region, arr))
        return out

    def take(self, flat: np.ndarray, indices: Sequence[int],
             whole: bool) -> Dict[str, Sliced]:
        """{leaf name: Sliced} of what the writer of `indices` writes, cut
        from `flat`, the whole buffer."""
        slices = []
        for leaf, region in self.regions(indices, whole):
            n = int(np.prod(leaf.part_shape, dtype=np.int64))
            parts = [flat[off:off + n].reshape(leaf.part_shape)[tuple(
                slice(a, b) for a, b in sub)]
                for off, sub in self._parts(leaf, region)]
            slices.append((leaf, region, np.stack(parts) if leaf.stacked
                           else parts[0].copy()))
        return self._sliced(slices)

    def indices(self, indices: Sequence[int], whole: bool, lo: int = 0,
                hi: Optional[int] = None) -> np.ndarray:
        """The flat indices in [lo, hi) of what the writer of `indices`
        writes, in the order of its slices (cached: every key reuses
        them)."""
        key = (tuple(indices), whole, lo, hi)
        if key not in self._indices:
            out = []
            for leaf, region in self.regions(indices, whole):
                for off, sub in self._parts(leaf, region):
                    starts, length = _runs(leaf.part_shape, sub, off)
                    if hi is not None:
                        starts = starts[(starts < hi)
                                        & (starts + length > lo)]
                    idx = (starts[:, None]
                           + np.arange(length, dtype=np.int64)).ravel()
                    if hi is not None:
                        idx = idx[(idx >= lo) & (idx < hi)]
                    out.append(idx)
            self._indices[key] = (np.concatenate(out) if out
                                  else np.empty(0, np.int64))
        return self._indices[key]

    def place(self, values: np.ndarray, indices: Sequence[int],
              whole: bool) -> Dict[str, Sliced]:
        """{leaf name: Sliced} of the writer of `indices` from `values`,
        the elements of its slices in the order `indices()` names them."""
        slices, at = [], 0
        for leaf, region in self.regions(indices, whole):
            shape = [b - a for a, b in region]
            n = int(np.prod(shape, dtype=np.int64))
            slices.append((leaf, region, values[at:at + n].reshape(shape)))
            at += n
        return self._sliced(slices)

    def read_ranges(self, cat: "_ShardCatalog", keys: Dict[str, str],
                    ranges: Sequence[Tuple[int, int]]
                    ) -> Dict[Tuple[int, int], np.ndarray]:
        """{(lo, hi): elements [lo, hi) of the flat buffer} read from
        `cat` (`keys`: {leaf name: checkpoint key}; a key the catalog lacks
        leaves zeros): for every part a range touches, the rows of its
        leaf that hold the touched elements, whatever the saved cut."""
        host = {r: np.zeros(r[1] - r[0], dtype=np.float32) for r in ranges}
        for leaf in self.leaves:
            key = keys[leaf.name]
            if key not in cat.index:
                continue
            own = leaf.part_shape
            n = int(np.prod(own, dtype=np.int64))
            row = int(np.prod(own[1:], dtype=np.int64)) if own else 1
            for at, off in enumerate(leaf.offsets):
                for lo, hi in ranges:
                    a, b = max(lo, off) - off, min(hi, off + n) - off
                    if a >= b:
                        continue
                    first, last = a // row, -(-b // row)
                    region = (((first, last),) + whole_region(own[1:])
                              if own else ())
                    if leaf.stacked:
                        region = ((at, at + 1),) + region
                    part = cat.read_region(key, region).reshape(-1)
                    host[(lo, hi)][off + a - lo:off + b - lo] = \
                        part[a - first * row:b - first * row]
            cat.release(key)
        return host


def has_sharded_layout(ckpt_dir: str) -> bool:
    return os.path.isfile(os.path.join(ckpt_dir, "model_index.json"))


class _ShardCatalog:
    """Every process's shard file of one saved tree, read lazily.  A
    stored block read for a region stays cached until `release(key)`, so
    that the regions of one leaf read each block once."""

    def __init__(self, ckpt_dir: str, name: str):
        self.files = sorted(glob.glob(
            os.path.join(ckpt_dir, f"{name}_shards_p*.npz")))
        if not self.files:
            raise FileNotFoundError(
                f"no shard files for '{name}' under {ckpt_dir}")
        self._handles = [np.load(f, allow_pickle=False) for f in self.files]
        self.by_leaf: Dict[str, List[Tuple[Region, int, str]]] = {}
        for fi, h in enumerate(self._handles):
            for sk in h.files:
                key, skey = sk.rsplit("|", 1)
                self.by_leaf.setdefault(key, []).append(
                    (_parse_slice_key(skey), fi, sk))
        with open(os.path.join(ckpt_dir, f"{name}_index.json")) as f:
            self.index = json.load(f)
        self._cache: Dict[Tuple[int, str], np.ndarray] = {}

    def shape(self, key: str) -> Tuple[int, ...]:
        return tuple(self.index[key]["shape"])

    def _block(self, fi: int, sk: str) -> np.ndarray:
        if (fi, sk) not in self._cache:
            self._cache[(fi, sk)] = _from_bf16_bits(self._handles[fi][sk])
        return self._cache[(fi, sk)]

    def read_region(self, key: str, region: Region) -> np.ndarray:
        """The `region` ((start, stop) a dimension) of leaf `key`,
        assembled from the stored blocks that overlap it; a bf16 leaf in
        fp32 (exactly)."""
        shape = self.shape(key)
        out = np.empty(tuple(b - a for a, b in region),
                       dtype=np.float32 if self.index[key]["dtype"] == BF16
                       else np.dtype(self.index[key]["dtype"]))
        filled = np.zeros(out.shape, dtype=bool) if out.size else None
        for stored, fi, sk in self.by_leaf.get(key, ()):
            stored = stored or whole_region(shape)
            lo = [max(w[0], s[0]) for w, s in zip(region, stored)]
            hi = [min(w[1], s[1]) for w, s in zip(region, stored)]
            if any(a >= b for a, b in zip(lo, hi)):
                continue
            src = tuple(slice(a - s[0], b - s[0])
                        for a, b, s in zip(lo, hi, stored))
            dst = tuple(slice(a - w[0], b - w[0])
                        for a, b, w in zip(lo, hi, region))
            out[dst] = self._block(fi, sk)[src]
            if filled is not None:
                filled[dst] = True
        if filled is not None and not filled.all():
            raise ValueError(
                f"checkpoint shards do not cover leaf {key} region "
                f"{region}: missing shard files?")
        return out

    def read(self, key: str) -> np.ndarray:
        return self.read_region(key, whole_region(self.shape(key)))

    def release(self, key: str) -> None:
        for fi, sk in [k for k in self._cache if k[1].rsplit("|", 1)[0]
                       == key]:
            del self._cache[(fi, sk)]

    def close(self):
        self._cache.clear()
        for h in self._handles:
            h.close()


def _cast_like(arr: np.ndarray, template):
    """`arr` in the template leaf's type and dtype (a torch tensor for a
    tensor, bf16 included)."""
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(template.dtype)
    dtype = getattr(template, "dtype", None)
    return arr.astype(dtype, copy=False) if dtype is not None else arr


def load_sharded(ckpt_dir: str, name: str, template: Any,
                 strict: bool = True) -> Any:
    """`template`'s structure with its leaves read from the catalog: a
    `Sliced` leaf gets each of its regions (its arrays' dtypes, else
    fp32), any other leaf the whole stored leaf cast to its own type.  A
    path missing from the checkpoint raises KeyError when `strict`, else
    keeps the template's leaf; a stored shape that differs from the
    template's raises ValueError."""
    from .checkpoint import _children, _is_namedtuple
    cat = _ShardCatalog(ckpt_dir, name)

    def one(leaf, key):
        if key not in cat.index:
            if strict:
                raise KeyError(f"checkpoint missing leaf {key}")
            return leaf
        shape = cat.shape(key)
        want = (leaf.shape if isinstance(leaf, Sliced)
                else tuple(getattr(leaf, "shape", shape)))
        if tuple(want) != shape:
            raise ValueError(f"leaf {key}: checkpoint shape {shape} != "
                             f"template {tuple(want)}")
        try:
            if isinstance(leaf, Sliced):
                return Sliced(shape, cat.index[key]["dtype"], [
                    (region, cat.read_region(key, region) if like is None
                     else _cast_like(cat.read_region(key, region), like))
                    for region, like in leaf.slices])
            return _cast_like(cat.read(key), leaf)
        finally:
            cat.release(key)

    def rebuild(node, path):
        kids = _children(node)
        if kids is None or isinstance(node, Sliced):
            return one(node, path)
        if isinstance(node, dict):
            return {k: rebuild(node[k], f"{path}[{k!r}]") for k in node}
        rebuilt = [rebuild(child, path + key) for key, child in kids]
        return type(node)(*rebuilt) if _is_namedtuple(node) \
            else type(node)(rebuilt)

    try:
        return rebuild(template, "")
    finally:
        cat.close()


def consolidate_sharded_to_fp32(ckpt_dir: str, name: str = "model",
                                output_file: Optional[str] = None
                                ) -> Dict[str, np.ndarray]:
    """Every leaf whole from the catalog, floating leaves (bf16 included)
    in fp32 (the offline zero_to_fp32 of the sharded layout); also written
    to `output_file` when given."""
    cat = _ShardCatalog(ckpt_dir, name)
    try:
        out = {}
        for key in cat.index:
            arr = cat.read(key)
            cat.release(key)
            out[key] = (arr.astype(np.float32, copy=False)
                        if np.issubdtype(arr.dtype, np.floating) else arr)
        if output_file:
            np.savez(output_file, **out)
        return out
    finally:
        cat.close()
