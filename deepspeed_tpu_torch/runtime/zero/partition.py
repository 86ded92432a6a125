"""ZeRO stages 1 and 2 over the data-parallel ranks of the mesh
(counterpart of deepspeed_tpu/runtime/zero/partition.py).

The JAX module gives every parameter leaf a PartitionSpec over the ZeRO
axes ("data", "expert") and lets XLA insert the reduce-scatter of the
gradients and keep the optimizer's math local to each shard.  Its
docstring names the design those per-leaf specs replace: DeepSpeed's own
stage-1/2 layout, flat 1-D shards with explicit collectives.  The port
uses that flat layout, because its engine already keeps the fp32 master
weights and their gradients in one flat buffer (runtime/engine.py):

- the buffer holds the n parameters, zero-padded to a multiple of the
  ZeRO world Z; rank r of the group owns the r-th of Z equal ranges;
- stage 1 shards the optimizer state: each rank's state covers its range;
- stage 2 also shards the gradients: each micro-step's gradients are
  reduce-scattered into the owner's range, where they accumulate;
- parameters stay whole on every rank below stage 3 (so does the JAX
  engine's replicated layout), and each rank's updated range is
  all-gathered back into every rank's buffer after the step.

The layout is only memory: the optimizer's math is elementwise, so a range
and a leaf get the same update, except for the global gradient norm and
Lamb's per-parameter norms, which the optimizer sums across the ranges
(runtime/optimizers.py).

Stage 3 shards the parameters too, per leaf as the JAX module does: each
leaf is cut along the dimension `zero_partition_spec` picks (the largest
one the ZeRO world divides and the model's tensor-parallel spec leaves
free), and rank r keeps the r-th piece; a leaf below the persistence
threshold, or one with no such dimension, stays whole on every rank.  A
layer parameter is cut on its own shape, which is the JAX stream's
per-layer spec (deepspeed_tpu/runtime/zero/stage3_streaming.py
`_per_layer_zero_spec`).  Each rank's pieces lie in
one flat fp32 buffer of its own (`Stage3Layout`), the non-layer leaves
first, then the layers in order, so that every layer group of the stream
is one contiguous region of it; the optimizer steps each rank's whole
buffer.
"""

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...parallel.mesh import MESH_AXES, ZERO_AXES, MeshContext


class PartitionSpec(tuple):
    """A sharding spec in jax.sharding.PartitionSpec's form: one entry a
    dimension, None (not sharded), an axis name, or a tuple of axis
    names."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


def zero_partition_spec(shape: Tuple[int, ...], axis_sizes: dict,
                        persistence_threshold: int = 0,
                        existing: Optional[PartitionSpec] = None
                        ) -> PartitionSpec:
    """The dimension to shard over the ZeRO ("data", "expert") axes (the
    JAX function's rule): the largest dimension divisible by the shard
    factor of the ZeRO axes that `existing` does not use, and not claimed
    by another axis there; replicated when the leaf is below
    `persistence_threshold` elements, the factor is 1, or nothing
    divides."""
    n = int(np.prod(shape)) if shape else 1
    zero_size = int(np.prod([axis_sizes.get(a, 1) for a in ZERO_AXES]))
    if zero_size <= 1 or n < max(1, persistence_threshold):
        return existing if existing is not None else PartitionSpec()
    existing_parts = (list(existing) if existing is not None
                      else [None] * len(shape))
    while len(existing_parts) < len(shape):
        existing_parts.append(None)
    used = set()
    for part in existing_parts:
        if part is None:
            continue
        for ax in (part if isinstance(part, tuple) else (part,)):
            used.add(ax)
    zero_axes = tuple(a for a in ZERO_AXES if a not in used)
    shard_factor = int(np.prod([axis_sizes.get(a, 1) for a in zero_axes]))
    if not zero_axes or shard_factor <= 1:
        return existing if existing is not None else PartitionSpec()
    best_dim, best_size = None, 0
    for i, d in enumerate(shape):
        if existing_parts[i] is not None:
            continue
        if d % shard_factor == 0 and d > best_size:
            best_dim, best_size = i, d
    if best_dim is None:
        return existing if existing is not None else PartitionSpec()
    existing_parts[best_dim] = zero_axes
    return PartitionSpec(*existing_parts)


def filter_spec_axes(spec: PartitionSpec, keep) -> PartitionSpec:
    """Only the axis names of `spec` for which `keep(axis)` is true,
    emptied entries collapsed to None and one-name tuples to the name."""
    parts = []
    for entry in spec:
        if entry is None:
            parts.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept = tuple(a for a in axes if keep(a))
        parts.append(kept if len(kept) > 1 else (kept[0] if kept else None))
    return PartitionSpec(*parts)


def resolve_hpz_axes(axis_sizes: dict, group_size: int) -> Tuple[str, ...]:
    """hpZ's secondary partition: the suffix of the ZeRO axes whose sizes
    multiply to `group_size` (the JAX function; 1 is the empty suffix).
    Raises ValueError listing the valid sizes otherwise."""
    group_size = int(group_size)
    sizes = [int(axis_sizes.get(a, 1)) for a in ZERO_AXES]
    valid = {1: ()}
    prod = 1
    for i in range(len(ZERO_AXES) - 1, -1, -1):
        prod *= sizes[i]
        valid[prod] = tuple(ZERO_AXES[i:])
    if group_size in valid:
        return tuple(a for a in valid[group_size]
                     if axis_sizes.get(a, 1) > 1)
    raise ValueError(
        f"hpz_group_size={group_size} does not match a suffix of the "
        f"ZeRO axes {dict(zip(ZERO_AXES, sizes))} — valid sizes here: "
        f"{sorted(valid)} (the secondary partition must align with whole "
        "inner mesh axes)")


def shard_dim(spec: PartitionSpec) -> Optional[int]:
    """The dimension a spec shards over the ZeRO axes (None: none)."""
    for i, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        if any(a in ZERO_AXES for a in axes):
            return i
    return None


@dataclass(frozen=True)
class ShardedLeaf:
    """One parameter at stage 3: its whole shape, the dimension cut over
    the ZeRO world (None: whole on every rank), the piece a rank holds and
    where that piece starts in the rank's flat buffer."""
    name: str
    shape: Tuple[int, ...]
    dim: Optional[int]
    world: int
    offset: int

    @property
    def piece_shape(self) -> Tuple[int, ...]:
        if self.dim is None:
            return self.shape
        s = list(self.shape)
        s[self.dim] //= self.world
        return tuple(s)

    @property
    def numel(self) -> int:
        """Elements of a rank's piece."""
        return int(np.prod(self.piece_shape)) if self.shape else 1

    def cut(self, whole, index: int):
        """Rank `index`'s piece of the whole leaf (a view; a tensor or an
        array)."""
        if self.dim is None:
            return whole
        c = self.shape[self.dim] // self.world
        at = [slice(None)] * len(self.shape)
        at[self.dim] = slice(index * c, (index + 1) * c)
        return whole[tuple(at)]


class Stage3Layout:
    """Every rank's flat buffer at stage 3: the pieces of the parameters,
    the non-layer ones (`layer_of(name)` None) first, then each layer's.
    `regions[0]` spans the non-layer pieces and `regions[1 + i]` the
    pieces of layer i, as [start, end) offsets.  `spec_of(name)`: the
    parameter's tensor-parallel spec, whose dimensions ZeRO leaves alone
    (the JAX engine's base specs)."""

    def __init__(self, named_shapes: Sequence[Tuple[str, Tuple[int, ...]]],
                 axis_sizes: dict, persistence_threshold: int,
                 layer_of, spec_of=lambda name: None):
        world = int(np.prod([axis_sizes.get(a, 1) for a in ZERO_AXES]))
        first = [(n, s) for n, s in named_shapes if layer_of(n) is None]
        layers = {}
        for n, s in named_shapes:
            if layer_of(n) is not None:
                layers.setdefault(layer_of(n), []).append((n, s))
        ordered = [first] + [layers[i] for i in sorted(layers)]
        self.leaves: List[ShardedLeaf] = []
        self.regions: List[Tuple[int, int]] = []
        off = 0
        for part in ordered:
            start = off
            for name, shape in part:
                dim = shard_dim(zero_partition_spec(
                    tuple(shape), axis_sizes, persistence_threshold,
                    spec_of(name)))
                leaf = ShardedLeaf(name, tuple(shape), dim, world, off)
                self.leaves.append(leaf)
                off += leaf.numel
            self.regions.append((start, off))
        self.size = off
        self.world = world
        self.by_name = {leaf.name: leaf for leaf in self.leaves}

    def region_leaves(self, i: int) -> List[ShardedLeaf]:
        lo, hi = self.regions[i]
        return [leaf for leaf in self.leaves if lo <= leaf.offset < hi]

    def whole_segments(self) -> List[Tuple[int, int]]:
        """(offset, numel) of every leaf every rank holds whole."""
        return [(leaf.offset, leaf.numel) for leaf in self.leaves
                if leaf.dim is None]

    def local_from_whole(self, full: np.ndarray, named_shapes,
                         index: int) -> np.ndarray:
        """Rank `index`'s flat buffer from the whole parameters laid out
        flat in `named_shapes` order (the engine's stage 0-2 layout)."""
        out = np.empty(self.size, dtype=full.dtype)
        off = 0
        for name, shape in named_shapes:
            n = int(np.prod(shape)) if shape else 1
            leaf = self.by_name[name]
            piece = leaf.cut(full[off:off + n].reshape(shape), index)
            out[leaf.offset:leaf.offset + leaf.numel] = \
                np.ascontiguousarray(piece).reshape(-1)
            off += n
        return out

    def whole_from_locals(self, locals_: Sequence[np.ndarray],
                          named_shapes) -> np.ndarray:
        """The whole parameters laid out flat in `named_shapes` order from
        every rank's flat buffer (in ZeRO-rank order)."""
        total = sum(int(np.prod(shape)) for _, shape in named_shapes)
        out = np.empty(total, dtype=locals_[0].dtype if len(locals_)
                       else np.float32)
        at = 0
        for name, shape in named_shapes:
            leaf = self.by_name[name]
            pieces = [loc[leaf.offset:leaf.offset + leaf.numel].reshape(
                leaf.piece_shape) for loc in locals_]
            n = int(np.prod(shape))
            dst = out[at:at + n].reshape(shape)
            if leaf.dim is None:
                dst[...] = pieces[0]
            else:  # straight into place
                np.concatenate(pieces, axis=leaf.dim, out=dst)
            at += n
        return out


# ---------------------------------------------------------------------- #
# partition topology: the saved-vs-requested contract behind checkpoints
# that load at another mesh shape (runtime/resilience/reshard.py)
# ---------------------------------------------------------------------- #
def topology_reshard_problems(saved: Dict[str, Any],
                              current: Dict[str, Any]) -> List[str]:
    """Problems mapping a partition topology saved at one mesh shape onto
    the current one ([] = reshardable).  A layout keyed by global slices
    reshards along the ZeRO (data / expert) axes only: the other axes
    (pipe / seq / model) change which values a leaf's dimensions hold.
    The zero stage may differ (the stored values are whole); callers log
    that."""
    problems: List[str] = []
    saved_mesh = dict(saved.get("mesh") or {})
    cur_mesh = dict(current.get("mesh") or {})
    for axis in MESH_AXES:
        if axis in ZERO_AXES:
            continue
        s = int(saved_mesh.get(axis, 1))
        c = int(cur_mesh.get(axis, 1))
        if s != c:
            problems.append(
                f"mesh axis {axis!r} resized {s} -> {c}: only the ZeRO "
                f"axes {ZERO_AXES} are reshape-portable (a non-ZeRO axis "
                "resize changes which values each shard holds)")
    return problems


def topologies_equal(saved: Dict[str, Any], current: Dict[str, Any]) -> bool:
    """True when two partition topologies agree in every field that shapes
    the step's collectives: mesh axis sizes, zero stage, hpZ group."""
    def key(t):
        mesh = {a: int((t.get("mesh") or {}).get(a, 1)) for a in MESH_AXES}
        return (tuple(sorted(mesh.items())),
                int(t.get("zero_stage") or 0),
                int(t.get("hpz_group_size") or 0))
    return key(saved) == key(current)


class ZeroPartitioner:
    """Which range of the flat buffer each rank owns at a stage.

    stage 0: nothing partitioned (plain data parallelism: every rank owns
             the whole buffer, the gradients are all-reduced)
    stage 1: optimizer state partitioned
    stage 2: + gradients reduce-scattered to their owner
    stage 3: + parameters partitioned per leaf (`stage3_layout`); each
             rank owns its whole buffer of pieces
    """

    def __init__(self, mesh_ctx: MeshContext, stage: int,
                 persistence_threshold: int = 0):
        self.ctx = mesh_ctx
        self.stage = stage
        self.zero_size = mesh_ctx.data_parallel_world_size
        self.axis_sizes = {a: mesh_ctx.axis_size(a) for a in ZERO_AXES}
        # only stage 3 honours the persistence threshold
        self.persistence_threshold = (persistence_threshold
                                      if stage >= 3 else 0)

    def padded_size(self, n: int) -> int:
        """The flat buffer's length for n parameters: a multiple of the
        ZeRO world."""
        return math.ceil(n / self.zero_size) * self.zero_size

    def stage3_layout(self, named_shapes, layer_of,
                      spec_of=lambda name: None) -> Stage3Layout:
        """Every rank's flat buffer of pieces at stage 3 (`layer_of(name)`:
        the layer index of a parameter, None outside the layers;
        `spec_of(name)`: its tensor-parallel spec)."""
        return Stage3Layout(named_shapes, self.axis_sizes,
                            self.persistence_threshold, layer_of, spec_of)

    def owned_range(self, n: int, rank: int) -> Tuple[int, int]:
        """[start, end) of the padded buffer whose optimizer update rank
        `rank` computes: the whole buffer at stage 0, else its range."""
        if self.stage == 0:
            return 0, self.padded_size(n)
        chunk = self.padded_size(n) // self.zero_size
        start = self.ctx.group_index(rank, ZERO_AXES) * chunk
        return start, start + chunk

    # -- partition topology ------------------------------------------- #
    def topology(self, hpz_group_size: int = 0) -> Dict[str, Any]:
        """The partition-topology descriptor a checkpoint records (the JAX
        module's keys)."""
        return {
            "mesh": {a: int(self.ctx.axis_size(a)) for a in MESH_AXES},
            "world_size": int(self.ctx.world_size),
            "zero_stage": int(self.stage),
            "zero_world_size": int(self.zero_size),
            "hpz_group_size": int(hpz_group_size or 0),
            "persistence_threshold": int(self.persistence_threshold),
        }

    # -- memory estimation -------------------------------------------- #
    def estimate_memory(self, n: int, bytes_per_param: int = 4,
                        optimizer_multiplier: int = 8) -> dict:
        """Bytes a rank holds for n parameters (the JAX module's estimate,
        the analog of stage2.py's memory estimators)."""
        z = self.zero_size
        param_b = n * bytes_per_param
        grad_b = n * bytes_per_param
        opt_b = n * optimizer_multiplier
        if self.stage >= 1:
            opt_b = math.ceil(opt_b / z)
        if self.stage >= 2:
            grad_b = math.ceil(grad_b / z)
        if self.stage >= 3:
            param_b = math.ceil(param_b / z)
        return {"params": param_b, "grads": grad_b, "optimizer": opt_b,
                "total": param_b + grad_b + opt_b}
