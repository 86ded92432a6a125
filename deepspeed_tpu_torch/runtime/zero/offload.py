"""ZeRO-Offload: the fp32 master and the Adam moments in host memory, stepped
by the native host Adam, while the card holds compute-dtype parameters
only (counterpart of deepspeed_tpu/runtime/zero/offload.py; reference:
the stage-2 CPU-offload path, runtime/zero/stage2.py:976-1125).

The tier keeps the master, exp_avg and exp_avg_sq as three flat fp32 host
buffers over the part of the engine's parameters it steps (`JaxLeafMap`):
the whole flat buffer, one process's ranges of it (`JaxLeafMap.ranged`,
the ranks' ranges of ZeRO stages 1-2), or every local rank's stage-3
pieces (`JaxLeafMap.pieces`), so one native call steps them all.  AdamW
is elementwise, so the result is the JAX tier's per-leaf sweep's, bit for
bit, however the buffer is cut.  The two global reductions are taken
over the map's parts, one a rank: the finite check, and under gradient
clipping the global norm.  Each rank's part is its leaves in the JAX
order, each leaf cut by the rank's range (or the rank's piece of it);
its squared norm is fp32 sums of fixed blocks of each span added in
float64 (`square_sums`), and the norm is the square root of the ranks'
partials summed in rank order.  So a tier over every rank's part (one
controller) and W tiers over one part each (W processes, the partials
exchanged by `gather`) take the same sum; the JAX tier's (a dot product
a leaf) agrees with it to fp32 rounding.  A leaf every stage-3 rank
holds whole counts once, in rank 0's part.  Its
`state_dict` is the JAX tier's layout ({"step", "exp_avg": {"0": leaf 0,
...}, "exp_avg_sq", "params": the JAX tree}), so a checkpoint moves
between the packages; a tier over a part of the leaves gives its flat
buffers (`local_state`) and the engine assembles the whole leaves.

`apply` takes the reduced, still-scaled fp32 grads in a host buffer
(scaled in place), returns False on a non-finite grad (the caller skips
the step and moves the loss scaler) and otherwise writes the new
parameters in the compute dtype into `out`, through the native bf16
copy-out when that is bf16.
"""

import math
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from ...ops.adam.cpu_adam import adam_step_buffers, native_lib
from ...utils.logging import log_dist
from ..swap_tensor.utils import aligned_empty

KINDS = ("param", "exp_avg", "exp_avg_sq")
DOT_BLOCK = 4096  # entries an fp32 squared sum of square_sums covers
DOT_ROWS = 256  # blocks square_sums reduces in one call
# `gather` of the tiers and of square_sums' callers: every process's
# float64 values concatenated in process order (None: one process)
Gather = Optional[Callable[[np.ndarray], np.ndarray]]


class _Leaf(NamedTuple):
    """One leaf of the JAX tree: its key path, its shape (a layer leaf is
    stacked over the layers; a leaf the map holds only a part of is 1-D)
    and its spans of the flat buffer, in row order."""
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    segments: Tuple[Tuple[int, int], ...]

    @property
    def numel(self) -> int:
        return sum(n for _, n in self.segments)


def _gather_spans(flat: torch.Tensor, segments, out=None) -> torch.Tensor:
    """The spans of `flat` as one 1-D tensor: a view when there is one,
    else copied into `out` (a staging buffer) or a new tensor."""
    if len(segments) == 1:
        off, n = segments[0]
        return flat[off:off + n]
    total = sum(n for _, n in segments)
    if out is None:
        out = torch.empty(total, dtype=flat.dtype)
    at = 0
    for off, n in segments:
        out[at:at + n].copy_(flat[off:off + n])
        at += n
    return out[:total]


class JaxLeafMap:
    """The JAX GPT-2 tree's leaves over a flat buffer of the port's named
    parameters.  `named_shapes`: (port name, shape) in the buffer's order;
    `offsets`: each one's start (default: one after another); `size`: the
    buffer's length (default: the parameters' count).  A layer parameter
    `h.<i>.<leaf>` is row i of the JAX leaf `h/<leaf>`; the leaves come in
    JAX's flattening order (sorted keys), the order of the JAX tier's
    leaf numbers and file names.  `parts`: one a rank the buffer holds,
    each leaf's spans of that rank's part (empty where the leaf counts in
    another rank's part); the whole map is one part.  `whole`: whether
    every leaf is whole in the buffer (the JAX tier's own layout)."""

    def __init__(self, named_shapes: Sequence[Tuple[str, Tuple[int, ...]]],
                 offsets: Optional[Sequence[int]] = None,
                 size: Optional[int] = None):
        from ...models.gpt2 import GPT2Model
        self.named_shapes = [(n, tuple(s)) for n, s in named_shapes]
        numels = [int(np.prod(s)) if s else 1 for _, s in self.named_shapes]
        if offsets is None:
            offsets = np.concatenate([[0], np.cumsum(numels)[:-1]]).tolist()
        self.offsets = [int(o) for o in offsets]
        self.num_params = sum(numels)
        self.size = int(size) if size is not None else self.num_params
        rows: Dict[Tuple[str, ...], list] = {}
        for (name, shape), off, n in zip(self.named_shapes, self.offsets,
                                         numels):
            path = tuple(GPT2Model.jax_leaf(name).split("."))
            layer = GPT2Model.layer_index(name)
            rows.setdefault(path, []).append((layer, off, n, shape, name))
        self.leaves: List[_Leaf] = []
        self._names: List[Tuple[str, ...]] = []  # port names, row order
        for path in sorted(rows):
            entries = sorted(rows[path], key=lambda e: -1 if e[0] is None
                             else e[0])
            stacked = entries[0][0] is not None
            shape = ((len(entries),) + entries[0][3] if stacked
                     else entries[0][3])
            self.leaves.append(_Leaf(path, shape, tuple(
                (off, n) for _, off, n, _, _ in entries)))
            self._names.append(tuple(e[4] for e in entries))
        self.parts = [[leaf.segments for leaf in self.leaves]]
        self.whole = True

    def _derived(self, leaves, parts, size) -> "JaxLeafMap":
        out = object.__new__(JaxLeafMap)
        out.named_shapes, out.offsets = self.named_shapes, None
        out.num_params, out._names = self.num_params, self._names
        out.size, out.leaves, out.parts = int(size), leaves, parts
        out.whole = all(a.shape == b.shape and a.numel == b.numel
                        for a, b in zip(leaves, self.leaves))
        return out

    def ranged(self, ranges: Sequence[Tuple[int, int]]) -> "JaxLeafMap":
        """The map over a buffer that holds `ranges` of this one ([lo, hi),
        ascending, one a rank), laid one after another: each leaf cut by
        the ranges keeps its rows' order, and rank i's part is its range's
        cut of every leaf.  Ranges that cover this buffer give its own
        layout (a `whole` map)."""
        starts = np.concatenate([[0], np.cumsum(
            [hi - lo for lo, hi in ranges])]).tolist()
        leaves, parts = [], [[] for _ in ranges]
        for leaf in self.leaves:
            # the leaf's spans in row order: a segment's pieces lie in the
            # ranges in order, and the segments come in row order
            spans = []
            for off, n in leaf.segments:
                for i, (lo, hi) in enumerate(ranges):
                    a, b = max(off, lo), min(off + n, hi)
                    if a < b:
                        spans.append((i, starts[i] + a - lo, b - a))
            for i, part in enumerate(parts):
                part.append(tuple((o, n) for j, o, n in spans if j == i))
            merged = []
            for _, off, n in spans:
                if merged and merged[-1][0] + merged[-1][1] == off:
                    merged[-1] = (merged[-1][0], merged[-1][1] + n)
                else:
                    merged.append((off, n))
            numel = sum(n for _, n in merged)
            shape = leaf.shape if numel == leaf.numel else (numel,)
            leaves.append(_Leaf(leaf.path, shape, tuple(merged)))
        return self._derived(leaves, parts, starts[-1])

    def pieces(self, layout, ranks: int) -> "JaxLeafMap":
        """The map over `ranks` stage-3 buffers laid one after another
        (partition.py `Stage3Layout`, `layout.size` entries a rank, in
        rank order): each leaf is its rows' pieces, rank by rank; rank i's
        part is its pieces of every leaf, a leaf every rank holds whole
        counting in rank 0's part only."""
        leaves, parts = [], [[] for _ in range(ranks)]
        for leaf, names in zip(self.leaves, self._names):
            spans = []
            for i in range(ranks):
                base = i * layout.size
                mine = tuple((base + layout.by_name[n].offset,
                              layout.by_name[n].numel) for n in names)
                whole = all(layout.by_name[n].dim is None for n in names)
                parts[i].append(mine if i == 0 or not whole else ())
                spans.extend(mine)
            numel = sum(n for _, n in spans)
            leaves.append(_Leaf(leaf.path, (numel,), tuple(spans)))
        return self._derived(leaves, parts, ranks * layout.size)

    def gather(self, flat: torch.Tensor, k: int,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Leaf k of `flat` as one contiguous tensor of its shape: a view
        when it is one span, else its rows copied into `out` (a staging
        buffer) or a new tensor."""
        leaf = self.leaves[k]
        return _gather_spans(flat, leaf.segments, out).view(leaf.shape)

    def scatter(self, flat: torch.Tensor, k: int, value) -> None:
        """Write leaf k (a tensor or array of its shape) into `flat`."""
        src = torch.as_tensor(np.asarray(value) if not isinstance(
            value, torch.Tensor) else value).reshape(-1)
        at = 0
        for off, n in self.leaves[k].segments:
            flat[off:off + n].copy_(src[at:at + n])
            at += n

    def tree(self, leaves: Sequence[Any]) -> Dict[str, Any]:
        """The nested-dict tree holding `leaves` (one a leaf, in order)."""
        out: Dict[str, Any] = {}
        for leaf, value in zip(self.leaves, leaves):
            node = out
            for key in leaf.path[:-1]:
                node = node.setdefault(key, {})
            node[leaf.path[-1]] = value
        return out

    def to_tree(self, flat: torch.Tensor) -> Dict[str, Any]:
        """The JAX tree of `flat` (copies, numpy)."""
        return self.tree([self.gather(flat, k).clone().numpy()
                          for k in range(len(self.leaves))])

    def tree_leaf(self, tree: Dict[str, Any], k: int):
        node = tree
        for key in self.leaves[k].path:
            node = node[key]
        return node

    def from_tree(self, tree: Dict[str, Any], flat: torch.Tensor) -> None:
        """Fill `flat` from a JAX tree (arrays or tensors)."""
        for k in range(len(self.leaves)):
            self.scatter(flat, k, self.tree_leaf(tree, k))


def _span_block_sums(x: torch.Tensor) -> List[torch.Tensor]:
    """The fp32 squared sums of `x`'s DOT_BLOCK-long blocks (the last one
    shorter), DOT_ROWS blocks a call.  Each block is reduced whole by one
    thread in an order that depends on neither its address nor the
    process's threads, so a span sums alike in any buffer."""
    n = x.numel()
    full = n - n % DOT_BLOCK
    out = []
    if full:
        rows = x[:full].view(-1, DOT_BLOCK)
        for r in range(0, rows.shape[0], DOT_ROWS):
            block = rows[r:r + DOT_ROWS]
            out.append(torch.sum(block * block, dim=1))
    if full < n:
        tail = x[full:]
        out.append(torch.sum(tail * tail).reshape(1))
    return out


def square_sums(leaf_map: JaxLeafMap, grads: torch.Tensor) -> np.ndarray:
    """Each part's squared L2 norm of `grads` (a buffer of the map), one a
    rank in rank order: its leaves in the JAX order, each leaf's spans in
    row order, each span cut into DOT_BLOCK-long blocks whose fp32 squared
    sums are added in float64 by `math.fsum` (correctly rounded, so in no
    particular order).  A rank's part has the same spans in any buffer
    that holds it (one controller's whole buffer or one process's range),
    so one controller and W processes take the same sum.  This is not the
    JAX tier's sum (one fp32 dot product a leaf, deepspeed_tpu's
    runtime/zero/offload.py `_global_grad_norm`): the two agree to fp32
    rounding, the blocks' being the smaller."""
    out = np.zeros(len(leaf_map.parts), dtype=np.float64)
    for i, part in enumerate(leaf_map.parts):
        sums = [s for segments in part for off, n in segments
                for s in _span_block_sums(grads[off:off + n])]
        if sums:
            out[i] = math.fsum(torch.cat(sums).double().tolist())
    return out


def total_norm(parts: np.ndarray) -> float:
    """The square root of every rank's squared norm summed in rank order,
    starting from zero (one fixed sum at any process count)."""
    sq = 0.0
    for v in parts:
        sq += float(v)
    return float(np.sqrt(sq))


def global_grad_norm(leaf_map: JaxLeafMap, grads: torch.Tensor,
                     gather: Gather = None) -> float:
    """The grads' global L2 norm: `square_sums` of this tier's parts, with
    every other process's (`gather`), summed in rank order (the JAX
    tier's, a dot product a leaf, to fp32 rounding)."""
    parts = square_sums(leaf_map, grads)
    return total_norm(parts if gather is None else gather(parts))


def process_all_gather(mesh, device, part: torch.Tensor) -> torch.Tensor:
    """Every process's `part` (one length and dtype) concatenated in
    process order, on the host: the mesh's all-gather on `device`, this
    process's card (a collective: every process calls it)."""
    with mesh.forked():
        full = mesh.all_gather_flat([part.to(device)])[0]
    return full.cpu()


def process_exchange(mesh, device) -> Gather:
    """The tiers' `gather` under a process group (None without one):
    every process's float64 values in process order."""
    if mesh.process_group is None:
        return None
    return lambda values: process_all_gather(mesh, device, torch.from_numpy(
        np.ascontiguousarray(values, np.float64))).numpy()


def _check_optimizer(optimizer_name: str, where: str) -> str:
    name = (optimizer_name or "adam").lower()
    if name not in ("adam", "adamw"):
        raise ValueError(
            f"{where} supports Adam/AdamW, got {optimizer_name!r} (only the "
            "host Adam is offloadable, as in the reference's stage2.py)")
    return name


class _AdamHyper:
    """The tier's Adam hyper-parameters from the config's optimizer block
    (the JAX tier's reading: AdamW mode for "adamw" or adam_w_mode)."""

    def __init__(self, optimizer_name, optimizer_params, gradient_clipping,
                 where):
        name = _check_optimizer(optimizer_name, where)
        p = dict(optimizer_params or {})
        self.lr = float(p.get("lr", 1e-3))
        betas = p.get("betas", (0.9, 0.999))
        self.betas = (float(betas[0]), float(betas[1]))
        self.eps = float(p.get("eps", 1e-8))
        self.weight_decay = float(p.get("weight_decay", 0.0))
        self.adamw_mode = name == "adamw" or bool(p.get("adam_w_mode", False))
        self.gradient_clipping = float(gradient_clipping or 0.0)
        self.name = name

    def step_args(self, step: int) -> Dict[str, Any]:
        return dict(lr=self.lr, beta1=self.betas[0], beta2=self.betas[1],
                    eps=self.eps, weight_decay=self.weight_decay, step=step,
                    adamw_mode=self.adamw_mode)

    def prepare(self, leaf_map: JaxLeafMap, grads: torch.Tensor,
                scale_inv: float, lr: Optional[float],
                gather: Gather = None) -> bool:
        """The JAX tier's order: the finite check on the raw grads, the
        unscale, the clip by the global norm; False when not finite.  With
        `gather` (a tier over one process's part) the flag and the norm's
        partials are exchanged, so every process takes the same skip and
        the same clip."""
        finite = bool(torch.isfinite(grads).all())
        if gather is not None:
            finite = bool(gather(np.array([float(finite)])).all())
        if not finite:
            return False
        if lr is not None:
            self.lr = float(lr)
        if scale_inv != 1.0:
            grads.mul_(scale_inv)
        if self.gradient_clipping > 0.0:
            norm = global_grad_norm(leaf_map, grads, gather)
            if norm > self.gradient_clipping:
                grads.mul_(self.gradient_clipping / (norm + 1e-6))
        return True


def host_state_layout(leaf_map: JaxLeafMap, step: int,
                      buffers: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The JAX host tier's state_dict from flat buffers of a whole map:
    {"step", "exp_avg": {"k": leaf k}, "exp_avg_sq", "params": the tree}
    (copies)."""
    count = range(len(leaf_map.leaves))
    return {"step": step,
            "exp_avg": {str(k): leaf_map.gather(buffers["exp_avg"], k)
                        .clone() for k in count},
            "exp_avg_sq": {str(k): leaf_map.gather(buffers["exp_avg_sq"], k)
                           .clone() for k in count},
            "params": leaf_map.to_tree(buffers["param"])}


def host_state_buffers(leaf_map: JaxLeafMap, sd: Dict[str, Any]):
    """(step, flat buffers by kind) of a JAX host tier's state_dict, over a
    whole map (the padding zero)."""
    out = {kind: torch.zeros(leaf_map.size, dtype=torch.float32)
           for kind in KINDS}
    for k in range(len(leaf_map.leaves)):
        leaf_map.scatter(out["exp_avg"], k, sd["exp_avg"][str(k)])
        leaf_map.scatter(out["exp_avg_sq"], k, sd["exp_avg_sq"][str(k)])
    leaf_map.from_tree(sd["params"], out["param"])
    return int(np.asarray(sd["step"])), out


class TierView:
    """A tier's state as the whole parameters' (checkpoints, the module
    tree): `whole_map` is the engine's whole layout, `to_whole` makes a
    tier buffer (this process's part) a buffer of it, `to_part` is its
    inverse; both are the identity when the tier's map is whole, and
    `to_whole` is a collective under a process group."""

    def __init__(self, tier, whole_map: JaxLeafMap,
                 to_whole: Callable[[torch.Tensor], torch.Tensor],
                 to_part: Callable[[torch.Tensor], torch.Tensor]):
        self.tier, self.whole_map = tier, whole_map
        self.to_whole, self.to_part = to_whole, to_part

    def master_flat(self) -> torch.Tensor:
        """The fp32 master over the whole layout."""
        return self.to_whole(self.tier.local_state(("param",))["param"])

    def master(self) -> Dict[str, Any]:
        """The fp32 master as the JAX tree (numpy)."""
        return self.whole_map.to_tree(self.master_flat())

    def state(self) -> Dict[str, Any]:
        """The tier's state_dict in the JAX tier's layout, leaves whole."""
        bufs = {k: self.to_whole(v)
                for k, v in self.tier.local_state().items()}
        return self.tier.state_layout(self.whole_map,
                                      self.tier.step_count(), bufs)

    def load_state(self, sd: Dict[str, Any]) -> None:
        """Load a JAX-layout tier state_dict: this process its part."""
        step, bufs = self.tier.state_buffers(self.whole_map, sd)
        self.tier.load_local_state(step, {k: self.to_part(v)
                                          for k, v in bufs.items()})

    def load_master_flat(self, flat: torch.Tensor) -> None:
        """Overwrite the master from a buffer of the whole layout, the
        moments untouched."""
        self.tier.load_local_state(None, {"param": self.to_part(flat)})

    def load_master(self, tree: Dict[str, Any]) -> None:
        """Overwrite the master from a whole JAX tree."""
        full = torch.zeros(self.whole_map.size, dtype=torch.float32)
        self.whole_map.from_tree(tree, full)
        self.load_master_flat(full)


class HostOffloadOptimizer:
    """The host tier: fp32 master, exp_avg, exp_avg_sq in flat host buffers
    of `leaf_map.size` entries (pinned when `pin`, for a CUDA engine), and
    the native Adam over them.  `gather`: under several processes, each
    holding one part, the exchange of the finite flag and the norm's
    partials (`_AdamHyper.prepare`)."""

    state_layout = staticmethod(host_state_layout)
    state_buffers = staticmethod(host_state_buffers)

    def __init__(self, leaf_map: JaxLeafMap, master: torch.Tensor,
                 optimizer_name: str, optimizer_params: dict,
                 gradient_clipping: float = 0.0, pin: bool = False,
                 gather: Gather = None):
        self.hyper = _AdamHyper(optimizer_name, optimizer_params,
                                gradient_clipping, "offload_optimizer")
        self.leaf_map = leaf_map
        self.gather = gather
        size = leaf_map.size
        self.master = aligned_empty(4 * size, torch.float32, pin)[:size]
        self.master.copy_(master.detach().reshape(-1)[:size].float().cpu())
        self.exp_avg = aligned_empty(4 * size, torch.float32, pin)[:size]
        self.exp_avg_sq = aligned_empty(4 * size, torch.float32, pin)[:size]
        self.exp_avg.zero_()
        self.exp_avg_sq.zero_()
        self.pinned_bytes = 12 * size if pin else 0
        self._step = 0
        self.last_sweep_stats: Optional[Dict[str, float]] = None
        native_lib()  # raises at engine build when it cannot build
        log_dist(f"ZeRO-Offload: host {self.hyper.name} over "
                 f"{sum(leaf.numel for leaf in leaf_map.leaves)} of "
                 f"{leaf_map.num_params} params (native, pinned="
                 f"{bool(pin)})", ranks=[0])

    def step_count(self) -> int:
        return self._step

    @property
    def master_params(self) -> Dict[str, Any]:
        return self.leaf_map.to_tree(self.master)

    def apply(self, grads: torch.Tensor, scale_inv: float,
              lr: Optional[float], out: Optional[torch.Tensor] = None) -> bool:
        """One step from the fp32 grads in `grads` (a host buffer of the
        layout, scaled in place): False, changing nothing, when a grad is
        not finite; else the master and moments stepped and `out` (a
        compute-dtype host buffer, or None) holding the new parameters."""
        h = self.hyper
        if not h.prepare(self.leaf_map, grads, scale_inv, lr,
                         gather=self.gather):
            return False
        self._step += 1
        bf16 = out if out is not None and out.dtype == torch.bfloat16 \
            else None
        n = self.master.numel()
        adam_step_buffers(self.master, self.exp_avg, self.exp_avg_sq,
                          grads[:n], bf16_out=None if bf16 is None
                          else bf16[:n], **h.step_args(self._step))
        if bf16 is None and out is not None:  # fp32 or fp16 compute
            out.copy_(self.master)
        return True

    def local_state(self, kinds=KINDS) -> Dict[str, torch.Tensor]:
        """The tier's flat buffers of `kinds` (its own tensors)."""
        own = {"param": self.master, "exp_avg": self.exp_avg,
               "exp_avg_sq": self.exp_avg_sq}
        return {kind: own[kind] for kind in kinds}

    def load_local_state(self, step: Optional[int],
                         buffers: Dict[str, torch.Tensor]) -> None:
        """Overwrite the flat buffers of the kinds given (and the step
        count, unless None)."""
        if step is not None:
            self._step = int(step)
        for kind, value in buffers.items():
            self.local_state()[kind].copy_(value)

    def state_dict(self) -> Dict[str, Any]:
        return host_state_layout(self.leaf_map, self._step,
                                 self.local_state())
