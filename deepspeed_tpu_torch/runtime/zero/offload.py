"""ZeRO-Offload: the fp32 master and the Adam moments in host memory, stepped
by the native host Adam, while the card holds compute-dtype parameters
only (counterpart of deepspeed_tpu/runtime/zero/offload.py; reference:
the stage-2 CPU-offload path, runtime/zero/stage2.py:976-1125).

The tier keeps the master, exp_avg and exp_avg_sq as three flat fp32 host
buffers laid out as the engine's flat parameter buffer (every parameter
one span), so one native call steps the whole model.  AdamW is
elementwise, so the result is the JAX tier's per-leaf sweep's, bit for
bit.  The two global reductions read the JAX tree's leaves in the JAX
order (`JaxLeafMap`): the finite check, and under gradient clipping the
global norm, summed leaf by leaf as the JAX tier sums it.  Its
`state_dict` is the JAX tier's layout ({"step", "exp_avg": {"0": leaf 0,
...}, "exp_avg_sq", "params": the JAX tree}), so a checkpoint moves
between the packages.

`apply` takes the reduced, still-scaled fp32 grads in a host buffer
(scaled in place), returns False on a non-finite grad (the caller skips
the step and moves the loss scaler) and otherwise writes the new
parameters in the compute dtype into `out`, through the native bf16
copy-out when that is bf16.
"""

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ...ops.adam.cpu_adam import adam_step_buffers, native_lib
from ...utils.logging import log_dist
from ..swap_tensor.utils import aligned_empty


class _Leaf(NamedTuple):
    """One leaf of the JAX tree: its key path, its shape (a layer leaf is
    stacked over the layers) and its spans of the flat buffer, in row
    order."""
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    segments: Tuple[Tuple[int, int], ...]

    @property
    def numel(self) -> int:
        return sum(n for _, n in self.segments)


class JaxLeafMap:
    """The JAX GPT-2 tree's leaves over a flat buffer of the port's named
    parameters.  `named_shapes`: (port name, shape) in the buffer's order;
    `offsets`: each one's start (default: one after another); `size`: the
    buffer's length (default: the parameters' count).  A layer parameter
    `h.<i>.<leaf>` is row i of the JAX leaf `h/<leaf>`; the leaves come in
    JAX's flattening order (sorted keys), the order of the JAX tier's
    leaf numbers and file names."""

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
            rows.setdefault(path, []).append((layer, off, n, shape))
        self.leaves: List[_Leaf] = []
        for path in sorted(rows):
            entries = sorted(rows[path], key=lambda e: -1 if e[0] is None
                             else e[0])
            stacked = entries[0][0] is not None
            shape = ((len(entries),) + entries[0][3] if stacked
                     else entries[0][3])
            self.leaves.append(_Leaf(path, shape, tuple(
                (off, n) for _, off, n, _ in entries)))

    def gather(self, flat: torch.Tensor, k: int,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Leaf k of `flat` as one contiguous tensor of its shape: a view
        when it is one span, else its rows copied into `out` (a staging
        buffer) or a new tensor."""
        leaf = self.leaves[k]
        if len(leaf.segments) == 1:
            off, n = leaf.segments[0]
            return flat[off:off + n].view(leaf.shape)
        if out is None:
            out = torch.empty(leaf.numel, dtype=flat.dtype)
        at = 0
        for off, n in leaf.segments:
            out[at:at + n].copy_(flat[off:off + n])
            at += n
        return out[:leaf.numel].view(leaf.shape)

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


def global_grad_norm(leaf_map: JaxLeafMap, grads: torch.Tensor,
                     staging: Optional[torch.Tensor] = None) -> float:
    """The grads' global L2 norm, summed leaf by leaf in the JAX order as
    the JAX tier sums it (fp32 dot products, their sum in double)."""
    sq = 0.0
    for k in range(len(leaf_map.leaves)):
        g = leaf_map.gather(grads, k, staging).reshape(-1).numpy()
        sq += float(np.vdot(g, g).real)
    return float(np.sqrt(sq))


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
                staging: Optional[torch.Tensor] = None) -> bool:
        """The JAX tier's order: the finite check on the raw grads, the
        unscale, the clip by the global norm; False when not finite."""
        if not bool(torch.isfinite(grads).all()):
            return False
        if lr is not None:
            self.lr = float(lr)
        if scale_inv != 1.0:
            grads.mul_(scale_inv)
        if self.gradient_clipping > 0.0:
            norm = global_grad_norm(leaf_map, grads, staging)
            if norm > self.gradient_clipping:
                grads.mul_(self.gradient_clipping / (norm + 1e-6))
        return True


class HostOffloadOptimizer:
    """The host tier: fp32 master, exp_avg, exp_avg_sq in flat host buffers
    of `leaf_map.size` entries (pinned when `pin`, for a CUDA engine), and
    the native Adam over them."""

    def __init__(self, leaf_map: JaxLeafMap, master: torch.Tensor,
                 optimizer_name: str, optimizer_params: dict,
                 gradient_clipping: float = 0.0, pin: bool = False):
        self.hyper = _AdamHyper(optimizer_name, optimizer_params,
                                gradient_clipping, "offload_optimizer")
        self.leaf_map = leaf_map
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
        if not h.prepare(self.leaf_map, grads, scale_inv, lr):
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

    def load_master_params(self, tree: Dict[str, Any]) -> None:
        """Overwrite the master from a JAX tree, moments untouched (a
        module-only checkpoint load)."""
        self.leaf_map.from_tree(tree, self.master)

    def state_dict(self) -> Dict[str, Any]:
        lm = self.leaf_map
        count = range(len(lm.leaves))
        return {"step": self._step,
                "exp_avg": {str(k): lm.gather(self.exp_avg, k).clone()
                            for k in count},
                "exp_avg_sq": {str(k): lm.gather(self.exp_avg_sq, k).clone()
                               for k in count},
                "params": lm.to_tree(self.master)}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        lm = self.leaf_map
        self._step = int(np.asarray(sd["step"]))
        for k in range(len(lm.leaves)):
            lm.scatter(self.exp_avg, k, sd["exp_avg"][str(k)])
            lm.scatter(self.exp_avg_sq, k, sd["exp_avg_sq"][str(k)])
        lm.from_tree(sd["params"], self.master)
