"""Config-name -> optimizer factory (counterpart of
deepspeed_tpu/runtime/optimizers.py).

The JAX package builds optax transformations and leaves their elementwise
math to XLA; here the same math is plain PyTorch over the engine's FLAT
fp32 master buffer (every parameter a view into one tensor), so a step is a
handful of large elementwise ops whatever the parameter count.  The math
follows optax exactly where the JAX package relies on it:

- Adam/AdamW (optax.scale_by_adam): mu = (1-b1) g + b1 mu,
  nu = (1-b2) g^2 + b2 nu, bias correction by the step count,
  u = mu_hat / (sqrt(nu_hat) + eps) (eps outside the sqrt);
- AdamW's decay is decoupled and multiplied by the lr
  (optax.add_decayed_weights then scale_by_learning_rate), and it applies
  to EVERY parameter, LayerNorm and biases included, as optax.adamw does
  (ROADMAP.md C);
- Lamb: Adam's update plus decay, scaled per parameter by the trust ratio
  ||p|| / ||u|| clipped to [min_coeff, max_coeff].  optax takes "per
  parameter" to be per leaf of the tree, and the JAX GPT-2 stacks each
  layer parameter over the layers into one leaf: the engine passes
  `segment_leaves` so that the layers' copies share one ratio;
- SGD: optax.sgd's momentum trace (nesterov optional);
- gradient clipping (optax.clip_by_global_norm) in fp32 before the
  optimizer;
- the lr is a float or a schedule's `lr_at(count)`, evaluated on the
  device count of applied steps.

`step` applies the update through a `where(finite, ...)` select, so a step
whose gradients are not finite leaves the parameters and every state
tensor, its count too, exactly as they were, with no host round trip.

The state is `count` plus `mu` / `nu` (Adam, AdamW, Lamb) or `trace`
(SGD).  A checkpoint holds it in the JAX layout (`jax_state`,
`from_jax_state`): the optax state that the JAX package's
`build_optimizer` chain gives for the same config.  The chain decides
the path, for example `[0].mu` for AdamW and `[1].mu` for Adam without
decoupled decay (its decay or identity comes first), `[1][0].mu` under
gradient clipping (the clip comes first), and a schedule adds its own
`count` at the chain's last place.  optax's SGD keeps no count: without a
schedule a JAX checkpoint holds none, and the engine restores the port's
`count` from the client state's `global_steps - skipped_steps` (SGD
without a schedule reads its count nowhere).

Under ZeRO (runtime/zero/partition.py) each data-parallel rank updates
only its range of the flat buffer (`step_ranks`).  The math is
elementwise except for two global reductions, which the ranks' partial
sums feed: the gradient norm of clipping (the square root of the sum over
ranks of each range's sum of squares) and Lamb's per-parameter norms of
the parameter and its update (a parameter may straddle two ranges).  Every
rank uses the same summed value.  At ZeRO-3 each rank's buffer holds its
pieces of the parameters (partition.py `Stage3Layout`); a parameter every
rank holds whole (`shared`) enters those sums from the first rank only.
"""

import contextlib
from typing import (Any, Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import torch

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
LAMB_OPTIMIZER = "lamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"
SGD_OPTIMIZER = "sgd"
DEEPSPEED_ADAM = "deepspeed_adam"

DEEPSPEED_OPTIMIZERS = [
    ADAM_OPTIMIZER, ADAMW_OPTIMIZER, LAMB_OPTIMIZER, ONEBIT_ADAM_OPTIMIZER,
    ONEBIT_LAMB_OPTIMIZER, DEEPSPEED_ADAM, SGD_OPTIMIZER,
]


class ScaleByAdamState(NamedTuple):
    """optax.scale_by_adam's state: its fields name the checkpoint keys."""
    count: Any
    mu: Any
    nu: Any


class TraceState(NamedTuple):
    """optax.trace's state (SGD's momentum)."""
    trace: Any


class ScaleByScheduleState(NamedTuple):
    """optax.scale_by_schedule's state (a schedule's step count)."""
    count: Any


def _select(finite, new, old):
    old.copy_(torch.where(finite, new, old))


class FlatOptimizer:
    """One optimizer over flat fp32 tensors: `init(params)` returns its
    state (a dict of tensors on the params' device); `step(params, grads,
    state, finite)` updates params and state in place.  `segments` are the
    (offset, numel) of each parameter inside the flat buffer, which Lamb's
    per-parameter trust ratio needs; `segment_leaves` (one int a segment,
    default: each its own) groups the segments that share one ratio."""

    def __init__(self, kind: str, lr, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.0, decoupled=True, min_coeff=0.01,
                 max_coeff=0.3, momentum=0.0, nesterov=False,
                 gradient_clipping=0.0,
                 segments: Optional[Sequence[Tuple[int, int]]] = None):
        self.kind = kind
        self.lr = lr
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.decoupled = decoupled
        self.min_coeff, self.max_coeff = min_coeff, max_coeff
        self.momentum, self.nesterov = momentum, nesterov
        self.gradient_clipping = gradient_clipping
        self.segments = segments
        self.segment_leaves: Optional[Sequence[int]] = None

    def init(self, params: torch.Tensor) -> Dict[str, torch.Tensor]:
        state = {"count": torch.zeros((), dtype=torch.int32,
                                      device=params.device)}
        if self.kind == SGD_OPTIMIZER:
            state["trace"] = torch.zeros_like(params)
        else:
            state["mu"] = torch.zeros_like(params)
            state["nu"] = torch.zeros_like(params)
        return state

    # -- the optax state of the JAX package's chain ------------------- #
    def _chain(self) -> Tuple[int, int]:
        """(length, place of the Adam / trace state) of the optax chain
        that deepspeed_tpu's build_optimizer makes for this optimizer: sgd
        = (trace, lr); adamw and decoupled adam = (adam, decay, lr); adam
        with L2 or no decay = (decay or identity, adam, lr); lamb = (adam,
        decay, trust ratio, lr)."""
        if self.kind == SGD_OPTIMIZER:
            return 2, 0
        if self.kind == LAMB_OPTIMIZER:
            return 4, 0
        if self.kind == ADAMW_OPTIMIZER or (self.decoupled
                                            and self.weight_decay):
            return 3, 0
        return 3, 1

    @property
    def _clipped(self) -> bool:
        return bool(self.gradient_clipping and self.gradient_clipping > 0)

    def jax_state(self, leaves: Dict[str, Any], count, scheduled: bool):
        """The optax state tree of the JAX package for this optimizer:
        `leaves` maps "mu" / "nu" or "trace" to parameter trees, `count` is
        the applied-step count, `scheduled` whether the lr is a schedule
        (whose state holds a count of its own).  Stateless links of the
        chain are empty tuples, which hold no checkpoint key."""
        length, core_at = self._chain()
        chain = [()] * length
        chain[core_at] = (TraceState(leaves["trace"])
                          if self.kind == SGD_OPTIMIZER else
                          ScaleByAdamState(count, leaves["mu"], leaves["nu"]))
        if scheduled:
            chain[-1] = ScaleByScheduleState(count)
        chain = tuple(chain)
        return ((), chain) if self._clipped else chain

    def from_jax_state(self, tree, scheduled: bool):
        """({"mu", "nu"} or {"trace"} parameter trees, the count or None)
        of an optax state tree laid out as `jax_state` lays it out."""
        chain = tree[1] if self._clipped else tree
        core = chain[self._chain()[1]]
        if self.kind == SGD_OPTIMIZER:
            count = chain[-1].count if scheduled else None
            return {"trace": core.trace}, count
        return {"mu": core.mu, "nu": core.nu}, core.count

    def lr_at(self, count):
        if hasattr(self.lr, "lr_at"):
            return self.lr.lr_at(count)
        return self.lr

    def _adam(self, g, state):
        count1 = (state["count"] + 1).float()
        mu = (1.0 - self.b1) * g + self.b1 * state["mu"]
        nu = (1.0 - self.b2) * (g * g) + self.b2 * state["nu"]
        mu_hat = mu / (1.0 - torch.pow(self.b1, count1))
        nu_hat = nu / (1.0 - torch.pow(self.b2, count1))
        return mu_hat / (torch.sqrt(nu_hat) + self.eps), {"mu": mu, "nu": nu}

    def _segments_in(self, offset: int, length: int):
        """(leaf index, start, end) within a range [offset, offset +
        length) of the flat buffer, for each parameter segment it meets."""
        if not self.segments:
            raise ValueError("lamb needs the parameters' segments")
        leaves = self.segment_leaves or range(len(self.segments))
        out = []
        for leaf, (off, n) in zip(leaves, self.segments):
            lo, hi = max(off, offset), min(off + n, offset + length)
            if lo < hi:
                out.append((leaf, lo - offset, hi - offset))
        return out

    def _segment_squares(self, params, u, offset, skip=()):
        """[leaves, 2]: each leaf's sum of squares of params and of u over
        the part of it that lies in this range (0 elsewhere), but for the
        segments that start at an offset in `skip`."""
        n_leaves = (max(self.segment_leaves) + 1 if self.segment_leaves
                    else len(self.segments))
        sq = torch.zeros(n_leaves, 2, dtype=torch.float32, device=u.device)
        for leaf, lo, hi in self._segments_in(offset, u.numel()):
            if lo + offset in skip:
                continue
            sq[leaf, 0] += (params[lo:hi] * params[lo:hi]).sum()
            sq[leaf, 1] += (u[lo:hi] * u[lo:hi]).sum()
        return sq

    def _trust_ratio(self, u, sq, offset):
        """u scaled per parameter by ||p|| / ||u|| clipped to [min_coeff,
        max_coeff] (1 where either norm is 0), from its leaf's summed
        squares."""
        p_norm, u_norm = torch.sqrt(sq[:, 0]), torch.sqrt(sq[:, 1])
        ratio = torch.where(
            u_norm > 0,
            torch.where(p_norm > 0, p_norm / u_norm, torch.ones_like(p_norm)),
            torch.ones_like(u_norm))
        ratio = torch.clamp(ratio, self.min_coeff, self.max_coeff)
        out = u.clone()
        for leaf, lo, hi in self._segments_in(offset, u.numel()):
            out[lo:hi] = u[lo:hi] * ratio[leaf]
        return out

    def step(self, params: torch.Tensor, grads: torch.Tensor,
             state: Dict[str, torch.Tensor], finite: torch.Tensor) -> None:
        """params, grads: flat fp32 (grads already unscaled); finite: a
        device bool, False leaves everything as it was."""
        self.step_ranks([params], [grads], [state], [finite])

    @staticmethod
    def square_sum(g: torch.Tensor, shared=None, first: bool = True):
        """g's sum of squares; for a rank after the first, without the
        (offset, numel) segments of `shared` (they count once)."""
        if first or not shared:
            return (g * g).sum()
        keep = torch.ones_like(g, dtype=torch.bool)
        for off, n in shared:
            keep[off:off + n] = False
        return torch.where(keep, g * g, torch.zeros_like(g)).sum()

    def step_ranks(self, params: List[torch.Tensor],
                   grads: List[torch.Tensor],
                   states: List[Dict[str, torch.Tensor]],
                   finite: List[torch.Tensor],
                   offsets: Optional[Sequence[int]] = None,
                   rank: Optional[Callable] = None,
                   total: Optional[Callable] = None,
                   shared: Sequence[Tuple[int, int]] = ()) -> None:
        """One step of every rank's range, in place.  Per rank (lists in
        rank order): its range of the fp32 parameters, the unscaled
        gradients of that range, its state and the finite flag (the same
        on every rank).  offsets: where each range starts in the flat
        buffer (default 0).  rank(r): a context that runs rank r's work
        (the mesh's `rank`).  total(parts): every rank's partial sums
        summed over the ranks, one result per rank (the mesh's `all_sum`);
        None when each rank holds the whole buffer.  shared: the (offset,
        numel) segments every rank holds whole at ZeRO-3, summed from the
        first rank only."""
        world = len(params)
        offsets = offsets if offsets is not None else [0] * world

        def each(fn):
            out = []
            for r in range(world):
                with (rank(r) if rank is not None
                      else contextlib.nullcontext()):
                    out.append(fn(r))
            return out

        def summed(parts):
            return parts if total is None else total(parts)

        g = list(grads)
        if self.gradient_clipping and self.gradient_clipping > 0:
            sq = summed(each(lambda r: self.square_sum(g[r], shared,
                                                       r == 0)))

            def clip(r):
                g_norm = torch.sqrt(sq[r])
                return torch.where(g_norm < self.gradient_clipping, g[r],
                                   g[r] / g_norm * self.gradient_clipping)
            g = each(clip)
        updates = each(lambda r: self._update(params[r], g[r], states[r]))
        if self.kind == LAMB_OPTIMIZER:
            skip = {off for off, _ in shared}
            sq = summed(each(lambda r: self._segment_squares(
                params[r], updates[r][0], offsets[r],
                skip if r > 0 else ())))
            updates = each(lambda r: (self._trust_ratio(
                updates[r][0], sq[r], offsets[r]), updates[r][1]))
        each(lambda r: self._apply(params[r], updates[r], states[r],
                                   finite[r]))

    def _update(self, params, g, state):
        """(the update u before the lr and Lamb's trust ratio, the new
        state tensors)."""
        if self.kind == SGD_OPTIMIZER:
            trace = g + self.momentum * state["trace"]
            u = g + self.momentum * trace if self.nesterov else trace
            return u, {"trace": trace}
        if not self.decoupled and self.weight_decay:
            g = g + self.weight_decay * params  # L2 into the gradient
        u, new_state = self._adam(g, state)
        if self.decoupled and self.weight_decay:
            u = u + self.weight_decay * params
        return u, new_state

    def _apply(self, params, update, state, finite):
        u, new_state = update
        lr = self.lr_at(state["count"])
        params.add_(torch.where(finite, -lr * u, torch.zeros_like(u)))
        for name, value in new_state.items():
            _select(finite, value, state[name])
        _select(finite, state["count"] + 1, state["count"])


def build_optimizer(name: Optional[str], params_cfg: Dict[str, Any],
                    learning_rate=None, gradient_clipping: float = 0.0,
                    segments=None) -> FlatOptimizer:
    """The optimizer of a config "optimizer" block.  `learning_rate` (a
    schedule with lr_at) overrides params_cfg["lr"]."""
    name = (name or ADAM_OPTIMIZER).lower()
    cfg = dict(params_cfg or {})
    lr = learning_rate if learning_rate is not None else cfg.get("lr", 1e-3)
    b1, b2 = cfg.get("betas", (0.9, 0.999))
    eps = cfg.get("eps", 1e-8)
    wd = cfg.get("weight_decay", 0.0)
    common = dict(lr=lr, gradient_clipping=gradient_clipping,
                  segments=segments)
    if name in (ADAM_OPTIMIZER, DEEPSPEED_ADAM, "fusedadam"):
        return FlatOptimizer(ADAM_OPTIMIZER, b1=b1, b2=b2, eps=eps,
                             weight_decay=wd,
                             decoupled=bool(cfg.get("adam_w_mode", True)),
                             **common)
    if name == ADAMW_OPTIMIZER:
        return FlatOptimizer(ADAMW_OPTIMIZER, b1=b1, b2=b2, eps=eps,
                             weight_decay=wd, **common)
    if name in (LAMB_OPTIMIZER, "fusedlamb"):
        return FlatOptimizer(LAMB_OPTIMIZER, b1=b1, b2=b2,
                             eps=cfg.get("eps", 1e-6), weight_decay=wd,
                             min_coeff=cfg.get("min_coeff", 0.01),
                             max_coeff=cfg.get("max_coeff", 0.3), **common)
    if name == SGD_OPTIMIZER:
        return FlatOptimizer(SGD_OPTIMIZER,
                             momentum=cfg.get("momentum", 0.0),
                             nesterov=cfg.get("nesterov", False), **common)
    if name in (ONEBIT_ADAM_OPTIMIZER, ONEBIT_LAMB_OPTIMIZER):
        raise NotImplementedError(
            f"{name}: the 1-bit optimizers are not ported yet (ROADMAP.md "
            "A.8, low-bandwidth collectives)")
    raise ValueError(f"Unknown optimizer {name!r}; "
                     f"supported: {DEEPSPEED_OPTIMIZERS}")
