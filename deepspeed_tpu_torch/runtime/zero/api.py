"""The user-facing ZeRO-3 construction API: `Init` and
`GatheredParameters` (counterpart of deepspeed_tpu/runtime/zero/api.py).

The JAX module builds each leaf directly into its ZeRO placement (a jit
whose out_shardings are the partition) and gathers a placed tree to host
arrays for surgery.  The port's per-rank values are lists of tensors in
rank order (parallel/mesh.py), so a sharded tree here maps each name to a
`ShardedParameter`: the leaf's whole shape, the dimension cut over the
ZeRO world (zero_partition_spec's pick, None: whole on every rank) and
one piece a rank, on the rank's device.

`GatheredParameters` also takes the parameters of a stage-3 engine's
module, which are empty placeholders (runtime/engine.py): inside the
context each holds its whole fp32 value, gathered from the engine's
ranks; with `modifier_rank` set, edits made there are scattered back
into every rank's piece on exit, and the placeholders are emptied again.
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ...parallel.mesh import ZERO_AXES, MeshContext, get_mesh_context
from ...utils.logging import log_dist
from .partition import ShardedLeaf, ZeroPartitioner, shard_dim, \
    zero_partition_spec


@dataclass
class ShardedParameter:
    """One leaf held as pieces: `shards[i]` is local rank i's."""
    leaf: ShardedLeaf
    shards: List[torch.Tensor]

    @property
    def shape(self):
        return self.leaf.shape

    def full(self) -> np.ndarray:
        """The whole leaf on the host."""
        pieces = [s.detach().cpu().numpy() for s in self.shards]
        if self.leaf.dim is None:
            return pieces[0].copy()
        return np.concatenate(pieces, axis=self.leaf.dim)


def _shard(name, value, ctx: MeshContext, partitioner: ZeroPartitioner,
           dtype) -> ShardedParameter:
    value = torch.as_tensor(value)
    dim = shard_dim(zero_partition_spec(
        tuple(value.shape), partitioner.axis_sizes,
        partitioner.persistence_threshold))
    leaf = ShardedLeaf(name, tuple(value.shape), dim, partitioner.zero_size,
                       0)
    cast = dtype if value.is_floating_point() else value.dtype
    shards = [leaf.cut(value, ctx.group_index(r, ZERO_AXES)).to(
        device=ctx.device_of(r), dtype=cast, copy=True)
        for r in ctx.local_ranks]
    return ShardedParameter(leaf, shards)


class Init:
    """Sharded-from-birth parameters (the JAX `Init`):

        with zero.Init(config=ds_config, mesh_ctx=ctx) as zinit:
            params = zinit.materialize(init_fn, generator)

    `init_fn(*args)` returns a dict of name -> tensor; each leaf is cut
    into the ranks' pieces as it is taken from the dict and the whole leaf
    is dropped, so that after `materialize` only the pieces are live."""

    def __init__(self, config=None, mesh_ctx: Optional[MeshContext] = None,
                 stage: int = 3, dtype=torch.float32,
                 persistence_threshold: int = 0):
        if config is not None:
            stage = config.zero_optimization_stage
            persistence_threshold = \
                config.zero_config.param_persistence_threshold
        self.stage = stage
        self.dtype = dtype
        self.mesh_ctx = mesh_ctx
        self.persistence_threshold = persistence_threshold
        self._partitioner = None

    def __enter__(self):
        self.mesh_ctx = self.mesh_ctx or get_mesh_context()
        self._partitioner = ZeroPartitioner(self.mesh_ctx, self.stage,
                                            self.persistence_threshold)
        return self

    def __exit__(self, *exc):
        return False

    def materialize(self, init_fn: Callable, *args
                    ) -> Dict[str, ShardedParameter]:
        tree = init_fn(*args)
        out = {}
        for name in list(tree):
            out[name] = _shard(name, tree.pop(name), self.mesh_ctx,
                               self._partitioner, self.dtype)
        n = sum(int(np.prod(p.shape)) for p in out.values())
        log_dist(f"zero.Init: materialized {n} params sharded at stage "
                 f"{self.stage}", ranks=[0])
        return out

    def shard_existing(self, params: Dict[str, Any]
                       ) -> Dict[str, ShardedParameter]:
        """Cut an already-whole dict of leaves into the ranks' pieces."""
        return {name: _shard(name, value, self.mesh_ctx, self._partitioner,
                             self.dtype) for name, value in params.items()}


class GatheredParameters:
    """Whole values of sharded parameters for host-side code (the JAX
    `GatheredParameters`):

        with GatheredParameters(params, modifier_rank=0) as full:
            full["w"][0, 0] = 1.0
        params = gp.updated        # the edits, cut into pieces again

    `params` is a dict of `ShardedParameter` (then `full` is a dict of
    writable numpy arrays, and with modifier_rank set `.updated` holds the
    edits re-sharded, also passed to `on_exit`), or parameters of a
    stage-3 engine's module (then they hold their whole fp32 values inside
    the context, and edits go back into the engine's pieces)."""

    def __init__(self, params: Any, modifier_rank: Optional[int] = None,
                 mesh_ctx: Optional[MeshContext] = None,
                 on_exit: Optional[Callable[[Any], None]] = None):
        if isinstance(params, torch.nn.Parameter):
            params = [params]
        self.params = params
        self.modifier_rank = modifier_rank
        self.mesh_ctx = mesh_ctx
        self.on_exit = on_exit
        self.updated = None
        self._full = None

    def _engine_params(self) -> bool:
        return not isinstance(self.params, dict)

    def __enter__(self):
        if self._engine_params():
            self.params = list(self.params)
            for p in self.params:
                p.data = p.ds_engine()._gather_parameter(p.ds_name).to(
                    p.device)
            return self.params
        self._full = {name: p.full() for name, p in self.params.items()}
        return self._full

    def __exit__(self, exc_type, exc, tb):
        if self._engine_params():
            for p in self.params:
                if exc_type is None and self.modifier_rank is not None:
                    p.ds_engine()._scatter_parameter(p.ds_name, p.data)
                p.data = torch.empty(0, device=p.device)
            return False
        if exc_type is not None:
            return False
        if self.modifier_rank is not None:
            ctx = self.mesh_ctx or get_mesh_context()
            self.updated = {}
            for name, p in self.params.items():
                full = torch.from_numpy(np.ascontiguousarray(
                    self._full[name]))
                self.updated[name] = ShardedParameter(p.leaf, [
                    p.leaf.cut(full, ctx.group_index(r, ZERO_AXES)).to(
                        device=s.device, dtype=s.dtype, copy=True)
                    for r, s in zip(ctx.local_ranks, p.shards)])
            if self.on_exit is not None:
                self.on_exit(self.updated)
        return False
