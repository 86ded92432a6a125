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
(runtime/optimizers.py).  Stage 3 (parameter sharding) is not ported.
"""

import math
from typing import Any, Dict, List, Tuple

from ...parallel.mesh import MESH_AXES, ZERO_AXES, MeshContext


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
    """

    def __init__(self, mesh_ctx: MeshContext, stage: int,
                 persistence_threshold: int = 0):
        if stage >= 3:
            raise NotImplementedError(
                f"zero_optimization.stage {stage} (ZeRO-3: parameter "
                "sharding) is not ported yet (ROADMAP.md A.5)")
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
        return {"params": param_b, "grads": grad_b, "optimizer": opt_b,
                "total": param_b + grad_b + opt_b}
