"""Parallel-group registry with the reference's groups API shape
(counterpart of deepspeed_tpu/parallel/groups.py).

Reference: deepspeed/utils/groups.py, initialize() with the scenarios D /
E+D / M / E+D+M and the get_* accessors.  As in the JAX package, a "group"
is a tuple of mesh axis names: the mesh's collectives take axis names, not
communicator handles, so the accessors return the axes to reduce over and
the sizes and ranks the registered `MeshContext` gives.
"""

from typing import Tuple

from . import mesh as mesh_mod
from .mesh import (DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS,
                   MeshContext)
from ..utils.logging import log_dist


def initialize(ep_size: int = 1, mpu=None, model_parallel_size: int = 1,
               pipe_parallel_size: int = 1, seq_parallel_size: int = 1,
               devices=None) -> MeshContext:
    """Create the global mesh of the reference's four scenarios (D, E+D,
    M, E+D+M); the data axis fills the devices.  An `mpu` exposing
    get_model_parallel_world_size() sets the model-parallel size."""
    if mpu is not None and hasattr(mpu, "get_model_parallel_world_size"):
        model_parallel_size = mpu.get_model_parallel_world_size()
    ctx = mesh_mod.initialize_mesh(pipe=pipe_parallel_size, data=-1,
                                   expert=ep_size, seq=seq_parallel_size,
                                   model=model_parallel_size, devices=devices)
    log_dist(f"initialized mesh {ctx.axis_sizes}", ranks=[0])
    return ctx


def is_initialized() -> bool:
    return mesh_mod.get_mesh_context(required=False) is not None


def _ctx() -> MeshContext:
    return mesh_mod.get_mesh_context()


# --- groups: the mesh axes a collective reduces over ---
def get_data_parallel_group() -> Tuple[str, ...]:
    """Dense parameters reduce over the data AND expert axes: the
    data-parallel group spans the whole data-parallel world."""
    return (DATA_AXIS, EXPERT_AXIS)


def get_expert_parallel_group() -> Tuple[str, ...]:
    return (EXPERT_AXIS,)


def get_expert_data_parallel_group() -> Tuple[str, ...]:
    """Expert parameters replicate over the data axis only."""
    return (DATA_AXIS,)


def get_model_parallel_group() -> Tuple[str, ...]:
    return (MODEL_AXIS,)


def get_pipe_parallel_group() -> Tuple[str, ...]:
    return (PIPE_AXIS,)


def get_sequence_parallel_group() -> Tuple[str, ...]:
    return (SEQ_AXIS,)


# --- world sizes ---
def get_data_parallel_world_size() -> int:
    return _ctx().data_parallel_world_size


def get_expert_parallel_world_size() -> int:
    return _ctx().expert_parallel_world_size


def get_expert_data_parallel_world_size() -> int:
    return _ctx().expert_data_parallel_world_size


def get_model_parallel_world_size() -> int:
    return _ctx().model_parallel_world_size


def get_pipe_parallel_world_size() -> int:
    return _ctx().pipe_parallel_world_size


def get_sequence_parallel_world_size() -> int:
    return _ctx().seq_parallel_world_size


def get_world_size() -> int:
    return _ctx().world_size


# --- ranks: the calling process's rank along an axis is that of the first
# rank it drives (the JAX package reads the coordinates of the process's
# first local device): rank 0 under one controller, the process's own rank
# under a torch.distributed world of one process a card. ---
def _axis_rank(axis: str) -> int:
    ctx = _ctx()
    return ctx.axis_index(ctx.local_ranks[0], axis)


def get_data_parallel_rank() -> int:
    # the dense data-parallel group spans data x expert, expert innermost
    return (_axis_rank(DATA_AXIS) * _ctx().expert_parallel_world_size
            + _axis_rank(EXPERT_AXIS))


def get_model_parallel_rank() -> int:
    return _axis_rank(MODEL_AXIS)


def get_expert_parallel_rank() -> int:
    return _axis_rank(EXPERT_AXIS)
