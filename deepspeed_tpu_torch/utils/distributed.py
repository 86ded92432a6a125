"""Multi-process bootstrap: one process per GPU (counterpart of
deepspeed_tpu/utils/distributed.py).

Discovery keeps the JAX module's order: (1) dslaunch's DS_* env, (2)
torch-style MASTER_ADDR / RANK / WORLD_SIZE env (torchrun sets these),
(3) OMPI_COMM_WORLD_* (mpirun), then the `rank` / `world_size` overrides.
Where the JAX module calls `jax.distributed.initialize`, this one calls
`torch.distributed.init_process_group` and binds the process to its card.
With no coordinator, or a world of one process, it does nothing, as the
JAX module does.

The backend is NCCL unless the caller names another (gloo runs the CPU
tests); NCCL without a visible card raises, never falling back to gloo or
to the CPU.
"""

import os
from typing import Optional

import torch

from .logging import logger

_INITIALIZED = False


def mpi_discovery() -> Optional[dict]:
    """OpenMPI env discovery (the JAX module's, reference:
    distributed.py:54)."""
    if "OMPI_COMM_WORLD_SIZE" not in os.environ:
        return None
    return {
        "num_processes": int(os.environ["OMPI_COMM_WORLD_SIZE"]),
        "process_id": int(os.environ["OMPI_COMM_WORLD_RANK"]),
        "coordinator_address": os.environ.get("MASTER_ADDR", "") and
        f"{os.environ['MASTER_ADDR']}:"
        f"{os.environ.get('MASTER_PORT', 29500)}",
    }


def local_device_index(pid: int) -> int:
    """This process's card: LOCAL_RANK (torchrun), else
    OMPI_COMM_WORLD_LOCAL_RANK (mpirun), else the process id modulo the
    visible cards."""
    for key in ("LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK"):
        if key in os.environ:
            return int(os.environ[key])
    return pid % torch.cuda.device_count()


def init_distributed(dist_backend: str = "nccl", auto_mpi_discovery=True,
                     init_method: Optional[str] = None, rank: int = -1,
                     world_size: int = -1) -> None:
    """Join the process group of a launcher / MPI / torch-style env: a
    no-op when one is already up, when there is no coordinator, or when
    the world is one process."""
    import torch.distributed as dist

    global _INITIALIZED
    if _INITIALIZED or (dist.is_available() and dist.is_initialized()):
        _INITIALIZED = True
        return
    coordinator = num = pid = None
    if "DS_COORDINATOR" in os.environ:  # dslaunch
        coordinator = os.environ["DS_COORDINATOR"]
        num = int(os.environ["DS_NUM_PROCESSES"])
        pid = int(os.environ["DS_PROCESS_ID"])
    elif "MASTER_ADDR" in os.environ and "RANK" in os.environ:
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', 29500)}")
        num = int(os.environ.get("WORLD_SIZE", world_size))
        pid = int(os.environ["RANK"])
    elif auto_mpi_discovery:
        found = mpi_discovery()
        if found and found["coordinator_address"]:
            coordinator = found["coordinator_address"]
            num, pid = found["num_processes"], found["process_id"]
    if rank >= 0:
        pid = rank
    if world_size > 0:
        num = world_size

    if coordinator is None or num is None or num <= 1:
        logger.info("init_distributed: single-process (no coordinator env)")
        _INITIALIZED = True
        return
    if dist_backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_distributed: the nccl backend needs a CUDA device and "
                "none is visible; the port does not fall back to gloo or to "
                "the CPU (pass dist_backend='gloo' explicitly for CPU "
                "processes)")
        torch.cuda.set_device(local_device_index(pid))
    logger.info(f"init_distributed: coordinator={coordinator} "
                f"process {pid}/{num} backend={dist_backend}")
    dist.init_process_group(dist_backend,
                            init_method=init_method or f"tcp://{coordinator}",
                            rank=pid, world_size=num)
    _INITIALIZED = True
