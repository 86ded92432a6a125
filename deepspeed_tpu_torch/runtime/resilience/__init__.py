"""Resilience (counterpart of deepspeed_tpu/runtime/resilience/): the
atomic commit protocol (atomic.py), tag discovery, verified tag
resolution and retention (recovery.py), the partition-topology contract
that lets a checkpoint load at another data-parallel world (reshard.py),
the bounded retry of transient I/O faults (retry.py), the degradation
registry (degradation.py), the training-health sentinel (sentinel.py)
and the preemption handler (preemption.py).  The engine wires them
through the config's `resilience` block.  The chaos plane (A.13), the
fleet supervisor (A.13) and the lockstep re-verify (A.14) are not ported
yet (ROADMAP.md)."""

from .atomic import (MANIFEST_FILE, cleanup_tmp_dirs, commit_tag_dir,
                     file_crc32, has_manifest, is_tmp_dir, is_working_dir,
                     retry_io, tmp_tag_dir, verify_manifest,
                     write_latest_atomic, write_manifest)
from .degradation import (DegradationEvent, DegradationRegistry,
                          get_registry, record)
from .preemption import PreemptionHandler, TrainingInterrupted
from .recovery import (gc_checkpoints, list_tags, rescue_renamed_aside,
                       resolve_intact_tag, tag_problems, tag_step)
from .reshard import (SIGNATURE_KEY, TOPOLOGY_FORMAT_VERSION, TOPOLOGY_KEY,
                      ReshardError, check_reshard, read_saved_client_state)
from .retry import CorruptionError, RetryPolicy, is_transient
from .sentinel import SentinelAbort, TrainingSentinel

__all__ = [
    "CorruptionError", "DegradationEvent", "DegradationRegistry",
    "MANIFEST_FILE", "PreemptionHandler", "ReshardError", "RetryPolicy",
    "SIGNATURE_KEY", "SentinelAbort", "TOPOLOGY_FORMAT_VERSION",
    "TOPOLOGY_KEY", "TrainingInterrupted", "TrainingSentinel",
    "check_reshard", "cleanup_tmp_dirs", "commit_tag_dir", "file_crc32",
    "gc_checkpoints", "get_registry", "has_manifest", "is_tmp_dir",
    "is_transient", "is_working_dir", "list_tags", "read_saved_client_state",
    "record", "rescue_renamed_aside", "resolve_intact_tag", "retry_io",
    "tag_problems", "tag_step", "tmp_tag_dir", "verify_manifest",
    "write_latest_atomic", "write_manifest",
]
