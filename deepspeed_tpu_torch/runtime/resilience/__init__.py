"""Checkpoint resilience (counterpart of deepspeed_tpu/runtime/resilience/):
the atomic commit protocol (atomic.py), tag discovery, verified tag
resolution and retention (recovery.py), and the partition-topology
contract that lets a checkpoint load at another data-parallel world
(reshard.py).  The engine's `resilience` config block, preemption, the
sentinel, chaos injection and the lockstep re-verify are not ported yet
(ROADMAP.md A.6, A.13, A.14)."""

from .atomic import (MANIFEST_FILE, cleanup_tmp_dirs, commit_tag_dir,
                     file_crc32, has_manifest, is_tmp_dir, is_working_dir,
                     retry_io, tmp_tag_dir, verify_manifest,
                     write_latest_atomic, write_manifest)
from .recovery import (gc_checkpoints, list_tags, rescue_renamed_aside,
                       resolve_intact_tag, tag_problems, tag_step)
from .reshard import (SIGNATURE_KEY, TOPOLOGY_FORMAT_VERSION, TOPOLOGY_KEY,
                      ReshardError, check_reshard, read_saved_client_state)

__all__ = [
    "MANIFEST_FILE", "ReshardError", "SIGNATURE_KEY",
    "TOPOLOGY_FORMAT_VERSION", "TOPOLOGY_KEY", "check_reshard",
    "cleanup_tmp_dirs", "commit_tag_dir", "file_crc32", "gc_checkpoints",
    "has_manifest", "is_tmp_dir", "is_working_dir", "list_tags",
    "read_saved_client_state", "rescue_renamed_aside", "resolve_intact_tag",
    "retry_io", "tag_problems", "tag_step", "tmp_tag_dir", "verify_manifest",
    "write_latest_atomic", "write_manifest",
]
