"""Atomic checkpoint commit protocol (counterpart of
deepspeed_tpu/runtime/resilience/atomic.py).

A process can die between any two system calls of a checkpoint save.  The
commit protocol makes every save all-or-nothing:

  1. all files are written into ``<save_dir>/<tag>.tmp.<nonce>/``,
  2. each file is fsync'd and recorded in ``manifest.json`` with its size
     and CRC32,
  3. the tmp dir is renamed into place (``os.rename``, atomic on POSIX
     within one filesystem),
  4. ``latest`` is updated LAST, via tmp file + atomic rename.

A reader therefore only ever observes (a) the old tag, (b) the new tag
without ``latest`` (resumable via bounded scan), or (c) the fully
committed new tag.  Partially written state is confined to ``*.tmp.*``
dirs, which are ignored by tag discovery and garbage-collected on the
next save.  The JAX module's chaos hooks (a torn manifest, a crash
between staging and rename) come with chaos.py (ROADMAP.md A.13).
"""

import json
import os
import shutil
import time
import uuid
import zlib
from typing import Callable, Dict, List, Optional

from ...utils.logging import logger

MANIFEST_FILE = "manifest.json"
TMP_MARKER = ".tmp."
OLD_MARKER = ".old."  # rename-aside name during a same-tag re-save


def tmp_tag_dir(save_dir: str, tag: str) -> str:
    """A fresh ``<save_dir>/<tag>.tmp.<nonce>`` working dir for one save."""
    path = os.path.join(save_dir, f"{tag}{TMP_MARKER}{uuid.uuid4().hex[:8]}")
    os.makedirs(path, exist_ok=True)
    return path


def is_tmp_dir(name: str) -> bool:
    return TMP_MARKER in os.path.basename(name)


def is_working_dir(name: str) -> bool:
    """In-flight (.tmp.) or renamed-aside (.old.) — not a committed tag."""
    base = os.path.basename(name)
    return TMP_MARKER in base or OLD_MARKER in base


def fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    """Durably record directory entries (renames/creates) themselves."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # some filesystems refuse O_RDONLY on dirs; best-effort
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def file_crc32(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return crc
            crc = zlib.crc32(block, crc)


def write_manifest(ckpt_dir: str) -> str:
    """Record every file in `ckpt_dir` (size + CRC32) into manifest.json.

    Written last inside the tmp dir, so a manifest's presence implies the
    listed files were completely written before it."""
    entries: Dict[str, Dict] = {}
    for name in sorted(os.listdir(ckpt_dir)):
        path = os.path.join(ckpt_dir, name)
        if name == MANIFEST_FILE or not os.path.isfile(path):
            continue
        fsync_file(path)
        entries[name] = {"size": os.path.getsize(path),
                         "crc32": file_crc32(path)}
    manifest_path = os.path.join(ckpt_dir, MANIFEST_FILE)
    with open(manifest_path, "w") as f:
        json.dump({"version": 1, "files": entries}, f, indent=0)
        f.flush()
        os.fsync(f.fileno())
    return manifest_path


def verify_manifest(ckpt_dir: str, check_crc: bool = True) -> List[str]:
    """Return a list of problems ([] = intact).  A tag without a manifest
    (pre-resilience or resilience-off save) is reported as unverifiable —
    callers decide whether that is acceptable."""
    manifest_path = os.path.join(ckpt_dir, MANIFEST_FILE)
    if not os.path.isfile(manifest_path):
        return [f"no {MANIFEST_FILE} in {ckpt_dir}"]
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return [f"unreadable {MANIFEST_FILE}: {e}"]
    problems = []
    for name, meta in manifest.get("files", {}).items():
        path = os.path.join(ckpt_dir, name)
        if not os.path.isfile(path):
            problems.append(f"missing file {name}")
            continue
        size = os.path.getsize(path)
        if size != meta.get("size"):
            problems.append(
                f"size mismatch {name}: {size} != {meta.get('size')}")
            continue
        if check_crc and file_crc32(path) != meta.get("crc32"):
            problems.append(f"CRC32 mismatch {name}")
    return problems


def has_manifest(ckpt_dir: str) -> bool:
    return os.path.isfile(os.path.join(ckpt_dir, MANIFEST_FILE))


def list_old_dirs(save_dir: str, tag: str):
    """Rename-aside copies of one tag (``<tag>.old.<nonce>``), any vintage."""
    prefix = f"{tag}{OLD_MARKER}"
    if not os.path.isdir(save_dir):
        return []
    return [os.path.join(save_dir, n) for n in os.listdir(save_dir)
            if n.startswith(prefix)]


def commit_tag_dir(save_dir: str, tag: str, tmp_dir: str) -> str:
    """Atomically promote `tmp_dir` to ``<save_dir>/<tag>``.

    If the final tag dir already exists (re-save under the same tag) it is
    renamed aside to ``<tag>.old.<nonce>`` first — the destination is
    never left half-replaced — and deleted only after the new dir is in
    place.  The ``.old.`` marker is distinct from ``.tmp.`` on purpose: a
    crash in the window between the two renames leaves the previous
    checkpoint intact under the ``.old.`` name, which `cleanup_tmp_dirs`
    never touches and `recovery.rescue_renamed_aside` can restore."""
    final_dir = os.path.join(save_dir, str(tag))
    write_manifest(tmp_dir)
    fsync_dir(tmp_dir)
    # everything is staged and durable under the .tmp. name and nothing
    # is promoted yet: a crash here leaves only the staging dir
    # (cleanup_tmp_dirs sweeps it; `latest` still names the previous tag)
    old_dir = None
    if os.path.isdir(final_dir):
        old_dir = f"{final_dir}{OLD_MARKER}{uuid.uuid4().hex[:8]}"
        os.rename(final_dir, old_dir)
    os.rename(tmp_dir, final_dir)
    fsync_dir(save_dir)
    # the committed dir supersedes every aside copy of this tag,
    # including orphans from previously crashed re-saves
    for stale in list_old_dirs(save_dir, str(tag)):
        shutil.rmtree(stale, ignore_errors=True)
    return final_dir


def write_latest_atomic(save_dir: str, tag: str,
                        latest_file: str = "latest") -> None:
    """tmp-file + os.replace so `latest` is never observed half-written."""
    latest_path = os.path.join(save_dir, latest_file)
    tmp_path = f"{latest_path}{TMP_MARKER}{uuid.uuid4().hex[:8]}"
    with open(tmp_path, "w") as f:
        f.write(str(tag))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp_path, latest_path)
    fsync_dir(save_dir)


def cleanup_tmp_dirs(save_dir: str) -> int:
    """Remove orphaned ``*.tmp.*`` dirs — and stray ``latest.tmp.*``
    files from a crash inside write_latest_atomic — left by dead saves."""
    removed = 0
    if not os.path.isdir(save_dir):
        return removed
    for name in os.listdir(save_dir):
        path = os.path.join(save_dir, name)
        if not is_tmp_dir(name):
            continue
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
            removed += 1
        elif os.path.isfile(path):
            try:
                os.remove(path)
                removed += 1
            except OSError:
                pass
    return removed


def retry_io(fn: Callable, retries: int = 3, backoff_seconds: float = 0.5,
             what: str = "checkpoint IO",
             retry_on: tuple = (OSError,),
             sleep: Optional[Callable[[float], None]] = None):
    """Run `fn()` with bounded retry + exponential backoff on transient
    filesystem errors.  Non-OSError exceptions propagate immediately."""
    sleep = sleep or time.sleep
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            attempt += 1
            if attempt > retries:
                raise
            delay = backoff_seconds * (2 ** (attempt - 1))
            logger.warning(
                f"{what} failed (attempt {attempt}/{retries}): {e} — "
                f"retrying in {delay:.1f}s")
            sleep(delay)
