"""Verified checkpoint load with fallback, and retention/GC (counterpart of
deepspeed_tpu/runtime/resilience/recovery.py).

``resolve_intact_tag`` is the read side of the atomic commit protocol
(atomic.py): given a requested tag (or None → ``latest``), validate its
manifest and — if the tag is corrupt or incomplete — fall back to the
newest intact tag under a bounded scan, logging loudly so silent
garbage-loading can never happen.

``gc_checkpoints`` implements the retention policy: keep the newest
``keep_last_n`` tags, keep forever any tag whose trailing step number is
a multiple of ``keep_every``, and never delete the tag ``latest`` points
to (or a tag that cannot be parsed while keep_every protection is on —
deleting what we cannot reason about is worse than keeping it).
"""

import os
import re
import shutil
from typing import List, Optional, Tuple

from ...utils.logging import logger
from .atomic import (fsync_dir, has_manifest, is_working_dir, list_old_dirs,
                     verify_manifest)

_STEP_RE = re.compile(r"(\d+)$")


def tag_step(tag: str) -> Optional[int]:
    """Trailing integer of a tag name (global_step120 → 120), or None."""
    m = _STEP_RE.search(str(tag))
    return int(m.group(1)) if m else None


def list_tags(load_dir: str) -> List[str]:
    """Tag dirs under `load_dir`, newest first (step number, then mtime);
    in-flight ``*.tmp.*`` dirs are not tags."""
    if not os.path.isdir(load_dir):
        return []
    tags = []
    for name in os.listdir(load_dir):
        path = os.path.join(load_dir, name)
        if os.path.isdir(path) and not is_working_dir(name):
            step = tag_step(name)
            mtime = os.path.getmtime(path)
            tags.append((step if step is not None else -1, mtime, name))
    tags.sort(reverse=True)
    return [name for _, _, name in tags]


def rescue_renamed_aside(load_dir: str, tag: str) -> bool:
    """Heal a crash inside commit_tag_dir's re-save window: the final tag
    dir is gone but an intact ``<tag>.old.<nonce>`` copy exists — rename
    it back so the tag is loadable again.  Returns True if restored."""
    final_dir = os.path.join(load_dir, str(tag))
    if os.path.isdir(final_dir):
        return False
    for old_dir in sorted(list_old_dirs(load_dir, str(tag))):
        if has_manifest(old_dir) and verify_manifest(old_dir):
            continue  # aside copy itself damaged; try another
        logger.error(
            f"checkpoint tag {tag!r} was mid-re-save when interrupted — "
            f"restoring the intact previous copy from "
            f"{os.path.basename(old_dir)}")
        os.rename(old_dir, final_dir)
        fsync_dir(load_dir)
        return True
    return False


def tag_problems(load_dir: str, tag: str,
                 require_manifest: bool = False) -> List[str]:
    """Problems with one tag ([] = usable).  Tags saved without the atomic
    protocol have no manifest; unless `require_manifest`, they pass an
    existence check instead of CRC verification."""
    ckpt_dir = os.path.join(load_dir, str(tag))
    if not os.path.isdir(ckpt_dir) and not rescue_renamed_aside(load_dir,
                                                                tag):
        return [f"tag dir {ckpt_dir} does not exist"]
    if has_manifest(ckpt_dir):
        return verify_manifest(ckpt_dir)
    if require_manifest:
        return [f"tag {tag} has no manifest"]
    if not os.listdir(ckpt_dir):
        return [f"tag dir {ckpt_dir} is empty"]
    return []


def resolve_intact_tag(load_dir: str, tag: Optional[str],
                       latest_tag: Optional[str] = None,
                       max_fallback_tags: int = 8
                       ) -> Tuple[str, List[str]]:
    """Resolve (tag or latest) to an intact tag, falling back if corrupt.

    Returns (resolved_tag, problems_with_requested_tag).  `problems` is
    non-empty iff a fallback happened.  Raises FileNotFoundError when no
    intact tag exists within the scan bound."""
    requested = tag if tag is not None else latest_tag
    if requested is not None:
        problems = tag_problems(load_dir, requested)
        if not problems:
            return str(requested), []
        logger.error(
            f"checkpoint tag {requested!r} under {load_dir} failed "
            f"verification: {problems} — scanning for the newest intact "
            f"tag instead")
    else:
        problems = [f"no 'latest' file at {load_dir}"]
        logger.error(problems[0] + " — scanning for the newest intact tag")

    scanned = 0
    for candidate in list_tags(load_dir):
        if candidate == str(requested):
            continue
        if scanned >= max_fallback_tags:
            break
        scanned += 1
        cand_problems = tag_problems(load_dir, candidate)
        if not cand_problems:
            logger.error(
                f"falling back to intact checkpoint tag {candidate!r} "
                f"(requested: {requested!r})")
            return candidate, problems
        logger.warning(
            f"fallback candidate {candidate!r} also bad: {cand_problems}")
    raise FileNotFoundError(
        f"no intact checkpoint tag under {load_dir} "
        f"(requested {requested!r}: {problems}; scanned "
        f"{scanned} fallback candidates, available tags: "
        f"{list_tags(load_dir)})")


def gc_checkpoints(save_dir: str, keep_last_n: int, keep_every: int = 0,
                   latest_tag: Optional[str] = None) -> List[str]:
    """Delete old tag dirs per the retention policy; returns deleted tags."""
    if keep_last_n <= 0:
        return []
    tags = list_tags(save_dir)
    deleted = []
    for i, tag in enumerate(tags):
        if i < keep_last_n:
            continue
        if latest_tag is not None and tag == str(latest_tag):
            continue
        step = tag_step(tag)
        if keep_every > 0 and (step is None or step % keep_every == 0):
            continue
        shutil.rmtree(os.path.join(save_dir, tag), ignore_errors=True)
        deleted.append(tag)
    if deleted:
        logger.info(f"checkpoint GC under {save_dir}: removed {deleted} "
                    f"(keep_last_n={keep_last_n}, keep_every={keep_every})")
    return deleted
