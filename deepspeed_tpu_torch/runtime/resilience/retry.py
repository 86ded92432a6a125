"""Bounded exponential-backoff retry for transient I/O faults (counterpart
of deepspeed_tpu/runtime/resilience/retry.py).

ZeRO-Infinity-scale runs stream state across HBM, host RAM and NVMe for
days; transient EIO/ENOSPC on the swap files or the checkpoint staging
dir are routine weather, not program bugs.  The policy here retries
exactly that class — OS-level errors whose errno marks them plausibly
transient — with a bounded exponential backoff and *seeded* jitter, so
the retry trace of a run is reproducible.

Two things are deliberately never retried:

* **Deterministic corruption** (:class:`CorruptionError`): a CRC
  mismatch or a torn manifest is the same bytes on every read; retrying
  only delays the loud failure and can paper over real data loss.
* **Injected crashes** (the JAX package's ``chaos.InjectedCrash`` is a
  ``RuntimeError``, not an ``OSError``; the chaos plane is not ported,
  ROADMAP.md A.13): crash-consistency tests must observe the crash, not
  a retry loop absorbing it.

On budget exhaustion the *original* exception is re-raised (with an
``retry_attempts`` attribute stamped on) so callers and tests see the
real fault, not a wrapper.  Counters round-trip through checkpoint
client state (``retry_counters``) like the sentinel counters, so a
resumed run keeps its retry history.
"""

import errno
import random
import threading
import time
from typing import Any, Callable, Dict, Optional

from ...utils.logging import logger


class CorruptionError(RuntimeError):
    """Deterministic data corruption (CRC mismatch, torn manifest).

    Never retried: the corrupt bytes are stable across reads, so a retry
    budget only converts a loud failure into a slow loud failure."""


#: errnos treated as plausibly transient.  EIO (flaky device path),
#: ENOSPC (space can be freed by a concurrent GC/eviction), and the
#: interrupted/again/timeout family.  ENOENT etc. are NOT here: a
#: missing file does not come back by waiting.
TRANSIENT_ERRNOS = frozenset({
    errno.EIO, errno.ENOSPC, errno.EAGAIN, errno.EINTR, errno.ETIMEDOUT,
    errno.EBUSY,
})


def is_transient(exc: BaseException) -> bool:
    """True when `exc` is worth retrying: an OSError that is not a
    corruption marker and whose errno (if set) is in the transient set.
    A bare ``OSError("msg")`` with no errno counts as transient — that
    is what ad-hoc wrappers raise for "the I/O flaked"."""
    if isinstance(exc, CorruptionError):
        return False
    if not isinstance(exc, OSError):
        return False
    return exc.errno is None or exc.errno in TRANSIENT_ERRNOS


class RetryPolicy:
    """Bounded exponential backoff with seeded jitter.

    ``run(fn, what=...)`` calls `fn` until it succeeds or the retry
    budget is spent.  Backoff for attempt *k* (1-based) is
    ``min(backoff_s * 2**(k-1), max_backoff_s) * (1 + jitter * u)`` with
    ``u`` drawn from a ``random.Random(seed)`` private to this policy —
    same seed, same backoff sequence, pinned by test.
    """

    def __init__(self, retries: int = 3, backoff_s: float = 0.5,
                 max_backoff_s: float = 30.0, jitter: float = 0.25,
                 seed: int = 0,
                 sleep: Optional[Callable[[float], None]] = None):
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.jitter = float(jitter)
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._sleep = sleep if sleep is not None else time.sleep
        self._lock = threading.Lock()
        # flat counters + per-surface retry tally; both round-trip
        # through checkpoint client state (snapshot()/restore())
        self.counters: Dict[str, int] = {
            "attempts": 0, "retries": 0, "recovered": 0, "gave_up": 0,
        }
        self.by_surface: Dict[str, int] = {}

    # ---- classification (overridable) -------------------------------- #
    def classify(self, exc: BaseException) -> bool:
        return is_transient(exc)

    def backoff(self, attempt: int) -> float:
        """Delay before retry number `attempt` (1-based), jittered."""
        base = min(self.backoff_s * (2.0 ** (attempt - 1)),
                   self.max_backoff_s)
        with self._lock:
            u = self._rng.random()
        return base * (1.0 + self.jitter * u)

    # ---- the wrapper -------------------------------------------------- #
    def run(self, fn: Callable[[], Any], what: str = "io") -> Any:
        attempt = 0
        while True:
            with self._lock:
                self.counters["attempts"] += 1
            try:
                out = fn()
            except Exception as e:  # noqa: BLE001 — classified below
                if not self.classify(e):
                    raise
                attempt += 1
                if attempt > self.retries:
                    with self._lock:
                        self.counters["gave_up"] += 1
                    # stamp the attempt count but re-raise the ORIGINAL
                    # error: callers match on the real fault type/errno
                    try:
                        e.retry_attempts = attempt
                    except Exception:  # noqa: BLE001 — slots/immutable
                        pass
                    raise
                with self._lock:
                    self.counters["retries"] += 1
                    self.by_surface[what] = self.by_surface.get(what, 0) + 1
                delay = self.backoff(attempt)
                logger.warning(
                    f"{what}: transient I/O error ({e}) — retry "
                    f"{attempt}/{self.retries} in {delay:.2f}s")
                self._sleep(delay)
                continue
            if attempt:
                with self._lock:
                    self.counters["recovered"] += 1
            return out

    # ---- checkpoint round-trip (mirrors the sentinel counters) -------- #
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {**self.counters, "by_surface": dict(self.by_surface)}

    def restore(self, state: Optional[Dict[str, Any]]) -> None:
        if not state:
            return
        with self._lock:
            for k in self.counters:
                if isinstance(state.get(k), int):
                    self.counters[k] = state[k]
            for k, v in (state.get("by_surface") or {}).items():
                if isinstance(v, int):
                    self.by_surface[k] = v
