"""Degradation registry — one grep-able answer to "what is this run
actually running?" (counterpart of
deepspeed_tpu/runtime/resilience/degradation.py).

The JAX package carries half a dozen hand-rolled fallback ladders (AIO
backends, the fused collective-matmul, the tensorboard writer chain,
ZeRO-3 prefetch, fleet aggregation, the atomic checkpoint commit); a run
that silently landed on the slow tier was indistinguishable from the
real thing.

Every ladder reports here: a structured :class:`DegradationEvent`
(subsystem, from-tier, to-tier, reason) with a one-shot loud warning,
deduplicated by (subsystem, from, to) with a repeat count.  In the port
the engine's checkpoint save records atomic -> in_place under a process
group, as the JAX engine does, and the monitor records its own ladders
(the tensorboard writer chain, the profiler capture, measured-only
reconciliation).  The registry surfaces in two places: the monitor
stream (``degradation`` records, `drain_records`) and the engine's init
line (`summary`).

Process-global by design: a degradation describes the *process*, not
one engine object.
"""

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ...utils.logging import logger


@dataclass
class DegradationEvent:
    subsystem: str
    from_tier: str
    to_tier: str
    reason: str
    count: int = 1

    def as_dict(self) -> Dict[str, Any]:
        return {"subsystem": self.subsystem, "from_tier": self.from_tier,
                "to_tier": self.to_tier, "reason": self.reason,
                "count": self.count}


class DegradationRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._events: Dict[Tuple[str, str, str], DegradationEvent] = {}
        self._order: List[Tuple[str, str, str]] = []
        self._undrained: List[Dict[str, Any]] = []

    def record(self, subsystem: str, from_tier: str, to_tier: str,
               reason: str = "") -> DegradationEvent:
        """Report one ladder step-down.  First report of a given
        (subsystem, from, to) warns loudly and queues a monitor record;
        repeats only bump the count."""
        key = (subsystem, from_tier, to_tier)
        with self._lock:
            ev = self._events.get(key)
            if ev is not None:
                ev.count += 1
                return ev
            ev = DegradationEvent(subsystem, from_tier, to_tier,
                                  str(reason))
            self._events[key] = ev
            self._order.append(key)
            self._undrained.append(ev.as_dict())
        logger.warning(
            f"DEGRADED: {subsystem} fell back {from_tier} -> {to_tier}"
            + (f" — {reason}" if reason else ""))
        return ev

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [self._events[k].as_dict() for k in self._order]

    def summary(self) -> str:
        """Compact one-line form for the engine init log, e.g.
        ``checkpoint:atomic->in_place, tensorboard:torch->jsonl``."""
        with self._lock:
            return ", ".join(
                f"{k[0]}:{k[1]}->{k[2]}" for k in self._order)

    def drain_records(self) -> List[Dict[str, Any]]:
        """New degradation events since the last drain, monitor-ready."""
        from ...monitor import record as R
        with self._lock:
            out, self._undrained = self._undrained, []
        return [{R.F_KIND: R.KIND_DEGRADATION, **e} for e in out]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._order.clear()
            self._undrained.clear()


_REGISTRY = DegradationRegistry()


def get_registry() -> DegradationRegistry:
    return _REGISTRY


def record(subsystem: str, from_tier: str, to_tier: str,
           reason: str = "") -> Optional[DegradationEvent]:
    """Module-level convenience for ladder sites; never raises — a
    reporting failure must not take down the fallback it reports."""
    try:
        return _REGISTRY.record(subsystem, from_tier, to_tier, reason)
    except Exception as e:  # noqa: BLE001 — pragma: no cover
        logger.warning(f"degradation registry record failed: {e}")
        return None
