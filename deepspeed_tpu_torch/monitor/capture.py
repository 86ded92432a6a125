"""Anomaly-triggered deep profiling — bounded torch.profiler captures
(counterpart of deepspeed_tpu/monitor/capture.py, which drives
jax.profiler).

The reconciliation report can say a window was slow and WHY at lane
granularity, but chasing a schedule bug on the card needs the kernel
timeline — and by the time a human re-runs with the profiler armed, the
anomaly is usually gone (T3's point: fine-grained overlap must be
OBSERVED, arXiv:2401.16677).  This module closes that loop: when a
reconciliation flag (``step_time_above_band``, ``swap_below_ceiling_band``)
or a fleet health event for THIS host fires, the monitor arms a bounded
``torch.profiler`` capture for the next K steps, so the first bad window
ships with device-level evidence instead of a reproduction request.

The capture records host activity, and the CUDA kernels when the process
has a card (CUPTI), and is written as a Chrome trace,
``<output_path>/capture<n>_step<step>_<reason>.json``, which
chrome://tracing and https://ui.perfetto.dev open.

Guard rails, because an accidental always-on profiler is its own
regression:

  * off by default (``monitor.capture.enabled``);
  * bounded: exactly ``steps`` optimizer steps per capture, then an
    automatic stop and export (disarm is unconditional — a capture can
    never outlive its window);
  * rate-limited: at most ``max_captures`` per run with a
    ``cooldown_steps`` gap between them, so a persistently-breached band
    yields a few traces, not a full-run profile;
  * the profiler is injectable (``profiler=``: an object with
    ``start_trace(path)`` and ``stop_trace()``) — tests drive arm/disarm
    with a mock, and a host without a working profiler degrades to a
    warning and a degradation-registry record.

Starting and stopping the profiler is host work, and the stop exports
the trace (it waits for the device's activity records).  That cost lands
only on anomaly windows on the flagged host, which is exactly when a
perturbed step is an acceptable price for evidence — and why capture is
never armed in the hot loop itself, only at flush boundaries.
"""

import os
import time
from typing import Any, Dict, List, Optional

import torch

from ..utils.logging import logger
from .reconcile import FLAG_STEP_TIME_ABOVE_BAND, FLAG_SWAP_BELOW_CEILING

# reconciliation flags that arm a capture (names single-sourced from
# reconcile.py)
TRIGGER_FLAGS = (FLAG_STEP_TIME_ABOVE_BAND, FLAG_SWAP_BELOW_CEILING)


class TorchProfiler:
    """The default profiler: one ``torch.profiler.profile`` session per
    capture (CPU activity, plus CUDA when the process has a card),
    exported as a Chrome trace to the path given at start."""

    def __init__(self):
        self._prof = None
        self._path = None

    def start_trace(self, path: str) -> None:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        self._prof, self._path = prof, path

    def stop_trace(self) -> None:
        prof, self._prof = self._prof, None
        if torch.cuda.is_initialized():
            # the captured steps' kernels may still be queued: let them
            # finish, so that the trace holds every one of them
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(self._path)


class ProfileCapture:
    """Arm/observe/disarm state machine around the profiler."""

    def __init__(self, output_path: str, steps: int = 8,
                 max_captures: int = 2, cooldown_steps: int = 100,
                 profiler: Any = None):
        self.output_path = output_path
        self.steps = max(1, int(steps))
        self.max_captures = max(1, int(max_captures))
        self.cooldown_steps = max(0, int(cooldown_steps))
        self._profiler = profiler
        self.armed = False
        self._steps_captured = 0
        self._last_stop_step: Optional[int] = None
        self.captures: List[Dict[str, Any]] = []
        self._failed = False
        # failed starts and stops (each also a degradation-registry record)
        self.failures = 0

    # ------------------------------------------------------------------ #
    def _prof(self):
        if self._profiler is None:
            self._profiler = TorchProfiler()
        return self._profiler

    @property
    def exhausted(self) -> bool:
        return len(self.captures) >= self.max_captures or self._failed

    def _in_cooldown(self, step: int) -> bool:
        return (self._last_stop_step is not None
                and step - self._last_stop_step < self.cooldown_steps)

    # ------------------------------------------------------------------ #
    def arm(self, reason: str, step: int) -> bool:
        """Request a capture starting at the next step.  Returns True iff
        the profiler was actually armed (rate limits may refuse)."""
        if self.armed or self.exhausted or self._in_cooldown(step):
            return False
        path = os.path.join(
            self.output_path,
            f"capture{len(self.captures)}_step{step}_{_slug(reason)}.json")
        try:
            os.makedirs(self.output_path, exist_ok=True)
            self._prof().start_trace(path)
        except Exception as e:  # noqa: BLE001 — capture must not crash
            self._failed = True
            self.failures += 1
            logger.warning(
                f"monitor: profiler capture failed to arm ({e}) — "
                "deep-profiling disabled for the rest of the run")
            from ..runtime.resilience.degradation import record as degrade
            degrade("profiling", "torch-profiler", "off",
                    f"capture failed to arm: {e}")
            return False
        self.armed = True
        self._steps_captured = 0
        self.captures.append({"reason": reason, "armed_at_step": step,
                              "dir": self.output_path, "path": path,
                              "t_armed": time.time(), "steps": None})
        logger.warning(
            f"monitor: profiler capture ARMED at step {step} "
            f"({reason}) — tracing the next {self.steps} step(s) "
            f"to {path}")
        return True

    def observe_step_end(self, step: int) -> None:
        """Per-step tick while armed; disarms after K captured steps.
        A no-op (one predicate check) when not armed."""
        if not self.armed:
            return
        self._steps_captured += 1
        if self._steps_captured >= self.steps:
            self.disarm(step)

    def disarm(self, step: int) -> None:
        if not self.armed:
            return
        self.armed = False
        self._last_stop_step = step
        cap = self.captures[-1]
        try:
            self._prof().stop_trace()
        except Exception as e:  # noqa: BLE001
            self.failures += 1
            cap["error"] = str(e)
            logger.warning(f"monitor: profiler stop/export failed ({e})")
            from ..runtime.resilience.degradation import record as degrade
            degrade("profiling", "torch-profiler", "no-trace",
                    f"capture failed to stop or export: {e}")
        cap["steps"] = self._steps_captured
        cap["stopped_at_step"] = step
        logger.warning(
            f"monitor: profiler capture complete at step {step} "
            f"({cap['steps']} step(s)) -> {cap['path']}")

    def maybe_arm_for_flags(self, flags: List[str], step: int) -> bool:
        """Reconciliation hook: arm when any trigger flag is present."""
        hit = [f for f in (flags or []) if f in TRIGGER_FLAGS]
        if not hit:
            return False
        return self.arm("+".join(hit), step)

    def close(self, step: int = -1) -> None:
        """End-of-run safety: an armed capture is stopped so its trace is
        written rather than lost."""
        self.disarm(step)

    def counters(self) -> Dict[str, int]:
        return {"captures": len(self.captures),
                "capture_armed": int(self.armed)}


def _slug(reason: str, max_len: int = 48) -> str:
    safe = "".join(c if c.isalnum() or c in "-_+" else "-"
                   for c in str(reason))
    return safe[:max_len] or "anomaly"
