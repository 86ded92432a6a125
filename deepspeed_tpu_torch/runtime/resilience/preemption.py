"""Preemption handler: graceful stop at the next step boundary (counterpart
of deepspeed_tpu/runtime/resilience/preemption.py).

Cloud GPU jobs are routinely preempted with a SIGTERM and a short grace
window.  The handler turns that into a deterministic protocol:

  signal arrives → flag is set (the handler body does nothing unsafe) →
  the engine notices at its next step boundary → takes an emergency
  checkpoint under a distinct tag → ``TrainingInterrupted`` is raised
  (and, for ``reraise=True``, the original disposition is restored and
  the signal re-delivered so process supervisors see the real exit).

With ``grace_s`` set (resilience.preemption.grace_s), the handler also
arms a deadline when the signal lands: if the training loop does NOT
reach a step boundary within the grace window (a wedged collective, a
pathologically slow step), the ``on_deadline`` callback fires from a
daemon timer thread and force-saves the LAST COMPLETED step's state —
losing one in-flight step instead of the whole tag.  The engine cancels
the deadline the moment a boundary is reached (``boundary_reached``),
so a healthy loop never sees it.
"""

import os
import signal
import threading
from typing import Callable, Iterable, Optional

from ...utils.logging import logger


class TrainingInterrupted(BaseException):
    """Raised at the step boundary after the emergency checkpoint.

    Derives from BaseException (like KeyboardInterrupt) so generic
    ``except Exception`` retry loops in user training code don't swallow
    a preemption."""

    def __init__(self, signum: int, emergency_tag: Optional[str] = None):
        self.signum = signum
        self.emergency_tag = emergency_tag
        name = signal.Signals(signum).name if signum in set(
            signal.Signals) else str(signum)
        super().__init__(
            f"training interrupted by {name}"
            + (f" — emergency checkpoint tag {emergency_tag!r}"
               if emergency_tag else ""))


def _resolve_signals(names: Iterable) -> list:
    out = []
    for n in names:
        if isinstance(n, str):
            out.append(getattr(signal, n))
        else:
            out.append(signal.Signals(n))
    return out


class PreemptionHandler:
    """Installs signal handlers that only set a flag; the engine polls
    `triggered` at step boundaries (the only safe place to checkpoint —
    mid-step state is half-updated in place on the device)."""

    def __init__(self, signals=("SIGTERM", "SIGINT"), reraise: bool = True,
                 grace_s: float = 0.0,
                 on_deadline: Optional[Callable[[], Optional[str]]] = None):
        self.signals = _resolve_signals(signals)
        self.reraise = reraise
        self.triggered = False
        self.signum: Optional[int] = None
        self._prev = {}
        self._installed = False
        # grace deadline: force-save the last completed step if no step
        # boundary is reached within grace_s of the signal
        self.grace_s = float(grace_s or 0.0)
        self.on_deadline = on_deadline
        self.deadline_fired = False
        self.forced_tag: Optional[str] = None
        self._deadline_timer: Optional[threading.Timer] = None

    def install(self) -> "PreemptionHandler":
        for sig in self.signals:
            self._prev[sig] = signal.signal(sig, self._on_signal)
        self._installed = True
        return self

    def uninstall(self) -> None:
        self.boundary_reached()  # never leave a grace timer behind
        if not self._installed:
            return
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):  # non-main thread / teardown
                pass
        self._prev.clear()
        self._installed = False

    def _on_signal(self, signum, frame) -> None:
        # async-signal context: just record; everything else happens at
        # the step boundary.  threading.Timer start is signal-safe
        # enough for CPython (it only creates a thread object) and the
        # grace window is useless if armed any later.
        self.triggered = True
        self.signum = signum
        self._arm_deadline()

    def request_stop(self, signum: int = signal.SIGTERM) -> None:
        """Programmatic trigger (tests, cluster agents with their own
        preemption notice channel)."""
        self.triggered = True
        self.signum = signum
        self._arm_deadline()

    # -- grace deadline ------------------------------------------------ #
    def _arm_deadline(self) -> None:
        if (self.grace_s <= 0 or self.on_deadline is None
                or self._deadline_timer is not None or self.deadline_fired):
            return
        t = threading.Timer(self.grace_s, self._deadline_expired)
        t.daemon = True
        t.name = "ds-preemption-grace"
        t.start()
        self._deadline_timer = t

    def _deadline_expired(self) -> None:
        self.deadline_fired = True
        logger.error(
            f"preemption: no step boundary within grace_s={self.grace_s}s "
            "of the signal — force-saving the last completed step")
        try:
            self.forced_tag = self.on_deadline()
        except Exception as e:  # noqa: BLE001 — a failed forced save must
            # not kill the timer thread silently mid-teardown
            logger.error(f"preemption: forced emergency save failed: {e}")

    def boundary_reached(self) -> None:
        """The engine reached a step boundary: the normal emergency path
        takes over, so a pending grace deadline is disarmed.  If the
        deadline ALREADY fired, ``forced_tag`` carries its result — the
        join below waits out a callback still running on the timer
        thread, so the boundary path never reads a stale ``forced_tag``
        and double-saves the same step (a cancelled-before-firing timer
        joins immediately)."""
        t = self._deadline_timer
        if t is not None:
            self._deadline_timer = None
            t.cancel()
            t.join()

    def finalize(self, emergency_tag: Optional[str] = None) -> None:
        """Restore handlers and raise; with reraise, re-deliver the signal
        under its original disposition first (a SIGTERM default kills the
        process, which is the honest exit for supervisors)."""
        signum = self.signum if self.signum is not None else signal.SIGTERM
        logger.error(
            f"preemption: stopping at step boundary (signal {signum})"
            + (f", emergency checkpoint {emergency_tag!r} saved"
               if emergency_tag else ""))
        self.uninstall()
        if self.reraise:
            os.kill(os.getpid(), signum)
            # SIGINT's default disposition raises KeyboardInterrupt at the
            # next bytecode; for a caught/ignored disposition we still fall
            # through to the explicit raise below.
        raise TrainingInterrupted(signum, emergency_tag)
