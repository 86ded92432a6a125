"""Chrome/Perfetto trace-event exporter (counterpart of
deepspeed_tpu/monitor/trace.py: the same lanes, span form, step bound
and metadata).

Turns the monitor's host-side timeline — step phases (the modular
path's grad / accumulate / apply dispatch windows, the fused path's one
whole-window replay), swap-tier I/O lanes (empty until the offload tier,
ROADMAP.md A.7), and flush boundaries — into trace-event JSON that
chrome://tracing and https://ui.perfetto.dev open directly.

Semantics caveat, stated once and embedded in the trace metadata: spans
are measured on the HOST with ``time.perf_counter``.  A step phase's span
is the host's *dispatch* window: the CUDA kernels it queues run
asynchronously behind it on the card, as XLA's do behind a jitted call.
That is exactly the timeline that matters for the asynchronous host
loop: a phase span that balloons means the host blocked (a device read,
a synchronising call) or spent that long issuing launches.  The port's
`forward` dispatches only the forward (``grad_dispatch``) and its
`backward` the backward plus the accumulation
(``accumulate_dispatch``), where the JAX engine's forward dispatches the
whole grad program; the names are kept so the two traces compare.

Format: the JSON-object form ``{"traceEvents": [...]}`` of the Trace
Event Format; complete events (``ph: "X"``) with microsecond ``ts``/
``dur``, one named tid per lane, thread-name metadata events.
"""

import json
import os
import time
from typing import Any, Dict, List, Optional

from .record import SCHEMA_VERSION

# lane -> tid (thread_name metadata emitted on first use)
TID_STEP = 1
TID_SWAP_IN = 2
TID_SWAP_OUT = 3
TID_MARKS = 4
TID_MOE = 5

# what each step-phase span of the port's engine dispatches (the JAX
# engine's names, so the two packages' traces compare)
PHASE_NOTES = {
    "grad_dispatch": "the forward of a micro-step (the JAX engine's "
                     "forward dispatches the whole grad program)",
    "accumulate_dispatch": "the backward and the gradient accumulation of "
                           "a micro-step",
    "apply_dispatch": "the optimizer step at the accumulation boundary",
    "fused_step(gas=N)": "one CUDA graph replay of the whole window "
                         "(eager on the CPU)",
}

_LANE_NAMES = {TID_STEP: "step phases", TID_SWAP_IN: "swap in (NVMe read)",
               TID_SWAP_OUT: "swap out (NVMe write)", TID_MARKS: "monitor",
               TID_MOE: "moe routing"}


class TraceEventBuffer:
    """Bounded in-memory span collector; write() emits the JSON file.

    ``max_steps`` bounds the number of optimizer steps traced (a
    long run would otherwise grow the trace without limit); once
    saturated, add calls become no-ops and the truncation is recorded
    in the trace metadata."""

    def __init__(self, max_steps: int = 128):
        self.max_steps = int(max_steps)
        self.events: List[Dict[str, Any]] = []
        self._t0: Optional[float] = None
        self._pid = os.getpid()
        self._steps_seen: set = set()
        self._lanes_named: set = set()
        self.truncated = False

    # ------------------------------------------------------------------ #
    @property
    def saturated(self) -> bool:
        return len(self._steps_seen) >= self.max_steps

    def note_untraced_step(self, step: int) -> None:
        """Record that a step happened past the bound (callers stop
        adding spans once saturated, so the buffer learns about
        truncation from this)."""
        if self.saturated and step not in self._steps_seen:
            self.truncated = True

    def note_step(self, step: int) -> bool:
        """Register an optimizer step; False once the bound is hit."""
        if step in self._steps_seen:
            return True
        if self.saturated:
            self.truncated = True
            return False
        self._steps_seen.add(step)
        return True

    def _ts(self, t: float) -> float:
        if self._t0 is None:
            self._t0 = t
        return (t - self._t0) * 1e6  # seconds -> microseconds

    def _name_lane(self, tid: int) -> None:
        if tid not in self._lanes_named:
            self._lanes_named.add(tid)
            self.events.append({
                "name": "thread_name", "ph": "M", "pid": self._pid,
                "tid": tid, "args": {"name": _LANE_NAMES.get(tid,
                                                             f"lane{tid}")}})

    # ------------------------------------------------------------------ #
    def add_span(self, name: str, t_start: float, t_end: float,
                 tid: int = TID_STEP, cat: str = "phase",
                 step: Optional[int] = None,
                 args: Optional[Dict[str, Any]] = None) -> None:
        """One complete event from perf_counter timestamps (seconds)."""
        if step is not None and not self.note_step(step):
            return
        self._name_lane(tid)
        ev: Dict[str, Any] = {
            "name": name, "cat": cat, "ph": "X",
            "ts": round(self._ts(t_start), 3),
            "dur": round(max(t_end - t_start, 0.0) * 1e6, 3),
            "pid": self._pid, "tid": tid,
        }
        a = dict(args or {})
        if step is not None:
            a["step"] = step
        if a:
            ev["args"] = a
        self.events.append(ev)

    def add_counter(self, name: str, t: float,
                    values: Dict[str, float],
                    tid: int = TID_MOE) -> None:
        """One counter sample (``ph: "C"`` — Perfetto renders these as
        stacked value tracks).  Used for the per-window MoE routing
        lanes: drop rate and expert-load imbalance sampled at every
        flush boundary.  Absent (None) values are SKIPPED, not zeroed
        — a window that routed nothing must read as a gap in the
        counter track, never as a confident 0.0."""
        args = {k: round(float(v), 6)
                for k, v in values.items() if v is not None}
        if not args:
            return
        self._name_lane(tid)
        self.events.append({
            "name": name, "cat": "counter", "ph": "C",
            "ts": round(self._ts(t), 3), "pid": self._pid, "tid": tid,
            "args": args})

    def add_instant(self, name: str, t: float, tid: int = TID_MARKS,
                    args: Optional[Dict[str, Any]] = None) -> None:
        self._name_lane(tid)
        ev: Dict[str, Any] = {"name": name, "cat": "mark", "ph": "i",
                              "ts": round(self._ts(t), 3), "s": "t",
                              "pid": self._pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def add_swap_read_events(self, events: List[Dict[str, Any]],
                             step: Optional[int] = None) -> None:
        """Spans from a streaming engine's swap-in window accounting (the
        offload tier, ROADMAP.md A.7): the issue→done window per group,
        plus an explicit `wait` sub-span for the exposed (caller-blocked)
        tail — serialized swap-ins are visible at a glance."""
        if step is not None and not self.note_step(step):
            return
        for e in events:
            t_issue = e.get("t_issue")
            t_done = e.get("t_done")
            if t_issue is None or t_done is None:
                continue
            self.add_span(
                f"swap_in:{e.get('name', '?')}", t_issue, t_done,
                tid=TID_SWAP_IN, cat="swap_in",
                args={"bytes": e.get("bytes"),
                      "hidden_s": round(e.get("hidden_s") or 0.0, 6),
                      "exposed_s": round(e.get("exposed_s") or 0.0, 6),
                      **({"step": step} if step is not None else {})})
            exposed = e.get("exposed_s") or 0.0
            if exposed > 1e-5:
                self.add_span(
                    f"wait:{e.get('name', '?')}", t_done - exposed, t_done,
                    tid=TID_SWAP_IN, cat="swap_wait",
                    args={"exposed_s": round(exposed, 6)})

    def add_swap_write_events(self, events: List[Dict[str, Any]],
                              step: Optional[int] = None) -> None:
        """Spans from write-side handles (InflightTensorWrite /
        PartitionedParamSwapper write→flush windows)."""
        if step is not None and not self.note_step(step):
            return
        for e in events:
            t_issue = e.get("t_issue")
            t_done = e.get("t_done")
            if t_issue is None or t_done is None:
                continue
            self.add_span(
                f"swap_out:{e.get('name', '?')}", t_issue, t_done,
                tid=TID_SWAP_OUT, cat="swap_out",
                args={"bytes": e.get("bytes"),
                      "wait_s": round(e.get("wait_s") or 0.0, 6)})

    # ------------------------------------------------------------------ #
    def to_json(self) -> Dict[str, Any]:
        return {
            "traceEvents": list(self.events),
            "displayTimeUnit": "ms",
            "otherData": {
                "source": "deepspeed_tpu_torch.monitor",
                "schema_version": SCHEMA_VERSION,
                "clock": "host perf_counter (dispatch windows: the CUDA "
                         "work of a phase runs asynchronously behind its "
                         "span; wall windows for swap I/O)",
                "phases": PHASE_NOTES,
                "steps_traced": len(self._steps_seen),
                "truncated_at_max_steps": self.truncated,
                "exported_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                             time.gmtime()),
            },
        }

    def write(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f)
        return path


def validate_trace_events(payload: Dict[str, Any]) -> List[str]:
    """Schema check for the Trace Event Format subset this module emits
    (used by tests and available to consumers): returns a list of
    problems, empty when the payload is loadable by chrome://tracing/
    Perfetto."""
    problems = []
    events = payload.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    # schema-version check (v2+): absent = a v1-era trace, accepted; a
    # version from the FUTURE means this validator predates the writer
    other = payload.get("otherData")
    if isinstance(other, dict) and "schema_version" in other:
        ver = other["schema_version"]
        if not isinstance(ver, int):
            problems.append(f"otherData.schema_version is not an int "
                            f"({ver!r})")
        elif ver > SCHEMA_VERSION:
            problems.append(
                f"trace schema_version {ver} is newer than this "
                f"validator ({SCHEMA_VERSION}) — upgrade the reader")
    for i, ev in enumerate(events):
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                problems.append(f"event {i} missing {key!r}")
        ph = ev.get("ph")
        if ph not in ("X", "B", "E", "i", "I", "M", "C"):
            problems.append(f"event {i} has unknown ph {ph!r}")
        if ph == "X":
            if not isinstance(ev.get("ts"), (int, float)):
                problems.append(f"event {i} (X) non-numeric ts")
            elif ev["ts"] < 0:
                # an event recorded from before the trace origin (e.g.
                # pre-step I/O leaking into a step span set)
                problems.append(f"event {i} (X) negative ts")
            if not isinstance(ev.get("dur"), (int, float)):
                problems.append(f"event {i} (X) missing numeric dur")
            elif ev["dur"] < 0:
                problems.append(f"event {i} (X) negative dur")
        elif ph in ("i", "I") and not isinstance(ev.get("ts"),
                                                 (int, float)):
            problems.append(f"event {i} (instant) non-numeric ts")
    return problems
