"""Per-host heartbeat file protocol — the fleet liveness signal
(counterpart of deepspeed_tpu/monitor/heartbeat.py; the file format is
the JAX package's, so either package's reader reads either's beats).

Every monitored process writes one small JSON file
(``<dir>/hb_<process_index>.json``, atomic tmp+rename so a reader never
sees a torn write) at its flush-window boundaries and on close.  The
files are the out-of-band liveness channel the collectives cannot
provide: a preempted worker going dark mid-allgather stops beating long
before the lockstep collective times out, and a watcher
(``format_watch_table``; the JAX package's ``dslaunch --watch``, which
the port takes with its launcher, ROADMAP.md A.13) renders the whole
job's status as a table from nothing but a shared filesystem — no
network, no coordinator.

Writes happen ONLY at flush boundaries (the monitor's existing cadence),
never in the hot loop; one ~200-byte file write per window is noise next
to the window's record flush.
"""

import json
import os
import time
from typing import Any, Dict, List, Optional

HEARTBEAT_DIR = "heartbeat"          # subdir under the monitor out_dir
STATUS_RUNNING = "running"
STATUS_STOPPED = "stopped"
STALE_AFTER_S_DEFAULT = 60.0


def heartbeat_path(directory: str, process_index: int) -> str:
    return os.path.join(directory, f"hb_{int(process_index)}.json")


def resolve_heartbeat_dir(root: str) -> str:
    """Locate the heartbeat dir under a monitor ``output_path``.

    The monitor writes to ``output_path/<job_name>/heartbeat`` — with an
    empty job_name that is ``root/heartbeat``, but an operator pointing
    a watcher at the output_path of a job that SET job_name
    would otherwise stare at an empty dir and a table of MISSING rows.
    Resolution order: ``root`` itself if it already holds hb files,
    then ``root/heartbeat``, then a unique ``root/*/heartbeat`` child;
    falls back to ``root/heartbeat`` (which may appear later)."""
    def _has_beats(d: str) -> bool:
        try:
            return any(n.startswith("hb_") and n.endswith(".json")
                       for n in os.listdir(d))
        except OSError:
            return False

    if _has_beats(root):
        return root
    direct = os.path.join(root, HEARTBEAT_DIR)
    if os.path.isdir(direct):
        return direct
    try:
        children = [os.path.join(root, n, HEARTBEAT_DIR)
                    for n in sorted(os.listdir(root))]
    except OSError:
        children = []
    nested = [d for d in children if os.path.isdir(d)]
    if len(nested) == 1:
        return nested[0]
    return direct


class HeartbeatWriter:
    """One per process.  ``beat()`` is cheap and crash-safe: any failure
    is swallowed after one warning — liveness reporting must never take
    down the training it reports on."""

    def __init__(self, directory: str, process_index: int = 0,
                 world_size: int = 1, host: Optional[str] = None):
        self.directory = directory
        self.process_index = int(process_index)
        self.world_size = int(world_size)
        from . import record as R
        self.host = R.identity(process_index, world_size,
                               host)[R.F_HOST]
        self.path = heartbeat_path(directory, process_index)
        self.beats = 0
        self._warned = False
        # seeded at construction so even the FIRST beat reports an
        # interval (monitor build -> first flush boundary, compile time
        # included — an over-estimate, which errs toward "not stale"):
        # a long-window job must not render a transient false STALE
        # between the wall-clock default and its second beat
        self._t_last = time.time()

    def beat(self, step: Optional[int] = None,
             status: str = STATUS_RUNNING,
             extra: Optional[Dict[str, Any]] = None) -> None:
        # the JAX package fires its chaos plane's liveness point here (a
        # "stale" fault skips the beat, a "corrupt" one writes a torn
        # file); the port has none yet (ROADMAP.md A.13)
        now = time.time()
        payload = {
            "host": self.host,
            "process_index": self.process_index,
            "world_size": self.world_size,
            "pid": os.getpid(),
            "step": step,
            "status": status,
            "time": now,
            # observed beat cadence (one beat per flush window): lets
            # the reader scale its staleness threshold to THIS job's
            # step time instead of a wall-clock constant — a 10 s/step
            # run with a 10-step window beats every ~100 s and must not
            # render permanently STALE against a 60 s default
            "interval_s": round(now - self._t_last, 3),
        }
        self._t_last = now
        if extra:
            payload.update(extra)
        try:
            os.makedirs(self.directory, exist_ok=True)
            tmp = self.path + f".tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.path)  # atomic: readers never see torn
            self.beats += 1
        except Exception as e:  # noqa: BLE001 — liveness must not crash
            if not self._warned:
                self._warned = True
                from ..utils.logging import logger
                logger.warning(f"monitor: heartbeat write failed ({e}) — "
                               "further heartbeat errors suppressed")
                from ..runtime.resilience.degradation import \
                    record as degrade
                degrade("heartbeat", "file", "silent",
                        f"heartbeat write failed: {e}")

    def close(self, step: Optional[int] = None) -> None:
        self.beat(step=step, status=STATUS_STOPPED)


# --------------------------------------------------------------------- #
# reader side (a watcher, tests, operators)
# --------------------------------------------------------------------- #
def read_heartbeats(directory: str,
                    now: Optional[float] = None) -> List[Dict[str, Any]]:
    """All heartbeat files in `directory`, process order, each annotated
    with ``age_s``.  Unparseable files surface as status "corrupt" (a
    half-dead writer is itself a signal) instead of being skipped."""
    now = time.time() if now is None else now
    out: List[Dict[str, Any]] = []
    if not os.path.isdir(directory):
        return out
    for name in sorted(os.listdir(directory)):
        if not (name.startswith("hb_") and name.endswith(".json")):
            continue
        path = os.path.join(directory, name)
        try:
            with open(path) as f:
                hb = json.load(f)
            hb["age_s"] = max(0.0, now - float(hb.get("time") or 0.0))
        except FileNotFoundError:
            # deleted between listdir and open (an atomic rewrite's
            # os.replace window, or operator cleanup) — skip, not crash
            continue
        except Exception:  # noqa: BLE001
            try:
                age = max(0.0, now - os.path.getmtime(path))
            except OSError:  # vanished since the failed read
                continue
            # recover the process index from the filename so the watch
            # table shows ONE corrupt row for this worker, not a
            # corrupt '?' row plus a spurious MISSING row
            try:
                pidx = int(name[len("hb_"):-len(".json")])
            except ValueError:
                pidx = None
            hb = {"host": name, "process_index": pidx,
                  "status": "corrupt", "step": None, "age_s": age}
        out.append(hb)
    out.sort(key=lambda h: (h.get("process_index")
                            if h.get("process_index") is not None else 1e9))
    return out


def annotate_stale(beats: List[Dict[str, Any]],
                   stale_after_s: float = STALE_AFTER_S_DEFAULT
                   ) -> List[Dict[str, Any]]:
    """Mark each beat ``stale`` — a RUNNING host whose file stopped
    moving is presumed dark (preempted, wedged, or partitioned).

    The effective threshold per host is ``max(stale_after_s, 3x the
    host's own reported beat interval)``: beats arrive once per flush
    window, so a long-step job legitimately beats far less often than
    any fixed wall-clock constant — a healthy host must miss ~3 of its
    OWN windows before it renders stale."""
    for hb in beats:
        threshold = stale_after_s
        interval = hb.get("interval_s")
        if isinstance(interval, (int, float)) and interval > 0:
            threshold = max(threshold, 3.0 * float(interval))
        hb["stale"] = (hb.get("status") == STATUS_RUNNING
                       and hb.get("age_s", 0.0) > threshold)
    return beats


def format_watch_table(beats: List[Dict[str, Any]],
                       stale_after_s: float = STALE_AFTER_S_DEFAULT,
                       expected_procs: Optional[int] = None) -> str:
    """The watch status table (plain text, one host per
    row).  STALE rows are the actionable ones: alive-claiming hosts
    whose heartbeat stopped.  With ``expected_procs`` (the launcher
    knows its world size), process indices that never wrote a heartbeat
    render as MISSING — a worker that died before its first beat must
    not be invisible."""
    beats = annotate_stale(list(beats), stale_after_s)
    seen = {hb.get("process_index") for hb in beats}
    if expected_procs is not None:
        for p in range(expected_procs):
            if p not in seen:
                beats.append({"process_index": p, "host": "?",
                              "step": None, "age_s": float("nan"),
                              "status": "MISSING (no heartbeat yet)",
                              "stale": False})
        beats.sort(key=lambda h: (h.get("process_index")
                                  if h.get("process_index") is not None
                                  else 1e9))
    header = f"{'PROC':>4}  {'HOST':<24} {'STEP':>8} {'AGE':>7}  STATUS"
    lines = [header, "-" * len(header)]
    for hb in beats:
        pidx = hb.get("process_index")
        status = hb.get("status", "?")
        if hb.get("stale"):
            status = f"STALE ({status})"
        step = hb.get("step")
        age = hb.get("age_s", 0.0)
        age_txt = f"{age:>6.1f}s" if age == age else f"{'-':>6} "
        lines.append(
            f"{pidx if pidx is not None else '?':>4}  "
            f"{str(hb.get('host', '?'))[:24]:<24} "
            f"{step if step is not None else '-':>8} "
            f"{age_txt}  {status}")
    if not beats:
        lines.append("(no heartbeat files yet)")
    return "\n".join(lines)
