"""TrainingMonitor — runtime telemetry orchestrator (counterpart of
deepspeed_tpu/monitor/monitor.py).

One instance per engine — rank 0 only in the single-process posture,
every process when ``monitor.fleet`` or ``monitor.heartbeat`` is on —
behind the ``monitor`` config block.  The design constraint everything
here serves: the step loop must stay dispatch-deep.  CUDA work runs
asynchronously behind the host, and any read of a device value makes the
host wait for everything queued before it.  So per optimizer step the
monitor does ONLY host work — a perf_counter read, appending a pending
entry holding the loss as a *device tensor reference* (not a value), and
integer counter copies.  All device reads (the batched loss transfer,
lr / loss-scale, memory stats) happen at flush-window boundaries,
exactly like the engine's own ``_boundary_logging``.

Emission is decoupled twice: records materialize at the boundary, and
file I/O runs on the WriterThread — a slow disk never blocks a step.
"""

import atexit
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..utils.logging import log_dist, logger
from . import record as R
from .capture import ProfileCapture
from .fleet import FleetAggregator, format_fleet_line
from .health import FleetHealth, format_health_line
from .heartbeat import HEARTBEAT_DIR, HeartbeatWriter
from .reconcile import Bands, format_line, reconcile_window
from .trace import TID_STEP, TraceEventBuffer
from .writers import (CsvWriter, JsonlWriter, MetricsWriter,
                      TensorBoardWriter, WriterThread)

METRICS_JSONL = "metrics.jsonl"
METRICS_CSV = "metrics.csv"
TRACE_JSON = "trace.json"
PROFILES_DIR = "profiles"


def _batched_loss_fetch(refs):
    """Materialize a window of retained device scalars in ONE transfer —
    N sequential per-record reads would pay N host-device round trips at
    every boundary.  The tensors are stacked on the first one's device
    (refs on other devices are moved there with non_blocking copies)
    and copied to the host once; host numbers pass through; None stays
    None.  Each value is rounded to 6 places, as the JAX package's."""
    vals = list(refs)
    tensors = [i for i, v in enumerate(vals) if isinstance(v, torch.Tensor)]
    if tensors:
        dev = vals[tensors[0]].device
        stacked = torch.stack([
            vals[i].detach().reshape(()).to(dev, torch.float64,
                                             non_blocking=True)
            for i in tensors])
        for i, v in zip(tensors, stacked.cpu().tolist()):
            vals[i] = v
    out = []
    for v in vals:
        if v is None:
            out.append(None)
            continue
        try:
            out.append(round(float(np.asarray(v)), 6))
        except Exception:  # noqa: BLE001
            out.append(None)
    return out


class MetricsStream:
    """Assembles one structured record per optimizer step.

    ``end_step`` is the per-step hot-path call: O(1) host work, no device
    reads.  ``flush`` is the boundary call: one batched transfer of the
    window's retained device scalars plus one read each of lr/loss-scale
    (``boundary_fn``), memory stats (of ``device``), and swap stats
    (``swap_stats_fn``; no port tier has them until offload, ROADMAP.md
    A.7), then the whole window's records go to the writer thread at
    once.  The JAX stream's MoE routing window (``moe_stats_fn``) comes
    with MoE (A.10)."""

    def __init__(self, window: int, sink: Callable[[List[dict]], None],
                 boundary_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 swap_stats_fn: Optional[Callable[[], Optional[dict]]] = None,
                 reconciler: Optional[Callable[[dict], Optional[dict]]] = None,
                 identity: Optional[Dict[str, Any]] = None,
                 window_hook: Optional[Callable[[dict],
                                                Optional[List[dict]]]] = None,
                 assemble_records: bool = True,
                 extra_records_fn: Optional[Callable[[],
                                                     List[dict]]] = None,
                 device: Any = None):
        self.window = max(1, int(window))
        self._sink = sink
        self._boundary_fn = boundary_fn
        self._swap_stats_fn = swap_stats_fn
        self._reconciler = reconciler
        self._device = device
        # False on fleet non-emitter ranks: no writer consumes step
        # records there, so the flush skips record assembly AND the
        # records-only boundary reads (lr / loss-scale) — the loss fetch,
        # reconciliation (it arms captures), window summary, and fleet
        # hook still run
        self._assemble_records = assemble_records
        # host identity stamped onto every record this stream emits
        # (schema v2 — single-host runs populate it too)
        self._identity = dict(identity) if identity else R.identity()
        # FULL-window hook (the fleet exchange): runs only on boundaries
        # reached by step count — every lockstep host hits them at the
        # same step, which is what makes a collective inside it safe.
        # Final/partial flushes (close, explicit flush) SKIP it: hosts
        # may exit at different times and a collective there would hang
        # the survivors.
        self._window_hook = window_hook
        # drained at each flush: out-of-band resilience records (the
        # degradation registry's events; the JAX engine adds its chaos
        # plane's fired faults, ROADMAP.md A.13) ride the stream at
        # boundary cadence — no hot-loop work, no new host reads
        self._extra_records_fn = extra_records_fn
        # set when the window hook died on an ExchangeTimeout: the
        # supervisor harness reads the attributed timeout from here
        self.last_exchange_timeout = None
        self._pending: List[dict] = []
        self._t_prev: Optional[float] = None
        self._t_start: Optional[float] = None      # first forward this step
        self._t_end_prev: Optional[float] = None   # previous end_step
        self.records_emitted = 0

    def mark_step_start(self) -> None:
        """Arm the wall clock before the first step's dispatch (later
        steps measure arrival-to-arrival — DELIVERED step time including
        host/dataloader gaps, same semantics as ThroughputTimer).  Also
        timestamps the FIRST forward of each step so end_step can split
        out the host-gap lane (previous end_step -> this forward)."""
        now = time.perf_counter()
        if self._t_start is None:
            self._t_start = now
        if self._t_prev is None:
            self._t_prev = now

    def discard_step(self) -> None:
        """A step that produced no record (e.g. a sentinel rewind)
        still consumed wall time — reset the arrival clock so the NEXT
        record does not silently absorb it."""
        now = time.perf_counter()
        if self._t_prev is not None:
            self._t_prev = now
        if self._t_end_prev is not None:
            self._t_end_prev = now
        self._t_start = None

    def end_step(self, step: int, loss: Any = None,
                 tokens: Optional[int] = None,
                 counters: Optional[Dict[str, Any]] = None,
                 swap: Optional[Dict[str, Any]] = None,
                 grad_norm: Optional[float] = None) -> None:
        """``swap``: this STEP's swap-stats dict when the caller already
        has it as host data (the streaming engine computes it per step in
        _finalize_swap_stats) — records then carry per-step values
        instead of the window boundary's snapshot.  ``grad_norm``: a
        host float the caller ALREADY fetched (the sentinel's per-step
        norm) — never a device read made for the monitor's sake; feeds
        the fleet window vector's grad-norm divergence lane."""
        now = time.perf_counter()
        wall = (now - self._t_prev) if self._t_prev is not None else None
        self._t_prev = now
        host_gap = None
        if self._t_end_prev is not None and self._t_start is not None:
            host_gap = max(0.0, self._t_start - self._t_end_prev)
        self._t_end_prev = now
        self._t_start = None
        # don't retain the device loss reference on ranks where nothing
        # will ever fetch it (heartbeat-only non-emitters)
        keep_loss = (self._assemble_records
                     or self._window_hook is not None)
        self._pending.append({"step": int(step),
                              "loss_ref": loss if keep_loss else None,
                              "wall_s": wall, "tokens": tokens,
                              "counters": dict(counters or {}),
                              "swap": swap, "host_gap": host_gap,
                              "grad_norm": grad_norm})
        if len(self._pending) >= self.window:
            self.flush(final=False)

    @property
    def fleet_live(self) -> bool:
        """True while the fleet window hook (the allgather) is armed."""
        return self._window_hook is not None

    def flush(self, final: bool = True) -> None:
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        boundary: Dict[str, Any] = {}
        if self._assemble_records and self._boundary_fn is not None:
            try:
                boundary = self._boundary_fn() or {}
            except Exception as e:  # noqa: BLE001 — never fail a step
                logger.warning(f"monitor: boundary reads failed ({e})")
        # same dead-consumer gate as boundary_fn/loss fetch below: the
        # memory reading only feeds step records and the reconciler
        memory = (R.device_memory(self._device)
                  if (self._assemble_records or self._reconciler
                      is not None) else {})
        swap = None
        if self._swap_stats_fn is not None:
            try:
                swap = self._swap_stats_fn()
            except Exception:  # noqa: BLE001
                swap = None
        # losses feed records and the fleet summary; a heartbeat-only
        # non-emitter rank (no writers, no fleet hook) has neither
        # consumer — skip the per-window device transfer entirely
        if self._assemble_records or self._window_hook is not None:
            losses = _batched_loss_fetch(
                [p["loss_ref"] for p in pending])
        else:
            losses = [None] * len(pending)
        records = []
        walls = []
        gaps = []
        for p, loss in zip(pending, losses):
            if p["wall_s"] is not None:
                walls.append(p["wall_s"])
            if p["host_gap"] is not None:
                gaps.append(p["host_gap"])
            if self._assemble_records:
                records.append(R.make_step_record(
                    p["step"], loss, p["wall_s"], p["tokens"],
                    p["counters"], boundary, memory,
                    p["swap"] if p["swap"] is not None else swap,
                    host_gap_s=p["host_gap"]))
        if self._reconciler is not None:
            # runs on every rank (its flags arm this host's capture);
            # the record itself is only worth keeping where a writer is
            rec = self._reconciler({
                "window_start_step": pending[0]["step"],
                "window_end_step": pending[-1]["step"],
                "step_time_s": (sum(walls) / len(walls)) if walls else None,
                "hbm_peak_bytes": memory.get(R.F_MEM_PEAK_BYTES),
                "mem_source": memory.get(R.F_MEM_SOURCE),
                "swap": swap,
            })
            if rec is not None and self._assemble_records:
                records.append(rec)
        if self._extra_records_fn is not None and self._assemble_records:
            try:
                records.extend(self._extra_records_fn() or [])
            except Exception as e:  # noqa: BLE001 — telemetry only
                logger.warning(f"monitor: extra-records hook failed ({e})")
        for rec in records:
            for k, v in self._identity.items():
                rec.setdefault(k, v)
        if self._window_hook is not None and not final:
            finite = [v for v in losses
                      if isinstance(v, float) and np.isfinite(v)]
            norms = [p["grad_norm"] for p in pending
                     if isinstance(p["grad_norm"], (int, float))
                     and np.isfinite(p["grad_norm"])]
            per_step_swaps = [p["swap"] for p in pending if p["swap"]]
            exposed = [
                float(s.get("read_exposed_s") or 0.0)
                + float(s.get("write_exposed_s") or 0.0)
                for s in per_step_swaps]
            summary = {
                "window_start_step": pending[0]["step"],
                "last_step": pending[-1]["step"],
                "steps": len(pending),
                "step_time_mean_s": (sum(walls) / len(walls)
                                     if walls else None),
                "step_time_max_s": max(walls) if walls else None,
                "loss_mean": (sum(finite) / len(finite)
                              if finite else None),
                "grad_norm_mean": (sum(norms) / len(norms)
                                   if norms else None),
                "host_gap_mean_s": (sum(gaps) / len(gaps)
                                    if gaps else None),
                "swap_read_gbps": ((swap or {}).get("read_gbps")
                                   if not per_step_swaps else
                                   per_step_swaps[-1].get("read_gbps")),
                "swap_exposed_mean_s": (sum(exposed) / len(exposed)
                                        if exposed else None),
            }
            try:
                extra = self._window_hook(summary)
            except Exception as e:  # noqa: BLE001
                # a failed fleet EXCHANGE means the distributed runtime
                # is sick; disable the hook (re-calling a broken
                # collective would wedge) and degrade loudly — a meta
                # record marks the degradation in the stream, not just
                # this host's log.  (Post-exchange local failures are
                # contained inside the hook and never reach here.)  If
                # the collective failed on THIS host only, peers will
                # still block in their next allgather — that hang is
                # inherent to timeout-less collectives; the heartbeat
                # file going stale is the operator's signal.
                self._window_hook = None
                logger.warning(
                    f"monitor: fleet window hook failed ({e}) — fleet "
                    "aggregation DISABLED on this host for the rest of "
                    "the run")
                from ..runtime.resilience import degradation
                degradation.record("fleet_monitor", "aggregating",
                                   "disabled", str(e)[:200])
                meta = {R.F_KIND: R.KIND_META,
                        "fleet_disabled": str(e)[:200],
                        **self._identity}
                from .fleet import ExchangeTimeout
                if isinstance(e, ExchangeTimeout):
                    # the watchdog attributed the wedge: name the hosts
                    # in the stream so the supervisor/operator can evict
                    # the right workers, not guess
                    meta["missing_hosts"] = e.missing_hosts()
                    self.last_exchange_timeout = e
                extra = [meta] if self._assemble_records else None
            if extra:
                records.extend(extra)
        self.records_emitted += len(records)
        self._sink(records)


class TrainingMonitor:
    """Config-driven telemetry: MetricsStream + writers + trace +
    reconciliation, plus the fleet layer (cross-process aggregation,
    straggler/divergence health, heartbeat liveness, anomaly-triggered
    profiler capture).  Constructed by the engine when
    ``monitor.enabled`` — on rank 0 only in the single-process posture,
    on EVERY process when ``monitor.fleet`` or ``monitor.heartbeat`` is
    on (non-zero ranks run no file writers; they contribute window
    vectors, beat their heartbeat, and can arm their own capture).
    ``device`` is the engine's device (memory stats read its allocator).
    Safe to close() more than once (atexit-registered so a crashed run
    still flushes what it saw)."""

    def __init__(self, cfg, steps_per_print: int = 10,
                 predictions: Optional[Dict[str, Any]] = None,
                 summary_writer: Any = None,
                 boundary_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 swap_stats_fn: Optional[Callable[[], Optional[dict]]] = None,
                 meta: Optional[Dict[str, Any]] = None,
                 process_index: Optional[int] = None,
                 world_size: Optional[int] = None,
                 host: Optional[str] = None,
                 gather_fn: Optional[Callable] = None,
                 health_sink: Optional[Callable[[dict], None]] = None,
                 profiler: Any = None,
                 extra_records_fn: Optional[Callable[[],
                                                     List[dict]]] = None,
                 device: Any = None):
        self.cfg = cfg
        self.out_dir = os.path.join(cfg.output_path, cfg.job_name or "")
        self.predictions = predictions
        self.bands = Bands(step_time_ratio_max=cfg.step_time_ratio_max,
                           hbm_ratio_max=cfg.hbm_ratio_max,
                           swap_min_vs_ceiling=cfg.swap_min_vs_ceiling)
        window = cfg.write_interval or steps_per_print
        self.last_reconciliation: Optional[Dict[str, Any]] = None
        self.identity = R.identity(process_index, world_size, host)
        self.process_index = self.identity[R.F_PROCESS_INDEX]
        self.world_size = self.identity[R.F_WORLD_SIZE]
        # rank 0 owns the record stream's files; other ranks contribute
        # to the fleet exchange but write nothing through the writer
        # thread (their heartbeat + profiler captures are host-local)
        self.is_emitter = self.process_index == 0
        self._last_step: Optional[int] = None

        writers: List[MetricsWriter] = []
        self.jsonl_path = self.csv_path = self.trace_path = None
        if self.is_emitter and "jsonl" in cfg.writers:
            self.jsonl_path = os.path.join(self.out_dir, METRICS_JSONL)
            writers.append(JsonlWriter(self.jsonl_path))
        if self.is_emitter and "csv" in cfg.writers:
            self.csv_path = os.path.join(self.out_dir, METRICS_CSV)
            writers.append(CsvWriter(self.csv_path))
        if self.is_emitter and "tensorboard" in cfg.writers:
            if summary_writer is not None:
                writers.append(TensorBoardWriter(summary_writer))
            else:
                logger.warning(
                    "monitor: writer 'tensorboard' requested but the "
                    "engine has no summary writer (enable the tensorboard "
                    "config block) — skipping that backend")
        # non-emitter fleet ranks end up with no writers at all: don't
        # spawn a writer thread that would only drain empty batches
        self._thread = WriterThread(writers) if writers else None

        self.trace: Optional[TraceEventBuffer] = None
        if cfg.trace and self.is_emitter:
            self.trace = TraceEventBuffer(max_steps=cfg.trace_steps)
            self.trace_path = os.path.join(self.out_dir, TRACE_JSON)

        # ---- fleet layer ----------------------------------------------- #
        self.fleet: Optional[FleetAggregator] = None
        self.health: Optional[FleetHealth] = None
        self._health_sink = health_sink
        self.last_fleet_matrix = None
        self.last_health_events: List[dict] = []
        if getattr(cfg, "fleet", False):
            self.fleet = FleetAggregator(
                process_index=self.process_index,
                process_count=self.world_size,
                host=self.identity[R.F_HOST], gather_fn=gather_fn,
                deadline_s=getattr(cfg, "fleet_exchange_deadline_s", 0.0),
                arrival_fn=self._heartbeat_ages)
            moe_knobs = {}
            if getattr(cfg, "moe", None) is not None:
                moe_knobs = dict(
                    dead_expert_threshold=cfg.moe.dead_expert_threshold,
                    dead_expert_windows=cfg.moe.dead_expert_windows,
                    entropy_floor=cfg.moe.entropy_floor,
                    collapse_windows=cfg.moe.collapse_windows,
                    ep_imbalance_ratio=cfg.moe.ep_imbalance_ratio,
                    ep_imbalance_windows=cfg.moe.ep_imbalance_windows)
            self.health = FleetHealth(
                straggler_zscore=cfg.straggler_zscore,
                straggler_min_ratio=cfg.straggler_min_ratio,
                divergence_rel_spread=cfg.divergence_rel_spread,
                warmup_windows=cfg.health_warmup_windows,
                **moe_knobs)

        self.heartbeat: Optional[HeartbeatWriter] = None
        if getattr(cfg, "heartbeat", False):
            self.heartbeat = HeartbeatWriter(
                os.path.join(self.out_dir, HEARTBEAT_DIR),
                process_index=self.process_index,
                world_size=self.world_size,
                host=self.identity[R.F_HOST])

        self.capture: Optional[ProfileCapture] = None
        cap = getattr(cfg, "capture", None)
        if cap is not None and cap.enabled:
            # the p<N> suffix applies to an EXPLICIT output_path too:
            # several hosts can arm in the same window (a fleet-wide
            # band breach) and concurrent profiler sessions must never
            # share a trace dir on a shared filesystem
            self.capture = ProfileCapture(
                output_path=os.path.join(
                    cap.output_path or os.path.join(self.out_dir,
                                                    PROFILES_DIR),
                    f"p{self.process_index}"),
                steps=cap.steps, max_captures=cap.max_captures,
                cooldown_steps=cap.cooldown_steps, profiler=profiler)

        reconciler = None
        if cfg.reconcile:
            reconciler = self._reconcile
        self.stream = MetricsStream(
            window, self._sink,
            boundary_fn=boundary_fn,
            swap_stats_fn=swap_stats_fn,
            reconciler=reconciler,
            identity=self.identity,
            window_hook=(self._fleet_window if self.fleet is not None
                         else None),
            extra_records_fn=extra_records_fn,
            device=device,
            # non-emitter ranks have no writers: skip record assembly
            # and the records-only boundary reads on them
            assemble_records=self.is_emitter)
        if meta and self.is_emitter and self._thread is not None:
            self._thread.submit([{R.F_KIND: R.KIND_META,
                                  "schema_version": R.SCHEMA_VERSION,
                                  **self.identity, **meta,
                                  **({"predicted_step_time_lb_s":
                                      predictions.get(
                                          "predicted_step_time_lb_s")}
                                     if predictions else {})}])
        self._closed = False
        self._warned_fleet_flush = False
        atexit.register(self.close)
        log_dist(
            f"monitor: writers={list(cfg.writers)} window={window} "
            f"trace={'on' if self.trace else 'off'} "
            f"reconcile={'on' if reconciler else 'off'} "
            f"fleet={'on' if self.fleet else 'off'} "
            f"heartbeat={'on' if self.heartbeat else 'off'} "
            f"capture={'armed-standby' if self.capture else 'off'} "
            f"-> {self.out_dir}", ranks=[0])

    # ------------------------------------------------------------------ #
    # hot-path API (host-only work; see MetricsStream)
    # ------------------------------------------------------------------ #
    @property
    def trace_active(self) -> bool:
        return self.trace is not None and not self.trace.saturated

    def mark_step_start(self) -> None:
        self.stream.mark_step_start()

    def discard_step(self) -> None:
        # a sentinel-rewound step produced no record but DID run a full
        # forward/backward on device — while a capture is armed that
        # work is in the trace, so it must count toward the K-step
        # bound or a rewind streak makes the capture outlive its window
        # (observe_step_end is a one-predicate no-op when idle)
        if self.capture is not None:
            self.capture.observe_step_end(
                self._last_step if self._last_step is not None else 0)
        self.stream.discard_step()

    def end_step(self, step: int, loss: Any = None,
                 tokens: Optional[int] = None,
                 counters: Optional[Dict[str, Any]] = None,
                 swap: Optional[Dict[str, Any]] = None,
                 grad_norm: Optional[float] = None) -> None:
        if self.trace is not None:
            self.trace.note_untraced_step(step)
        self._last_step = int(step)
        if self.capture is not None:
            # one predicate check when idle; while armed, counts the
            # captured steps and stops the profiler after the K-th.
            # BEFORE the stream call: a flush inside end_step may ARM
            # the capture, and the arming step itself is not captured
            # (the profiler starts after this step already ended)
            self.capture.observe_step_end(step)
        self.stream.end_step(step, loss=loss, tokens=tokens,
                             counters=counters, swap=swap,
                             grad_norm=grad_norm)

    def add_phase(self, name: str, t_start: float,
                  step: Optional[int] = None,
                  t_end: Optional[float] = None) -> None:
        """Record one dispatch-phase span ending now (or at t_end)."""
        if self.trace is not None:
            self.trace.add_span(name, t_start,
                                t_end if t_end is not None
                                else time.perf_counter(),
                                tid=TID_STEP, step=step)

    # ------------------------------------------------------------------ #
    def _sink(self, records: List[dict]) -> None:
        """Flush-boundary sink: hand the window to the writer thread,
        beat the heartbeat, and mark the boundary on the trace timeline
        (the flush is where the batched device reads happen — worth
        seeing next to the spans)."""
        if self.trace is not None and not self.trace.saturated:
            self.trace.add_instant("flush", time.perf_counter(),
                                   args={"records": len(records)})
        if self.heartbeat is not None:
            self.heartbeat.beat(step=self._last_step)
        if self._thread is not None:
            self._thread.submit(records)

    def _reconcile(self, measured: Dict[str, Any]) -> Optional[dict]:
        rec = reconcile_window(measured, self.predictions, self.bands)
        self.last_reconciliation = rec
        if rec.get(R.R_FLAGS):
            logger.warning(format_line(rec))
            if self.capture is not None and not self._closed:
                # a breached band arms a bounded profiler capture for
                # the NEXT K steps — the first bad window ships with
                # a profiler trace (monitor/capture.py rate limits).
                # Never during close()'s final flush: there are no next
                # steps, so arming would burn a max_captures slot on an
                # empty trace
                self.capture.maybe_arm_for_flags(
                    rec[R.R_FLAGS], rec.get(R.R_WINDOW_END) or 0)
        else:
            log_dist(format_line(rec), ranks=[0])
        return rec

    def _heartbeat_ages(self) -> Dict[int, float]:
        """Per-host arrival evidence for the exchange watchdog: seconds
        since each peer's heartbeat file last moved.  File mtimes (not
        payload timestamps) so a corrupt-but-moving file still counts as
        alive; hosts with no file at all simply have no entry — the
        watchdog treats absence as missing."""
        hb_dir = os.path.join(self.out_dir, HEARTBEAT_DIR)
        ages: Dict[int, float] = {}
        try:
            names = os.listdir(hb_dir)
        except OSError:
            return ages
        now = time.time()
        for name in names:
            if not (name.startswith("hb_") and name.endswith(".json")):
                continue
            try:
                pidx = int(name[len("hb_"):-len(".json")])
                mtime = os.path.getmtime(os.path.join(hb_dir, name))
            except (ValueError, OSError):
                continue
            ages[pidx] = max(0.0, now - mtime)
        return ages

    def _fleet_window(self, summary: Dict[str, Any]) -> List[dict]:
        """FULL-window hook: one fixed-shape allgather of this host's
        window vector, then — from the identical [P, V] matrix every
        host now holds — per-host/fleet records on rank 0 and the SAME
        deterministic health detection on every host, so a flagged host
        arms its own capture with zero extra cross-host traffic.

        Failure containment: only the EXCHANGE may raise out of this
        hook (the stream then disables it — a broken collective must
        not be re-entered).  Everything after the exchange is local
        record/health work; a bug there on one host must not desync the
        fleet (every OTHER host would keep calling the allgather and
        block forever on the missing participant), so it is contained
        here with a warning."""
        matrix = self.fleet.exchange(summary)
        extra: List[dict] = []
        try:
            hosts = self.fleet.host_names()
            self.last_fleet_matrix = matrix
            events = (self.health.observe(matrix, hosts)
                      if self.health is not None else [])
            self.last_health_events = events
            if self.is_emitter:
                extra.extend(self.fleet.per_host_records(matrix))
                fleet_rec = self.fleet.fleet_record(matrix)
                fleet_rec[R.FL_WINDOW_START] = summary.get(
                    "window_start_step")
                extra.append(fleet_rec)
                log_dist(format_fleet_line(fleet_rec), ranks=[0])
                extra.extend(events)
            for ev in events:
                mine = ev.get(R.F_PROCESS_INDEX) == self.process_index
                if self.is_emitter or mine:
                    logger.warning(format_health_line(ev))
                    # structured health event into the resilience
                    # sentinel — same gate as the log line: rank 0's
                    # sentinel diagnostic carries the FLEET view, every
                    # other host's ring records only its OWN events (P
                    # sentinels all mirroring every neighbor's straggle
                    # would crowd each ring with remote noise)
                    if self._health_sink is not None:
                        try:
                            self._health_sink(ev)
                        except Exception as e:  # noqa: BLE001
                            logger.warning(
                                f"monitor: health sink failed ({e})")
                if mine and self.capture is not None:
                    self.capture.arm(
                        f"{ev.get(R.H_EVENT)}-"
                        f"{ev.get(R.H_LANE) or 'fleet'}",
                        ev.get(R.H_STEP) or self._last_step or 0)
        except Exception as e:  # noqa: BLE001 — local-only failure
            logger.warning(
                f"monitor: fleet record/health processing failed ({e}) "
                "— this window's fleet records are dropped on this host; "
                "the exchange stays live")
        return extra

    def flush(self) -> None:
        """Flush buffered records to the writers.

        With the fleet hook live the partial window is NOT flushed:
        window boundaries are counted in steps, and each FULL window
        runs one cross-host allgather — emptying the partial window on
        a subset of hosts (say, a rank-0-only checkpoint hook calling
        flush()) would shift those hosts' future boundaries so their
        next exchange fires at a different global step than their
        peers', wedging the pod.  Completed windows are already queued
        to the writer thread, which flushes its writers after every
        batch, so durability of everything up to the last boundary
        costs nothing here.  A 1-process world has no peers to desync,
        so the degenerate fleet mode keeps plain flush semantics."""
        if self.stream.fleet_live and self.world_size > 1:
            if not self._warned_fleet_flush:
                self._warned_fleet_flush = True
                logger.warning(
                    "monitor: flush() with fleet aggregation live keeps "
                    "the partial window buffered — window cadence is "
                    "collective state shared by every host, so a "
                    "mid-window flush on one host would desync the "
                    "fleet allgather; records through the last full "
                    "window are already on their way to disk")
            return
        self.stream.flush()

    def close(self) -> None:
        """Flush pending records, write the trace file, stop the writer
        thread.  Idempotent; registered atexit."""
        if self._closed:
            return
        self._closed = True
        # drop the atexit registry's reference so a discarded engine's
        # monitor (trace buffer + writer thread) is actually reclaimable
        try:
            atexit.unregister(self.close)
        except Exception:  # noqa: BLE001
            pass
        try:
            # final=True: a partial last window never runs the fleet
            # collective — hosts may be exiting at different times
            self.stream.flush(final=True)
        except Exception as e:  # noqa: BLE001
            logger.warning(f"monitor: final flush failed ({e})")
        if self.capture is not None:
            self.capture.close(self._last_step if self._last_step
                               is not None else -1)
        if self.heartbeat is not None:
            self.heartbeat.close(step=self._last_step)
        if self.trace is not None and self.trace_path is not None:
            try:
                self.trace.write(self.trace_path)
            except Exception as e:  # noqa: BLE001
                logger.warning(f"monitor: trace export failed ({e})")
        if self._thread is not None:
            self._thread.close()
