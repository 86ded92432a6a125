"""Straggler & divergence detection over the fleet window matrix
(counterpart of deepspeed_tpu/monitor/health.py; the rules and their
defaults are the JAX package's).

Consumes the [P, VEC_LEN] matrix every host holds after a fleet exchange
(monitor/fleet.py) and emits structured health events:

  * **straggler** — EWMA z-score on per-host DELIVERED step time.  The
    detector keeps an exponentially-weighted mean/variance of the fleet's
    per-window step-time distribution (all hosts pooled — the baseline is
    "what a healthy host costs on this pod right now", so a global
    slowdown, e.g. a smaller batch after elastic reshape, moves the
    baseline instead of flagging every host).  A host is flagged when it
    sits both ``straggler_zscore`` sigmas above that baseline AND at
    least ``straggler_min_ratio`` × the window's PEER median (leave-one-
    out: a median including the candidate is dragged toward it on small
    fleets — on 2 hosts it is the midpoint of the pair and masks a 30%
    straggler behind a 1.15 gate).  The ratio gate keeps sub-millisecond
    jitter from crying wolf on fast steps.  Each event carries a LANE
    attribution reusing reconcile.py's lanes: the host's excess over the
    peer median is charged to host-gap (dataloader/host work),
    swap-exposed (NVMe tier), or compute — whichever excess term
    dominates.

  * **divergence** — per-host loss spread.  In a lockstep data-parallel
    run the engine's loss is globally reduced, so every host reports the
    SAME value to rounding; a spread beyond ``divergence_rel_spread``
    (relative to the fleet median) means a replica is no longer computing
    the same program state — corrupt HBM, a missed update, a desynced
    RNG — long before the loss curve looks wrong on rank 0.

Detection is pure host math and runs identically on every host (same
matrix in, same events out), which is what lets a flagged host arm its
own profiler capture with no extra cross-host traffic.  Events feed the
resilience sentinel (TrainingSentinel.record_health_event) and, on rank
0, the record stream.  The MoE rules stay, fed only by ``monitor.moe``
(the JAX package's monitor/moe.py), which the port takes with MoE
(ROADMAP.md A.10); on a dense model their slots stay NaN and they never
fire.
"""

import math
from typing import Any, Dict, List, Optional

import numpy as np

from .. import constants as C
from . import record as R
from .fleet import _IDX
from .reconcile import (ATTR_COMPUTE, ATTR_EXPERT_HOTSPOT, ATTR_HOST_GAP,
                        ATTR_SWAP)

_VAR_FLOOR = 1e-18


class _Ewma:
    """Exponentially-weighted mean/variance of one scalar stream (the
    sentinel's estimator, local so monitor/ stays import-independent of
    runtime/)."""

    def __init__(self, alpha: float):
        self.alpha = alpha
        self.mean: Optional[float] = None
        self.var = 0.0
        self.count = 0

    def update(self, x: float) -> None:
        self.count += 1
        if self.mean is None:
            self.mean = x
            self.var = 0.0
            return
        diff = x - self.mean
        incr = self.alpha * diff
        self.mean += incr
        self.var = (1.0 - self.alpha) * (self.var + diff * incr)

    def zscore(self, x: float) -> float:
        if self.mean is None:
            return 0.0
        # std floored at 1% of the mean: a perfectly jitter-free
        # baseline (synthetic fleets, quantized timers) must not turn
        # microsecond noise into astronomic z-scores
        std = math.sqrt(max(self.var, _VAR_FLOOR,
                            (0.01 * abs(self.mean)) ** 2))
        return (x - self.mean) / std


def attribute_straggler_lane(row: Dict[str, Optional[float]],
                             median_row: Dict[str, float],
                             ep_imbalance_ratio: float =
                             C.MONITOR_MOE_EP_IMBALANCE_RATIO_DEFAULT
                             ) -> str:
    """Charge a straggler host's excess step time to a lane.

    ``row``: the flagged host's decoded window vector; ``median_row``:
    peer medians for the same fields.  The host's excess host-gap and
    excess exposed-swap are subtracted from its excess step time; the
    dominant term names the lane (ties/residual -> compute: the device
    itself is slow — thermal throttle, a sick chip).  One refinement on
    the compute residual: when the host's expert-parallel load share
    sits at or past the EP-imbalance gate vs its peers, the verdict
    names the expert hot-spot instead of generic compute — the device
    isn't sick, its local experts are popular ."""
    excess_total = ((row.get("step_time_mean_s") or 0.0)
                    - (median_row.get("step_time_mean_s") or 0.0))
    excess_gap = ((row.get("host_gap_mean_s") or 0.0)
                  - (median_row.get("host_gap_mean_s") or 0.0))
    excess_swap = ((row.get("swap_exposed_mean_s") or 0.0)
                   - (median_row.get("swap_exposed_mean_s") or 0.0))
    candidates = {ATTR_HOST_GAP: excess_gap, ATTR_SWAP: excess_swap}
    lane, value = max(candidates.items(), key=lambda kv: kv[1])
    # the named lane must explain a meaningful share of the excess
    if value > 0.0 and excess_total > 0.0 and value >= 0.25 * excess_total:
        return lane
    load = row.get("moe_local_load")
    load_ref = median_row.get("moe_local_load")
    if (load is not None and load_ref is not None and load_ref > 0.0
            and load / load_ref >= ep_imbalance_ratio):
        return ATTR_EXPERT_HOTSPOT
    return ATTR_COMPUTE


class FleetHealth:
    """Stateful detector: observe one window matrix, return events."""

    def __init__(self,
                 straggler_zscore: float =
                 C.MONITOR_STRAGGLER_ZSCORE_DEFAULT,
                 straggler_min_ratio: float =
                 C.MONITOR_STRAGGLER_MIN_RATIO_DEFAULT,
                 divergence_rel_spread: float =
                 C.MONITOR_DIVERGENCE_REL_SPREAD_DEFAULT,
                 warmup_windows: int =
                 C.MONITOR_HEALTH_WARMUP_WINDOWS_DEFAULT,
                 ewma_alpha: float = 0.2,
                 dead_expert_threshold: float =
                 C.MONITOR_MOE_DEAD_EXPERT_THRESHOLD_DEFAULT,
                 dead_expert_windows: int =
                 C.MONITOR_MOE_DEAD_EXPERT_WINDOWS_DEFAULT,
                 entropy_floor: float =
                 C.MONITOR_MOE_ENTROPY_FLOOR_DEFAULT,
                 collapse_windows: int =
                 C.MONITOR_MOE_COLLAPSE_WINDOWS_DEFAULT,
                 ep_imbalance_ratio: float =
                 C.MONITOR_MOE_EP_IMBALANCE_RATIO_DEFAULT,
                 ep_imbalance_windows: int =
                 C.MONITOR_MOE_EP_IMBALANCE_WINDOWS_DEFAULT):
        self.straggler_zscore = straggler_zscore
        self.straggler_min_ratio = straggler_min_ratio
        self.divergence_rel_spread = divergence_rel_spread
        self.warmup_windows = warmup_windows
        self._stat = _Ewma(ewma_alpha)
        self.windows_seen = 0
        self.stragglers_flagged = 0
        self.divergences_flagged = 0
        # ---- MoE rules: deterministic K-consecutive-window
        # gates, no EWMA baseline to pollute.  The dead-expert and
        # router-collapse metrics are fleet-global (the gating math is
        # replicated, every host reports the same value); EP imbalance
        # is per-host, gated against the leave-one-out PEER median so a
        # flagged host never defines its own reference — the same
        # flagged-samples-never-update-baseline discipline as the
        # straggler detector, realized cross-sectionally.
        self.dead_expert_threshold = dead_expert_threshold
        self.dead_expert_windows = dead_expert_windows
        self.entropy_floor = entropy_floor
        self.collapse_windows = collapse_windows
        self.ep_imbalance_ratio = ep_imbalance_ratio
        self.ep_imbalance_windows = ep_imbalance_windows
        self._dead_streak = 0
        self._collapse_streak = 0
        self._ep_streaks: Dict[int, int] = {}
        self.moe_events_flagged = 0

    # ------------------------------------------------------------------ #
    def observe(self, matrix: np.ndarray,
                hosts: Optional[List[str]] = None) -> List[Dict[str, Any]]:
        """One fleet window: update the EWMA baseline, emit events.

        Baseline hygiene: a host whose window sits at or above the
        ratio gate vs its peer median NEVER feeds the baseline — not
        during warmup either.  Warmup-polluted statistics would mask a
        straggler that is slow from the job's first window (cold NVMe,
        a sick host from boot — the motivating scenario): its samples
        would inflate the EWMA variance enough that its own z-score
        never trips.  The cross-sectional ratio needs no history, so it
        is the pollution gate; the z-score against the clean baseline
        is then free to fire the first window past warmup."""
        matrix = np.asarray(matrix, dtype=np.float64)
        self.windows_seen += 1
        hosts = hosts or [f"p{i}" for i in range(matrix.shape[0])]
        times = matrix[:, _IDX["step_time_mean_s"]]
        finite = np.isfinite(times)
        events: List[Dict[str, Any]] = []
        if not finite.any():
            return events
        step = _window_step(matrix)
        warmed = self.windows_seen > self.warmup_windows

        flagged = np.zeros(matrix.shape[0], dtype=bool)
        for p in range(matrix.shape[0]):
            t = float(times[p])
            if not math.isfinite(t):
                continue
            z = self._stat.zscore(t)
            # leave-one-out reference: "X times a healthy PEER", never
            # a median the candidate itself drags (see _peer_median)
            ref_t = _peer_median(times, p)
            ratio = t / ref_t if ref_t else 1.0
            if ratio >= self.straggler_min_ratio:
                flagged[p] = True  # excluded from the baseline either way
            if (warmed and z >= self.straggler_zscore
                    and ratio >= self.straggler_min_ratio):
                row = {name: _none_nan(matrix[p, i])
                       for name, i in _IDX.items()}
                median_row = {
                    "step_time_mean_s": ref_t,
                    "host_gap_mean_s": _peer_median(
                        matrix[:, _IDX["host_gap_mean_s"]], p) or 0.0,
                    "swap_exposed_mean_s": _peer_median(
                        matrix[:, _IDX["swap_exposed_mean_s"]], p) or 0.0,
                    "moe_local_load": _peer_median(
                        matrix[:, _IDX["moe_local_load"]], p),
                }
                lane = attribute_straggler_lane(
                    row, median_row,
                    ep_imbalance_ratio=self.ep_imbalance_ratio)
                self.stragglers_flagged += 1
                events.append({
                    R.F_KIND: R.KIND_HEALTH,
                    R.H_EVENT: R.EVENT_STRAGGLER,
                    R.F_HOST: hosts[p] if p < len(hosts) else f"p{p}",
                    R.F_PROCESS_INDEX: p,
                    # matrix rows = participating processes, so the row
                    # count IS the world size (schema-v2 identity triple)
                    R.F_WORLD_SIZE: int(matrix.shape[0]),
                    R.H_STEP: step,
                    R.H_LANE: lane,
                    R.H_RATIO: round(ratio, 3),
                    R.H_ZSCORE: round(z, 2),
                    "step_time_s": round(t, 6),
                    "peer_median_s": round(ref_t, 6),
                    R.H_DETAIL: (
                        f"host step time {t * 1e3:.1f}ms is "
                        f"{ratio:.2f}x the peer median "
                        f"({ref_t * 1e3:.1f}ms), z={z:.1f}; "
                        f"lane: {lane}"),
                })
        # baseline learns from the ratio-clean hosts only (see above)
        for p in range(matrix.shape[0]):
            if finite[p] and not flagged[p]:
                self._stat.update(float(times[p]))

        events.extend(self._check_divergence(matrix, hosts, step))
        events.extend(self._check_moe(matrix, hosts, step))
        return events

    # metric-column -> human name for divergence events; both scalars
    # are globally reduced in a lockstep run, so per-host spread on
    # EITHER means a desynced replica (grad-norm typically moves first
    # — corrupt optimizer state shows there before the loss drifts)
    _DIVERGENCE_METRICS = (("loss_mean", "loss"),
                           ("grad_norm_mean", "grad_norm"))

    def _check_divergence(self, matrix: np.ndarray, hosts: List[str],
                          step: Optional[int]) -> List[Dict[str, Any]]:
        events: List[Dict[str, Any]] = []
        for column, metric in self._DIVERGENCE_METRICS:
            vals_all = matrix[:, _IDX[column]]
            finite = np.isfinite(vals_all)
            if finite.sum() < 2:
                continue
            vals = vals_all[finite]
            spread = float(vals.max() - vals.min())
            scale = max(abs(float(np.median(vals))), 1e-12)
            if spread / scale <= self.divergence_rel_spread:
                continue
            self.divergences_flagged += 1
            deviation = np.where(finite,
                                 np.abs(vals_all - float(np.median(vals))),
                                 -np.inf)
            outlier = int(np.argmax(deviation))
            # argmax breaks ties toward index 0 — on a 2-host fleet BOTH
            # hosts are equidistant from the midpoint median, so naming
            # argmax's winner would confidently blame a possibly-healthy
            # replica (and arm ITS profiler).  Ambiguous events name the
            # tied candidates and carry no process_index, so no host
            # self-arms a capture over them.
            tied = np.flatnonzero(
                finite & np.isclose(deviation, deviation[outlier],
                                    rtol=1e-9, atol=0.0))
            ambiguous = tied.size > 1
            if ambiguous:
                names = [hosts[i] if i < len(hosts) else f"p{i}"
                         for i in tied]
                host_label = "ambiguous:" + "+".join(names)
                proc: Optional[int] = None
                where = (f"candidates {', '.join(names)} are equidistant "
                         "from the fleet median — cannot attribute")
            else:
                host_label = (hosts[outlier] if outlier < len(hosts)
                              else f"p{outlier}")
                proc = outlier
                where = f"replica {host_label} is farthest from the fleet"
            events.append({
                R.F_KIND: R.KIND_HEALTH,
                R.H_EVENT: R.EVENT_DIVERGENCE,
                R.F_HOST: host_label,
                R.F_PROCESS_INDEX: proc,
                R.F_WORLD_SIZE: int(matrix.shape[0]),
                R.H_STEP: step,
                R.H_METRIC: metric,
                R.H_RATIO: round(spread / scale, 6),
                # metric-neutral key; the legacy loss_spread name rides
                # only on loss events (a grad-norm magnitude must never
                # land under a loss-labeled field)
                R.H_SPREAD: round(spread, 6),
                **({R.FL_LOSS_SPREAD: round(spread, 6)}
                   if metric == "loss" else {}),
                R.H_DETAIL: (
                    f"per-host {metric} spread {spread:.3g} "
                    f"({spread / scale:.2%} of median {scale:.6g}) "
                    f"exceeds {self.divergence_rel_spread:.2%} — "
                    f"{where}"),
            })
        return events

    # ------------------------------------------------------------------ #
    # MoE health rules : dead expert, router collapse, EP
    # load imbalance — all deterministic (same matrix in, same events
    # out on every host), all K-consecutive-window gated, all NaN-inert
    # on dense configs (the moe_* slots simply never go finite).
    # ------------------------------------------------------------------ #
    def _fleet_scalar(self, matrix: np.ndarray, field: str
                      ) -> Optional[float]:
        """Fleet-global moe scalar: the gating math is replicated, so
        every host reports the same value — the median shrugs off a
        host that missed the window (NaN)."""
        col = matrix[:, _IDX[field]]
        finite = col[np.isfinite(col)]
        return float(np.median(finite)) if finite.size else None

    def _check_moe(self, matrix: np.ndarray, hosts: List[str],
                   step: Optional[int]) -> List[Dict[str, Any]]:
        events: List[Dict[str, Any]] = []
        world = int(matrix.shape[0])

        def base(event: str) -> Dict[str, Any]:
            return {R.F_KIND: R.KIND_HEALTH, R.H_EVENT: event,
                    R.F_WORLD_SIZE: world, R.H_STEP: step}

        # -- dead expert: the coldest expert's share of the fair
        # per-expert load sits at/below the threshold K windows running.
        # Model-level pathology (the router starved an expert), so the
        # event carries no process identity — no host self-arms a
        # capture over it; the record stream and sentinel ring get it.
        min_frac = self._fleet_scalar(matrix, "moe_min_count_frac")
        if min_frac is not None and min_frac <= self.dead_expert_threshold:
            self._dead_streak += 1
        else:
            self._dead_streak = 0
        if self._dead_streak >= self.dead_expert_windows:
            cold = self._fleet_scalar(matrix, "moe_coldest_expert")
            self.moe_events_flagged += 1
            events.append({
                **base(R.EVENT_DEAD_EXPERT),
                R.F_HOST: "fleet", R.F_PROCESS_INDEX: None,
                R.H_RATIO: round(min_frac, 6),
                "expert": int(cold) if cold is not None else None,
                "consecutive_windows": self._dead_streak,
                R.H_DETAIL: (
                    f"expert {int(cold) if cold is not None else '?'} "
                    f"received {min_frac * 100:.2f}% of its fair token "
                    f"share for {self._dead_streak} consecutive windows "
                    f"(threshold {self.dead_expert_threshold * 100:.1f}%)"
                    " — a dead expert wastes its parameters and, under "
                    "expert streaming, its NVMe slot"),
            })

        # -- router collapse: normalized entropy under the floor K
        # windows running — the router concentrated onto a few experts
        # (l_aux too weak / gate logits saturated); capacity drops and
        # dead experts follow.
        ent = self._fleet_scalar(matrix, "moe_entropy")
        if ent is not None and ent <= self.entropy_floor:
            self._collapse_streak += 1
        else:
            self._collapse_streak = 0
        if self._collapse_streak >= self.collapse_windows:
            self.moe_events_flagged += 1
            events.append({
                **base(R.EVENT_ROUTER_COLLAPSE),
                R.F_HOST: "fleet", R.F_PROCESS_INDEX: None,
                R.H_RATIO: round(ent, 6),
                "consecutive_windows": self._collapse_streak,
                R.H_DETAIL: (
                    f"normalized router entropy {ent:.4f} has sat at or "
                    f"under the {self.entropy_floor:.2f} floor for "
                    f"{self._collapse_streak} consecutive windows — the "
                    "router is collapsing onto a few experts (raise "
                    "moe_aux_loss_coef or check the gate's lr)"),
            })

        # -- EP load imbalance: a host whose LOCAL experts carry >=
        # ratio x the leave-one-out peer-median load for K consecutive
        # windows.  Per-host: the flagged host gets the event (and arms
        # its own capture), lane-attributed as an expert hot-spot so
        # the verdict reads "expert hot-spot on host w2", not generic
        # compute.
        load = matrix[:, _IDX["moe_local_load"]]
        seen = set()
        for p in range(world):
            v = float(load[p])
            if not math.isfinite(v):
                continue
            seen.add(p)
            ref = _peer_median(load, p)
            ratio = v / ref if ref else 1.0
            if ref and ratio >= self.ep_imbalance_ratio:
                self._ep_streaks[p] = self._ep_streaks.get(p, 0) + 1
            else:
                self._ep_streaks[p] = 0
                continue
            if self._ep_streaks[p] < self.ep_imbalance_windows:
                continue
            host = hosts[p] if p < len(hosts) else f"p{p}"
            self.moe_events_flagged += 1
            events.append({
                **base(R.EVENT_EP_IMBALANCE),
                R.F_HOST: host, R.F_PROCESS_INDEX: p,
                R.H_LANE: ATTR_EXPERT_HOTSPOT,
                R.H_RATIO: round(ratio, 3),
                "local_load": round(v, 4),
                "peer_median_load": round(ref, 4),
                "consecutive_windows": self._ep_streaks[p],
                R.H_DETAIL: (
                    f"expert hot-spot on host {host}: its local experts "
                    f"carry {v:.2f}x their fair token share, "
                    f"{ratio:.2f}x the peer median ({ref:.2f}), for "
                    f"{self._ep_streaks[p]} consecutive windows — "
                    "rebalance experts or tune capacity_factor"),
            })
        # a host that left the fleet (elastic reshape) drops its streak
        for p in list(self._ep_streaks):
            if p not in seen:
                del self._ep_streaks[p]
        return events

    def counters(self) -> Dict[str, int]:
        return {"fleet_windows": self.windows_seen,
                "stragglers_flagged": self.stragglers_flagged,
                "divergences_flagged": self.divergences_flagged,
                "moe_events_flagged": self.moe_events_flagged}


def _peer_median(col: np.ndarray, p: int) -> Optional[float]:
    """Median of the OTHER hosts' finite values (leave-one-out).

    The straggler gate must mean "X times a healthy peer".  A median
    that includes the candidate is dragged toward it on small fleets —
    on P=2 it is the midpoint of the pair, so a host 30% slower than
    its peer reads as only ~1.13x "the fleet" and slips a 1.15 gate
    (and, unflagged, keeps polluting the EWMA baseline).  None when the
    host has no finite peers (single-host fleet)."""
    mask = np.isfinite(col)
    if 0 <= p < mask.size:
        mask[p] = False
    vals = col[mask]
    return float(np.median(vals)) if vals.size else None


def _none_nan(v: float) -> Optional[float]:
    v = float(v)
    return None if math.isnan(v) else v


def _window_step(matrix: np.ndarray) -> Optional[int]:
    steps = matrix[:, _IDX["last_step"]]
    finite = steps[np.isfinite(steps)]
    return int(finite.max()) if finite.size else None


def straggler_verdict(matrix: np.ndarray,
                      hosts: Optional[List[str]] = None,
                      min_ratio: float =
                      C.MONITOR_STRAGGLER_MIN_RATIO_DEFAULT,
                      ep_imbalance_ratio: float =
                      C.MONITOR_MOE_EP_IMBALANCE_RATIO_DEFAULT
                      ) -> Dict[str, Any]:
    """Single-window cross-sectional verdict (no EWMA history) — the
    form a benchmark row embeds: with one measured window there is no baseline
    to z-score against, so the verdict is purely ratio-vs-fleet-median.
    A 1-host matrix is the degenerate case: ratio 1.0, no straggler.
    ``ep_imbalance_ratio`` gates the expert-hotspot lane exactly like
    the live detector — pass the configured monitor.moe value so the
    two surfaces can never disagree on the same window matrix."""
    matrix = np.asarray(matrix, dtype=np.float64)
    hosts = hosts or [f"p{i}" for i in range(matrix.shape[0])]
    times = matrix[:, _IDX["step_time_mean_s"]]
    finite = np.isfinite(times)
    if not finite.any():
        return {"straggler": False, "ratio": None, "host": None}
    worst = int(np.argmax(np.where(finite, times, -np.inf)))
    # leave-one-out reference, same rationale as FleetHealth.observe:
    # on a 2-host row the all-host median is the midpoint of the pair
    # and halves the worst host's measured excess
    ref_t = _peer_median(times, worst)
    ratio = (float(times[worst]) / ref_t) if ref_t else 1.0
    out: Dict[str, Any] = {"straggler": bool(ratio >= min_ratio),
                           "ratio": round(ratio, 3),
                           "host": None}
    if out["straggler"]:
        row = {name: _none_nan(matrix[worst, i])
               for name, i in _IDX.items()}
        median_row = {
            "step_time_mean_s": ref_t,
            "host_gap_mean_s": _peer_median(
                matrix[:, _IDX["host_gap_mean_s"]], worst) or 0.0,
            "swap_exposed_mean_s": _peer_median(
                matrix[:, _IDX["swap_exposed_mean_s"]], worst) or 0.0,
            "moe_local_load": _peer_median(
                matrix[:, _IDX["moe_local_load"]], worst),
        }
        out["host"] = hosts[worst] if worst < len(hosts) else f"p{worst}"
        out["lane"] = attribute_straggler_lane(
            row, median_row, ep_imbalance_ratio=ep_imbalance_ratio)
    return out


def format_health_line(ev: Dict[str, Any]) -> str:
    # ambiguous divergence events carry no process index by design —
    # the host label already lists the tied candidates
    p = ev.get(R.F_PROCESS_INDEX)
    who = f"{ev.get(R.F_HOST)}" + (f" (p{p})" if p is not None else "")
    return (f"[monitor-health] {ev.get(R.H_EVENT)} on {who} "
            f"@ step {ev.get(R.H_STEP)}: {ev.get(R.H_DETAIL)}")
