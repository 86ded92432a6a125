"""Cross-host aggregation — the fleet half of the telemetry subsystem
(counterpart of deepspeed_tpu/monitor/fleet.py; the window-vector layout
is the JAX package's, slot for slot).

A single monitor sees exactly one process.  Across processes, every
failure mode that matters — a straggler host dragging the lockstep
collectives, a diverging replica, a slow swap tier on one host — is
invisible from rank 0's own scalars.  This module closes that gap
without touching the hot loop:

  * every process compresses its flush window into a FIXED-SHAPE float64
    vector (``encode_window_vector`` — the field list is static, missing
    values ride as NaN, so the exchange never changes shape);
  * at flush-window boundaries — and ONLY there, never per step, never
    on the final/partial flush where processes may have drifted apart —
    one host-side all-gather ships every process's vector to every
    process (``FleetAggregator.exchange``).  All processes receive the
    full [P, V] matrix so each can run the SAME deterministic health
    detection locally (monitor/health.py) and a flagged process can arm
    its own profiler capture (monitor/capture.py) without a second
    round-trip or a broadcast;
  * rank 0 turns the matrix into per-host and fleet-aggregate records
    (min/median/max/p99 step time, per-host swap GB/s and host-gap) and
    emits them through the existing writer thread.

The exchange is an all-gather of a CPU tensor over a gloo process group
that the engine makes at init for the monitor alone
(``process_group_gather``).  It never shares an NCCL communicator or a
CUDA stream with the step: the deadline watchdog runs it on a second
thread, which must not issue collectives beside the engine's own, and a
captured fused step holds NCCL work in its CUDA graph.  Host names
cannot ride a float all-gather, so they are exchanged ONCE at init as a
fixed-width byte matrix.
"""

import math
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from . import record as R

# ---- the fixed window-vector layout ---------------------------------- #
# One slot per scalar; the tuple order IS the wire layout.  Extending it
# is a one-line change here plus consumers — never reorder released
# slots (a mixed-version pod would silently transpose metrics).
VEC_FIELDS = (
    "last_step",            # last global step in the window
    "steps",                # records in the window
    "step_time_mean_s",     # mean delivered (arrival-to-arrival) step time
    "step_time_max_s",
    "loss_mean",            # mean of the window's fetched losses
    "host_gap_mean_s",      # mean host gap (end_step -> next forward)
    "swap_read_gbps",       # achieved swap-tier read bandwidth
    "swap_exposed_mean_s",  # mean per-step exposed (caller-blocked) swap
    "grad_norm_mean",       # mean global grad norm (sentinel-fed; NaN
                            # when no host-side norm is computed)
    # ---- MoE routing slots (filled by monitor.moe, which the port takes
    # with MoE, ROADMAP.md A.10; NaN = absent on dense configs or with
    # monitor.moe off) — appended after the v2 set so
    # positional readers of the released slots keep working ------------ #
    "moe_drop_frac",        # capacity-dropped fraction of routed slots
    "moe_entropy",          # normalized router entropy (1 = uniform)
    "moe_imbalance",        # hottest / mean routed expert count
    "moe_min_count_frac",   # coldest expert count / fair share
    "moe_coldest_expert",   # coldest expert id (float-encoded index)
    "moe_local_load",       # this host's local-expert load / fair share
)
VEC_LEN = len(VEC_FIELDS)
_IDX = {name: i for i, name in enumerate(VEC_FIELDS)}

_HOSTNAME_BYTES = 64


def encode_window_vector(summary: Dict[str, Any]) -> np.ndarray:
    """Window summary dict -> fixed-shape float64 vector (NaN = absent)."""
    vec = np.full(VEC_LEN, np.nan, dtype=np.float64)
    for name, i in _IDX.items():
        v = summary.get(name)
        if v is None:
            continue
        try:
            vec[i] = float(v)
        except (TypeError, ValueError):
            pass
    return vec


def decode_window_vector(vec: np.ndarray) -> Dict[str, Optional[float]]:
    """Inverse of encode: NaN slots come back as None."""
    out: Dict[str, Optional[float]] = {}
    for name, i in _IDX.items():
        v = float(vec[i])
        out[name] = None if math.isnan(v) else v
    return out


def _encode_host(host: str) -> np.ndarray:
    raw = host.encode("utf-8", "replace")[:_HOSTNAME_BYTES]
    buf = np.zeros(_HOSTNAME_BYTES, dtype=np.uint8)
    buf[:len(raw)] = np.frombuffer(raw, dtype=np.uint8)
    return buf


def _decode_host(row: np.ndarray) -> str:
    raw = bytes(row.astype(np.uint8))
    return raw.rstrip(b"\x00").decode("utf-8", "replace")


def process_group_gather(group) -> Callable[[np.ndarray], np.ndarray]:
    """The exchange over `group` (a gloo process group): all-gather a
    fixed-shape host array across its processes -> [P, ...].

    A collective: every process must call it at the same point, which the
    lockstep flush-window cadence guarantees (all processes step
    together, windows close by step count)."""
    import torch
    import torch.distributed as dist

    def gather(vec: np.ndarray) -> np.ndarray:
        local = torch.from_numpy(np.ascontiguousarray(vec))
        parts = [torch.empty_like(local)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, local, group=group)
        return torch.stack(parts).numpy()

    return gather


class ExchangeTimeout(RuntimeError):
    """The window allgather missed its deadline.  Carries per-host
    attribution (``missing``: (process_index, host) pairs whose arrival
    evidence went dark) and converts into supervisor eviction events via
    :meth:`as_events` — a hang becomes an evictable, attributed event
    instead of a wedge."""

    def __init__(self, message: str,
                 missing: Optional[List[tuple]] = None,
                 deadline_s: float = 0.0):
        super().__init__(message)
        self.missing = list(missing or [])
        self.deadline_s = float(deadline_s)

    def missing_hosts(self) -> List[str]:
        return [f"p{p}:{h}" for p, h in self.missing] or ["<unattributed>"]

    def as_events(self) -> List[Dict[str, Any]]:
        """EVENT_DEAD-shaped dicts for SupervisorPolicy.observe_window —
        the watchdog's output feeds the existing eviction pathway."""
        detail = str(self)
        if not self.missing:
            return [{"event": "dead_worker", "process_index": None,
                     "host": None, "detail": detail}]
        return [{"event": "dead_worker", "process_index": p, "host": h,
                 "detail": detail} for p, h in self.missing]


class FleetAggregator:
    """Window-boundary fleet exchange + record assembly.

    ``gather_fn`` is the exchange over several processes (the engine
    passes ``process_group_gather`` of its gloo group); tests inject
    synthetic multi-host matrices through it (the fake-fleet harness)
    without a real distributed world.  With ``process_count == 1`` the
    exchange is a local stack — single-host runs emit the degenerate 1-host fleet
    records, so the record shape downstream tooling sees is identical.

    ``deadline_s > 0`` arms the exchange watchdog: the (blocking)
    allgather runs on a daemon thread under a timer, and on deadline an
    :class:`ExchangeTimeout` is raised naming the hosts whose arrival
    evidence (``arrival_fn``: process_index -> seconds since last seen,
    usually heartbeat file ages) exceeds the deadline.  Without a
    deadline the allgather may block forever, exactly as before."""

    def __init__(self, process_index: int = 0, process_count: int = 1,
                 host: Optional[str] = None,
                 gather_fn: Optional[Callable[[np.ndarray],
                                              np.ndarray]] = None,
                 deadline_s: float = 0.0,
                 arrival_fn: Optional[Callable[[], Dict[int, float]]]
                 = None):
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        ident = R.identity(process_index=process_index,
                           world_size=process_count, host=host)
        self.host = ident[R.F_HOST]
        self._gather = gather_fn
        self.deadline_s = float(deadline_s)
        self._arrival_fn = arrival_fn
        self.exchanges = 0
        self.timeouts = 0
        self._hosts: Optional[List[str]] = None

    # ------------------------------------------------------------------ #
    def _do_gather(self, arr: np.ndarray) -> np.ndarray:
        if self._gather is not None:
            return np.asarray(self._gather(arr))
        if self.process_count <= 1:
            return arr[None]
        raise RuntimeError(
            f"fleet exchange over {self.process_count} processes needs a "
            "gather_fn (process_group_gather over a gloo group)")

    def host_names(self) -> List[str]:
        """All hosts' names, pod order.  Exchanged ONCE (init-time side
        channel — strings cannot ride the float window gather); cached."""
        if self._hosts is None:
            mat = self._do_gather(_encode_host(self.host))
            self._hosts = [_decode_host(row) for row in mat]
            if len(self._hosts) != self.process_count:
                # a test gather_fn rigged for a different world: trust it
                self.process_count = len(self._hosts)
        return self._hosts

    def _missing_hosts(self) -> List[tuple]:
        """Per-host arrival accounting at timeout: every peer whose last
        evidence of life is older than the deadline gets named."""
        hosts = self._hosts or []
        if self._arrival_fn is None:
            return []
        try:
            ages = self._arrival_fn() or {}
        except Exception:  # noqa: BLE001 — attribution is best-effort
            return []
        out = []
        for p in range(self.process_count):
            if p == self.process_index:
                continue
            age = ages.get(p)
            if age is None or age > self.deadline_s:
                name = hosts[p] if p < len(hosts) else f"p{p}"
                out.append((p, name))
        return out

    def _gather_window(self, vec: np.ndarray) -> np.ndarray:
        """The exchange work itself.  The JAX package fires its chaos
        plane's fleet-exchange point here (a hang fault sleeps inside, so
        the watchdog deadline catches it like a wedged collective); the
        port has no chaos plane yet (ROADMAP.md A.13), so nothing fires."""
        return self._do_gather(vec)

    def _gather_under_deadline(self, vec: np.ndarray) -> np.ndarray:
        box: Dict[str, Any] = {}

        def work():
            try:
                box["mat"] = self._gather_window(vec)
            except BaseException as e:  # noqa: BLE001 — rethrown below
                box["exc"] = e

        t = threading.Thread(target=work, name="ds-fleet-exchange",
                             daemon=True)
        t.start()
        t.join(self.deadline_s)
        if t.is_alive():
            self.timeouts += 1
            missing = self._missing_hosts()
            names = ", ".join(f"p{p}:{h}" for p, h in missing) \
                or "<no per-host arrival evidence — enable " \
                   "monitor.heartbeat for attribution>"
            raise ExchangeTimeout(
                f"fleet exchange missed its {self.deadline_s:.1f}s "
                f"deadline (window {self.exchanges + 1}); missing hosts: "
                f"{names}", missing=missing, deadline_s=self.deadline_s)
        if "exc" in box:
            raise box["exc"]
        return box["mat"]

    def exchange(self, summary: Dict[str, Any]) -> np.ndarray:
        """One flush window's collective: encode, allgather, return the
        [P, VEC_LEN] matrix (every process gets the full fleet view)."""
        self.host_names()  # resolve labels before the first window
        vec = encode_window_vector(summary)
        if self.deadline_s > 0:
            mat = self._gather_under_deadline(vec)
        else:
            mat = self._gather_window(vec)
        self.exchanges += 1
        if mat.shape != (self.process_count, VEC_LEN):
            raise ValueError(
                f"fleet gather returned shape {mat.shape}, expected "
                f"{(self.process_count, VEC_LEN)} — mixed monitor schema "
                "versions across the pod?")
        return mat

    # ------------------------------------------------------------------ #
    # record assembly (rank 0 emits these through the writer thread)
    # ------------------------------------------------------------------ #
    def per_host_records(self, matrix: np.ndarray) -> List[Dict[str, Any]]:
        hosts = self.host_names()
        out = []
        for p, row in enumerate(np.asarray(matrix)):
            d = decode_window_vector(row)
            rec = {
                R.F_KIND: R.KIND_FLEET_HOST,
                R.F_HOST: hosts[p] if p < len(hosts) else f"p{p}",
                R.F_PROCESS_INDEX: p,
                R.F_WORLD_SIZE: len(hosts),
                R.FL_WINDOW_END: (int(d["last_step"])
                                  if d["last_step"] is not None else None),
                R.FL_STEP_TIME_MEAN_S: _r(d["step_time_mean_s"]),
                R.FL_STEP_TIME_MAX_S: _r(d["step_time_max_s"]),
                R.FL_LOSS_MEAN: _r(d["loss_mean"]),
                R.FL_HOST_GAP_MEAN_S: _r(d["host_gap_mean_s"]),
                R.FL_SWAP_READ_GBPS: _r(d["swap_read_gbps"]),
                R.FL_SWAP_EXPOSED_S: _r(d["swap_exposed_mean_s"]),
                R.FL_MOE_DROP_FRAC: _r(d["moe_drop_frac"]),
                R.FL_MOE_LOCAL_LOAD: _r(d["moe_local_load"]),
            }
            out.append(rec)
        return out

    def fleet_record(self, matrix: np.ndarray) -> Dict[str, Any]:
        """The fleet-aggregate view of one window's matrix."""
        matrix = np.asarray(matrix)
        summary = summarize_fleet(matrix)
        hosts = self.host_names()
        rec: Dict[str, Any] = {R.F_KIND: R.KIND_FLEET,
                               R.F_WORLD_SIZE: len(hosts)}
        rec.update(summary)
        # per-host scalar lists keyed in pod order — the at-a-glance
        # columns an operator scans for the odd host out
        gap = matrix[:, _IDX["host_gap_mean_s"]]
        swp = matrix[:, _IDX["swap_read_gbps"]]
        rec[R.FL_PER_HOST] = {
            "host": list(hosts),
            "step_time_s": _rlist(matrix[:, _IDX["step_time_mean_s"]]),
            "host_gap_s": _rlist(gap),
            "swap_read_gbps": _rlist(swp),
        }
        # expert-parallel load skew column, only when any host routed
        # (dense configs keep the fleet record exactly as before)
        load = matrix[:, _IDX["moe_local_load"]]
        if np.isfinite(load).any():
            rec[R.FL_PER_HOST]["moe_local_load"] = _rlist(load)
            drop = matrix[:, _IDX["moe_drop_frac"]]
            finite_drop = drop[np.isfinite(drop)]
            rec[R.FL_MOE_DROP_FRAC] = (_r(float(finite_drop.mean()))
                                       if finite_drop.size else None)
            rec[R.FL_MOE_LOAD_MAX] = _r(float(
                load[np.isfinite(load)].max()))
        return rec


def summarize_fleet(matrix: np.ndarray) -> Dict[str, Any]:
    """Fleet-aggregate scalars from a [P, VEC_LEN] window matrix — also
    the embeddable form a benchmark row carries."""
    matrix = np.asarray(matrix, dtype=np.float64)
    times = matrix[:, _IDX["step_time_mean_s"]]
    losses = matrix[:, _IDX["loss_mean"]]
    steps = matrix[:, _IDX["last_step"]]
    valid_t = times[np.isfinite(times)]
    valid_l = losses[np.isfinite(losses)]
    valid_s = steps[np.isfinite(steps)]
    out: Dict[str, Any] = {
        R.FL_HOSTS: int(matrix.shape[0]),
        R.FL_WINDOW_END: (int(valid_s.max()) if valid_s.size else None),
        R.FL_STEP_TIME_MIN_S: _r(valid_t.min()) if valid_t.size else None,
        R.FL_STEP_TIME_MEDIAN_S: (_r(float(np.median(valid_t)))
                                  if valid_t.size else None),
        R.FL_STEP_TIME_MAX_S: _r(valid_t.max()) if valid_t.size else None,
        R.FL_STEP_TIME_P99_S: (_r(float(np.percentile(valid_t, 99)))
                               if valid_t.size else None),
        R.FL_LOSS_MEAN: (_r(float(valid_l.mean()))
                         if valid_l.size else None),
        R.FL_LOSS_SPREAD: (_r(float(valid_l.max() - valid_l.min()))
                           if valid_l.size else None),
    }
    return out


def _r(v, nd: int = 6):
    if v is None:
        return None
    v = float(v)
    return None if math.isnan(v) else round(v, nd)


def _rlist(arr) -> List[Optional[float]]:
    return [_r(v) for v in np.asarray(arr, dtype=np.float64)]


def format_fleet_line(rec: Dict[str, Any]) -> str:
    """One-line log form of a fleet-aggregate record."""
    med = rec.get(R.FL_STEP_TIME_MEDIAN_S)
    mx = rec.get(R.FL_STEP_TIME_MAX_S)
    bits = [f"hosts={rec.get(R.FL_HOSTS)}"]
    if med is not None and mx is not None:
        bits.append(f"step med {med * 1e3:.1f}ms max {mx * 1e3:.1f}ms")
    spread = rec.get(R.FL_LOSS_SPREAD)
    if spread is not None:
        bits.append(f"loss spread {spread:.3g}")
    return "[monitor-fleet] " + " ".join(bits)
