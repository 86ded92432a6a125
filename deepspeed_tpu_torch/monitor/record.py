"""Step-record schema — the single source of metric field names
(counterpart of deepspeed_tpu/monitor/record.py, field for field).

One optimizer step produces one structured record.  Every consumer —
the JSONL/CSV/TensorBoard writers and the reconciliation report —
imports these names instead of spelling its own, so a field rename is a
one-file change.  The names, kinds and SCHEMA_VERSION are the JAX
package's, so records from the two packages are interchangeable for the
tooling that reads them.

The record is assembled with BOUNDARY-ONLY host reads: per-step fields
are either pure host state (wall time, counters) or device scalar
*references* that the MetricsStream batches into one transfer at the
flush window boundary (monitor.py).  Nothing in this module reads the
device per step: CUDA work is queued asynchronously behind the host, and
a per-step read would make the host wait for it.
"""

from typing import Any, Dict, Optional

import torch

# Schema version of the record stream.  v1 had no host identity;
# v2 adds host / process_index / world_size to every
# single-host-attributable record plus the fleet/health record kinds
# (the `fleet` aggregate carries world_size and per-host columns — it
# describes the whole fleet, so a single host identity would mislead).
# The version rides every meta record and the trace file's otherData so
# a consumer can tell which era a stream came from.
SCHEMA_VERSION = 2

# ---- record kinds ---------------------------------------------------- #
KIND_STEP = "step"
KIND_RECONCILE = "reconcile"
KIND_META = "meta"
# fleet-aggregation kinds (monitor/fleet.py): one record per host per
# flush window, one fleet-aggregate record per window, and structured
# health events (monitor/health.py)
KIND_FLEET_HOST = "fleet_host"
KIND_FLEET = "fleet"
KIND_HEALTH = "health"
# MoE routing telemetry (the JAX package's monitor/moe.py, which the
# port takes with MoE, ROADMAP.md A.10): one record per flush window
# summarizing the device-resident RoutingStats accumulator — expert
# popularity, drop/overflow accounting, router entropy/confidence
KIND_MOE = "moe"
# resilience plane (runtime/resilience): a fired chaos-injected fault
# (post-mortems separate injected from organic failures) and a fallback-
# ladder step-down from the degradation registry
KIND_CHAOS = "chaos"
KIND_DEGRADATION = "degradation"

# ---- per-step field names (the schema) ------------------------------- #
F_KIND = "kind"
F_STEP = "step"
F_LOSS = "loss"
F_LR = "lr"
F_LOSS_SCALE = "loss_scale"
F_WALL_TIME_S = "wall_time_s"
F_TOKENS_PER_SEC = "tokens_per_sec"
F_MEM_PEAK_BYTES = "mem_peak_bytes"
F_MEM_IN_USE_BYTES = "mem_in_use_bytes"
F_MEM_SOURCE = "mem_source"
F_SKIPPED_STEPS = "skipped_steps"
F_SENTINEL_ANOMALIES = "sentinel_anomalies"
F_SENTINEL_SKIPS = "sentinel_skips"
F_RETRACES = "retraces"
F_DISPATCHES_PER_STEP = "dispatches_per_step"
# cumulative transient-I/O retries absorbed by the RetryPolicy
# (resilience/retry.py) — nonzero means the run rode out real faults
F_IO_RETRIES = "io_retries"
F_SWAP_READ_GBPS = "swap_read_gbps"
F_SWAP_OVERLAP_FRACTION = "swap_overlap_fraction"
F_SWAP_READ_VS_CEILING = "swap_read_vs_ceiling"
# host identity (schema v2): populated on every record, single-host runs
# included — a merged multi-host JSONL stream stays attributable per line
F_HOST = "host"
F_PROCESS_INDEX = "process_index"
F_WORLD_SIZE = "world_size"
# per-step host-gap: wall time between the previous step's end_step and
# this step's first forward (dataloader / host work the device waits on)
F_HOST_GAP_S = "host_gap_s"

# CSV column order; JSONL records carry the same names (plus any
# engine-specific extras, which CSV drops — CSV is the fixed-width view).
# Schema v2 appends the identity + host-gap columns after the v1 set, so
# v1 tooling reading by position keeps working on the shared prefix.
STEP_RECORD_FIELDS = (
    F_STEP, F_LOSS, F_LR, F_LOSS_SCALE, F_WALL_TIME_S, F_TOKENS_PER_SEC,
    F_MEM_PEAK_BYTES, F_MEM_IN_USE_BYTES, F_MEM_SOURCE,
    F_SKIPPED_STEPS, F_SENTINEL_ANOMALIES, F_SENTINEL_SKIPS, F_RETRACES,
    F_DISPATCHES_PER_STEP,
    F_SWAP_READ_GBPS, F_SWAP_OVERLAP_FRACTION, F_SWAP_READ_VS_CEILING,
    F_HOST_GAP_S, F_HOST, F_PROCESS_INDEX, F_WORLD_SIZE,
    # appended after the released v2 set (position-readers keep their
    # shared prefix): retry counters ride every step record
    F_IO_RETRIES,
)

# ---- fleet field names (fleet.py / health.py payloads) --------------- #
FL_WINDOW_START = "window_start_step"
FL_WINDOW_END = "window_end_step"
FL_HOSTS = "hosts"
FL_STEP_TIME_MEAN_S = "step_time_mean_s"
FL_STEP_TIME_MAX_S = "step_time_max_s"
FL_STEP_TIME_MIN_S = "step_time_min_s"
FL_STEP_TIME_MEDIAN_S = "step_time_median_s"
FL_STEP_TIME_P99_S = "step_time_p99_s"
FL_LOSS_MEAN = "loss_mean"
FL_LOSS_SPREAD = "loss_spread"
FL_HOST_GAP_MEAN_S = "host_gap_mean_s"
FL_SWAP_READ_GBPS = "swap_read_gbps"
FL_SWAP_EXPOSED_S = "swap_exposed_mean_s"
FL_PER_HOST = "per_host"
# MoE routing slots (fleet.py moe_* vector fields; absent on dense runs)
FL_MOE_DROP_FRAC = "moe_drop_frac"
FL_MOE_LOCAL_LOAD = "moe_local_load"
FL_MOE_LOAD_MAX = "moe_local_load_max"
# health-event field names (health.py)
H_EVENT = "event"
H_STEP = "step"
H_LANE = "lane"
H_RATIO = "ratio"
H_ZSCORE = "zscore"
H_DETAIL = "detail"
H_METRIC = "metric"
H_SPREAD = "spread"
EVENT_STRAGGLER = "straggler"
EVENT_DIVERGENCE = "divergence"
# MoE health events (health.py MoE rules)
EVENT_DEAD_EXPERT = "dead_expert"
EVENT_ROUTER_COLLAPSE = "router_collapse"
EVENT_EP_IMBALANCE = "ep_imbalance"

# ---- MoE routing field names (the moe record's payload) ---------------- #
M_WINDOW_START = "window_start_step"
M_WINDOW_END = "window_end_step"
M_STEPS = "steps"
M_EXPERTS = "num_experts"
M_LAYERS_PER_STEP = "layers_per_step"
M_TOKENS_PER_STEP = "tokens_per_step"
M_DROP_FRAC = "drop_fraction"
M_COUNTS = "expert_counts"
M_OVERFLOW = "overflow_counts"
M_IMBALANCE = "imbalance"          # hottest / mean routed count
M_MIN_COUNT_FRAC = "min_count_frac"  # coldest / fair share
M_ENTROPY = "router_entropy"       # normalized [0, 1] (1 = uniform)
M_CONFIDENCE = "router_confidence"  # mean raw top-k gate mass per token
M_LAUX = "l_aux_mean"              # per gate invocation
M_LOCAL_LOAD = "local_expert_load"  # this host's load vs fair share
M_POPULARITY = "popularity"        # embedded ExpertPopularitySnapshot

# ---- reconciliation field names (reconcile.py payload) --------------- #
R_WINDOW_START = "window_start_step"
R_WINDOW_END = "window_end_step"
R_MEASURED_STEP_S = "measured_step_time_s"
R_PREDICTED_STEP_S = "predicted_step_time_lb_s"
R_STEP_RATIO = "step_time_ratio"
R_LANES = "lanes"
R_ATTRIBUTION = "attribution"
R_MEASURED_HBM = "measured_hbm_peak_bytes"
R_PREDICTED_HBM = "predicted_hbm_peak_bytes"
R_HBM_RATIO = "hbm_ratio"
R_SWAP_GBPS = "swap_read_gbps"
R_SWAP_CEILING_GBPS = "swap_ceiling_gbps"
R_SWAP_VS_CEILING = "swap_read_vs_ceiling"
R_OVERLAP_FRACTION = "swap_overlap_fraction"
R_FLAGS = "flags"


def device_memory(device=None) -> Dict[str, Any]:
    """Measured memory high-water, one bounded read.

    On a CUDA `device`, the caching allocator's own counters
    (`torch.cuda.max_memory_allocated` / `memory_allocated`: the peak since
    the process started or since the caller last reset it, and what is
    allocated now).  Elsewhere (the CPU) the process RSS high-water
    (``ru_maxrss``) stands in, labeled via ``mem_source`` so a record
    never passes host RSS off as device memory."""
    try:
        dev = torch.device(device) if device is not None else None
        if dev is not None and dev.type == "cuda":
            return {F_MEM_PEAK_BYTES: int(torch.cuda.max_memory_allocated(dev)),
                    F_MEM_IN_USE_BYTES: int(torch.cuda.memory_allocated(dev)),
                    F_MEM_SOURCE: "device"}
    except Exception:  # noqa: BLE001 — monitoring must never crash a step
        pass
    try:
        import resource
        import sys
        ru = resource.getrusage(resource.RUSAGE_SELF)
        # linux reports ru_maxrss in KiB; macOS/BSD report bytes
        unit = 1024 if sys.platform.startswith("linux") else 1
        return {F_MEM_PEAK_BYTES: int(ru.ru_maxrss) * unit,
                F_MEM_IN_USE_BYTES: None,
                F_MEM_SOURCE: "host_rss"}
    except Exception:  # noqa: BLE001
        return {F_MEM_PEAK_BYTES: None, F_MEM_IN_USE_BYTES: None,
                F_MEM_SOURCE: "unavailable"}


def identity(process_index: Optional[int] = None,
             world_size: Optional[int] = None,
             host: Optional[str] = None) -> Dict[str, Any]:
    """The host-identity triple every v2 record carries.  Defaults are
    resolved from the running process (its rank and world in the
    torch.distributed group when one is up, else 0 / 1, and the hostname)
    so single-process runs populate them too."""
    if process_index is None or world_size is None:
        rank, world = 0, 1
        try:
            import torch.distributed as dist
            if dist.is_available() and dist.is_initialized():
                rank, world = dist.get_rank(), dist.get_world_size()
        except Exception:  # noqa: BLE001 — identity must never crash
            pass
        if process_index is None:
            process_index = rank
        if world_size is None:
            world_size = world
    if host is None:
        import socket
        try:
            host = socket.gethostname()
        except Exception:  # noqa: BLE001
            host = f"host{process_index}"
    return {F_HOST: host, F_PROCESS_INDEX: int(process_index),
            F_WORLD_SIZE: int(world_size)}


def make_step_record(step: int, loss: Optional[float], wall_s: float,
                     tokens: Optional[int], counters: Dict[str, Any],
                     boundary: Dict[str, Any],
                     memory: Dict[str, Any],
                     swap: Optional[Dict[str, Any]] = None,
                     extra: Optional[Dict[str, Any]] = None,
                     host_gap_s: Optional[float] = None
                     ) -> Dict[str, Any]:
    """Assemble one step record from already-fetched host values."""
    rec: Dict[str, Any] = {F_KIND: KIND_STEP, F_STEP: int(step)}
    rec[F_LOSS] = loss
    rec[F_HOST_GAP_S] = (round(float(host_gap_s), 6)
                         if host_gap_s is not None else None)
    rec[F_WALL_TIME_S] = round(float(wall_s), 6) if wall_s else wall_s
    rec[F_TOKENS_PER_SEC] = (round(tokens / wall_s, 1)
                             if tokens and wall_s and wall_s > 0 else None)
    rec[F_LR] = boundary.get("lr")
    rec[F_LOSS_SCALE] = boundary.get("loss_scale")
    rec.update(memory)
    for k in (F_SKIPPED_STEPS, F_SENTINEL_ANOMALIES, F_SENTINEL_SKIPS,
              F_RETRACES, F_DISPATCHES_PER_STEP, F_IO_RETRIES):
        rec[k] = counters.get(k)
    if swap:
        rec[F_SWAP_READ_GBPS] = swap.get("read_gbps")
        rec[F_SWAP_OVERLAP_FRACTION] = swap.get("overlap_fraction")
        rec[F_SWAP_READ_VS_CEILING] = swap.get("read_vs_ceiling")
    else:
        rec[F_SWAP_READ_GBPS] = None
        rec[F_SWAP_OVERLAP_FRACTION] = None
        rec[F_SWAP_READ_VS_CEILING] = None
    if extra:
        rec.update(extra)
    return rec
