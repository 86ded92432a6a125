"""Measured-vs-predicted reconciliation — the honesty report
(counterpart of deepspeed_tpu/monitor/reconcile.py; pure Python).

In the JAX package the Program/Schedule Auditor predicts step time (a
roofline lower bound), peak device memory (a liveness estimate), and the
aio sweep measures a disk ceiling; the monitor measures what actually
happened.  This module closes the loop: each flush window compares the
two sides and ATTRIBUTES the gap to a cost-model lane — compute-bound,
io-bound (device memory or swap), comm-hidden, or comm-exposed — so a
slow run says *why* it is slow instead of just *that* it is (the
ZeRO-Infinity methodology: attribute step time to compute/NVMe/comm
lanes, arXiv:2104.07857).

The port has no auditor yet (ROADMAP.md A.14) and no offload tier
(A.7): its engine reconciles with no predictions, so every window's
payload carries the measured values and an empty comparison, still
self-describing.  Everything here is pure host math over already-fetched
numbers, so rigged predicted/measured pairs test the band logic exactly.

Interpretation contract: the predicted step time is a LOWER BOUND —
measured *below* it means the model's hardware constants are wrong for
this host (``model_violation`` flag); measured far above it bounds what
the schedule leaves on the table (``step_time_above_band`` with the lane
attribution).
"""

from dataclasses import dataclass
from typing import Any, Dict, Optional

from . import record as R

# flag names (single-sourced for tests/consumers)
FLAG_MODEL_VIOLATION = "model_violation"
FLAG_STEP_TIME_ABOVE_BAND = "step_time_above_band"
FLAG_HBM_ABOVE_BAND = "hbm_above_band"
FLAG_HBM_BELOW_BAND = "hbm_below_band"
FLAG_SWAP_BELOW_CEILING = "swap_below_ceiling_band"

# measured-below-lower-bound tolerance: timer jitter on a sub-ms step
# must not cry model violation
_VIOLATION_TOL = 0.98

# attribution labels (per the cost-model lanes)
ATTR_COMPUTE = "compute-bound"
ATTR_IO = "io-bound"
ATTR_COMM_HIDDEN = "comm-hidden"
ATTR_COMM_EXPOSED = "comm-exposed"
ATTR_SWAP = "io-bound (swap exposed)"
# fleet-health lane (health.py straggler attribution): the excess step
# time sits BETWEEN dispatches — dataloader / host work, not the device
ATTR_HOST_GAP = "host-gap"
# fleet-health lane (health.py MoE rules): the host's excess is explained
# by expert-parallel load skew — its local experts carry more than the
# peer-median share of routed tokens, so its expert FFN pass is longer
# ("expert hot-spot on host w2" instead of generic compute)
ATTR_EXPERT_HOTSPOT = "expert-hotspot"

_LANE_ATTR = {"compute": ATTR_COMPUTE, "memory": ATTR_IO,
              "hidden_comm": ATTR_COMM_HIDDEN,
              # the cost model's offload-tier lane (swap traffic priced
              # at the aio sweep ceiling) attributes as swap-exposed io
              "swap": ATTR_SWAP}


@dataclass
class Bands:
    """Configurable acceptance bands (monitor config block)."""
    step_time_ratio_max: float = 10.0
    hbm_ratio_max: float = 2.0
    swap_min_vs_ceiling: float = 0.25


def attribute_gap(lanes: Dict[str, Any],
                  swap: Optional[Dict[str, Any]] = None,
                  measured_step_s: Optional[float] = None) -> str:
    """Name the lane responsible for the measured time, per the model.

    Swap-tier evidence wins when present: if the streaming engine paid a
    meaningful share of the measured step blocked on NVMe reads, the run
    is io-bound on the swap tier no matter what the on-chip roofline
    says.  Otherwise: exposed comm dominates if it exceeds the binding
    roofline term; else the binding term itself names the lane."""
    if swap and measured_step_s:
        exposed_io = float(swap.get("read_exposed_s") or 0.0) + \
            float(swap.get("write_exposed_s") or 0.0)
        if exposed_io > 0.25 * measured_step_s:
            return ATTR_SWAP
    if not lanes:
        return "unattributed"
    # "swap" joins the binding set only when the static model priced an
    # offload tier (older payloads / non-offload configs carry no key)
    cands = ["compute", "memory", "hidden_comm"]
    if float(lanes.get("swap") or 0.0) > 0.0:
        cands.append("swap")
    binding = max(cands, key=lambda k: float(lanes.get(k) or 0.0))
    exposed = float(lanes.get("exposed_comm") or 0.0)
    if exposed > float(lanes.get(binding) or 0.0):
        return ATTR_COMM_EXPOSED
    return _LANE_ATTR[binding]


def reconcile_window(measured: Dict[str, Any],
                     predicted: Optional[Dict[str, Any]],
                     bands: Bands) -> Dict[str, Any]:
    """One window's reconciliation payload.

    ``measured``: step_time_s (mean over the window), hbm_peak_bytes,
    and optionally the swap-stats dict of an offload tier's
    accounting (read_gbps / sweep_read_gbps / overlap_fraction
    / read_exposed_s ...).

    ``predicted``: {"predicted_step_time_lb_s", "lanes"
    (cost_model.per_lane_predictions), "peak_hbm_bytes"} or None when no
    static model is available (the payload then carries measured values
    and an empty comparison — still self-describing)."""
    predicted = predicted or {}
    swap = measured.get("swap") or {}
    out: Dict[str, Any] = {R.F_KIND: R.KIND_RECONCILE, R.R_FLAGS: []}
    out[R.R_WINDOW_START] = measured.get("window_start_step")
    out[R.R_WINDOW_END] = measured.get("window_end_step")

    # ---- step time ------------------------------------------------ #
    m_t = measured.get("step_time_s")
    p_t = predicted.get("predicted_step_time_lb_s")
    lanes = predicted.get("lanes") or {}
    out[R.R_MEASURED_STEP_S] = (round(float(m_t), 6)
                                if m_t is not None else None)
    out[R.R_PREDICTED_STEP_S] = (round(float(p_t), 6)
                                 if p_t is not None else None)
    out[R.R_LANES] = {k: round(float(v), 6)
                      for k, v in lanes.items()
                      if isinstance(v, (int, float))} or None
    out[R.R_STEP_RATIO] = None
    out[R.R_ATTRIBUTION] = None
    if m_t and p_t and p_t > 0:
        ratio = float(m_t) / float(p_t)
        out[R.R_STEP_RATIO] = round(ratio, 3)
        out[R.R_ATTRIBUTION] = attribute_gap(lanes, swap, float(m_t))
        if ratio < _VIOLATION_TOL:
            out[R.R_FLAGS].append(FLAG_MODEL_VIOLATION)
        elif ratio > bands.step_time_ratio_max:
            out[R.R_FLAGS].append(FLAG_STEP_TIME_ABOVE_BAND)

    # ---- HBM high-water ------------------------------------------- #
    m_hbm = measured.get("hbm_peak_bytes")
    p_hbm = predicted.get("peak_hbm_bytes")
    mem_source = measured.get("mem_source")
    out[R.R_MEASURED_HBM] = m_hbm
    out[R.R_PREDICTED_HBM] = p_hbm
    out[R.R_HBM_RATIO] = None
    if m_hbm and p_hbm and mem_source == "device":
        # host-RSS fallback readings (CPU runs) are not comparable to the
        # HBM liveness estimate — compare only real allocator stats
        ratio = float(m_hbm) / float(p_hbm)
        out[R.R_HBM_RATIO] = round(ratio, 3)
        if ratio > bands.hbm_ratio_max:
            out[R.R_FLAGS].append(FLAG_HBM_ABOVE_BAND)
        elif ratio < 1.0 / bands.hbm_ratio_max:
            out[R.R_FLAGS].append(FLAG_HBM_BELOW_BAND)
    if mem_source is not None:
        out[R.F_MEM_SOURCE] = mem_source

    # ---- swap tier vs sweep ceiling -------------------------------- #
    out[R.R_SWAP_GBPS] = swap.get("read_gbps")
    out[R.R_SWAP_CEILING_GBPS] = swap.get("sweep_read_gbps")
    out[R.R_SWAP_VS_CEILING] = swap.get("read_vs_ceiling")
    out[R.R_OVERLAP_FRACTION] = swap.get("overlap_fraction")
    vs = swap.get("read_vs_ceiling")
    if vs is not None and vs < bands.swap_min_vs_ceiling:
        out[R.R_FLAGS].append(FLAG_SWAP_BELOW_CEILING)
    return out


def bare_summary(rec: Dict[str, Any]) -> Dict[str, Any]:
    """A reconciliation payload without its stream-record envelope
    (kind + window keys) — the embeddable form a benchmark row carries."""
    out = dict(rec)
    for key in (R.F_KIND, R.R_WINDOW_START, R.R_WINDOW_END):
        out.pop(key, None)
    return out


def format_line(rec: Dict[str, Any]) -> str:
    """One-line log form of a reconciliation payload."""
    bits = []
    if rec.get(R.R_STEP_RATIO) is not None:
        bits.append(f"step {rec[R.R_MEASURED_STEP_S] * 1e3:.1f}ms vs "
                    f"lb {rec[R.R_PREDICTED_STEP_S] * 1e3:.1f}ms "
                    f"(x{rec[R.R_STEP_RATIO]:.2f}, "
                    f"{rec[R.R_ATTRIBUTION]})")
    if rec.get(R.R_HBM_RATIO) is not None:
        bits.append(f"hbm x{rec[R.R_HBM_RATIO]:.2f} of estimate")
    if rec.get(R.R_SWAP_VS_CEILING) is not None:
        bits.append(f"swap {rec[R.R_SWAP_VS_CEILING]:.0%} of ceiling")
    if rec.get(R.R_FLAGS):
        bits.append("FLAGS: " + ",".join(rec[R.R_FLAGS]))
    window = f"[{rec.get(R.R_WINDOW_START)}-{rec.get(R.R_WINDOW_END)}]"
    return f"[monitor-reconcile] {window} " + ("; ".join(bits) if bits
                                               else "no comparisons")
