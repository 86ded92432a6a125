"""Training-health sentinel: EWMA monitor of loss and global grad-norm
(counterpart of deepspeed_tpu/runtime/resilience/sentinel.py).

The fp16 dynamic-loss-scale machinery skips steps on overflow, but bf16
and fp32 runs have no such guard (the engine's finite select: overflow is
near-impossible in bf16's range, so the skip never fires) — a data
glitch or optimizer blow-up silently poisons the weights and the run
burns until a human notices.  The sentinel watches the two scalars every
run already produces — loss and global gradient norm — and flags

  * non-finite values (NaN/Inf), immediately, even during warmup, and
  * k-sigma spikes against exponentially-weighted mean/variance after a
    warmup period,

then applies a configured policy (``warn`` | ``skip_step`` | ``rewind``)
with a bounded consecutive-anomaly budget: a wedged run aborts with a
structured diagnostic (``SentinelAbort``) instead of burning compute.

Anomalous observations do NOT update the EWMA statistics — a divergence
must not drag the baseline along with it.
"""

import json
import math
from typing import Dict, List, Optional

from ...utils.logging import logger

_VAR_FLOOR = 1e-12


class SentinelAbort(RuntimeError):
    """Consecutive-anomaly budget exhausted; carries the diagnostic."""

    def __init__(self, diagnostic: Dict):
        self.diagnostic = diagnostic
        super().__init__(
            "training-health sentinel abort: "
            + json.dumps(diagnostic, sort_keys=True, default=str))


class _EwmaStat:
    """Exponentially-weighted mean/variance of one scalar stream."""

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
        return abs(x - self.mean) / math.sqrt(max(self.var, _VAR_FLOOR))

    def state_dict(self) -> Dict:
        return {"mean": self.mean, "var": self.var, "count": self.count}

    def load_state_dict(self, sd: Dict) -> None:
        self.mean = sd.get("mean")
        self.var = float(sd.get("var", 0.0))
        self.count = int(sd.get("count", 0))


class TrainingSentinel:
    """Host-side policy engine over per-step (loss, grad_norm) scalars."""

    def __init__(self, ewma_alpha: float = 0.02, k_sigma: float = 6.0,
                 warmup_steps: int = 20, policy: str = "warn",
                 anomaly_budget: int = 5, monitor_grad_norm: bool = True):
        self.k_sigma = k_sigma
        self.warmup_steps = warmup_steps
        self.policy = policy
        self.anomaly_budget = anomaly_budget
        self.monitor_grad_norm = monitor_grad_norm
        self.loss_stat = _EwmaStat(ewma_alpha)
        self.grad_stat = _EwmaStat(ewma_alpha)
        # counters surfaced in the engine's monitor line + client state
        self.anomalies_seen = 0
        self.steps_skipped = 0
        self.rewinds = 0
        self.consecutive_anomalies = 0
        self.last_reasons: List[str] = []
        # structured fleet-health events (the JAX monitor's straggler/
        # divergence detections; the port's monitor is ROADMAP.md A.6b) —
        # bounded ring so a chronically-sick
        # pod cannot grow host memory without limit
        self.health_events: List[Dict] = []
        self.health_events_seen = 0

    # ---------------------------------------------------------------- #
    def observe(self, step: int, loss: float,
                grad_norm: Optional[float] = None) -> bool:
        """Record one step's scalars; returns True iff anomalous.

        On anomaly the consecutive counter advances and the EWMA baseline
        is left untouched; the caller then applies the policy and, if
        `over_budget`, calls `abort`.  Exception — policy "warn" with a
        finite spike: the run trains straight through it, so the baseline
        MUST follow (a legitimate permanent level-shift, e.g. an LR-decay
        boundary, would otherwise stay >k-sigma forever) and only
        non-finite anomalies count toward the abort budget."""
        reasons = []
        nonfinite = False
        if not math.isfinite(loss):
            nonfinite = True
            reasons.append(f"loss is non-finite ({loss})")
        if grad_norm is not None and not math.isfinite(grad_norm):
            nonfinite = True
            reasons.append(f"grad_norm is non-finite ({grad_norm})")
        warmed = self.loss_stat.count >= self.warmup_steps
        if not reasons and warmed:
            z = self.loss_stat.zscore(loss)
            if z > self.k_sigma:
                reasons.append(
                    f"loss {loss:.6g} is {z:.1f}σ from EWMA mean "
                    f"{self.loss_stat.mean:.6g} (k={self.k_sigma})")
            if grad_norm is not None and self.monitor_grad_norm and \
                    self.grad_stat.count >= self.warmup_steps:
                zg = self.grad_stat.zscore(grad_norm)
                if zg > self.k_sigma:
                    reasons.append(
                        f"grad_norm {grad_norm:.6g} is {zg:.1f}σ from EWMA "
                        f"mean {self.grad_stat.mean:.6g} (k={self.k_sigma})")
        self.last_reasons = reasons
        if reasons:
            self.anomalies_seen += 1
            if self.policy == "warn" and not nonfinite:
                # train-through spike: adapt the baseline, leave the
                # consecutive (abort) counter to non-finite anomalies
                self.loss_stat.update(loss)
                if grad_norm is not None and self.monitor_grad_norm:
                    self.grad_stat.update(grad_norm)
            else:
                self.consecutive_anomalies += 1
            logger.warning(
                f"sentinel: anomaly at step {step} "
                f"({self.consecutive_anomalies}/{self.anomaly_budget} "
                f"consecutive): {'; '.join(reasons)}")
            return True
        self.consecutive_anomalies = 0
        self.loss_stat.update(loss)
        if grad_norm is not None and self.monitor_grad_norm:
            self.grad_stat.update(grad_norm)
        return False

    @property
    def over_budget(self) -> bool:
        return self.consecutive_anomalies >= self.anomaly_budget

    def record_skip(self) -> None:
        self.steps_skipped += 1

    def record_rewind(self) -> None:
        self.rewinds += 1

    _HEALTH_EVENTS_KEPT = 32

    def record_health_event(self, event: Dict) -> None:
        """Fleet-health sink (the JAX package's monitor/health.py): a
        straggler or divergence detection lands here as a structured
        event so the sentinel's diagnostic — the post-mortem an operator reads after
        an abort — carries the FLEET's view next to the loss/grad-norm
        history.  Events inform the diagnostic; they do not advance the
        consecutive-anomaly abort budget (a slow host is an
        infrastructure fault, not a training-dynamics one — the policy
        machinery here must not skip steps because a neighbor's NVMe is
        cold)."""
        self.health_events_seen += 1
        self.health_events.append(dict(event))
        if len(self.health_events) > self._HEALTH_EVENTS_KEPT:
            del self.health_events[:-self._HEALTH_EVENTS_KEPT]
        # debug, not warning: the monitor already emits the formatted
        # health line under its own emitter-or-mine gate — a second
        # warning here would double-log every event on the ranks that
        # feed the sink
        logger.debug(
            f"sentinel: fleet health event #{self.health_events_seen} "
            f"({event.get('event')} on {event.get('host')} at step "
            f"{event.get('step')})")

    # ---------------------------------------------------------------- #
    def diagnostic(self, step: int, loss: Optional[float] = None,
                   grad_norm: Optional[float] = None) -> Dict:
        """Structured post-mortem for logs/abort — everything an operator
        needs to decide between resume, rewind, and data triage."""
        return {
            "step": step,
            "policy": self.policy,
            "loss": loss,
            "grad_norm": grad_norm,
            "reasons": list(self.last_reasons),
            "consecutive_anomalies": self.consecutive_anomalies,
            "anomaly_budget": self.anomaly_budget,
            "anomalies_seen": self.anomalies_seen,
            "steps_skipped": self.steps_skipped,
            "rewinds": self.rewinds,
            "loss_ewma": self.loss_stat.state_dict(),
            "grad_norm_ewma": self.grad_stat.state_dict(),
            "health_events_seen": self.health_events_seen,
            "recent_health_events": list(self.health_events[-5:]),
        }

    def abort(self, step: int, loss: Optional[float] = None,
              grad_norm: Optional[float] = None) -> None:
        diag = self.diagnostic(step, loss, grad_norm)
        logger.error(f"sentinel: consecutive-anomaly budget exhausted — "
                     f"aborting. diagnostic: {json.dumps(diag, default=str)}")
        raise SentinelAbort(diag)

    # ---------------------------------------------------------------- #
    def counters(self) -> Dict[str, int]:
        return {"anomalies_seen": self.anomalies_seen,
                "steps_skipped": self.steps_skipped,
                "rewinds": self.rewinds,
                "health_events": self.health_events_seen}

    def state_dict(self) -> Dict:
        return {
            "loss_stat": self.loss_stat.state_dict(),
            "grad_stat": self.grad_stat.state_dict(),
            "anomalies_seen": self.anomalies_seen,
            "steps_skipped": self.steps_skipped,
            "rewinds": self.rewinds,
            "consecutive_anomalies": self.consecutive_anomalies,
            "health_events_seen": self.health_events_seen,
        }

    def load_state_dict(self, sd: Dict) -> None:
        self.loss_stat.load_state_dict(sd.get("loss_stat", {}))
        self.grad_stat.load_state_dict(sd.get("grad_stat", {}))
        self.anomalies_seen = int(sd.get("anomalies_seen", 0))
        self.steps_skipped = int(sd.get("steps_skipped", 0))
        self.rewinds = int(sd.get("rewinds", 0))
        self.consecutive_anomalies = int(sd.get("consecutive_anomalies", 0))
        self.health_events_seen = int(sd.get("health_events_seen", 0))
