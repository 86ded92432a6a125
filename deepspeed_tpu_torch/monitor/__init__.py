"""Runtime telemetry (counterpart of deepspeed_tpu/monitor/).

Structured per-step metrics behind the ``monitor`` config block (off by
default): a MetricsStream assembling one record per optimizer step with
boundary-only batched device reads, pluggable JSONL/CSV/TensorBoard
writers on a background thread, a Chrome/Perfetto trace-event exporter
for the step phases, and a measured-vs-predicted reconciliation report
(measured-only in the port until its auditor, ROADMAP.md A.14).

The fleet layer (``monitor.fleet``) extends the same contract across
processes: fixed-shape aggregation over a gloo group at flush-window
boundaries (fleet.py), EWMA straggler + loss-divergence detection with
lane attribution (health.py), a per-process heartbeat liveness protocol
(heartbeat.py), and anomaly-triggered bounded ``torch.profiler``
captures (capture.py).  The record schema is the JAX package's
(record.py), so either package's tooling reads either's streams.  The
MoE routing records (the JAX package's monitor/moe.py) come with MoE
(ROADMAP.md A.10).
"""

from . import record
from .capture import TRIGGER_FLAGS, ProfileCapture
from .fleet import (VEC_FIELDS, ExchangeTimeout, FleetAggregator,
                    decode_window_vector, encode_window_vector,
                    format_fleet_line, process_group_gather,
                    summarize_fleet)
from .health import (FleetHealth, attribute_straggler_lane,
                     format_health_line, straggler_verdict)
from .heartbeat import (HEARTBEAT_DIR, HeartbeatWriter, annotate_stale,
                        format_watch_table, read_heartbeats,
                        resolve_heartbeat_dir)
from .monitor import (METRICS_CSV, METRICS_JSONL, PROFILES_DIR, TRACE_JSON,
                      MetricsStream, TrainingMonitor)
from .reconcile import (ATTR_COMM_EXPOSED, ATTR_COMM_HIDDEN, ATTR_COMPUTE,
                        ATTR_EXPERT_HOTSPOT, ATTR_HOST_GAP, ATTR_IO,
                        ATTR_SWAP, FLAG_HBM_ABOVE_BAND, FLAG_HBM_BELOW_BAND,
                        FLAG_MODEL_VIOLATION, FLAG_STEP_TIME_ABOVE_BAND,
                        FLAG_SWAP_BELOW_CEILING, Bands, attribute_gap,
                        bare_summary, format_line, reconcile_window)
from .record import (EVENT_DEAD_EXPERT, EVENT_DIVERGENCE,
                     EVENT_EP_IMBALANCE, EVENT_ROUTER_COLLAPSE,
                     EVENT_STRAGGLER, KIND_FLEET, KIND_FLEET_HOST,
                     KIND_HEALTH, KIND_META, KIND_MOE, KIND_RECONCILE,
                     KIND_STEP, SCHEMA_VERSION, STEP_RECORD_FIELDS,
                     device_memory, identity, make_step_record)
from .trace import TraceEventBuffer, validate_trace_events
from .writers import (CsvWriter, JsonlWriter, MetricsWriter,
                      ScalarJsonlWriter, TensorBoardWriter, WriterThread)

__all__ = [
    "ATTR_COMM_EXPOSED", "ATTR_COMM_HIDDEN", "ATTR_COMPUTE",
    "ATTR_EXPERT_HOTSPOT", "ATTR_HOST_GAP", "ATTR_IO", "ATTR_SWAP", "Bands",
    "CsvWriter", "EVENT_DEAD_EXPERT", "EVENT_DIVERGENCE",
    "EVENT_EP_IMBALANCE", "EVENT_ROUTER_COLLAPSE", "EVENT_STRAGGLER",
    "ExchangeTimeout", "FLAG_HBM_ABOVE_BAND", "FLAG_HBM_BELOW_BAND",
    "FLAG_MODEL_VIOLATION", "FLAG_STEP_TIME_ABOVE_BAND",
    "FLAG_SWAP_BELOW_CEILING", "FleetAggregator", "FleetHealth",
    "HEARTBEAT_DIR", "HeartbeatWriter", "JsonlWriter", "KIND_FLEET",
    "KIND_FLEET_HOST", "KIND_HEALTH", "KIND_META", "KIND_MOE",
    "KIND_RECONCILE", "KIND_STEP", "METRICS_CSV", "METRICS_JSONL",
    "MetricsStream", "MetricsWriter", "PROFILES_DIR", "ProfileCapture",
    "SCHEMA_VERSION", "STEP_RECORD_FIELDS", "ScalarJsonlWriter",
    "TRACE_JSON", "TRIGGER_FLAGS", "TensorBoardWriter", "TraceEventBuffer",
    "TrainingMonitor", "VEC_FIELDS", "WriterThread", "annotate_stale",
    "attribute_gap", "attribute_straggler_lane", "bare_summary",
    "decode_window_vector", "device_memory", "encode_window_vector",
    "format_fleet_line", "format_health_line", "format_line",
    "format_watch_table", "identity", "make_step_record",
    "process_group_gather", "read_heartbeats", "reconcile_window",
    "record", "resolve_heartbeat_dir", "straggler_verdict",
    "summarize_fleet", "validate_trace_events",
]
