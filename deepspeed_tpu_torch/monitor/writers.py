"""Pluggable metric writers + the background emission thread
(counterpart of deepspeed_tpu/monitor/writers.py).

Writers consume fully-materialized host records (record.py) — no device
tensors reach this module.  The ``WriterThread`` decouples file I/O from
the step loop: the monitor enqueues record batches at flush boundaries
and the daemon thread writes them, so a slow disk (or a wedged NFS
mount) can never block a training step.  ``close()`` drains the queue
before returning, so tests and benches read complete files.

``ScalarJsonlWriter`` doubles as the TensorBoard stand-in: it implements
the ``add_scalar``/``flush``/``close`` subset of SummaryWriter that the
engine uses, writing JSONL lines instead — a host where neither
``torch.utils.tensorboard`` (which needs the ``tensorboard`` package)
nor ``tensorboardX`` imports still gets its scalars
(engine._configure_tensorboard falls back here with one loud warning and
a degradation-registry record).
"""

import csv
import json
import os
import queue
import threading
from typing import Any, Dict, List, Optional

from ..utils.logging import logger
from . import record as R


class MetricsWriter:
    """Writer interface: write(record) per record, then flush/close."""

    def write(self, rec: Dict[str, Any]) -> None:  # pragma: no cover
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class JsonlWriter(MetricsWriter):
    """One JSON object per line; carries every record kind and field.
    Lazy-open: the file (and its directory) appear at the first record,
    so an engine that never steps leaves no artifacts behind."""

    def __init__(self, path: str):
        self.path = path
        self._f = None

    def _file(self):
        if self._f is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._f = open(self.path, "a", buffering=1)
        return self._f

    def write(self, rec: Dict[str, Any]) -> None:
        self._file().write(json.dumps(rec, default=_json_default) + "\n")

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()


class CsvWriter(MetricsWriter):
    """Fixed-column view of STEP records only (the schema's field order);
    reconcile/meta records and engine-specific extras live in the JSONL
    stream — CSV is the spreadsheet-friendly projection.  Lazy-open like
    JsonlWriter."""

    def __init__(self, path: str):
        self.path = path
        self._f = None
        self._w = None

    def _writer(self):
        if self._w is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._f = open(self.path, "a", newline="", buffering=1)
            self._w = csv.writer(self._f)
            if self._f.tell() == 0:
                self._w.writerow(R.STEP_RECORD_FIELDS)
        return self._w

    def write(self, rec: Dict[str, Any]) -> None:
        if rec.get(R.F_KIND) != R.KIND_STEP:
            return
        self._writer().writerow(
            [rec.get(k) for k in R.STEP_RECORD_FIELDS])

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()


class TensorBoardWriter(MetricsWriter):
    """Adapter over an existing SummaryWriter-like object (the engine's
    own tensorboard writer — one writer, one event file; the monitor does
    not open a second).  Numeric step-record fields become scalars under
    ``Monitor/<field>``."""

    _SCALAR_FIELDS = (R.F_LOSS, R.F_LR, R.F_LOSS_SCALE, R.F_WALL_TIME_S,
                      R.F_TOKENS_PER_SEC, R.F_MEM_PEAK_BYTES,
                      R.F_SKIPPED_STEPS, R.F_SWAP_READ_GBPS,
                      R.F_SWAP_OVERLAP_FRACTION)

    def __init__(self, summary_writer: Any):
        self._sw = summary_writer
        self._warned = False

    def write(self, rec: Dict[str, Any]) -> None:
        if rec.get(R.F_KIND) != R.KIND_STEP:
            return
        step = rec.get(R.F_STEP, 0)
        try:
            for field in self._SCALAR_FIELDS:
                val = rec.get(field)
                if isinstance(val, (int, float)):
                    self._sw.add_scalar(f"Monitor/{field}", float(val), step)
        except Exception as e:  # noqa: BLE001 — telemetry must not raise
            if not self._warned:
                self._warned = True
                logger.warning(f"monitor: tensorboard writer failed ({e}) "
                               "— further tensorboard errors suppressed")
                from ..runtime.resilience.degradation import \
                    record as degrade
                degrade("tensorboard", "summary-writer", "silent",
                        f"tensorboard write failed: {e}")

    def flush(self) -> None:
        try:
            self._sw.flush()
        except Exception:  # noqa: BLE001
            pass


class ScalarJsonlWriter:
    """SummaryWriter-compatible JSONL fallback (add_scalar subset).

    Used when tensorboard is requested but neither torch.utils.tensorboard
    nor tensorboardX imports — scalars land as ``{"tag": ..., "value": ..., "step": ...}``
    lines instead of silently vanishing."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "scalars.jsonl")
        self._f = open(self.path, "a", buffering=1)

    def add_scalar(self, tag: str, value: float, global_step: int = 0
                   ) -> None:
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(global_step)}) + "\n")

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def _json_default(o):
    try:
        import numpy as np
        if isinstance(o, np.generic):
            return o.item()
        if isinstance(o, np.ndarray):
            return o.tolist()
    except Exception:  # noqa: BLE001
        pass
    return str(o)


class WriterThread:
    """Daemon thread that drains record batches into the writers.

    submit() never blocks (unbounded queue of small dicts); close()
    sends the sentinel and joins, then closes the writers — after
    close() returns, every submitted record is on disk, OR the drain
    outran the close timeout (wedged filesystem) and a loud warning
    says records were dropped."""

    def __init__(self, writers: List[MetricsWriter]):
        self.writers = writers
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._errored = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ds-monitor-writer")
        self._thread.start()
        self._closed = False

    def submit(self, records: List[Dict[str, Any]]) -> None:
        if not self._closed:
            self._q.put(records)

    def _run(self) -> None:
        while True:
            batch = self._q.get()
            if batch is None:
                break
            for rec in batch:
                for w in self.writers:
                    try:
                        w.write(rec)
                    except Exception as e:  # noqa: BLE001
                        if not self._errored:
                            self._errored = True
                            logger.warning(
                                f"monitor: writer {type(w).__name__} "
                                f"failed ({e}) — further writer errors "
                                "suppressed")
                            from ..runtime.resilience.degradation \
                                import record as degrade
                            degrade("monitor-writer",
                                    type(w).__name__, "silent",
                                    f"writer failed: {e}")
            for w in self.writers:
                try:
                    w.flush()
                except Exception:  # noqa: BLE001
                    pass

    def close(self, timeout: Optional[float] = 10.0) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            # the drain outran the timeout (wedged disk/NFS): say that
            # records were dropped and do NOT close the files underneath
            # the still-running thread — the daemon dies with the process
            logger.warning(
                f"monitor: writer thread did not drain within {timeout}s "
                "— some records were NOT flushed to disk (wedged or slow "
                "filesystem?)")
            return
        for w in self.writers:
            try:
                w.close()
            except Exception:  # noqa: BLE001
                pass
