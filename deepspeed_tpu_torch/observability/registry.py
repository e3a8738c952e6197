"""MetricRegistry — the single exporter fan-out.

Before this layer the engine had three independent scalar-writing paths
(throughput logging, ``resilience/counters.py`` TensorBoard loops, the
compile-cache counters riding the same loop) and nothing machine-readable.
Now every producer registers a SOURCE — a callable returning
``{name: number}`` — and the registry emits one consistent snapshot per
report window to every attached SINK:

* :class:`TensorboardSink` — ``Train/<group>/<name>`` scalars through the
  engine's existing ``SummaryWriter`` (same tags the three legacy paths
  wrote, so dashboards keep working);
* :class:`JsonlSink` — one schema-versioned line per window
  (observability/schema.py), the artifact the CI smoke job validates and
  bench tooling diffs.

Sources are pulled at EMIT time (drain or boundary), never per step —
collection cost rides the report cadence, not the hot path.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Callable, Dict, Optional

from deepspeed_tpu_torch.observability import schema

logger = logging.getLogger(__name__)


class MetricRegistry:
    """Named metric sources fanned out to sinks (thread-safe: the spool
    drain callback runs on the runtime's callback thread)."""

    def __init__(self):
        self._sources: Dict[str, Callable[[], dict]] = {}
        self._sinks = []
        self._lock = threading.Lock()

    def register(self, group: str, source: Callable[[], dict]) -> None:
        """Register/replace the source for ``group`` (a callable returning
        a flat ``{name: number}`` dict, pulled at emit time)."""
        with self._lock:
            self._sources[group] = source

    def unregister(self, group: str) -> None:
        with self._lock:
            self._sources.pop(group, None)

    def add_sink(self, sink) -> None:
        with self._lock:
            self._sinks.append(sink)

    def collect(self) -> Dict[str, dict]:
        """One snapshot of every source: ``{group: {name: value}}``.  A
        source that raises is skipped with a warning — observability must
        never take down training."""
        with self._lock:
            sources = dict(self._sources)
        out = {}
        for group, fn in sources.items():
            try:
                out[group] = dict(fn())
            except Exception as e:  # pragma: no cover - defensive
                logger.warning("telemetry source %r failed: %s", group, e)
        return out

    def counters_snapshot(self) -> dict:
        """Every source flattened to ``{"group/name": value}`` — the
        counter spelling both export cadences (window drain and legacy
        boundary) share."""
        out = {}
        for group, vals in self.collect().items():
            for name, val in vals.items():
                out[f"{group}/{name}"] = val
        return out

    def emit(self, event: dict, sample_count: Optional[int] = None) -> None:
        """Fan one window event (plus a fresh source snapshot) out to every
        sink.  ``event`` is the spool's window record; sinks receive it
        with ``counters`` filled from the collected snapshot."""
        event = dict(event)
        event.setdefault("counters", {}).update(self.counters_snapshot())
        self.emit_event(event, sample_count=sample_count)

    def emit_event(self, event: dict,
                   sample_count: Optional[int] = None) -> None:
        """Fan a pre-built event (fleet/startup — or a window event whose
        counters are already attached) out to every sink verbatim: no
        source collection, no counter merge — the fleet event's counters
        are a cross-host roll-up that a local snapshot must not clobber."""
        with self._lock:
            sinks = list(self._sinks)
        for sink in sinks:
            try:
                sink.emit(event, sample_count=sample_count)
            except Exception as e:  # pragma: no cover - defensive
                logger.warning("telemetry sink %r failed: %s",
                               type(sink).__name__, e)

    def close(self) -> None:
        with self._lock:
            sinks, self._sinks = list(self._sinks), []
        for sink in sinks:
            try:
                sink.close()
            except Exception:  # pragma: no cover - defensive
                pass


class TensorboardSink:
    """Window events as ``Train/*`` scalars through an existing
    SummaryWriter — the dedup target of the three legacy write loops.
    Scalar tags: window metrics under ``Train/Telemetry/*``, counter
    groups under ``Train/<Group>/<name>`` (``Train/Resilience/*`` keeps
    its older spelling, so existing dashboards keep working)."""

    #: window-event fields exported as Train/Telemetry/* scalars
    _WINDOW_FIELDS = ("loss", "loss_mean", "grad_norm", "loss_scale",
                      "skipped", "step_ms", "samples_per_sec", "mfu",
                      "host_ms", "data_wait_ms",
                      "measured_peak_hbm_gb", "hbm_drift",
                      "predicted_peak_hbm_gb", "predicted_boundary_ms",
                      "measured_boundary_ms", "boundary_drift")

    #: fleet-event fields exported as Train/Fleet/* scalars (rank 0)
    _FLEET_FIELDS = ("reported_hosts", "step_ms_min", "step_ms_median",
                     "step_ms_max", "host_ms_min", "host_ms_median",
                     "host_ms_max", "samples_per_sec_sum",
                     "straggler_index", "loss_mean", "loss_spread",
                     "skipped_total")

    #: startup-event fields exported once as Train/Telemetry/* scalars
    _STARTUP_FIELDS = ("time_to_first_step_s", "first_dispatch_s",
                       "restore_seconds")

    def __init__(self, writer):
        #: a SummaryWriter, or a zero-arg callable resolving one LIVE —
        #: the engine's writer may be replaced after construction (tests
        #: inject fakes; users wire writers late), so the sink must not
        #: capture a stale reference
        self._writer = writer

    @property
    def writer(self):
        w = self._writer
        return w() if callable(w) else w

    def emit(self, event: dict, sample_count: Optional[int] = None) -> None:
        writer = self.writer
        if writer is None:
            return
        x = sample_count if sample_count is not None else event["step"]
        sid = event.get("schema")
        if sid == schema.FLEET_SCHEMA_ID:
            # rank-0 fleet roll-up: spread/straggler scalars + the count
            # of flagged ranks (the alarmable number); per_host detail
            # stays in the JSONL record
            for name in self._FLEET_FIELDS:
                val = event.get(name)
                if val is not None:
                    writer.add_scalar(f"Train/Fleet/{name}", float(val), x)
            writer.add_scalar("Train/Fleet/stragglers",
                              float(len(event.get("stragglers") or [])), x)
            writer.add_scalar("Train/Fleet/missing_hosts",
                              float(len(event.get("missing_hosts") or [])),
                              x)
            return
        if sid == schema.STARTUP_SCHEMA_ID:
            for name in self._STARTUP_FIELDS:
                val = event.get(name)
                if val is not None:
                    writer.add_scalar(f"Train/Telemetry/{name}",
                                      float(val), x)
            return
        for name in self._WINDOW_FIELDS:
            val = event.get(name)
            if val is not None:
                writer.add_scalar(f"Train/Telemetry/{name}",
                                  float(val), x)
        for key, val in event.get("counters", {}).items():
            group, _, name = key.partition("/")
            writer.add_scalar(
                f"Train/{group.capitalize()}/{name}", float(val), x)

    def close(self) -> None:
        pass        # the writer belongs to the engine


class JsonlSink:
    """One schema-stamped JSON line per event, flushed per emit (the file
    must be complete up to the last drained window when the process is
    preempted — the flush-on-drain contract the resilience driver relies
    on).  Events carrying their own ``schema`` stamp (fleet/startup) pass
    through; unstamped events are window events and get the window schema
    + null-filled field set.  Lines that fail self-validation are still
    written but logged loudly: a schema bug must be visible in CI, not
    silently dropped."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._f = open(path, "a")
        # window emits arrive on the runtime callback thread, fleet emits
        # on the aggregator thread — interleaved partial writes would
        # corrupt the line framing the validator gates on
        self._lock = threading.Lock()

    def emit(self, event: dict, sample_count: Optional[int] = None) -> None:
        event = dict(event)
        if event.get("schema") is None:
            event["schema"] = schema.SCHEMA_ID
            event["version"] = schema.SCHEMA_VERSION
            # every schema field present (null when unmeasured): a missing
            # column and an unmeasured column are different facts
            for name in schema.FIELDS:
                event.setdefault(name, None)
        event.setdefault("ts", time.time())
        msg = schema.validate_any(event)
        if msg is not None:  # pragma: no cover - schema bug guard
            logger.error("telemetry event fails its own schema (%s): %r",
                         msg, event)
        line = json.dumps(event) + "\n"
        with self._lock:
            self._f.write(line)
            self._f.flush()

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:  # pragma: no cover - defensive
            pass
