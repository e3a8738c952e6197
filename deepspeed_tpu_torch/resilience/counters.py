"""Resilience observability counters.

One process-wide :class:`Counters` instance (``COUNTERS``) accumulates the
degradation events the resilience subsystem absorbs — restarts, skipped
non-finite steps, storage retries, watchdog near-misses/fires, preemption
signals.  The engine exports them through the existing TensorBoard path
(``Train/Resilience/*`` scalars, engine._post_boundary_bookkeeping) and via
``engine.resilience_counters()``, so a job that is silently limping —
retrying every save, skipping every tenth step — is observable instead of
merely "still running" (docs/resilience.md "Observability").
"""

from __future__ import annotations

from dataclasses import dataclass, fields


@dataclass
class Counters:
    #: successful resume-from-checkpoint restores (driver.run_resumable)
    restarts: int = 0
    #: preemption signals / sentinel observations (preempt.PreemptionHandler)
    preemptions: int = 0
    #: optimizer boundaries skipped by the NaN/Inf sentinel
    #: (resilience.nan_sentinel; engine._post_boundary_bookkeeping)
    nan_skips: int = 0
    #: storage operations retried after a transient error (retry.io_retry)
    io_retries: int = 0
    #: armed operations that finished but consumed more than
    #: ``near_miss_frac`` of the watchdog deadline (watchdog.Watchdog)
    watchdog_near_misses: int = 0
    #: watchdog deadline expiries (stack dump emitted; process aborted when
    #: ``watchdog_abort`` is set)
    watchdog_fires: int = 0
    #: wall-clock seconds of the most recent checkpoint restore
    #: (engine.load_checkpoint) — the resume-latency half of fast resume
    restore_seconds: float = 0.0
    #: compile-cache hits/misses: kernel libraries loaded from the build
    #: directory / built by nvcc (ops/_build.py, utils/compile_cache.py;
    #: hits > 0 on a relaunch means the restart skipped the builds)
    compile_cache_hits: int = 0
    compile_cache_misses: int = 0

    def as_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    def reset(self) -> None:
        for f in fields(self):
            setattr(self, f.name, f.default)


#: process-wide counter instance (tests reset it between scenarios)
COUNTERS = Counters()
