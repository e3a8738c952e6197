"""Hang watchdog: a heartbeat thread armed around blocking calls.

A hung collective on a pod slice is worse than a crash: the job burns its
reservation doing nothing and nobody is told.  The watchdog is armed around
each blocking engine call (step / train_batch / backward / checkpoint IO —
engine._armed) and, past the configured deadline:

1. dumps EVERY thread's stack (``sys._current_frames``) plus the last N
   armed-operation timings to the log (the dump names the stuck frame —
   pinned by the chaos suite), and
2. optionally aborts the process with ``WATCHDOG_EXIT_CODE`` so the
   launcher's ``--max_restarts`` path can take over
   (``resilience.watchdog_abort``).

Operations that complete but consume more than ``near_miss_frac`` of the
deadline increment ``COUNTERS.watchdog_near_misses`` — the observable
early-warning that a deadline is about to start firing.

NOTE: importable without torch (the launcher parent imports the exit-code
contract).
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
import traceback
from collections import deque
from contextlib import contextmanager

from deepspeed_tpu_torch.resilience.counters import COUNTERS

logger = logging.getLogger(__name__)

#: process aborted by the hang watchdog after dumping stacks: the launcher
#: should relaunch (docs/resilience.md "Exit codes")
WATCHDOG_EXIT_CODE = 44


def format_all_stacks() -> str:
    """Every live thread's current stack, rendered with frame names."""
    names = {t.ident: t.name for t in threading.enumerate()}
    parts = []
    for ident, frame in sorted(sys._current_frames().items()):
        parts.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        parts.append("".join(traceback.format_stack(frame)).rstrip())
    return "\n".join(parts)


class Watchdog:
    """Deadline monitor for armed operations.

    One background monitor thread (daemon, started on first arm) polls the
    armed deadline; arming is two clock reads and a field write, cheap
    enough for the per-step hot path.  Armed regions do not nest — the
    engine's blocking calls are sequential.
    """

    def __init__(self, timeout_s: float, abort: bool = False,
                 near_miss_frac: float = 0.8, history: int = 32,
                 poll_s: float = None, on_fire=None):
        self.timeout_s = float(timeout_s)
        #: optional callable run (on the monitor thread) after the stack
        #: dump and BEFORE any abort: the telemetry layer hooks a short
        #: torch.profiler hang capture here, so a wedged run leaves a
        #: trace, not just stacks (observability/tracing.py)
        self.on_fire = on_fire
        self.abort = bool(abort)
        self.near_miss_frac = float(near_miss_frac)
        self.poll_s = (poll_s if poll_s is not None
                       else max(0.02, min(1.0, self.timeout_s / 10.0)))
        self.timings = deque(maxlen=int(history))   # (label, seconds)
        self.fired = False          # any fire over the watchdog's lifetime
        self.last_dump = None
        self.fire_event = threading.Event()
        self._lock = threading.Lock()
        self._armed_label = None
        self._armed_at = None
        self._armed_deadline_s = self.timeout_s
        self._fired_this_arm = False
        self._thread = None

    # ------------------------------------------------------------- arming
    @contextmanager
    def armed(self, label: str, deadline_scale: float = 1.0):
        """``deadline_scale`` stretches THIS region's deadline (and its
        near-miss threshold): the multi-step driver arms once around a
        K-step fused dispatch, so a deadline tuned for one boundary must
        scale by K or every healthy K-block fires it
        (docs/resilience.md "Watchdog tuning")."""
        self._arm(label, deadline_scale)
        try:
            yield self
        finally:
            self._disarm()

    def _arm(self, label: str, deadline_scale: float = 1.0) -> None:
        if deadline_scale <= 0:
            raise ValueError(
                f"watchdog deadline_scale must be > 0, got {deadline_scale}")
        self._ensure_thread()
        with self._lock:
            if self._armed_label is not None:
                raise RuntimeError(
                    f"watchdog already armed for {self._armed_label!r}; "
                    f"armed regions do not nest (attempted {label!r})")
            self._armed_label = label
            self._armed_at = time.monotonic()
            self._armed_deadline_s = self.timeout_s * float(deadline_scale)
            self._fired_this_arm = False

    def _disarm(self) -> None:
        with self._lock:
            label, at = self._armed_label, self._armed_at
            deadline = self._armed_deadline_s
            fired = self._fired_this_arm
            self._armed_label = None
            self._armed_at = None
            self._armed_deadline_s = self.timeout_s
            self._fired_this_arm = False
        if at is None:
            return
        dur = time.monotonic() - at
        self.timings.append((label, dur))
        if not fired and dur > self.near_miss_frac * deadline:
            COUNTERS.watchdog_near_misses += 1
            logger.warning(
                "watchdog near-miss: %r took %.2fs of a %.2fs deadline",
                label, dur, deadline)

    # ------------------------------------------------------------ monitor
    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._monitor, daemon=True, name="dstpu-watchdog")
            self._thread.start()

    def _monitor(self) -> None:
        while True:
            time.sleep(self.poll_s)
            with self._lock:
                label, at = self._armed_label, self._armed_at
                deadline = self._armed_deadline_s
                already = self._fired_this_arm
                if (label is None or already
                        or time.monotonic() - at <= deadline):
                    continue
                self._fired_this_arm = True
            self._fire(label, time.monotonic() - at, deadline)

    def _fire(self, label: str, elapsed: float,
              deadline_s: float = None) -> None:
        recent = "\n".join(f"  {lbl}: {dur * 1000.0:.1f} ms"
                           for lbl, dur in self.timings) or "  (none)"
        # the flight recorder's tail: the stack dump says where this thread
        # is stuck NOW, the tail which step / window the process reached
        # before it hung.  A torch-free import; best-effort.
        flight = "  (unavailable)"
        try:
            from deepspeed_tpu_torch.observability import flightrec
            flight = flightrec.RECORDER.format_tail()
        except Exception:  # pragma: no cover - defensive
            pass
        deadline_s = self.timeout_s if deadline_s is None else deadline_s
        dump = (f"WATCHDOG: {label!r} exceeded {deadline_s:.2f}s "
                f"deadline ({elapsed:.2f}s elapsed)\n"
                f"last {len(self.timings)} armed-operation timings:\n"
                f"{recent}\n"
                f"recent flight-recorder entries:\n{flight}\n"
                f"all-thread stacks:\n{format_all_stacks()}")
        self.last_dump = dump
        self.fired = True
        COUNTERS.watchdog_fires += 1
        logger.error("%s", dump)
        try:
            # the ring on disk next to the stack dump: a relaunch (or the
            # abort below) ends the process, the file is what a
            # post-mortem collects
            from deepspeed_tpu_torch.observability import flightrec
            flightrec.RECORDER.dump("watchdog")
        except Exception:  # pragma: no cover - defensive
            pass
        if self.on_fire is not None:
            # best-effort diagnostics (the hang trace): a hook failure must
            # never mask the dump or block the abort path
            try:
                self.on_fire()
            except Exception as e:  # pragma: no cover - defensive
                logger.warning("watchdog on_fire hook failed: %s", e)
        self.fire_event.set()
        if self.abort:
            # the restart path takes over: flush the dump to stderr and
            # exit with the contract code.  os._exit, not sys.exit — the
            # main thread is by definition stuck and cannot unwind.
            sys.stderr.write(dump + "\n")
            sys.stderr.flush()
            os._exit(WATCHDOG_EXIT_CODE)
