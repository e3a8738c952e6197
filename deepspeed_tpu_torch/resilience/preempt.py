"""Preemption handling: signal → flag → cross-host agreement → drain.

Preemptible TPU pods deliver SIGTERM to *some* hosts with a short grace
window; a run survives only if every host drains at the SAME optimizer
boundary, takes one coherent emergency checkpoint, and exits with a code
the launcher recognises as "relaunch me" (``RESUME_EXIT_CODE``).  The
pieces:

* :class:`PreemptionHandler` — installs SIGTERM/SIGINT handlers that set a
  host-local flag (async-signal-safe: the handler only flips a bool); a
  sentinel FILE (``DSTPU_PREEMPT_FILE``) is honoured too, so tests and
  external orchestrators can request a drain without racing signal
  delivery.
* :func:`agree_any` — the cross-process agreement collective: a MAX
  all-reduce of the per-process flag over the default process group, so
  one preempted process drains the whole job at the same step (every
  process must call it at the same boundary — ``driver.run_resumable``
  does, every step).
* ``RESUME_EXIT_CODE`` — the exit-code contract with the launcher's
  ``--max_restarts`` loop (docs/resilience.md "Exit codes").

NOTE: this module must stay importable without torch (a launcher parent
process imports the exit-code contract); torch is imported lazily inside
``agree_any``.
"""

from __future__ import annotations

import logging
import os
import signal
import threading

from deepspeed_tpu_torch.resilience.counters import COUNTERS

logger = logging.getLogger(__name__)

#: process exited because it drained after a preemption request and saved an
#: emergency checkpoint: the launcher should relaunch (docs/resilience.md)
RESUME_EXIT_CODE = 43

PREEMPT_FILE_ENV = "DSTPU_PREEMPT_FILE"

_DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class PreemptionHandler:
    """Flag-setting signal handler + sentinel-file poll.

    ``install()`` registers the handlers (idempotent) and remembers the
    previous ones for ``uninstall()``.  ``requested`` is the HOST-LOCAL
    view; ``should_stop()`` runs the cross-host agreement so every process
    answers identically at the same boundary.
    """

    def __init__(self, sentinel_file: str = None,
                 signals=_DEFAULT_SIGNALS):
        self.sentinel_file = (sentinel_file if sentinel_file is not None
                              else os.environ.get(PREEMPT_FILE_ENV) or None)
        self.signals = tuple(signals)
        self._flag = False
        self._signum = None
        self._installed = False
        self._prev = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------- install
    def install(self) -> "PreemptionHandler":
        with self._lock:
            if self._installed:
                return self
            for sig in self.signals:
                try:
                    self._prev[sig] = signal.signal(sig, self._on_signal)
                except (ValueError, OSError):    # non-main thread / platform
                    logger.warning(
                        "preemption handler: could not install handler for "
                        "signal %s (non-main thread?)", sig)
            self._installed = True
        return self

    def uninstall(self) -> None:
        with self._lock:
            if not self._installed:
                return
            for sig, prev in self._prev.items():
                try:
                    signal.signal(sig, prev)
                except (ValueError, OSError):
                    pass
            self._prev = {}
            self._installed = False

    def _on_signal(self, signum, frame):
        # async-signal context: flip the flag, nothing else — the engine
        # polls it at the next step boundary
        self._flag = True
        self._signum = signum
        COUNTERS.preemptions += 1

    # --------------------------------------------------------------- state
    @property
    def requested(self) -> bool:
        """Host-local preemption view: a delivered signal, or the sentinel
        file existing (the test/orchestrator spelling)."""
        if self._flag:
            return True
        if self.sentinel_file and os.path.exists(self.sentinel_file):
            return True
        return False

    def clear(self) -> None:
        """Reset the local flag (the sentinel file is the caller's to
        remove) — used between in-process restart legs in tests."""
        self._flag = False
        self._signum = None

    def should_stop(self) -> bool:
        """Cross-host agreement: True everywhere iff ANY process has a
        pending preemption request.  Collective — every process must call
        it at the same step boundary."""
        return agree_any(self.requested)


# ----------------------------------------------------- agreement collective

def agree_any(flag: bool) -> bool:
    """An all-reduce (MAX) of the per-process flag over the default
    process group: True everywhere iff any process passed True.  Without
    a started group (one process) the local flag."""
    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return bool(flag)
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if device == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t[0]) > 0.0
