"""Step tracing: a scheduled ``torch.profiler`` window and hang capture.

The port of ``deepspeed_tpu/observability/tracing.py``.  Two capture paths
share one :class:`Tracer`:

* scheduled window: ``observability: {trace_dir, trace_start_step,
  trace_num_steps}`` captures the optimizer boundaries ``[start, start +
  num)``.  The checks are ranges, so a resume that lands mid-window still
  traces the rest; configuring the ``profile`` section as well is a
  config error, as in the JAX package.  The profiler is warmed one
  boundary ahead, and on a card the window starts and stops behind a
  drain of the card's queue, so the trace holds exactly the kernels that
  the window's steps launched.
* hang capture: the resilience watchdog's ``on_fire`` hook.  When a hang
  deadline trips, the monitor thread records a short trace under
  ``<trace_dir>/hang_*.json`` before the optional abort.

A capture records the CPU activity always and the CUDA activity on a card;
it is written as a Chrome-trace JSON file (``torch.profiler``'s
``export_chrome_trace``), loadable in Perfetto or ``chrome://tracing``.
:func:`annotate` gives the ``dstpu/<span>`` ranges the engine wraps around
forward, backward, the boundary and the checkpoint IO
(``torch.profiler.record_function``); outside a capture it is a
``nullcontext``.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from contextlib import nullcontext
from typing import Optional

logger = logging.getLogger(__name__)

#: env spelling of the trace directory: how the launcher (``--trace_dir``)
#: hands the capture destination to every worker and relaunch
ENV_TRACE_DIR = "DSTPU_TRACE_DIR"

#: set while ANY capture is active (the scheduled window, a hang capture or
#: the engine's ``profile`` window); :func:`annotate` records nothing
#: otherwise
_capture_active = threading.Event()


def note_capture_active(active: bool) -> None:
    """Capture bracket: called by every start and stop site (the Tracer
    and the engine's ``start_profile`` / ``stop_profile``)."""
    if active:
        _capture_active.set()
    else:
        _capture_active.clear()


def _rank_and_world():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def resolve_trace_dir(cfg_dir: Optional[str]) -> Optional[str]:
    """The config's directory beats the :data:`ENV_TRACE_DIR` fallback; a
    multi-process run gets one subdirectory per process, so workers never
    overwrite each other's files."""
    d = cfg_dir or os.environ.get(ENV_TRACE_DIR) or None
    if d is None:
        return None
    rank, world = _rank_and_world()
    if world > 1:
        d = os.path.join(d, f"proc{rank}")
    return d


def annotate(span: str):
    """``with annotate("fwd"): ...``: a ``dstpu/<span>`` range while a
    capture is active, a ``nullcontext`` otherwise."""
    if not _capture_active.is_set():
        return nullcontext()
    import torch
    return torch.profiler.record_function(f"dstpu/{span}")


def prepare_capture(with_cuda: Optional[bool] = None):
    """A ``torch.profiler.profile`` whose tracing is prepared (CUPTI
    enabled) but not recording: CPU activity, and CUDA activity when a
    card is in use (``with_cuda`` None: when CUDA is initialized).  A
    capture that starts recording one boundary later loses no kernel to
    CUPTI's start-up (torch.profiler's "warmup")."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if with_cuda is None:
        with_cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU]
    if with_cuda:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.prepare_trace()
    return prof


def _drain_device() -> None:
    """Wait for the card's queued work (a counted fence): a capture that
    starts or stops behind it holds exactly the kernels launched inside
    it, none of the step before still running, none of its own cut off."""
    import torch

    from deepspeed_tpu_torch.observability import fences
    fences.count_fence()
    torch.cuda.synchronize()


def start_capture(with_cuda: Optional[bool] = None, prepared=None):
    """A recording ``torch.profiler.profile`` (``prepared``'s, or a new
    one's)."""
    prof = prepared if prepared is not None else prepare_capture(with_cuda)
    prof.start_trace()
    return prof


def export_capture(prof, path: str) -> str:
    """Write the stopped ``prof``'s Chrome trace to ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    prof.export_chrome_trace(path)
    return path


def stop_capture(prof, path: str) -> str:
    """Stop ``prof`` and write its Chrome trace to ``path``."""
    prof.stop_trace()
    return export_capture(prof, path)


class Tracer:
    """Owns the profiler captures of one engine.  Thread-safe: the
    scheduled window runs on the training thread, the hang capture on the
    watchdog's monitor thread; one capture at a time."""

    def __init__(self, trace_dir: str, start_step: int = 0,
                 num_steps: int = 0, hang_capture_s: float = 1.0,
                 with_cuda: Optional[bool] = None):
        self.trace_dir = trace_dir
        self.start_step = int(start_step)
        self.end_step = self.start_step + int(num_steps)
        self.hang_capture_s = float(hang_capture_s)
        self.with_cuda = with_cuda
        self._lock = threading.Lock()
        self._active = None         # path of the active capture, or None
        self._prof = None
        self._prepared = None       # the scheduled window's warm profiler
        self._window_path = None    # the scheduled window's capture path
        self._window_done = False
        self._atexit = False

    # ----------------------------------------------------------- start/stop
    def _start(self, path: str, prepared=None, drain: bool = False) -> bool:
        """``drain``: start after the card's queued work (the fence runs
        before the lock: a wait under it would stall the other thread)."""
        if drain:
            _drain_device()
        with self._lock:
            if self._active is not None:
                return False
            try:
                self._prof = start_capture(self.with_cuda, prepared)
            except Exception as e:
                logger.warning("trace capture could not start (%s): %s",
                               path, e)
                return False
            self._active = path
            note_capture_active(True)
        if not self._atexit:
            # write the capture even if training ends inside the window
            import atexit
            atexit.register(self.stop)
            self._atexit = True
        logger.info("telemetry: trace capture started -> %s", path)
        return True

    def stop(self, drain: bool = False) -> Optional[str]:
        """Stop the active capture (``drain``: after the card's queued
        work) and write it; the fence and the file IO run outside the
        lock."""
        if drain:
            _drain_device()
        with self._lock:
            path, self._active = self._active, None
            prof, self._prof = self._prof, None
            if path is None:
                return None
            note_capture_active(False)
            try:
                prof.stop_trace()
            except Exception as e:  # pragma: no cover - defensive
                logger.warning("trace capture stop failed: %s", e)
                return None
        try:
            export_capture(prof, path)
        except Exception as e:  # pragma: no cover - defensive
            logger.warning("trace capture write failed: %s", e)
            return None
        logger.info("telemetry: trace capture stopped (%s)", path)
        return path

    # ------------------------------------------------------ scheduled window
    def maybe_window(self, global_step: int) -> None:
        """Boundary hook: warm the profiler one boundary before the
        configured window, start it at the window, stop it after."""
        if self.end_step <= self.start_step:
            return
        if (self._active is None and not self._window_done
                and self._prepared is None
                and global_step == self.start_step - 1):
            try:
                prepared = prepare_capture(self.with_cuda)
            except Exception as e:
                logger.warning("trace capture could not warm up: %s", e)
            else:
                with self._lock:
                    self._prepared = prepared
        elif (self._active is None and not self._window_done
                and self.start_step <= global_step < self.end_step):
            path = os.path.join(
                self.trace_dir,
                f"steps_{self.start_step}_{self.end_step}.json")
            # the scheduled window drains the card at its edges (two
            # counted fences a window; never the hang capture, whose card
            # may be the thing that hangs)
            if self._start(path, self._take_prepared(),
                           drain=bool(self.with_cuda)):
                self._window_path = path
        elif (self._active is not None
                and self._active == self._window_path
                and global_step >= self.end_step):
            # stop only the scheduled capture: a concurrent hang capture
            # must not be cut short by the next boundary's bookkeeping
            self.stop(drain=bool(self.with_cuda))
            self._window_path = None
            self._window_done = True

    def _take_prepared(self):
        with self._lock:
            prepared, self._prepared = self._prepared, None
        return prepared

    # ----------------------------------------------------------- hang capture
    def capture_hang(self, tag: str = "") -> Optional[str]:
        """A short trace when the watchdog fires; runs on the monitor
        thread while the training thread is stuck.  Returns the trace's
        path, or None when a capture was already active or could not
        start."""
        path = os.path.join(
            self.trace_dir,
            f"hang_{tag or 'watchdog'}_{int(time.time())}.json")
        # a profiler warmed for the scheduled window serves the hang
        # capture (one profiler session at a time)
        if not self._start(path, self._take_prepared()):
            return None
        time.sleep(self.hang_capture_s)
        return self.stop()
