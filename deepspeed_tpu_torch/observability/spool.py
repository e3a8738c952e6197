"""MetricSpool: a device-side metric ring buffer, drained once per window.

The port of ``deepspeed_tpu/observability/spool.py``.  Upstream's engine
waited for the device on every step to report scalars
(``deepspeed_timer.py``'s ``torch.cuda.synchronize``); the spool removes
that wait:

* each optimizer boundary APPENDS its metrics (loss, global grad norm,
  loss scale, skip flag) into a ``[window, 4]`` fp32 tensor on the
  engine's device with in-place tensor ops: no host transfer, no wait.
* every ``report_window`` boundaries the ring is copied, ``non_blocking``,
  into a pinned host buffer, and a CUDA event is recorded behind the copy.
  A daemon thread waits for that event (polling ``Event.query``, which
  never synchronizes the device) and delivers the window: the training
  thread never waits.  This is the counterpart of the JAX drain's
  ``io_callback``.  On the CPU the copy is a plain clone, delivered by the
  same thread.
* ``flush()`` is the only synchronous read, a single counted fence
  (``observability/fences.py``), used at run end, before a restore and on
  a preemption drain so that the final partial window is never dropped.

Trajectory neutrality: the append reads tensors the boundary already
computed (loss, norm, scale, overflow) and writes only the ring, so the
optimizer math is bitwise the same with the spool on or off
(``tests/test_torch_observability.py``).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable

import numpy as np
import torch

from deepspeed_tpu_torch.observability import fences

logger = logging.getLogger(__name__)

#: ring-buffer channel layout ([window, N_CHANNELS] fp32)
LOSS, GRAD_NORM, LOSS_SCALE, SKIP = range(4)
N_CHANNELS = 4

#: the delivery thread's poll of a drain's CUDA event
_POLL_S = 0.0005


def _scalar(x, device) -> torch.Tensor:
    """``x`` (a tensor, a tuple of loss tensors or a number) as a 0-d fp32
    tensor on ``device``, without a host read."""
    if isinstance(x, (tuple, list)):
        return sum(_scalar(v, device) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=torch.float32).sum()
    return torch.tensor(float(x), dtype=torch.float32, device=device)


class MetricSpool:
    """Owns the device ring, the window bookkeeping and the delivery
    thread.

    ``on_window(rows, end_pos)`` receives the drained window as a host
    ``[n, 4]`` numpy array (append order) and the append count at the
    window's end; it runs on the delivery thread for window edges and on
    the calling thread for ``flush()``.
    """

    def __init__(self, window: int,
                 on_window: Callable[[np.ndarray, int], None],
                 device=None):
        if window < 1:
            raise ValueError(f"spool window must be >= 1, got {window}")
        self.window = int(window)
        self.device = torch.device(device if device is not None else "cpu")
        self._on_window = on_window
        self.buf = torch.zeros((self.window, N_CHANNELS),
                               dtype=torch.float32, device=self.device)
        self._appended = 0       # appends noted by the host
        self._drained = 0        # appends already handed to on_window
        self._lock = threading.Lock()
        self._queue: "queue.Queue" = queue.Queue()
        self._thread = None

    # ------------------------------------------------------------- append
    def write_row(self, offset: int, loss, grad_norm, loss_scale,
                  overflow) -> None:
        """Write one boundary's metrics into the ring row of append
        ``appended + offset`` (device ops only).  ``note_appends`` makes
        the rows count."""
        dev = self.device
        vec = torch.stack([_scalar(loss, dev), _scalar(grad_norm, dev),
                           _scalar(loss_scale, dev), _scalar(overflow, dev)])
        self.buf[(self._appended + int(offset)) % self.window].copy_(vec)

    def append(self, loss, grad_norm, loss_scale, overflow) -> None:
        """One boundary: its row, then the bookkeeping (and the drain on a
        window edge)."""
        self.write_row(0, loss, grad_norm, loss_scale, overflow)
        self.note_appends(1)

    def would_straddle(self, n: int) -> bool:
        """True when ``n`` further appends would cross a window edge inside
        one block: the ring holds exactly one window, so rows past the edge
        would overwrite undrained ones.  Pure K-block runs never straddle
        (the config pins ``window % K == 0``); a run that mixed a stray
        single append in can, and the engine flushes first."""
        return (self._appended % self.window) + int(n) > self.window

    def note_appends(self, n: int) -> None:
        """Count ``n`` rows written since the last call (``train_many``
        writes a K-block's rows, then notes them at once) and drain on
        every window-edge crossing."""
        if n > self.window:
            # unreachable through the engine (the config checks window
            # alignment), but an overrun must be loud, never silent
            raise ValueError(
                f"spool: {n} appends in one block exceed the report window "
                f"({self.window}); rows would be overwritten before any "
                f"drain could deliver them")
        before = self._appended
        self._appended += int(n)
        if before // self.window != self._appended // self.window:
            self.drain_async()

    # -------------------------------------------------------------- drain
    def drain_async(self) -> None:
        """Copy the ring to a fresh pinned host buffer behind the step's
        work and hand it to the delivery thread: the host does NOT wait."""
        if self.device.type == "cuda":
            host = torch.empty(self.buf.shape, dtype=self.buf.dtype,
                               pin_memory=True)
            host.copy_(self.buf, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        else:
            host, event = self.buf.clone(), None
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="dstpu-spool-drain")
            self._thread.start()
        self._queue.put((host, event, self._appended))

    def _run(self) -> None:
        while True:
            host, event, pos = self._queue.get()
            try:
                if event is not None:
                    while not event.query():
                        time.sleep(_POLL_S)
                self._deliver(host.numpy(), pos)
            except Exception as e:  # pragma: no cover - defensive
                logger.warning("telemetry drain failed: %s", e)
            finally:
                self._queue.task_done()

    def _deliver(self, buf: np.ndarray, pos: int) -> None:
        # under the lock: the counter update and the on_window call are
        # atomic, so windows reach the sinks once and in append order even
        # when a flush and a late delivery race
        with self._lock:
            n = pos - self._drained
            if n <= 0:
                return
            if n > self.window:
                # unreachable by design (a drain runs at every window edge
                # and flush waits for the outstanding ones first), but an
                # overrun must lose data LOUDLY, never slice garbage
                logger.error(
                    "telemetry spool overran: %d appends undelivered with "
                    "window %d — delivering the most recent %d",
                    n, self.window, self.window)
                n = self.window
            idx = [(pos - n + i) % self.window for i in range(n)]
            self._drained = pos
            self._on_window(buf[idx], pos)

    def flush(self) -> None:
        """Synchronously deliver whatever the ring holds past the last
        drain: THE one deliberate fence of the telemetry layer (run end,
        restore, preemption drain).  The outstanding window-edge drains are
        delivered first, so ``pos - drained`` never exceeds the ring."""
        self._queue.join()
        if self._appended == self._drained:
            return
        buf, = fences.read_arrays(self.buf)
        self._deliver(buf, self._appended)
