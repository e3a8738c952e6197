"""Deterministic fault injection for the chaos test suite.

Every injection point is keyed by explicit configuration — an env var (so a
launcher-spawned subprocess can be armed from outside) or the programmatic
``configure()`` twin — and is a no-op when unarmed, so production code paths
carry only a cheap attribute check.  Points are *deterministic*: "fail the
first N writes", "SIGTERM at step K on rank R", never random, so a chaos
test failure reproduces exactly.

Injection points (wired by checkpoint.py and resilience.driver):

==============================  ==============================================
``io_point("ckpt_write")``      raises ``IOError`` for the first
                                ``io_fail_writes`` checkpoint file writes
                                (``DSTPU_CHAOS_IO_FAIL_WRITES``)
``read_point("ckpt_read")``     raises ``IOError`` for the first
                                ``io_fail_reads`` restore chunk reads
                                (``DSTPU_CHAOS_IO_FAIL_READS``) — hit by
                                every restore reader, serial or pooled,
                                so the per-reader ``io_retry`` budget is
                                exercisable deterministically
``step_point(step, rank)``      at ``sigterm_step`` on ``sigterm_rank``
                                sends SIGTERM to this process
                                (``DSTPU_CHAOS_SIGTERM_STEP`` /
                                ``DSTPU_CHAOS_RANK``)
``maybe_stall(step)``           inside the engine's watchdog-armed
                                boundary region: stalls ``stall_s``
                                seconds in the recognisably-named
                                ``chaos_stall`` frame at ``stall_step``
                                (``DSTPU_CHAOS_STALL_STEP`` /
                                ``DSTPU_CHAOS_STALL_S``)
``nan_at(step)``                True at ``nan_step``
                                (``DSTPU_CHAOS_NAN_STEP``);
                                ``run_resumable`` then poisons the batch
                                with ``poison_batch`` so
                                the step's loss/grads go non-finite and the
                                engine's NaN/Inf sentinel must absorb it
==============================  ==============================================

The catalog lives in docs/resilience.md ("Fault-injection points").
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time

logger = logging.getLogger(__name__)

ENV_IO_FAIL_WRITES = "DSTPU_CHAOS_IO_FAIL_WRITES"
ENV_IO_FAIL_READS = "DSTPU_CHAOS_IO_FAIL_READS"
ENV_SIGTERM_STEP = "DSTPU_CHAOS_SIGTERM_STEP"
ENV_CHAOS_RANK = "DSTPU_CHAOS_RANK"
ENV_STALL_STEP = "DSTPU_CHAOS_STALL_STEP"
ENV_STALL_S = "DSTPU_CHAOS_STALL_S"
ENV_NAN_STEP = "DSTPU_CHAOS_NAN_STEP"


class _State:
    def __init__(self):
        self.io_fail_writes = 0     # fail this many io_point() calls, then heal
        self.io_fail_reads = 0      # fail this many read_point() calls
        self.sigterm_step = None    # SIGTERM self at this step
        self.sigterm_rank = None    # ...only on this rank (None = every rank)
        self.stall_step = None      # stall at this step
        self.stall_s = 0.0          # ...for this long
        self.stall_until = None     # ...or until this Event fires
                                    # (programmatic-only: tests end the
                                    # stall when the watchdog reacted)
        self.nan_step = None        # poison the batch at this step


_state = _State()


def _env_int(name):
    v = os.environ.get(name, "").strip()
    return int(v) if v else None


def reload_env() -> None:
    """(Re-)read the DSTPU_CHAOS_* env vars into the injection state —
    called once at import; call again after mutating os.environ in-process."""
    _state.io_fail_writes = _env_int(ENV_IO_FAIL_WRITES) or 0
    _state.io_fail_reads = _env_int(ENV_IO_FAIL_READS) or 0
    _state.sigterm_step = _env_int(ENV_SIGTERM_STEP)
    _state.sigterm_rank = _env_int(ENV_CHAOS_RANK)
    _state.stall_step = _env_int(ENV_STALL_STEP)
    _state.stall_s = float(os.environ.get(ENV_STALL_S, "0") or 0)
    _state.stall_until = None       # programmatic-only, never from env
    _state.nan_step = _env_int(ENV_NAN_STEP)


def configure(io_fail_writes: int = None, sigterm_step: int = None,
              sigterm_rank: int = None, stall_step: int = None,
              stall_s: float = None, nan_step: int = None,
              io_fail_reads: int = None, stall_until=None) -> None:
    """Programmatic arming (in-process tests); only the passed points move."""
    if stall_until is not None:
        _state.stall_until = stall_until
    if io_fail_writes is not None:
        _state.io_fail_writes = int(io_fail_writes)
    if io_fail_reads is not None:
        _state.io_fail_reads = int(io_fail_reads)
    if sigterm_step is not None:
        _state.sigterm_step = int(sigterm_step)
    if sigterm_rank is not None:
        _state.sigterm_rank = int(sigterm_rank)
    if stall_step is not None:
        _state.stall_step = int(stall_step)
    if stall_s is not None:
        _state.stall_s = float(stall_s)
    if nan_step is not None:
        _state.nan_step = int(nan_step)


def reset() -> None:
    """Disarm every injection point (does NOT touch os.environ)."""
    global _state
    _state = _State()


def armed() -> bool:
    return bool(_state.io_fail_writes or _state.io_fail_reads
                or _state.sigterm_step is not None
                or _state.stall_step is not None
                or _state.nan_step is not None)


# ------------------------------------------------------------------- points

def io_point(name: str = "ckpt_write") -> None:
    """Storage-write injection point: raises IOError while armed writes
    remain.  checkpoint._ChunkedWriter.finish calls this once per file."""
    if _state.io_fail_writes > 0:
        _state.io_fail_writes -= 1
        logger.warning("chaos: injected IO failure at %s (%d more armed)",
                       name, _state.io_fail_writes)
        raise IOError(f"chaos: injected IO failure at {name}")


#: read_point runs on restore-pool reader THREADS — the decrement must be
#: atomic or the armed count drifts (two readers both seeing 1)
_read_lock = threading.Lock()


def read_point(name: str = "ckpt_read") -> None:
    """Storage-read injection point: raises IOError while armed reads
    remain.  checkpoint._read_part calls this once per restore chunk, on
    whichever thread (serial caller or pool reader) performs the read."""
    if _state.io_fail_reads > 0:
        with _read_lock:
            if _state.io_fail_reads <= 0:
                return
            _state.io_fail_reads -= 1
            remaining = _state.io_fail_reads
        logger.warning("chaos: injected IO read failure at %s (%d more "
                       "armed)", name, remaining)
        raise IOError(f"chaos: injected IO read failure at {name}")


def step_point(step: int, rank: int = 0) -> None:
    """Step-boundary injection point (driver.run_resumable, before the
    step's work): SIGTERM-to-self at the armed step/rank."""
    if (_state.sigterm_step is not None and step == _state.sigterm_step
            and (_state.sigterm_rank is None or rank == _state.sigterm_rank)):
        _state.sigterm_step = None      # one shot
        logger.warning("chaos: SIGTERM self at step %d (rank %d)", step, rank)
        os.kill(os.getpid(), signal.SIGTERM)


def maybe_stall(step: int) -> None:
    """Collective-stall injection point: called by the ENGINE inside the
    watchdog-armed boundary region (step()/train_batch), so an armed stall
    is indistinguishable from a hung collective to the watchdog — the
    dump must name ``chaos_stall``."""
    if _state.stall_step is not None and step == _state.stall_step:
        _state.stall_step = None        # one shot
        until, _state.stall_until = _state.stall_until, None
        chaos_stall(_state.stall_s, until=until)


class _AnyEvent:
    """Composite stall-ender for multi-replica processes: only the
    replica that actually stalls has a watchdog that will fire, so the
    stall ends when ANY registered event sets."""

    def __init__(self, events):
        self.events = list(events)

    def is_set(self) -> bool:
        return any(e.is_set() for e in self.events)


def add_stall_until(event) -> None:
    """Register an ADDITIONAL stall-ending event.  ``configure``
    replaces the event; a process hosting several replicas (each with
    its own watchdog) must instead accumulate them — the stall lands in
    whichever replica reaches the armed dispatch first, and only that
    replica's watchdog reacts."""
    cur = _state.stall_until
    if cur is None:
        _state.stall_until = event
    elif isinstance(cur, _AnyEvent):
        cur.events.append(event)
    else:
        _state.stall_until = _AnyEvent([cur, event])


def chaos_stall(seconds: float, until=None) -> None:
    """Burn wall-clock inside a frame named ``chaos_stall`` so a watchdog
    stack dump identifies the stuck site by name.  ``until`` (a
    ``threading.Event``) ends the stall early — tests use the watchdog's
    ``fire_event`` so the stall lasts exactly until the dump happened."""
    logger.warning("chaos: stalling %.2fs", seconds)
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        if until is not None and until.is_set():
            return
        time.sleep(0.02)


def nan_at(step: int) -> bool:
    """True when the armed non-finite-loss step is ``step`` (one shot)."""
    if _state.nan_step is not None and step == _state.nan_step:
        _state.nan_step = None
        return True
    return False


def poison_batch(batch):
    """NaN-poison every float leaf of a batch (a tensor, an array, or a
    tuple/list/dict of them; integer token leaves pass through) — loss and
    gradients go non-finite downstream, which the engine's NaN/Inf
    sentinel must absorb as a skipped step.  A torch tensor stays a
    tensor on its device."""
    import numpy as np
    import torch

    def poison(leaf):
        if isinstance(leaf, (tuple, list)):
            return type(leaf)(poison(x) for x in leaf)
        if isinstance(leaf, dict):
            return {k: poison(v) for k, v in leaf.items()}
        if isinstance(leaf, torch.Tensor):
            return (torch.full_like(leaf, float("nan"))
                    if leaf.is_floating_point() else leaf)
        a = np.asarray(leaf)
        if np.issubdtype(a.dtype, np.floating):
            return np.full_like(a, np.nan)
        return leaf

    logger.warning("chaos: poisoning batch with NaN float leaves")
    return poison(batch)


reload_env()
