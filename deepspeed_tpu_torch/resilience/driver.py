"""Auto-resume training driver: ``run_resumable``.

The piece that USES the bit-exact checkpoint/restore machinery
automatically when the world breaks: discover the newest VALID checkpoint
(``checkpoint.find_latest_valid_tag`` — validated, not just the ``latest``
pointer), restore engine + lr-scheduler + data-iterator state, and run the
step loop with preemption polling, chaos injection points, watchdog-armed
steps, and retry-wrapped storage IO.  On an agreed preemption it takes an
emergency checkpoint under ``emergency/`` and exits with
``RESUME_EXIT_CODE`` so a launcher's restart loop (or an external
orchestrator) relaunches the process; the relaunched process lands
back here and resumes step-accurately.

The resume proof (tests/test_torch_resilience.py, after the JAX
``tests/test_resilience.py``): a run SIGTERM'd mid-training finishes with
parameters BITWISE identical to an uninterrupted run, data-iterator
position included.  A drain flushes the telemetry spool before the
emergency save and the fleet after it, and dumps the flight recorder
(``preempt``); a crash dumps it too (``crash``).
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

from time import monotonic as _monotonic

from deepspeed_tpu_torch import checkpoint as ckpt_mod
from deepspeed_tpu_torch.observability.flightrec import RECORDER as _flightrec
from deepspeed_tpu_torch.resilience import chaos
from deepspeed_tpu_torch.resilience.counters import COUNTERS
from deepspeed_tpu_torch.resilience.preempt import (PreemptionHandler,
                                              RESUME_EXIT_CODE)
from deepspeed_tpu_torch.resilience.retry import io_retry

logger = logging.getLogger(__name__)

#: client_state key carrying the data-iterator snapshot
#: (data.DeepSpeedDataLoader.state_dict) inside every driver-written
#: checkpoint — namespaced so user client_state cannot collide
DATA_ITER_KEY = "__dstpu_data_iter__"

#: tag prefix for preemption-drain checkpoints: ``emergency/<tag>``
EMERGENCY_PREFIX = "emergency/"


def save_with_retry(engine, save_dir: str, tag: str = None,
                    client_state: dict = None, io_retries: int = None):
    """``engine.save_checkpoint`` + durability wait wrapped in ONE
    retry-with-backoff (the per-file writes are atomic, so a re-run after
    a transient error is safe).  The wait lives INSIDE the retried
    closure: with ``checkpoint.async_save`` the writes run on the writer
    thread and their errors only surface at ``checkpoint_wait()`` — left
    outside, the configured retry budget would silently never apply to
    the actual file IO.  ``io_retries`` defaults to the engine's
    ``resilience.io_retries`` config."""
    if io_retries is None:
        io_retries = int(getattr(engine.config, "resilience_io_retries", 3))

    def attempt():
        ret = engine.save_checkpoint(save_dir, tag=tag,
                                     client_state=client_state)
        engine.checkpoint_wait()    # no-op for sync saves
        return ret

    return io_retry(attempt, retries=io_retries,
                    what=f"checkpoint save ({tag or 'auto'})")


def load_with_retry(engine, load_dir: str, tag: str = None,
                    io_retries: int = None):
    if io_retries is None:
        io_retries = int(getattr(engine.config, "resilience_io_retries", 3))
    return io_retry(
        lambda: engine.load_checkpoint(load_dir, tag=tag),
        retries=io_retries, what=f"checkpoint load ({tag or 'auto'})")


def restore_latest(engine, save_dir: str, data_loader=None,
                   io_retries: int = None):
    """Restore the newest VALID checkpoint under ``save_dir`` (emergency
    tags included), data-iterator state included; no-op when none exists.
    Returns the restored tag (or None).

    Discovery validates only the model-state header (cheap), so a tag a
    mid-save SIGKILL left without its ZeRO shard files can still surface
    here; when the FULL load fails even after retries, the tag is excluded
    and the next-newest valid candidate is tried — one half-written tag
    must never brick a job whose older checkpoints are fine."""
    failed: list = []
    last_error = None
    while True:
        tag = ckpt_mod.find_latest_valid_tag(save_dir, exclude=failed)
        if tag is None:
            if last_error is not None:
                # checkpoints exist but NONE restored: a systematic error
                # (stage/topology mismatch, dead filesystem) — silently
                # training from scratch here would throw the run away
                raise last_error
            return None
        try:
            path, client = load_with_retry(engine, save_dir, tag=tag,
                                           io_retries=io_retries)
        except Exception as e:
            logger.warning(
                "resilience: checkpoint %r is not restorable (%s); "
                "falling back to the next-newest valid tag", tag, e)
            failed.append(tag)
            last_error = e
            continue
        if path is None:
            return None
        if data_loader is not None and client and DATA_ITER_KEY in client:
            data_loader.load_state_dict(client[DATA_ITER_KEY])
        COUNTERS.restarts += 1
        logger.info("resilience: resumed from %s at global step %d",
                    path, engine.global_steps)
        return tag


def _client_state(data_loader, extra: Optional[dict]) -> dict:
    state = dict(extra or {})
    if data_loader is not None:
        state[DATA_ITER_KEY] = data_loader.state_dict()
    return state


def run_resumable(engine_factory: Callable, train_step: Callable, *,
                  steps: int, save_dir: str, data_loader=None,
                  save_interval: int = 0, tag_prefix: str = "global_step",
                  client_state: dict = None, handler: PreemptionHandler = None,
                  save_final: bool = False):
    """Drive ``train_step(engine, batch)`` to ``steps`` optimizer
    boundaries, preemption-safely.

    Args:
      engine_factory: builds a FRESH engine (called once per invocation;
        a relaunched process calls ``run_resumable`` again and the factory
        rebuilds the engine the checkpoint restores into).
      train_step: ``(engine, batch) -> loss`` completing exactly ONE
        optimizer boundary (``engine.train_batch``, or gas split-API
        micro-steps + ``step()``).  ``batch`` is None when no
        ``data_loader`` is given.
      steps: target ``engine.global_steps``.
      save_dir: checkpoint root; resume discovery scans it for the newest
        valid tag (``checkpoint.find_latest_valid_tag``).
      data_loader: optional ``DeepSpeedDataLoader`` (defaults to the
        engine's ``training_dataloader``); its epoch/batch/seed state rides
        in every driver checkpoint and restores on resume.
      save_interval: periodic checkpoint every N boundaries (0 = only
        emergency saves).
      handler: a pre-installed :class:`PreemptionHandler` (a default one is
        installed otherwise — SIGTERM/SIGINT + ``DSTPU_PREEMPT_FILE``).
      save_final: also checkpoint at ``steps``.

    Returns the engine after ``steps`` boundaries.  Raises
    ``SystemExit(RESUME_EXIT_CODE)`` after an agreed preemption drain (the
    emergency checkpoint is durable first).
    """
    engine = engine_factory()
    # a default handler is OURS to uninstall on return: leaving it
    # installed would make the process permanently swallow Ctrl-C /
    # graceful SIGTERM after training finishes (a caller-provided handler
    # stays the caller's — install() is idempotent across legs)
    own_handler = handler is None
    if handler is None:
        handler = PreemptionHandler()
    handler.install()
    if data_loader is None:
        data_loader = engine.training_dataloader
    cache_dir = getattr(engine, "compile_cache_dir", None)
    if cache_dir:
        # enable() exported DSTPU_COMPILE_CACHE_DIR, so in-process
        # re-invocations and launcher relaunches (--max_restarts) all load
        # the kernel libraries from the same directory
        logger.info("resilience: kernel build directory %s (kept across "
                    "restart attempts)", cache_dir)
    rank = getattr(engine, "global_rank", 0)
    preempt_save = bool(getattr(engine.config, "resilience_preempt_save",
                                True))

    try:
        restore_latest(engine, save_dir, data_loader=data_loader)

        it = iter(data_loader) if data_loader is not None else None

        def next_batch():
            nonlocal it
            if it is None:
                return None
            # time the blocking fetch: the telemetry data-starvation
            # detector compares a window's data wait with its step time
            t0 = _monotonic()
            try:
                batch = next(it)
            except StopIteration:
                it = iter(data_loader)  # epoch rolled (loader re-shuffles)
                batch = next(it)
            note_wait = getattr(getattr(engine, "telemetry", None),
                                "note_data_wait_seconds", None)
            if note_wait is not None:
                note_wait(_monotonic() - t0)
            return batch

        while engine.global_steps < steps:
            step = engine.global_steps
            batch = next_batch()
            chaos.step_point(step, rank)    # SIGTERM / stall injection
            if chaos.nan_at(step) and batch is not None:
                batch = chaos.poison_batch(batch)
            before = engine.global_steps
            train_step(engine, batch)
            if engine.global_steps == before:
                raise RuntimeError(
                    "run_resumable: train_step completed no optimizer "
                    "boundary (global_steps did not advance) — it must "
                    "drive a full effective batch (train_batch, or gas "
                    "micro-steps + step())")

            # step-boundary preemption poll: collective agreement, so one
            # preempted host drains EVERY host here, at the same step
            if handler.should_stop():
                tag = f"{EMERGENCY_PREFIX}{tag_prefix}{engine.global_steps}"
                # the spooled window may be mid-fill: flush the LOCAL
                # spool BEFORE the emergency save, so the telemetry record
                # covers the drained step, but skip the fleet wait: the
                # grace period belongs to the checkpoint
                _flightrec.record("preempt_agreed", step=engine.global_steps)
                _flush_telemetry(engine, local_only=True)
                if preempt_save:
                    save_with_retry(engine, save_dir, tag=tag,
                                    client_state=_client_state(data_loader,
                                                               client_state))
                    logger.warning(
                        "resilience: preemption agreed at step %d; "
                        "emergency checkpoint %s durable, exiting %d for "
                        "restart",
                        engine.global_steps, tag, RESUME_EXIT_CODE)
                else:
                    logger.warning(
                        "resilience: preemption agreed at step %d "
                        "(preempt_save off); exiting %d",
                        engine.global_steps, RESUME_EXIT_CODE)
                # checkpoint durable: NOW the final fleet report, on a
                # short bound
                _flush_telemetry(engine, fleet_timeout=10.0)
                # post-mortem artifact before the drain exit: which step
                # this host reached
                _flightrec.record("preempt", step=engine.global_steps)
                _flightrec.dump("preempt")
                raise SystemExit(RESUME_EXIT_CODE)

            if save_interval and engine.global_steps % save_interval == 0 \
                    and engine.global_steps < steps:
                save_with_retry(engine, save_dir,
                                tag=f"{tag_prefix}{engine.global_steps}",
                                client_state=_client_state(data_loader,
                                                           client_state))

        if save_final:
            save_with_retry(engine, save_dir, tag=f"{tag_prefix}{steps}",
                            client_state=_client_state(data_loader,
                                                       client_state))
        _flush_telemetry(engine)
        return engine
    except SystemExit:
        raise               # the drain path dumped above
    except BaseException as e:
        # crash exit: leave the ring on disk so the post-mortem knows the
        # step this host died at — best-effort, never masks the crash
        _flightrec.record("crash", step=engine.global_steps,
                          error=repr(e)[:200])
        _flightrec.dump("crash")
        raise
    finally:
        if own_handler:
            handler.uninstall()


def _flush_telemetry(engine, **kwargs) -> None:
    """Deliver the final (possibly partial) metric window — best-effort;
    a telemetry failure must never turn a clean drain into a crash."""
    flush = getattr(engine, "flush_telemetry", None)
    if flush is None:
        return
    try:
        flush(**kwargs)
    except Exception as e:  # pragma: no cover - defensive
        logger.warning("resilience: telemetry flush failed: %s", e)
