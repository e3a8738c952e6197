"""Preemption-safe training, fault injection and hang detection.

The port of ``deepspeed_tpu/resilience/``: the same modules, exit codes,
counter names and chaos environment keys, in PyTorch idiom where the
package touches the device (``agree_any`` is an all-reduce over the
default process group; ``chaos.poison_batch`` poisons torch tensors).

Four cooperating pieces (docs/resilience.md):

* **preemption** (:mod:`.preempt`): SIGTERM/SIGINT (+ ``DSTPU_PREEMPT_FILE``
  sentinel) set a flag the step loop polls at optimizer boundaries; an
  all-reduce agreement makes every process drain at the SAME step, take one
  emergency checkpoint (``emergency/`` tags), and exit
  ``RESUME_EXIT_CODE``.
* **auto-resume** (:mod:`.driver`): :func:`run_resumable` discovers the
  newest VALID checkpoint, restores engine + lr-scheduler + data-iterator
  state, and continues step-accurately; the launcher's ``--max_restarts``
  relaunch loop on ``RESTARTABLE_EXIT_CODES`` closes the circle
  (``launcher/launch.py``).
* **hang watchdog** (:mod:`.watchdog`): a heartbeat thread armed around
  each blocking step/collective/checkpoint call; past the deadline it dumps
  all-thread stacks + recent step timings and (configurably) aborts with
  ``WATCHDOG_EXIT_CODE``.  Storage IO is additionally retry-wrapped
  (:func:`.retry.io_retry`).
* **fault injection** (:mod:`.chaos`): deterministic env/config-keyed
  injection points (IO error on Nth write, SIGTERM at step K, stall,
  non-finite loss) driving the ``chaos`` test tier.

Config: the ``resilience`` JSON block (``preempt_save``, ``max_restarts``,
``watchdog_timeout_s``, ``watchdog_abort``, ``io_retries``,
``nan_sentinel``) — docs/config.md.

This module (and everything it imports eagerly) imports neither torch nor
the engine: a launcher parent process imports the exit-code contract.
``run_resumable`` and friends load lazily.  The driver and the watchdog
record into and dump the flight recorder (``observability/flightrec.py``).
"""

from deepspeed_tpu_torch.resilience import chaos  # noqa: F401
from deepspeed_tpu_torch.resilience.counters import (  # noqa: F401
    COUNTERS, Counters)
from deepspeed_tpu_torch.resilience.preempt import (  # noqa: F401
    PREEMPT_FILE_ENV, PreemptionHandler, RESUME_EXIT_CODE, agree_any)
from deepspeed_tpu_torch.resilience.retry import io_retry  # noqa: F401
from deepspeed_tpu_torch.resilience.watchdog import (  # noqa: F401
    WATCHDOG_EXIT_CODE, Watchdog)

#: exit codes after which the launcher's --max_restarts loop relaunches
RESTARTABLE_EXIT_CODES = (RESUME_EXIT_CODE, WATCHDOG_EXIT_CODE)

_DRIVER_API = ("run_resumable", "restore_latest", "save_with_retry",
               "load_with_retry", "DATA_ITER_KEY", "EMERGENCY_PREFIX")


def __getattr__(name):
    # driver imports checkpoint (which imports torch and, for the chaos IO
    # hook, this package) — load it lazily to keep this module light and
    # cycle-free
    if name in _DRIVER_API or name == "driver":
        # importlib, not a from-import: ``from pkg import mod`` re-enters
        # this __getattr__ via _handle_fromlist before the submodule is
        # bound, recursing forever
        import importlib
        _driver = importlib.import_module(
            "deepspeed_tpu_torch.resilience.driver")
        return _driver if name == "driver" else getattr(_driver, name)
    raise AttributeError(
        f"module 'deepspeed_tpu_torch.resilience' has no attribute {name!r}")
