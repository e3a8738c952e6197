"""Retry-with-backoff for transient storage errors.

Checkpoint saves/loads on preemptible pods hit transient filesystem and
object-store errors (EIO, ESTALE, throttling surfaced as OSError); a single
flake must not kill a run the rest of the subsystem works hard to keep
alive.  Per-file checkpoint writes are already atomic (temp + ``os.replace``,
checkpoint._ChunkedWriter), so re-running a whole save/load is safe.
"""

from __future__ import annotations

import logging
import random
import time
from typing import Callable, Tuple, Type

from deepspeed_tpu_torch.resilience.counters import COUNTERS

logger = logging.getLogger(__name__)

#: transient storage failures worth retrying; ValueError/TypeError style
#: logic errors are NOT — retrying those only delays the real traceback
IO_EXCEPTIONS: Tuple[Type[BaseException], ...] = (OSError,)


def io_retry(fn: Callable, retries: int = 3, base_delay_s: float = 0.05,
             max_delay_s: float = 5.0, exceptions=IO_EXCEPTIONS,
             what: str = "storage op"):
    """Run ``fn()`` with up to ``retries`` retries on ``exceptions``.

    Backoff is exponential with full jitter:
    ``min(max_delay_s, base_delay_s * 2**attempt) * uniform(0.5, 1.5)`` —
    jitter so a pod's worth of workers retrying a shared filesystem do not
    re-stampede in lockstep.  Every retry increments
    ``COUNTERS.io_retries``; the final failure re-raises the last error.
    """
    retries = max(0, int(retries))
    for attempt in range(retries + 1):
        try:
            return fn()
        except exceptions as e:
            if attempt == retries:
                logger.error("%s failed after %d retries: %s",
                             what, retries, e)
                raise
            COUNTERS.io_retries += 1
            delay = (min(max_delay_s, base_delay_s * (2.0 ** attempt))
                     * (0.5 + random.random()))
            logger.warning("%s failed (%s); retry %d/%d in %.2fs",
                           what, e, attempt + 1, retries, delay)
            time.sleep(delay)
