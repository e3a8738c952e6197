"""Wall-clock and throughput timers.

The port of ``deepspeed_tpu/utils/timer.py``.  Where the JAX package blocks
on the arrays a span produced, a CUDA span ends in
``torch.cuda.synchronize()`` (upstream deepspeed_timer.py:32-40); ``sync_on``
names the tensors whose device should be synchronised, and nothing is
synchronised for CPU tensors or when ``sync_on`` is None.  Every such wait
goes through ``observability.fences.fence_on``, which counts it.
"""

from __future__ import annotations

import logging
import time

import torch

logger = logging.getLogger(__name__)

try:
    import psutil
    PSUTIL_AVAILABLE = True
except ImportError:  # pragma: no cover
    PSUTIL_AVAILABLE = False


def _fence(sync_on) -> None:
    # the fence choke point: counted, so "zero fences between report
    # windows" is a number the tests pin
    from deepspeed_tpu_torch.observability import fences as obs_fences
    obs_fences.fence_on(sync_on)


class SynchronizedWallClockTimer:
    """Named span timers (upstream deepspeed_timer.py:19-79)."""

    class Timer:
        def __init__(self, name: str):
            self.name_ = name
            self.elapsed_ = 0.0
            self.started_ = False
            self.start_time = time.time()

        def start(self, sync_on=None):
            assert not self.started_, f"timer {self.name_} has already started"
            _fence(sync_on)
            self.start_time = time.time()
            self.started_ = True

        def stop(self, sync_on=None):
            assert self.started_, f"timer {self.name_} is not started"
            _fence(sync_on)
            self.elapsed_ += time.time() - self.start_time
            self.started_ = False

        def reset(self):
            self.elapsed_ = 0.0
            self.started_ = False

        def elapsed(self, reset: bool = True) -> float:
            started = self.started_
            if started:
                self.stop()
            e = self.elapsed_
            if reset:
                self.reset()
            if started:
                self.start()
            return e

    def __init__(self):
        self.timers = {}

    def __call__(self, name: str) -> "SynchronizedWallClockTimer.Timer":
        if name not in self.timers:
            self.timers[name] = self.Timer(name)
        return self.timers[name]

    @staticmethod
    def memory_usage() -> str:
        """Device memory (allocated + peak) and host memory."""
        parts = []
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            parts.append(
                f"device mem {torch.cuda.memory_allocated() / 2**30:.2f} GB "
                f"(peak {torch.cuda.max_memory_allocated() / 2**30:.2f})")
        if PSUTIL_AVAILABLE:
            vm = psutil.virtual_memory()
            parts.append(
                f"host mem used {vm.used / 2**30:.2f} GB ({vm.percent}%)")
        return " | ".join(parts)

    def log(self, names, normalizer: float = 1.0, reset: bool = True,
            memory_breakdown: bool = False):
        """Grouped ms printout (upstream deepspeed_timer.py:72-79)."""
        assert normalizer > 0.0
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                elapsed = self.timers[name].elapsed(reset=reset) * 1000.0
                string += f" | {name}: {elapsed / normalizer:.2f}"
        if memory_breakdown:
            string += " | " + self.memory_usage()
        logger.info(string)
        return string


class ThroughputTimer:
    """Samples/sec reporter (upstream deepspeed_timer.py:82-156), with the
    JAX package's window accounting: ``sync_on`` is synchronised only on
    the steps that report, so the host does not wait for the device on
    every step."""

    def __init__(self,
                 batch_size: int,
                 num_workers: int = 1,
                 start_step: int = 2,
                 steps_per_output: int = 50,
                 monitor_memory: bool = False,
                 logging_fn=None):
        self.start_time = 0.0
        self.end_time = 0.0
        self.started = False
        self.batch_size = max(1, batch_size)
        self.num_workers = num_workers
        self.start_step = start_step
        self.epoch_count = 0
        self.local_step_count = 0
        self.total_step_count = 0
        self.total_elapsed_time = 0.0
        self._window_start = None   # first start() since the last report
        self._window_steps = 0      # steps in the open window
        self._counted_steps = 0     # steps folded into total_elapsed_time
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory and PSUTIL_AVAILABLE
        self.logging = logging_fn or logger.info
        self.initialized = False

    def update_epoch_count(self):
        self.epoch_count += 1
        self.local_step_count = 0

    def start(self):
        self.initialized = True
        self.started = True
        if self.total_step_count >= self.start_step:
            self.start_time = time.time()
            if self._window_start is None:
                self._window_start = self.start_time

    def stop(self, report_speed: bool = True, sync_on=None):
        if not self.started:
            return
        self.started = False
        self.total_step_count += 1
        self.local_step_count += 1
        if self.total_step_count > self.start_step:
            self._window_steps += 1
            if (report_speed
                    and self.local_step_count % self.steps_per_output == 0):
                _fence(sync_on)
                self.end_time = time.time()
                self.total_elapsed_time += self.end_time - self._window_start
                self._counted_steps += self._window_steps
                self._window_start = None
                self._window_steps = 0
                self.logging(
                    f"{self.epoch_count}/{self.local_step_count}, "
                    f"SamplesPerSec={self.avg_samples_per_sec():.3f}")
                if self.monitor_memory:
                    vm = psutil.virtual_memory()
                    self.logging(
                        f"{self.epoch_count}/{self.local_step_count}, "
                        f"vm percent: {vm.percent}, swap percent: "
                        f"{psutil.swap_memory().percent}")

    def discard_window(self):
        """Drop the open (unreported) measurement window."""
        self._window_start = None
        self._window_steps = 0

    def avg_samples_per_sec(self) -> float:
        elapsed = self.total_elapsed_time
        steps = self._counted_steps
        if self._window_start is not None and self._window_steps > 0:
            elapsed += time.time() - self._window_start
            steps += self._window_steps
        if steps > 0 and elapsed > 0.0:
            samples_per_step = self.batch_size * self.num_workers
            return samples_per_step / (elapsed / steps)
        return float("-inf")
