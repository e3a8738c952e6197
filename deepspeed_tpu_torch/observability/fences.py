"""Host-fence accounting: the choke point every deliberate host wait on
device data goes through (the port of ``deepspeed_tpu/observability/
fences.py``).

A "fence" is a host-side read of a tensor the device produces: a
``torch.cuda.synchronize()``, a ``float()``/``bool()``/``.item()`` of a
device scalar, a blocking copy to the host.  Each one serializes the host's
launches with the device's work, so the telemetry layer keeps them off the
per-step path: metrics spool through a device ring buffer and drain once
per report window (``observability/spool.py``).

Every fence the engine takes ON PURPOSE routes through this module (the
``utils/timer.py`` synchronize, the fp16 / NaN-sentinel boundary read of
the skip flag, the TensorBoard loss read, the spool flush), so "zero
fences between report windows" is a COUNTER the tests pin, not a
code-review convention.  A read of a CPU tensor counts as a fence too: the
count follows the code path, not the device it ran on.
"""

from __future__ import annotations

#: process-wide count of deliberate host fences (monotonic; tests snapshot
#: around a region and assert the delta)
FENCE_COUNT = 0


def count_fence(n: int = 1) -> None:
    """Record ``n`` deliberate host fences (called by the sites that wait)."""
    global FENCE_COUNT
    FENCE_COUNT += n


def _tensors(obj):
    import torch
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def fence_on(sync_on) -> None:
    """Wait for the devices of the tensors in ``sync_on`` (None = no-op),
    counting ONE fence for the whole tree: it is one host wait, however
    many tensors drain behind it.  CPU tensors need no wait."""
    if sync_on is None:
        return
    devices = {t.device for t in _tensors(sync_on)}
    if not devices:
        return
    count_fence()
    import torch
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def read_scalar(x):
    """Fetch one device scalar to the host (a fence) and return the Python
    value.  The engine's boundary read of the skip flag routes through
    here."""
    import torch
    if isinstance(x, torch.Tensor):
        count_fence()
        return x.item()
    return x


def read_arrays(*xs):
    """Fetch tensors to host numpy arrays (one counted fence for the
    batch).  The spool's synchronous flush routes through here."""
    import torch
    if any(isinstance(x, torch.Tensor) for x in xs):
        count_fence()
    return tuple(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                 else x for x in xs)
