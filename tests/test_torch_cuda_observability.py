"""The observability layer on the card: the metric spool's drain is driven
by a CUDA event and takes no synchronizing call, and the tracer records
the CUDA activity.  This file imports no JAX; without a card its tests
skip.  On a machine with one, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_observability.py
"""

import json
import threading
import warnings

import pytest
import torch

from deepspeed_tpu_torch.observability import fences
from deepspeed_tpu_torch.observability.spool import (GRAD_NORM, LOSS,
                                                     LOSS_SCALE, SKIP,
                                                     MetricSpool)
from deepspeed_tpu_torch.observability.tracing import Tracer, annotate

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the spool's event drain and the "
                    "tracer's CUDA activity exist only there)")
    return torch.device("cuda", 0)


def _busy(dev, n=24):
    """A chain of products that keeps the card busy for a while."""
    a = torch.randn(2048, 2048, device=dev)
    for _ in range(n):
        a = torch.tanh(a @ a / 2048.0)
    return a


def test_spool_drain_is_event_driven(dev):
    """Two appends behind queued work cross the window edge: the training
    thread takes no synchronizing call and no counted fence, the delivery
    thread hands over the window once the card reaches the copy, and its
    rows are the appended values."""
    got, done = [], threading.Event()

    def on_window(rows, pos):
        got.append((rows.copy(), pos))
        done.set()

    spool = MetricSpool(2, on_window, device=dev)
    a = _busy(dev)
    vals = [a.mean(), a.abs().mean()]
    f0 = fences.FENCE_COUNT
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i, v in enumerate(vals):
                spool.append(v, v * 2, torch.ones((), device=dev) * 8,
                             torch.zeros((), dtype=torch.bool, device=dev))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert fences.FENCE_COUNT == f0
    assert not [x for x in w
                if "called a synchronizing CUDA" in str(x.message)]
    assert done.wait(60.0)
    rows, pos = got[0]
    assert pos == 2 and rows.shape == (2, 4)
    want = torch.stack(vals).cpu()
    assert torch.equal(torch.from_numpy(rows[:, LOSS]), want)
    assert torch.equal(torch.from_numpy(rows[:, GRAD_NORM]), want * 2)
    assert (rows[:, LOSS_SCALE] == 8).all() and (rows[:, SKIP] == 0).all()
    spool.flush()                   # nothing new: no window, no fence
    assert len(got) == 1 and fences.FENCE_COUNT == f0


def test_tracer_records_cuda_activity(dev, tmp_path):
    tracer = Tracer(str(tmp_path), start_step=1, num_steps=1,
                    with_cuda=True)
    tracer.maybe_window(1)
    with annotate("fwd"):
        _busy(dev, n=4)
    torch.cuda.synchronize(dev)
    tracer.maybe_window(2)
    with open(tmp_path / "steps_1_2.json") as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    assert any(e.get("cat") == "kernel" for e in events)
    assert any(e.get("name") == "dstpu/fwd" for e in events)
