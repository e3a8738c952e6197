"""``calibrate_stream_threshold`` of the port: its threshold rule on given
timings (the reference's rule, ``deepspeed_tpu/ops/pallas_attention.py``
``calibrate_stream_threshold``: the first sequence length, in increasing
order, whose einsum time over kernel time is >= 1.05, else the causal
entry of the device table), and its refusal without a CUDA device.  The
measurement itself runs on the card (``chip_smoke.py``'s ``calibrate``
phase)."""

import pytest
import torch

from deepspeed_tpu_torch.models import layers as L
from deepspeed_tpu_torch.ops import stream_attention as sattn


@pytest.mark.parametrize("ratios,fallback,want", [
    ({256: 0.8, 512: 1.2, 1024: 2.0}, 256, 512),
    ({256: 1.05, 512: 0.9}, 512, 256),            # the margin is inclusive
    ({256: 1.049, 512: 1.0499}, 256, 256),        # none wins: the fallback
    ({1024: 3.0, 256: 0.5, 512: 1.06}, 256, 512),  # in increasing seq order
    ({256: 1.1, 512: 0.7, 1024: 1.3}, 512, 256),  # the first win, not the last
    ({}, 1024, 1024),
])
def test_threshold_rule(ratios, fallback, want):
    assert sattn.threshold_from_ratios(ratios, fallback) == want


def test_fallback_is_the_causal_table_entry():
    entry = L.STREAM_AUTO_MIN_BY_KIND["NVIDIA H100 80GB HBM3"]
    assert min(entry["causal"]) == 256
    assert L.STREAM_AUTO_MIN_CAUSAL == sattn.STREAM_TILE_MIN
    assert sattn.CALIBRATE_WIN == 1.05


def test_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the call measures")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        sattn.calibrate_stream_threshold()
