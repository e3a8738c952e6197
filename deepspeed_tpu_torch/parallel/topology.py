"""Device resolution and the parallel layout of one card.

The port of what one card needs from ``deepspeed_tpu/parallel/topology.py``:
this slice trains on one device, so data, model, sequence and pipeline
parallel sizes are all 1.  A config that asks for more raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deepspeed_tpu_torch import constants as C


@dataclasses.dataclass(frozen=True)
class Topology:
    """Data- and model-parallel sizes of the run (1 on one card) and its
    device."""
    device: torch.device
    dp: int = 1
    mp: int = 1


def resolve_device(device=None) -> torch.device:
    """``None`` means the first CUDA device, and raises when there is none:
    the port never falls back to the CPU on its own.  Tests pass
    ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "deepspeed_tpu_torch.initialize: no CUDA device is visible; "
                "pass device='cpu' explicitly to train on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not "
                               f"available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_topology(config: Optional[dict] = None, device=None) -> Topology:
    """One-card topology; any parallel size above 1 in ``config`` raises."""
    config = config or {}
    sizes = {C.MODEL_PARALLEL_SIZE: "tensor parallelism",
             C.CONTEXT_PARALLEL_SIZE: "sequence parallelism",
             C.PIPELINE_PARALLEL_SIZE: "pipeline parallelism"}
    for key, what in sizes.items():
        if int(config.get(key, 1) or 1) != 1:
            raise NotImplementedError(
                f"{key}={config[key]}: {what} is not ported to "
                f"deepspeed_tpu_torch yet (ROADMAP.md, Queue 1 items 5, 10 "
                f"and 11); this slice trains on one card")
    return Topology(device=resolve_device(device))
