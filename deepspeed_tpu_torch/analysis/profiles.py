"""Per-device capacity profiles for the planners.

The port of ``deepspeed_tpu/analysis/profiles.py`` with the port's own
devices.  No TPU profile is carried over: the port runs on an H100 or on
the CPU, and a number of a TPU is no number of either.

* ``h100``: the H100 SXM.  HBM is the card's
  ``torch.cuda.get_device_properties(0).total_memory`` (79.1 GiB without a
  card) less ``H100_RESERVE_GIB``, the device memory the process holds
  outside the caching allocator (CUDA context, loaded kernel libraries,
  cuBLAS handles), measured by ``chip_smoke.py``'s ``analysis_gpt2`` (e)
  as ``total_memory - free - memory_reserved()``; the allocator's
  fragmentation is not in it.  The bf16 peak is NVIDIA's dense 989
  TFLOP/s.  The link rates are NVIDIA's nominal figures: NVLink 4 at 450
  GB/s each way per GPU, PCIe Gen5 x16 at 64 GB/s each way (the ``data``
  axis across hosts).  The host constants (``dispatch_us``, ``fence_us``,
  ``callback_us``, ``h2d_gibps``) and ``stream_workspace_bytes`` are the
  ones ``analysis_gpt2`` (e) measured on the card (see PERF.md for the
  card's name and power limit).
* ``cpu``: the test rig.  ``lowp_dot_f32_copies`` is the CPU quirk: there
  is no bf16/fp16 product with an fp32 result on this host, so a
  low-precision product's fp32 accumulation is an upcast of its operands.

``resolve`` of a JAX TPU name (``v4-8``, ``v5e-8``, ``v5p-8``, which the
shipped configs name) returns the profile of the device the engine runs
on, with one warning naming both; any other unknown name raises.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class BackendProfile:
    """Declared capability sheet of one device."""

    name: str
    #: usable device memory in GiB (the planner's default budget)
    hbm_gib: float
    #: nominal in-node link rate per device, GiB/s one way (NVLink)
    ici_gibps: float
    #: nominal cross-host rate, GiB/s (the ``data`` axis across hosts)
    dcn_gibps: float
    #: dense bf16 peak, TFLOP/s
    peak_bf16_tflops: float
    #: CPU quirk: a bf16/fp16 product's fp32 accumulation is an upcast of
    #: its operands (the lint reports it at INFO there)
    lowp_dot_f32_copies: bool = False
    #: host cost of one launch (a kernel eager, a graph replay graphed), us
    dispatch_us: float = 5.0
    #: host cost of one deliberate fence (a synchronize + scalar read), us
    fence_us: float = 20.0
    #: host cost of one host-callback crossing (the spool's drain), us
    callback_us: float = 20.0
    #: host -> device staging rate, GiB/s
    h2d_gibps: float = 10.0
    #: device memory a stream's first matrix products allocate and keep
    #: (the cuBLAS and cuBLASLt workspaces of that stream), bytes
    stream_workspace_bytes: int = 0

    @property
    def hbm_bytes(self) -> int:
        return int(self.hbm_gib * (1 << 30))


#: the H100's device memory outside the caching allocator (GiB): 835,518,464
#: bytes, measured by chip_smoke.py's analysis_gpt2 (e) late in a whole run
#: (every kernel library and cuBLAS handle loaded)
H100_RESERVE_GIB = 0.778
H100_TOTAL_GIB = 79.1

PROFILES: Dict[str, BackendProfile] = {
    # the host constants and the stream workspace: measured by
    # chip_smoke.py's analysis_gpt2 (e) on an H100 80GB HBM3 at a 700 W
    # limit (PERF.md): a launch, a fence (synchronize + a scalar read), a
    # drain's host side (pinned buffer, async copy, event), pinned
    # staging; a new stream's cuBLAS and cuBLASLt workspaces (with
    # CUBLAS_WORKSPACE_CONFIG=:4096:8, as chip_smoke.py sets it)
    "h100": BackendProfile(
        name="h100", hbm_gib=H100_TOTAL_GIB - H100_RESERVE_GIB,
        ici_gibps=450e9 / 2 ** 30, dcn_gibps=64e9 / 2 ** 30,
        peak_bf16_tflops=989.0, dispatch_us=6.95, fence_us=22.1,
        callback_us=20.0, h2d_gibps=48.2,
        stream_workspace_bytes=34603008),
    "cpu": BackendProfile(
        name="cpu", hbm_gib=4.0, ici_gibps=10.0, dcn_gibps=10.0,
        peak_bf16_tflops=1.0, lowp_dot_f32_copies=True,
        dispatch_us=4.0, fence_us=0.1, callback_us=20.0, h2d_gibps=1.0),
}

#: axes that cross hosts when the layout spans them
DCN_AXES = frozenset({"data"})

#: the JAX package's TPU profile names: a config naming one runs on the
#: port's device profile instead
TPU_NAMES = frozenset({"v4-8", "v5e-8", "v5p-8", "v4", "v5e", "v5p",
                       "cpu-8"})

_warned: set = set()


def _h100_for_card() -> BackendProfile:
    """``h100`` with the running card's memory, when there is one."""
    try:
        import torch
        if torch.cuda.is_available():
            total = torch.cuda.get_device_properties(0).total_memory
            return dataclasses.replace(
                PROFILES["h100"],
                hbm_gib=total / 2 ** 30 - H100_RESERVE_GIB)
    except Exception:  # noqa: BLE001 - probing is best effort
        pass
    return PROFILES["h100"]


def resolve(name: str, device=None) -> BackendProfile:
    """Profile by name; a JAX TPU name resolves to the profile of
    ``device`` (default: the running one), with one warning."""
    key = str(name).strip().lower()
    if key == "h100":
        return _h100_for_card()
    if key in PROFILES:
        return PROFILES[key]
    if key in TPU_NAMES:
        prof = default_profile(device)
        if key not in _warned:
            _warned.add(key)
            logger.warning(
                "analysis profile %r is a TPU profile of the JAX package; "
                "the port plans with the profile of the device it runs on, "
                "%r", name, prof.name)
        return prof
    raise KeyError(
        f"unknown backend profile {name!r}; known: "
        f"{sorted(set(PROFILES) | TPU_NAMES)}")


def default_profile(device=None) -> BackendProfile:
    """The profile of ``device`` (a ``torch.device`` or its type; default:
    the card when one is visible, else the CPU)."""
    kind = getattr(device, "type", device)
    if kind is None:
        try:
            import torch
            kind = "cuda" if torch.cuda.is_available() else "cpu"
        except Exception:  # noqa: BLE001
            kind = "cpu"
    return _h100_for_card() if str(kind) == "cuda" else PROFILES["cpu"]


def for_plan(profile, config, device, budget_gb=None):
    """``(explicit, profile, budget_bytes)`` of an engine's plan.
    ``explicit``: ``profile`` (a name resolves) or the config's
    ``analysis.profile``, else None; ``profile``: that or the device's.
    The budget is ``budget_gb``, else ``analysis.memory_budget_gb``, else
    the explicit profile's memory; with none the plan only reports."""
    explicit = profile
    if isinstance(profile, str):
        explicit = resolve(profile, device)
    elif profile is None and config.analysis_profile:
        explicit = resolve(config.analysis_profile, device)
    if budget_gb is None:
        budget_gb = config.analysis_memory_budget_gb
    budget = (int(float(budget_gb) * (1 << 30)) if budget_gb is not None
              else None)
    if budget is None and explicit is not None:
        budget = explicit.hbm_bytes
    return explicit, explicit or default_profile(device), budget
