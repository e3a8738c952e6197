"""Process groups, device resolution and the data-parallel layout.

The port of ``deepspeed_tpu/parallel/topology.py`` at mp = sp = pp = 1: the
JAX mesh's ``data`` axis becomes the world of a ``torch.distributed``
process group, one process per card (or per CPU rank in the tests).

* ``init_distributed`` reads the JAX package's launch contract
  (``DSTPU_COORDINATOR``, ``DSTPU_NUM_PROCESSES``, ``DSTPU_PROCESS_ID``;
  ``LOCAL_RANK`` picks the card) or, with ``use_mpi``, the OMPI/PMI/SLURM
  variables (``mpi_discovery``), and starts the default process group:
  NCCL for a CUDA device, gloo for the CPU.  A card without NCCL raises;
  the port never switches a card to gloo.
* ``make_topology`` reads the rank and the data-parallel size (the world
  size) from the started group, or 1 when none was started.
* ``Topology.with_subgroups`` builds the ZeRO ``parameter_parallel_size``
  sub-groups of ``comm.subgroup_index_groups``: ``within`` (consecutive
  blocks of ranks that own the partitions) and ``across`` (the ranks that
  hold the same partition in different blocks).

Tensor, sequence and pipeline parallelism (mp, sp, pp > 1) raise naming
their ROADMAP.md items.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from deepspeed_tpu_torch import constants as C

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Topology:
    """The run's device, rank and data-parallel layout.

    ``group`` is the data-parallel process group (None when no process
    group was started: one process, no collectives).  ``pps`` is the ZeRO
    partition group size; with ``pps < dp`` this rank's ``within`` group is
    its block of ``pps`` consecutive ranks and ``across`` the ``dp / pps``
    ranks holding the same partition."""
    device: torch.device
    rank: int = 0
    dp: int = 1
    mp: int = 1
    group: Optional[object] = None
    pps: int = 1
    within: Optional[object] = None
    across: Optional[object] = None

    @property
    def partition_id(self) -> int:
        """The partition this rank owns within its sub-group."""
        return self.rank % self.pps

    def with_subgroups(self, pps: int) -> "Topology":
        """This topology with ZeRO partition groups of ``pps`` ranks.  At
        ``pps == dp`` the partition group is the data group itself; below
        it every rank creates every sub-group, in the same order, and keeps
        its own (``dist.new_group`` is collective over the world)."""
        from deepspeed_tpu_torch.parallel import comm
        if pps <= 0 or self.dp % pps != 0:
            raise ValueError(f"parameter_parallel_size={pps} must divide "
                             f"the data-parallel size ({self.dp})")
        if pps == self.dp:
            return dataclasses.replace(self, pps=pps, within=self.group,
                                       across=None)
        within_ranks, across_ranks = comm.subgroup_index_groups(self.dp, pps)
        within = across = None
        for ranks in within_ranks:
            g = dist.new_group(ranks)
            if self.rank in ranks:
                within = g
        for ranks in across_ranks:
            g = dist.new_group(ranks)
            if self.rank in ranks:
                across = g
        return dataclasses.replace(self, pps=pps, within=within,
                                   across=across)


def _local_rank() -> Optional[int]:
    value = os.environ.get("LOCAL_RANK")
    return None if value in (None, "") else int(value)


def resolve_device(device=None) -> torch.device:
    """``None`` means a CUDA device, and raises when there is none: the
    port never falls back to the CPU on its own.  Which card: ``LOCAL_RANK``
    when the launcher set it, else the current one.  Tests pass
    ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "deepspeed_tpu_torch.initialize: no CUDA device is visible; "
                "pass device='cpu' explicitly to train on the CPU")
        device = torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not "
                               f"available")
        if device.index is None:
            local = _local_rank()
            device = torch.device("cuda", torch.cuda.current_device()
                                  if local is None else local)
    return device


def backend_for(device: torch.device) -> str:
    """NCCL for a CUDA device, gloo for the CPU.  A card whose torch has
    no NCCL raises: gloo on a card is never chosen."""
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError(
                "torch.distributed has no NCCL backend: a multi-process run "
                "on CUDA devices needs it (the port does not fall back to "
                "gloo on a card)")
        return "nccl"
    return "gloo"


def mpi_discovery() -> dict:
    """Rank, world size and coordinator from an MPI/PMI/SLURM launch (the
    JAX package's ``mpi_discovery``; reference ``_mpi_check``,
    deepspeed_light.py:187-223)."""
    def first_env(*names, default=None):
        for name in names:
            if name in os.environ:
                return os.environ[name]
        return default

    rank = first_env("OMPI_COMM_WORLD_RANK", "PMI_RANK", "SLURM_PROCID")
    size = first_env("OMPI_COMM_WORLD_SIZE", "PMI_SIZE", "SLURM_NTASKS")
    if rank is None or size is None:
        raise RuntimeError(
            "MPI discovery requested but no OMPI/PMI/SLURM rank variables "
            "found")
    addr = first_env("MASTER_ADDR", default="127.0.0.1")
    port = first_env("MASTER_PORT", default="29500")
    return {"rank": int(rank), "world_size": int(size),
            "coordinator_address": f"{addr}:{port}"}


def _init_method(coordinator: str) -> str:
    """``host:port`` (the JAX contract) as a TCP rendezvous; a URL
    (``tcp://``, ``file://``, ``env://``) as it is."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     use_mpi: bool = False,
                     device=None) -> None:
    """Start the default process group (the JAX package's
    ``init_distributed``; reference deepspeed_light.py:125-130).

    Arguments beat ``use_mpi`` discovery, which beats the environment
    (``DSTPU_COORDINATOR``, ``DSTPU_NUM_PROCESSES``, ``DSTPU_PROCESS_ID``).
    Does nothing when a process group is already started, or for one
    process with no explicit coordinator; an explicit coordinator starts a
    group even for one process.  ``device`` (resolved as
    ``resolve_device``) picks the backend."""
    explicit = coordinator_address is not None
    if use_mpi:
        info = mpi_discovery()
        coordinator_address = (coordinator_address
                               or info["coordinator_address"])
        if num_processes is None:
            num_processes = info["world_size"]
        if process_id is None:
            process_id = info["rank"]
    coordinator_address = (coordinator_address
                           or os.environ.get("DSTPU_COORDINATOR"))
    if num_processes is None:
        num_processes = int(os.environ.get("DSTPU_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("DSTPU_PROCESS_ID", "0"))
    if dist.is_initialized():
        logger.info("init_distributed: already initialized, skipping")
        return
    if num_processes <= 1 and not explicit:
        logger.info("init_distributed: single-process run, skipping "
                    "rendezvous")
        return
    if coordinator_address is None:
        raise RuntimeError(
            f"init_distributed: {num_processes} processes but no "
            f"coordinator (set DSTPU_COORDINATOR or pass "
            f"coordinator_address)")
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend_for(device),
                            init_method=_init_method(coordinator_address),
                            world_size=int(num_processes),
                            rank=int(process_id))
    logger.info("init_distributed: process %d/%d via %s", process_id,
                num_processes, coordinator_address)


def make_topology(config: Optional[dict] = None, device=None) -> Topology:
    """The run's topology: the device, and the rank and data-parallel size
    of the started process group (1 without one).  Any model, sequence or
    pipeline parallel size above 1 in ``config`` raises."""
    config = config or {}
    sizes = {C.MODEL_PARALLEL_SIZE: ("tensor parallelism", "10"),
             C.CONTEXT_PARALLEL_SIZE: ("sequence parallelism", "11"),
             C.PIPELINE_PARALLEL_SIZE: ("pipeline parallelism", "11")}
    for key, (what, item) in sizes.items():
        if int(config.get(key, 1) or 1) != 1:
            raise NotImplementedError(
                f"{key}={config[key]}: {what} is not ported to "
                f"deepspeed_tpu_torch yet (ROADMAP.md, Queue 1 item {item})")
    device = resolve_device(device)
    if not dist.is_initialized():
        return Topology(device=device)
    backend = dist.get_backend()
    if device.type == "cuda" and backend != "nccl":
        raise RuntimeError(
            f"the process group runs {backend!r} but the engine's device is "
            f"{device}: a CUDA run needs NCCL")
    dp = dist.get_world_size()
    return Topology(device=device, rank=dist.get_rank(), dp=dp,
                    group=dist.group.WORLD, pps=dp, within=dist.group.WORLD)
