"""Process groups, device resolution and the data x pipe x seq x model layout.

The port of ``deepspeed_tpu/parallel/topology.py``: the JAX mesh's
``data``, ``pipe``, ``seq`` and ``model`` axes become ``torch.distributed``
process groups, one process per card (or per CPU rank in the tests).
Ranks are laid out as the JAX mesh lays out its devices, ``[data, pipe,
seq, model]`` with the model axis innermost, so ``rank = ((dp_rank * pp +
pp_rank) * sp + sp_rank) * mp + mp_rank``: a model group is ``mp``
consecutive ranks (one sequence shard of one stage of one data replica), a
seq group the ``sp`` sequence shards of one stage and model rank, a pipe
group the ``pp`` stages of one data replica, sequence shard and model
rank, a data group the ranks of one stage, sequence shard and model rank.
The ranks of a seq group are replicas of the parameters and the optimizer
state, as in the JAX mesh: ZeRO partitions over the data group only.

* ``init_distributed`` reads the JAX package's launch contract
  (``DSTPU_COORDINATOR``, ``DSTPU_NUM_PROCESSES``, ``DSTPU_PROCESS_ID``;
  ``LOCAL_RANK`` picks the card) or, with ``use_mpi``, the OMPI/PMI/SLURM
  variables (``mpi_discovery``), and starts the default process group:
  by default NCCL for a CUDA device, gloo for the CPU.  A card without
  NCCL raises; the port never switches a card to gloo by itself.  An
  explicit ``backend="gloo"`` on a card is the caller's choice (one card
  shared by several ranks, where NCCL refuses): its collectives stage
  through the host.
* ``make_topology`` reads the model-, context- and pipeline-parallel sizes
  from the config or a ``MeshConfig``, the rank and world size from the
  started group (1 without one), and builds every model, seq, pipe and
  data group.
* ``Topology.with_subgroups`` builds the ZeRO ``parameter_parallel_size``
  sub-groups of ``comm.subgroup_index_groups`` inside each (stage, seq
  rank, model rank)'s data group: ``within`` (consecutive blocks of ranks
  that own the partitions) and ``across`` (the ranks that hold the same
  partition in different blocks).
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


@dataclasses.dataclass
class MeshConfig:
    """A declarative layout request, as the JAX package's ``MeshConfig``
    (``initialize(..., mesh=MeshConfig(model_parallel_size=2))``):
    ``model_parallel_size`` ranks per model shard group,
    ``context_parallel_size`` ranks per sequence ring,
    ``pipeline_parallel_size`` stages per pipeline, the rest of the world
    the data axis.  It has no ``devices``: the port's devices are the
    processes of the group."""
    model_parallel_size: int = 1
    context_parallel_size: int = 1
    pipeline_parallel_size: int = 1


@dataclasses.dataclass(frozen=True)
class Topology:
    """The run's device, rank and data x pipe x seq x model layout.

    ``group`` is this rank's data-parallel process group, ``model_group``
    its model-parallel one, ``seq_group`` its sequence-parallel one and
    ``pipe_group`` its pipeline one; each is None where its axis has size
    1 (no collectives there).  ``pps`` is the
    ZeRO partition group size; with ``pps < dp`` this rank's ``within``
    group is its block of ``pps`` consecutive data ranks and ``across``
    the ``dp / pps`` data ranks holding the same partition."""
    device: torch.device
    rank: int = 0
    dp: int = 1
    mp: int = 1
    group: Optional[object] = None
    pps: int = 1
    within: Optional[object] = None
    across: Optional[object] = None
    model_group: Optional[object] = None
    pp: int = 1
    pipe_group: Optional[object] = None
    sp: int = 1
    seq_group: Optional[object] = None

    @property
    def dp_rank(self) -> int:
        """This rank's place on the data axis."""
        return self.rank // (self.pp * self.sp * self.mp)

    @property
    def pp_rank(self) -> int:
        """This rank's pipeline stage."""
        return (self.rank // (self.sp * self.mp)) % self.pp

    @property
    def sp_rank(self) -> int:
        """This rank's sequence shard."""
        return (self.rank // self.mp) % self.sp

    @property
    def mp_rank(self) -> int:
        """This rank's place on the model axis."""
        return self.rank % self.mp

    def global_rank(self, dp_rank: int, pp_rank: int, mp_rank: int,
                    sp_rank: Optional[int] = None) -> int:
        """The rank at ``(dp_rank, pp_rank, sp_rank, mp_rank)``; this
        rank's sequence shard when ``sp_rank`` is None."""
        if sp_rank is None:
            sp_rank = self.sp_rank
        return ((dp_rank * self.pp + pp_rank) * self.sp + sp_rank) \
            * self.mp + mp_rank

    def pipe_ranks(self) -> list:
        """The global ranks of this rank's pipe group, by stage."""
        return [self.global_rank(self.dp_rank, s, self.mp_rank)
                for s in range(self.pp)]

    @property
    def partition_id(self) -> int:
        """The partition this rank owns within its sub-group."""
        return self.dp_rank % self.pps

    def data_ranks(self, mp_rank: int, pp_rank: int = 0,
                   sp_rank: Optional[int] = None) -> list:
        """The global ranks of the data group of model rank ``mp_rank`` at
        stage ``pp_rank`` and sequence shard ``sp_rank`` (this rank's when
        None)."""
        return [self.global_rank(d, pp_rank, mp_rank, sp_rank)
                for d in range(self.dp)]

    def with_subgroups(self, pps: int) -> "Topology":
        """This topology with ZeRO partition groups of ``pps`` data ranks.
        At ``pps == dp`` the partition group is the data group itself;
        below it every rank creates every sub-group of every (stage, seq
        rank, model rank)'s data group, in the same order, and keeps its
        own (``dist.new_group`` is collective over the world)."""
        from deepspeed_tpu_torch.parallel import comm
        if pps <= 0 or self.dp % pps != 0:
            raise ValueError(f"parameter_parallel_size={pps} must divide "
                             f"the data-parallel size ({self.dp})")
        if pps == self.dp:
            return dataclasses.replace(self, pps=pps, within=self.group,
                                       across=None)
        within_idx, across_idx = comm.subgroup_index_groups(self.dp, pps)
        mine = {"within": None, "across": None}
        for s in range(self.pp):
            for q in range(self.sp):
                for m in range(self.mp):
                    ranks = self.data_ranks(m, s, q)
                    for kind, groups in (("within", within_idx),
                                         ("across", across_idx)):
                        for idx in groups:
                            members = [ranks[i] for i in idx]
                            g = _new_group(members)
                            if self.rank in members:
                                mine[kind] = g
        return dataclasses.replace(self, pps=pps, **mine)


def _new_group(ranks):
    """A process group of ``ranks`` (collective: every rank calls it for
    every group, in one order); None for a single rank, where a collective
    is the identity."""
    g = dist.new_group(ranks)
    return g if len(ranks) > 1 else None


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


#: the backend the caller named when ``init_distributed`` started the
#: group (None: chosen by ``backend_for``)
_EXPLICIT_BACKEND: Optional[str] = None


def backend_for(device: torch.device) -> str:
    """NCCL for a CUDA device, gloo for the CPU.  A card whose torch has
    no NCCL raises: gloo on a card is never chosen by default."""
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
                     device=None,
                     backend: Optional[str] = None) -> None:
    """Start the default process group (the JAX package's
    ``init_distributed``; reference deepspeed_light.py:125-130).

    Arguments beat ``use_mpi`` discovery, which beats the environment
    (``DSTPU_COORDINATOR``, ``DSTPU_NUM_PROCESSES``, ``DSTPU_PROCESS_ID``).
    Does nothing when a process group is already started, or for one
    process with no explicit coordinator; an explicit coordinator starts a
    group even for one process.  ``device`` (resolved as
    ``resolve_device``) picks the backend, unless ``backend`` names one;
    ``make_topology`` accepts gloo on a card only when it was named here.
    Nothing switches the backend by itself."""
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
    global _EXPLICIT_BACKEND
    dist.init_process_group(backend or backend_for(device),
                            init_method=_init_method(coordinator_address),
                            world_size=int(num_processes),
                            rank=int(process_id))
    _EXPLICIT_BACKEND = backend
    logger.info("init_distributed: process %d/%d via %s (%s)", process_id,
                num_processes, coordinator_address, dist.get_backend())


def _parallel_sizes(config: dict, mesh) -> tuple:
    """``(mp, sp, pp)``: the model-, context- and pipeline-parallel sizes
    of ``mesh`` (a ``MeshConfig``, which beats the config, as in the JAX
    engine) or of ``config``."""
    if mesh is not None:
        sizes = {C.MODEL_PARALLEL_SIZE: mesh.model_parallel_size,
                 C.CONTEXT_PARALLEL_SIZE: mesh.context_parallel_size,
                 C.PIPELINE_PARALLEL_SIZE: mesh.pipeline_parallel_size}
    else:
        sizes = {k: config.get(k, 1) for k in (
            C.MODEL_PARALLEL_SIZE, C.CONTEXT_PARALLEL_SIZE,
            C.PIPELINE_PARALLEL_SIZE)}
    sizes = {k: int(v or 1) for k, v in sizes.items()}
    for key, size in sizes.items():
        if size < 1:
            raise ValueError(f"{key}={size} must be >= 1")
    return (sizes[C.MODEL_PARALLEL_SIZE], sizes[C.CONTEXT_PARALLEL_SIZE],
            sizes[C.PIPELINE_PARALLEL_SIZE])


def make_topology(config: Optional[dict] = None, device=None,
                  mesh=None) -> Topology:
    """The run's topology: the device, the model-, context- and
    pipeline-parallel sizes (``mesh``, else ``config``), and the rank and
    sizes of the started process group (one rank without one).  Every
    model group, seq group, pipe group and data group is built on every
    rank, in one order.  A CUDA device needs an NCCL group, unless
    ``init_distributed`` was given ``backend="gloo"``: then the
    collectives stage through the host."""
    mp, sp, pp = _parallel_sizes(config or {}, mesh)
    device = resolve_device(device)
    if not dist.is_initialized():
        if mp * sp * pp != 1:
            key, size = next((k, v) for k, v in (
                (C.MODEL_PARALLEL_SIZE, mp), (C.CONTEXT_PARALLEL_SIZE, sp),
                (C.PIPELINE_PARALLEL_SIZE, pp)) if v != 1)
            raise ValueError(
                f"{key}={size} needs {mp * sp * pp} processes in a "
                f"started process group; none was started")
        return Topology(device=device)
    running = dist.get_backend()
    if device.type == "cuda" and running != "nccl":
        if _EXPLICIT_BACKEND != running:
            raise RuntimeError(
                f"the process group runs {running!r} but the engine's "
                f"device is {device}: a CUDA run needs NCCL (pass "
                f"backend={running!r} to init_distributed to run it on "
                f"purpose)")
        logger.info("make_topology: %s collectives on %s stage through the "
                    "host", running, device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % (mp * sp * pp):
        raise ValueError(
            f"{C.MODEL_PARALLEL_SIZE}={mp} x {C.CONTEXT_PARALLEL_SIZE}={sp} "
            f"x {C.PIPELINE_PARALLEL_SIZE}={pp} must divide the world size "
            f"{world}")
    dp = world // (mp * sp * pp)
    if mp == sp == pp == 1:
        return Topology(device=device, rank=rank, dp=dp,
                        group=dist.group.WORLD, pps=dp,
                        within=dist.group.WORLD)
    topo = Topology(device=device, rank=rank, dp=dp, mp=mp, pp=pp, sp=sp,
                    pps=dp)
    at, mine = topo.global_rank, {}

    def build(name, rank_lists, size):
        for ranks in rank_lists:
            g = _new_group(ranks) if size > 1 else None
            if rank in ranks:
                mine[name] = g

    build("model_group", ([at(d, s, m, q) for m in range(mp)]
                          for d in range(dp) for s in range(pp)
                          for q in range(sp)), mp)
    build("seq_group", ([at(d, s, m, q) for q in range(sp)]
                        for d in range(dp) for s in range(pp)
                        for m in range(mp)), sp)
    build("pipe_group", ([at(d, s, m, q) for s in range(pp)]
                         for d in range(dp) for q in range(sp)
                         for m in range(mp)), pp)
    build("group", ([at(d, s, m, q) for d in range(dp)]
                    for s in range(pp) for q in range(sp)
                    for m in range(mp)), dp)
    return dataclasses.replace(topo, within=mine["group"], **mine)
