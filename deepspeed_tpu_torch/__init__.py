"""deepspeed_tpu_torch: the PyTorch/CUDA port of ``deepspeed_tpu``.

The same public API as the JAX package (upstream DeepSpeed's):
``initialize(...)`` returns ``(engine, optimizer, dataloader, lr_scheduler)``
and ``add_config_arguments(parser)`` adds the standard CLI flags.  The port
imports torch and never jax, nor anything of ``deepspeed_tpu``.

It trains BERT pretraining (``models.bert``) and the GPT-2 causal LM
(``models.gpt2``), with hand-written CUDA kernels for the fused LAMB/Adam
updates (``ops/cuda_optim.py``) and for attention: the whole-tile kernels
at short causal shapes (``ops/block_attention.py``) and the streaming ones
from seq 256 (``ops/stream_attention.py``).  It trains data-parallel over
a ``torch.distributed`` group (``parallel/``), tensor-parallel with the
Megatron layers (``model_parallel_size``, ``MeshConfig``),
pipeline-parallel over stage processes (``pipeline_parallel_size``,
``models.GPT2Pipelined``, ``parallel/pipeline.py``), with ZeRO
stages 1 and 2 (``zero.py``) and 3 (``zero3.py``), reduces row-sparse
embedding gradients (``sparse.py``), loads data (``data.py``), saves and
resumes checkpoints in the JAX package's layout (``checkpoint.py``) and
fine-tunes the SQuAD span model (``models.BertForQuestionAnswering``,
``squad.py``).  What it does not cover yet is listed in ROADMAP.md.
"""

from deepspeed_tpu_torch.models.pipeline_gpt2 import (  # noqa: F401
    GPT2Pipelined)
from deepspeed_tpu_torch.parallel.topology import MeshConfig  # noqa: F401

__version__ = "0.1.0"
__version_major__, __version_minor__, __version_patch__ = (
    int(x) for x in __version__.split("."))


def initialize(args=None,
               model=None,
               optimizer=None,
               model_parameters=None,
               training_data=None,
               lr_scheduler=None,
               dist_init_required=None,
               collate_fn=None,
               config=None,
               config_params=None,
               param_groups=None,
               seed=0,
               device=None,
               mesh=None):
    """Build the engine; returns (engine, optimizer, dataloader, lr_scheduler).

    ``model`` is an ``nn.Module`` whose ``forward(*batch)`` returns the loss.
    ``model_parameters`` optionally loads a JAX-layout parameter tree
    (nested dict of arrays, see ``weights.py``) into it first.
    ``training_data`` (an indexable dataset) gives the dataloader, whose
    batches arrive on the engine's device.  ``device``
    None means a CUDA device (``LOCAL_RANK``'s, else the current one), and
    raises if there is none: pass ``device="cpu"`` to train on the CPU.
    ``dist_init_required`` (or ``args.deepspeed_mpi``, or
    ``DSTPU_COORDINATOR`` in the environment) starts the process group
    (``parallel.topology.init_distributed``).  ``mesh`` (a
    ``MeshConfig``) beats the config's ``model_parallel_size`` and
    ``pipeline_parallel_size``: the started group's ranks form ``dp x pp x
    mp``, model axis innermost, and ``model`` (built at its global shapes)
    is narrowed to this rank's slices and stage.
    """
    from deepspeed_tpu_torch.engine import DeepSpeedTorchEngine

    engine = DeepSpeedTorchEngine(args=args,
                                  model=model,
                                  optimizer=optimizer,
                                  model_parameters=model_parameters,
                                  training_data=training_data,
                                  lr_scheduler=lr_scheduler,
                                  dist_init_required=dist_init_required,
                                  collate_fn=collate_fn,
                                  config=config,
                                  config_params=config_params,
                                  param_groups=param_groups,
                                  seed=seed,
                                  device=device,
                                  mesh=mesh)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, use_mpi=False, device=None,
                     backend=None):
    """Start the default process group before ``initialize()`` (the JAX
    package's ``init_distributed``; reference deepspeed_light.py:125-130):
    ``parallel.topology.init_distributed``, whose docstring gives the
    arguments and the environment it reads."""
    from deepspeed_tpu_torch.parallel.topology import init_distributed as _init
    _init(coordinator_address=coordinator_address,
          num_processes=num_processes, process_id=process_id,
          use_mpi=use_mpi, device=device, backend=backend)


def _add_core_arguments(parser):
    """Core flags (upstream deepspeed/__init__.py:105-153)."""
    group = parser.add_argument_group("DeepSpeed", "DeepSpeed configurations")
    group.add_argument("--deepspeed", default=False, action="store_true",
                       help="Enable DeepSpeed (helper flag for user code, no impact on engine)")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="Path to DeepSpeed json configuration file")
    group.add_argument("--deepscale", default=False, action="store_true",
                       help="Deprecated enable DeepSpeed (helper flag for user code)")
    group.add_argument("--deepscale_config", default=None, type=str,
                       help="Deprecated path to DeepSpeed json configuration")
    group.add_argument("--deepspeed_mpi", default=False, action="store_true",
                       help="Run via MPI; rank/size discovered from the MPI environment")
    return parser


def add_config_arguments(parser):
    """Update an argument parser to enable config-file params
    (upstream deepspeed/__init__.py:156-169)."""
    return _add_core_arguments(parser)
