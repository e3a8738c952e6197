"""deepspeed_tpu_torch: the PyTorch/CUDA port of ``deepspeed_tpu``.

The same public API as the JAX package (upstream DeepSpeed's):
``initialize(...)`` returns ``(engine, optimizer, dataloader, lr_scheduler)``
and ``add_config_arguments(parser)`` adds the standard CLI flags.  The port
imports torch and never jax, nor anything of ``deepspeed_tpu``.

This slice trains BERT pretraining on one card (``models.bert``) with the
hand-written CUDA fused LAMB/Adam kernels (``ops/cuda_optim.py``).  What it
does not cover yet is listed in ROADMAP.md.
"""

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
               device=None):
    """Build the engine; returns (engine, optimizer, dataloader, lr_scheduler).

    ``model`` is an ``nn.Module`` whose ``forward(*batch)`` returns the loss.
    ``model_parameters`` optionally loads a JAX-layout parameter tree
    (nested dict of arrays, see ``weights.py``) into it first.  ``device``
    None means the first CUDA device, and raises if there is none: pass
    ``device="cpu"`` to train on the CPU.
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
                                  device=device)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)


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
