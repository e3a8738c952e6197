from deepspeed_tpu_torch.ops.optim import (  # noqa: F401
    Adam, AdamW, Lamb, Optimizer, OptimizerState, Sgd, from_config)
