"""The port's runnable drivers:
``python -m deepspeed_tpu_torch.examples.<name>``."""
