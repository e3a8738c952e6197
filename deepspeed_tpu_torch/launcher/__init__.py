"""Multi-node launcher (``dst-torch``, ``python -m
deepspeed_tpu_torch.launcher.run``): hostfile, include/exclude DSL and a
per-node launcher that starts one process per local GPU slot.  The port of
``deepspeed_tpu/launcher/`` (upstream DeepSpeed's ``deepspeed_run.py`` and
``deepspeed_launch.py``)."""
