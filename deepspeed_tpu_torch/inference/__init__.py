"""deepspeed_tpu_torch.inference: single-replica serving on one card.

The port of ``deepspeed_tpu/inference/`` for one model replica: weights
from a training checkpoint through the weights-only restore
(``checkpoint.load_params_only``), a refcounted KV page pool with prefix
reuse (paged and ring layouts), continuous and static batching, fused
greedy decode, speculative decoding with a small draft model, bf16 or
int8-weight compute, serve telemetry, health endpoints and the serve
watchdog.

    from deepspeed_tpu_torch.inference import InferenceEngine
    eng = InferenceEngine(GPT2.from_size("medium", device="meta"),
                          config=cfg, checkpoint_dir="ckpts")
    outs = eng.generate([[1, 2, 3]], max_new_tokens=16)

The fleet (``FleetRouter``, ``RouterObservability``, ``run_fleet``, the
``router`` module: replicas behind a router, prefill/decode
disaggregation) is ROADMAP.md Queue 1 item 13b; those names raise
``NotImplementedError`` until then.
"""

from deepspeed_tpu_torch.inference import driver, kvcache, quant  # noqa: F401
from deepspeed_tpu_torch.inference import observability  # noqa: F401
from deepspeed_tpu_torch.inference.driver import (  # noqa: F401
    ServeTelemetry, run_serve, synthetic_requests)
from deepspeed_tpu_torch.inference.engine import InferenceEngine  # noqa: F401
from deepspeed_tpu_torch.inference.kvcache import (  # noqa: F401
    KVCacheSpec, PagePool)
from deepspeed_tpu_torch.inference.observability import (  # noqa: F401
    ServeObservability)
from deepspeed_tpu_torch.inference.scheduler import (  # noqa: F401
    ContinuousScheduler, KVHandoff, Request, RequestResult,
    StaticScheduler, greedy_sampler, latency_summary, request_latency_ms)

_FLEET = ("FleetRouter", "RouterObservability", "run_fleet", "router")


def __getattr__(name):
    if name in _FLEET:
        raise NotImplementedError(
            f"{name} (fleet serving) is not ported to deepspeed_tpu_torch "
            f"yet (ROADMAP.md, Queue 1 item 13b)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "InferenceEngine", "KVCacheSpec", "PagePool", "ContinuousScheduler",
    "StaticScheduler", "Request", "RequestResult", "KVHandoff",
    "greedy_sampler", "latency_summary", "request_latency_ms",
    "ServeTelemetry", "ServeObservability", "run_serve",
    "synthetic_requests", "driver", "kvcache", "observability", "quant",
]
