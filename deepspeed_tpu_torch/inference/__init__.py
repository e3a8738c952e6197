"""deepspeed_tpu_torch.inference: serving.

The port of ``deepspeed_tpu/inference/``: weights
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

The fleet (``router``): ``FleetRouter`` / ``run_fleet`` put N engines,
each on its own driver thread, behind a least-loaded router with prefix
affinity, 503-eviction with resubmission, and prefill/decode
disaggregation through KV handoff artifacts; ``RouterObservability``
serves the fleet's endpoints.

    from deepspeed_tpu_torch.inference import run_fleet
    out = run_fleet([eng_a, eng_b], requests)

At ``model_parallel_size`` mp > 1 every replica is mp processes, one per
model rank (``engine.py``); every rank builds the same engines in one
order, and ``lead_fleet`` serves them: the router on model rank 0, each
engine's follower loop on the other ranks.

    out = lead_fleet([eng_a, eng_b],
                     lambda engines: run_fleet(engines, requests))
"""

from deepspeed_tpu_torch.inference import driver, kvcache, quant  # noqa: F401
from deepspeed_tpu_torch.inference import observability, router  # noqa: F401
from deepspeed_tpu_torch.inference.driver import (  # noqa: F401
    ServeTelemetry, run_serve, synthetic_requests)
from deepspeed_tpu_torch.inference.engine import (  # noqa: F401
    InferenceEngine, lead_fleet)
from deepspeed_tpu_torch.inference.kvcache import (  # noqa: F401
    KVCacheSpec, PagePool)
from deepspeed_tpu_torch.inference.observability import (  # noqa: F401
    ServeObservability)
from deepspeed_tpu_torch.inference.router import (  # noqa: F401
    FleetRouter, RouterObservability, run_fleet)
from deepspeed_tpu_torch.inference.scheduler import (  # noqa: F401
    ContinuousScheduler, KVHandoff, Request, RequestResult,
    StaticScheduler, greedy_sampler, latency_summary, request_latency_ms)

__all__ = [
    "InferenceEngine", "KVCacheSpec", "PagePool", "ContinuousScheduler",
    "StaticScheduler", "Request", "RequestResult", "KVHandoff",
    "greedy_sampler", "latency_summary", "request_latency_ms",
    "ServeTelemetry", "ServeObservability", "run_serve",
    "synthetic_requests", "driver", "kvcache", "observability", "quant",
    "FleetRouter", "RouterObservability", "run_fleet", "router",
    "lead_fleet",
]
