"""Serve a GPT-2 checkpoint with continuous batching, on the port.

The counterpart of ``examples/gpt2/serve_gpt2.py``, checkpoint to tokens:

    # 1) produce a tiny checkpoint (a short real training run)
    python -m deepspeed_tpu_torch.examples.serve_gpt2 --prepare \
        --ckpt /tmp/gpt2_ck

    # 2) serve it under synthetic traffic, telemetry to JSONL
    python -m deepspeed_tpu_torch.examples.serve_gpt2 --ckpt /tmp/gpt2_ck \
        --deepspeed_config my_serve_config.json --requests 8 \
        --jsonl /tmp/serve/serve.jsonl

    # 3) validate the serve telemetry (exit 2 on invalid/empty)
    python -m deepspeed_tpu_torch.observability /tmp/serve/serve.jsonl

The serving engine loads ONLY the model weights
(``checkpoint.load_params_only``; the optimizer and ZeRO partitions are
never read), sizes its KV page pool from the ``inference`` config section
and runs the request trace through the continuous-batching scheduler.
Exits nonzero if any request produced no tokens.

The shipped serving configs (``examples/gpt2/ds_config_serve*.json``,
``ds_config_fleet_serve.json``) set ``graph_lint`` and ``analysis`` to
``error``: the engine lints and plans every serving program at build
(``analysis/``) and serves when they are clean.

Two of them set ``model_parallel_size`` 2: a replica is then one process
per model rank, started by the port's launcher, e.g. on the CPU

    python -m deepspeed_tpu_torch.launcher.run --num_gpus 2 \
        deepspeed_tpu_torch/examples/serve_gpt2.py --ckpt /tmp/gpt2_ck \
        --deepspeed_config my_serve_config.json --device cpu

(``PYTHONPATH`` naming the repository).  Model rank 0 serves and prints;
the other ranks follow its commands and print nothing.  ``--fleet N`` and
``--verify-identity`` serve there too: every rank builds every engine
(the decode replicas, then the prefill replicas, then the one
``--verify-identity`` re-serves on) in one order, model rank 0 runs the
router through ``inference.lead_fleet``, and each other rank follows
every engine on a thread of its own.

Replica observability: ``--health_port`` serves live /healthz /status
/metrics; ``--probe-endpoints`` probes them over HTTP mid-traffic and
parse-gates /metrics; ``--watchdog_timeout_s`` arms the serve watchdog;
``--chaos-stall-iter N`` stalls the Nth decode dispatch and gates the
watchdog-fire -> 503 -> loadable-dump chain; ``--verify-identity``
re-serves the trace observability-off and requires identical outputs and
fence counts.

Fleet serving: ``--fleet N`` loads the SAME checkpoint into N replicas
behind the least-loaded router (``--prefill-replicas K`` splits K of them
into a prefill pool with KV handoff; the config needs
``inference.fleet.disaggregate``); ``--router-port`` serves the router's
own endpoints, per-replica endpoints ride ``--health_port`` + replica
index, and ``--probe-endpoints`` probes the router and every replica.
``--verify-identity`` then re-serves the trace on ONE replica and
requires identical greedy outputs; with ``--chaos-stall-iter`` the wedged
replica's eviction and resubmission must be invisible too.

It serves on the first CUDA device; ``--device cpu`` serves on the CPU.
"""

import argparse
import json
import os
import sys
import threading
import time
import urllib.request

import numpy as np

VOCAB, SEQ = 512, 64


class _EndpointProber(threading.Thread):
    """Poll the replica's live endpoints over real HTTP while the serve
    trace drains ("curl /healthz and parse-gate /metrics MID-TRAFFIC",
    in-process so the timing is deterministic)."""

    def __init__(self, port: int, interval_s: float = 0.05):
        super().__init__(daemon=True, name="serve-endpoint-prober")
        self.base = f"http://127.0.0.1:{port}"
        self.interval_s = interval_s
        self.stop = threading.Event()
        self.healthz_codes = []
        self.best_metrics = None     # parsed snapshot with most load
        self.metrics_text = None
        self.errors = []

    def _get(self, path):
        with urllib.request.urlopen(self.base + path, timeout=5) as r:
            return r.getcode(), r.read().decode()

    def run(self):
        from deepspeed_tpu_torch.observability.health import \
            parse_prometheus_text
        while not self.stop.is_set():
            try:
                code, _ = self._get("/healthz")
                self.healthz_codes.append(code)
                _, text = self._get("/metrics")
                parsed = parse_prometheus_text(text)   # the parse gate
                busy = parsed.get("dstpu_slots_in_use", 0)
                if (self.best_metrics is None
                        or busy >= self.best_metrics.get(
                            "dstpu_slots_in_use", 0)):
                    self.best_metrics = parsed
                    self.metrics_text = text
            except Exception as e:       # noqa: BLE001 - reported below
                self.errors.append(str(e))
            self.stop.wait(self.interval_s)


def prepare(args):
    """Short real training run → checkpoint (the serve smoke's input)."""
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.examples.train_gpt2 import synthetic_lm_batch
    from deepspeed_tpu_torch.models import GPT2

    model = GPT2.from_size(args.size, vocab_size=VOCAB, max_seq_len=SEQ,
                           generator=torch.Generator().manual_seed(0))
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model,
        config={"train_batch_size": 8,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                "bf16": {"enabled": True},
                "zero_optimization": {"stage": 1}},
        device=args.device)
    rng = np.random.default_rng(0)
    for step in range(args.steps):
        loss = engine.train_batch(synthetic_lm_batch(rng, 8, VOCAB, SEQ))
    print(f"prepared: {args.steps} steps, final loss {float(loss):.4f}")
    path = engine.save_checkpoint(args.ckpt)
    print(f"checkpoint: {path}")


def _load_config(args) -> dict:
    """Config dict with the CLI observability overrides applied
    (--health_port / --watchdog_timeout_s ride the
    inference.observability section; env DSTPU_HEALTH_PORT still works
    as the fallback when neither is set).  An EXPLICIT 0 overrides a
    config-enabled port/watchdog to off (the env fallback still
    applies to port 0 — unset DSTPU_HEALTH_PORT for fully off)."""
    with open(args.deepspeed_config) as f:
        cfg = json.load(f)
    obs = cfg.setdefault("inference", {}).setdefault("observability", {})
    if args.health_port is not None:
        obs["health_port"] = args.health_port
    if args.watchdog_timeout_s is not None:
        obs["watchdog_timeout_s"] = args.watchdog_timeout_s
    return cfg


def _model(args):
    from deepspeed_tpu_torch.models import GPT2
    return GPT2.from_size(args.size, vocab_size=VOCAB, max_seq_len=SEQ,
                          device="meta")


def _arm_chaos(args, engine):
    """Deterministic stalled-decode chaos, on the leader only (the one
    rank that dispatches): the Nth decode dispatch stalls inside the
    watchdog-armed region until the watchdog reacted (ServeObservability
    wires stall_until to fire_event)."""
    if args.chaos_stall_iter and engine.is_leader:
        from deepspeed_tpu_torch.resilience import chaos
        chaos.configure(stall_step=args.chaos_stall_iter,
                        stall_s=args.chaos_stall_s)


def serve(args):
    from deepspeed_tpu_torch.inference import InferenceEngine, lead_fleet

    cfg = _load_config(args)
    engine = InferenceEngine(_model(args), config=cfg,
                             checkpoint_dir=args.ckpt, device=args.device)
    engines = [engine]
    if args.verify_identity:
        # the observability-off engine, built on every rank at this point
        base_cfg = _load_config(args)
        base_cfg.get("inference", {}).pop("observability", None)
        engines.append(InferenceEngine(
            _model(args), config=base_cfg, checkpoint_dir=args.ckpt,
            device=args.device))
    _arm_chaos(args, engine)
    # model rank 0 serves; at model_parallel_size > 1 the other ranks
    # follow its commands until it is done
    return lead_fleet(engines,
                      lambda engs: _serve_replica(args, *engs)) or 0


def _serve_replica(args, engine, base_engine=None):
    from deepspeed_tpu_torch.inference import (ServeObservability,
                                               observability, run_serve,
                                               synthetic_requests)
    obs = (ServeObservability(engine)
           if observability.configured(engine.config) else None)
    print(f"serving tag {engine.loaded_tag}: {engine.num_slots} slots x "
          f"{engine.cache_spec.capacity} tokens "
          f"({engine.cache_spec.layout}), restore "
          f"{engine.restore_seconds:.2f}s")

    if args.prefix_trace:
        # multi-tenant trace: every request shares a system prompt of
        # two pages, so prefix reuse serves the shared pages and
        # prefills only each tail
        from deepspeed_tpu_torch.inference import Request
        rng = np.random.default_rng(1)
        sys_len = min(2 * engine.cache_spec.page_tokens,
                      engine.prefill_bucket - 8)
        sys_prompt = rng.integers(0, VOCAB, size=sys_len).astype(
            int).tolist()
        reqs = []
        for i in range(args.requests):
            tail = rng.integers(0, VOCAB, size=int(
                rng.integers(2, 7))).astype(int).tolist()
            reqs.append(Request(rid=i, prompt=sys_prompt + tail,
                                max_new_tokens=int(
                                    rng.integers(4, args.max_new + 1))))
    else:
        reqs = synthetic_requests(
            args.requests, vocab=VOCAB, seed=1, prompt_min=4,
            prompt_max=min(16, engine.prefill_bucket),
            new_min=4, new_max=args.max_new)

    prober = None
    if args.probe_endpoints:
        if obs is None or obs.port is None:
            print("ERROR: --probe-endpoints needs --health_port (or "
                  "DSTPU_HEALTH_PORT)", file=sys.stderr)
            return 1
        prober = _EndpointProber(obs.port)
        prober.start()

    from deepspeed_tpu_torch.observability import fences
    fences_before = fences.FENCE_COUNT
    out = run_serve(engine, reqs, jsonl_path=args.jsonl,
                    window_iters=args.window, observability=obs)
    obs_fence_delta = fences.FENCE_COUNT - fences_before

    rc = 0
    if prober is not None:
        prober.stop.set()
        prober.join(timeout=5)
        rc = max(rc, _check_probes(args, prober))
    if args.chaos_stall_iter:
        rc = max(rc, _check_chaos(obs))
    if obs is not None:
        obs.close()

    if args.prefix_trace and engine.prefix_reuse \
            and not out["summary"]["prefix_hit_rate"]:
        print("ERROR: shared-prefix trace recorded no prefix hits",
              file=sys.stderr)
        return 1
    empty = [r.rid for r in out["results"] if not r.tokens]
    for r in sorted(out["results"], key=lambda r: r.rid)[:4]:
        print(f"  req {r.rid}: prompt[{r.prompt_len}] -> "
              f"{r.tokens} ({r.finish_reason})")
    print(json.dumps(out["summary"]))
    if empty:
        print(f"ERROR: requests {empty} generated no tokens",
              file=sys.stderr)
        return 1

    if base_engine is not None:
        rc = max(rc, _verify_identity(args, base_engine, reqs, out,
                                      obs_fence_delta))
    return rc


def serve_fleet(args):
    """--fleet N: the same checkpoint behind the least-loaded router —
    N in-process replicas, each its own engine + scheduler + driver
    thread + live endpoints;
    ``--prefill-replicas K`` disaggregates K of them into a prefill
    pool with chunk-container KV handoff."""
    from deepspeed_tpu_torch.inference import InferenceEngine, lead_fleet

    cfg = _load_config(args)
    fleet_cfg = cfg.get("inference", {}).get("fleet", {})
    n = args.fleet or int(fleet_cfg.get("replicas", 0)) or 2
    k = (args.prefill_replicas if args.prefill_replicas is not None
         else int(fleet_cfg.get("prefill_replicas", 0)))
    if k < 0 or k >= n:
        # the config spelling gets this guard in config.py; the CLI
        # values never pass through it
        print(f"ERROR: --prefill-replicas {k} must leave at least one "
              f"DECODE replica out of --fleet {n}", file=sys.stderr)
        return 1

    def build():
        return InferenceEngine(_model(args), config=cfg,
                               checkpoint_dir=args.ckpt, device=args.device)

    # every rank builds the same engines in this order (at
    # model_parallel_size > 1 each build makes the replica's groups,
    # collectively over the ranks)
    decode = [build() for _ in range(n - k)]
    prefill = [build() for _ in range(k)]
    single = [build()] if args.verify_identity else []
    _arm_chaos(args, decode[0])
    return lead_fleet(decode + prefill + single, lambda engines: _serve_fleet(
        args, decode, prefill, single[0] if single else None)) or 0


def _serve_fleet(args, decode, prefill, single):
    """The leader's side of --fleet: the router over ``decode`` +
    ``prefill``, then the trace again on ``single`` with
    --verify-identity."""
    from deepspeed_tpu_torch.inference import FleetRouter, synthetic_requests
    n, k = len(decode) + len(prefill), len(prefill)
    print(f"fleet: {n - k} decode/mixed + {k} prefill replica(s), "
          f"tag {decode[0].loaded_tag}")
    reqs = synthetic_requests(
        args.requests, vocab=VOCAB, seed=1, prompt_min=4,
        prompt_max=min(16, decode[0].prefill_bucket),
        new_min=4, new_max=args.max_new)

    router = FleetRouter(decode, prefill, jsonl_path=args.jsonl,
                         health_port=args.router_port,
                         window_iters=args.window)
    probers = []
    router_prober = None
    if args.probe_endpoints:
        replica_ports = [rep.port for rep in router.all_replicas
                         if rep.port is not None]
        router_port = (router.obs.port if router.obs is not None
                       else None)
        if router_port is None and not replica_ports:
            print("ERROR: --probe-endpoints needs --router-port and/or "
                  "--health_port", file=sys.stderr)
            return 1
        if router_port is not None:
            router_prober = _EndpointProber(router_port)
            probers.append(router_prober)
        probers.extend(_EndpointProber(p) for p in replica_ports)
        for p in probers:
            p.start()
    try:
        out = router.serve(reqs)
    finally:
        for p in probers:
            p.stop.set()
        for p in probers:
            p.join(timeout=5)
    summary = out["summary"]

    rc = 0
    for p in probers:
        if not p.healthz_codes:
            print(f"ERROR: no successful probe of {p.base} "
                  f"(errors: {p.errors[:3]})", file=sys.stderr)
            rc = 1
    if probers and rc == 0:
        if router_prober is not None:
            router_metrics = router_prober.best_metrics or {}
            if not (router_metrics.get("dstpu_n_replicas") or 0) >= n:
                print(f"ERROR: router /metrics n_replicas gauge not "
                      f"live: {router_metrics.get('dstpu_n_replicas')}",
                      file=sys.stderr)
                rc = 1
        if rc == 0:
            n_rep_probers = len(probers) - (router_prober is not None)
            print(f"endpoints: "
                  + ("router + " if router_prober is not None else "")
                  + f"{n_rep_probers} replica "
                  f"endpoint(s) probed mid-traffic, "
                  f"{sum(len(p.healthz_codes) for p in probers)} probes")
    if args.chaos_stall_iter and summary["evictions"] < 1:
        print("ERROR: chaos stall evicted no replica — the watchdog → "
              "503 → eviction chain did not engage", file=sys.stderr)
        rc = 1
    if k and summary["handoffs"] < 1:
        print("ERROR: disaggregated fleet recorded no KV handoffs",
              file=sys.stderr)
        rc = 1

    empty = [r.rid for r in out["results"] if not r.tokens]
    for r in sorted(out["results"], key=lambda r: r.rid)[:4]:
        print(f"  req {r.rid}: prompt[{r.prompt_len}] -> "
              f"{r.tokens} ({r.finish_reason})")
    print(json.dumps(summary))
    if empty:
        print(f"ERROR: requests {empty} generated no tokens",
              file=sys.stderr)
        rc = 1
    router.close()

    if single is not None and rc == 0:
        from deepspeed_tpu_torch.inference import run_serve
        from deepspeed_tpu_torch.resilience import chaos
        chaos.reset()                    # the single run must not stall
        base = run_serve(single, [r.__class__(
            rid=r.rid, prompt=list(r.prompt),
            max_new_tokens=r.max_new_tokens, eos_id=r.eos_id)
            for r in reqs])
        fleet_tokens = {r.rid: r.tokens for r in out["results"]}
        base_tokens = {r.rid: r.tokens for r in base["results"]}
        if fleet_tokens != base_tokens:
            diff = [rid for rid in fleet_tokens
                    if fleet_tokens[rid] != base_tokens.get(rid)]
            print(f"ERROR: fleet placement changed greedy outputs for "
                  f"requests {diff}", file=sys.stderr)
            return 1
        print(f"identity: {len(base_tokens)} requests identical to a "
              f"single replica"
              + (f" (through {summary['evictions']} eviction(s) + "
                 f"{summary['resubmits']} resubmit(s))"
                 if summary["evictions"] else "")
              + (f" ({summary['handoffs']} KV handoffs)"
                 if summary["handoffs"] else ""))
    return rc


def _check_probes(args, prober) -> int:
    """Gate the mid-traffic endpoint probes: /healthz answered 200,
    /metrics parsed (parse_prometheus_text already gated every probe)
    with nonzero slot/page gauges at peak load."""
    if not prober.healthz_codes:
        print(f"ERROR: no successful /healthz probe "
              f"(errors: {prober.errors[:3]})", file=sys.stderr)
        return 1
    if not all(c == 200 for c in prober.healthz_codes):
        print(f"ERROR: /healthz returned non-200 mid-serve: "
              f"{sorted(set(prober.healthz_codes))}", file=sys.stderr)
        return 1
    m = prober.best_metrics or {}
    checks = {"dstpu_slots_in_use": 1, "dstpu_pool_pages_in_use": 1,
              "dstpu_healthy": 1}
    bad = {k: m.get(k) for k, v in checks.items()
           if not (m.get(k) or 0) >= v}
    if bad:
        print(f"ERROR: mid-traffic /metrics gauges not live: {bad}",
              file=sys.stderr)
        return 1
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(prober.metrics_text or "")
    print(f"endpoints: {len(prober.healthz_codes)} mid-traffic probes, "
          f"peak slots_in_use={m.get('dstpu_slots_in_use')}, "
          f"pages_in_use={m.get('dstpu_pool_pages_in_use')}")
    return 0


def _check_chaos(obs) -> int:
    """Gate the stalled-decode chaos leg: the serve watchdog fired,
    /healthz now answers 503, and the flight-recorder dump is loadable
    and names the stalled decode dispatch."""
    from deepspeed_tpu_torch.observability import flightrec
    if obs is None or obs.watchdog is None:
        print("ERROR: --chaos-stall-iter needs --watchdog_timeout_s",
              file=sys.stderr)
        return 1
    if not obs.watchdog.fired:
        print("ERROR: chaos stall did not fire the serve watchdog",
              file=sys.stderr)
        return 1
    if obs.port is not None:
        import urllib.error
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{obs.port}/healthz",
                    timeout=5) as r:
                code = r.getcode()
        except urllib.error.HTTPError as e:
            code = e.code
        if code != 503:
            print(f"ERROR: /healthz returned {code} after the watchdog "
                  f"fired (expected 503)", file=sys.stderr)
            return 1
    path = os.path.join(flightrec.RECORDER.resolve_dump_dir(),
                         f"flightrec_rank{flightrec.RECORDER.rank}"
                         f"_watchdog.json")
    try:
        payload = flightrec.load_dump(path)
    except (OSError, ValueError) as e:
        print(f"ERROR: watchdog flight-recorder dump missing/invalid "
              f"({path}): {e}", file=sys.stderr)
        return 1
    kinds = [e.get("kind") for e in payload["entries"]]
    if not any(str(k).startswith("serve_decode") for k in kinds):
        print(f"ERROR: dump does not name the stalled decode "
              f"(kinds: {sorted(set(kinds))})", file=sys.stderr)
        return 1
    print(f"chaos: watchdog fired, /healthz 503, dump {path} names "
          f"the stalled decode dispatch")
    return 0


def _verify_identity(args, engine, reqs, out, obs_fence_delta) -> int:
    """Re-serve the SAME trace on ``engine`` (observability stripped) and
    pin bitwise-identical greedy outputs + an identical deliberate-fence
    count — observability must be trajectory-neutral."""
    import copy

    from deepspeed_tpu_torch.inference import run_serve
    from deepspeed_tpu_torch.observability import fences

    f0 = fences.FENCE_COUNT
    base = run_serve(engine, copy.deepcopy(reqs), window_iters=args.window)
    base_fences = fences.FENCE_COUNT - f0
    obs_tokens = {r.rid: r.tokens for r in out["results"]}
    base_tokens = {r.rid: r.tokens for r in base["results"]}
    if obs_tokens != base_tokens:
        diff = [rid for rid in obs_tokens
                if obs_tokens[rid] != base_tokens.get(rid)]
        print(f"ERROR: observability changed greedy outputs for "
              f"requests {diff}", file=sys.stderr)
        return 1
    if base_fences != obs_fence_delta:
        print(f"ERROR: observability changed the deliberate-fence count "
              f"({obs_fence_delta} with, {base_fences} without)",
              file=sys.stderr)
        return 1
    print(f"identity: {len(base_tokens)} requests bitwise-identical "
          f"with observability off ({base_fences} deliberate fences "
          f"either way)")
    return 0


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", required=True,
                        help="checkpoint directory (written by --prepare, "
                             "or any training run's save_dir)")
    parser.add_argument("--prepare", action="store_true",
                        help="train a tiny checkpoint instead of serving")
    parser.add_argument("--prefix-trace", action="store_true",
                        help="serve a multi-tenant trace sharing a "
                             "system prompt (exercises prefix KV reuse; "
                             "exits 1 if no hit was recorded)")
    parser.add_argument("--deepspeed_config", default=None,
                        help="the serving config (JSON); without one the "
                             "engine's defaults serve in fp32")
    parser.add_argument("--size", default="tiny")
    parser.add_argument("--vocab", type=int, default=VOCAB)
    parser.add_argument("--seq", type=int, default=SEQ)
    parser.add_argument("--steps", type=int, default=20,
                        help="--prepare training steps")
    parser.add_argument("--requests", type=int, default=8)
    parser.add_argument("--max-new", type=int, default=16)
    parser.add_argument("--window", type=int, default=8,
                        help="decode iterations per serve telemetry event")
    parser.add_argument("--jsonl", default=None,
                        help="serve telemetry JSONL path")
    parser.add_argument("--health_port", type=int, default=None,
                        help="serve /healthz /status /metrics on this "
                             "port (unset = the config/env value; an "
                             "explicit 0 disables a config-enabled "
                             "port)")
    parser.add_argument("--watchdog_timeout_s", type=float, default=None,
                        help="arm the serve watchdog around every "
                             "prefill/decode dispatch (explicit 0 "
                             "disables a config-enabled watchdog)")
    parser.add_argument("--probe-endpoints", action="store_true",
                        help="probe /healthz + parse-gate /metrics over "
                             "HTTP mid-traffic; exits 1 unless the "
                             "slot/page gauges went live")
    parser.add_argument("--metrics-out", default=None,
                        help="write the peak-load /metrics payload here "
                             "(an artifact to keep)")
    parser.add_argument("--chaos-stall-iter", type=int, default=0,
                        help="stall the Nth decode dispatch inside the "
                             "armed watchdog region (chaos leg); exits "
                             "1 unless the watchdog fired, /healthz "
                             "turned 503 and a loadable dump names the "
                             "stalled decode")
    parser.add_argument("--chaos-stall-s", type=float, default=30.0,
                        help="stall duration ceiling (ends early when "
                             "the watchdog reacted)")
    parser.add_argument("--verify-identity", action="store_true",
                        help="re-serve the trace observability-off (or, "
                             "with --fleet, on one replica) and require "
                             "bitwise-identical outputs")
    parser.add_argument("--fleet", type=int, default=0,
                        help="serve through a least-loaded router over "
                             "N in-process replicas (0 = single "
                             "replica; falls back to the config's "
                             "inference.fleet.replicas)")
    parser.add_argument("--prefill-replicas", type=int, default=None,
                        help="of the fleet, how many form the prefill "
                             "pool (KV handoff to the decode pool; "
                             "needs inference.fleet.disaggregate)")
    parser.add_argument("--router-port", type=int, default=None,
                        help="serve the ROUTER's own /healthz /status "
                             "/metrics here (replica endpoints ride "
                             "--health_port + replica index)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the first CUDA "
                             "device); 'cpu' serves on the CPU")
    parser.add_argument("--local_rank", type=int, default=None,
                        help="set by the launcher (the card comes from "
                             "LOCAL_RANK)")
    return parser.parse_args(argv)


def main(argv=None):
    global VOCAB, SEQ
    args = parse_args(argv)
    VOCAB, SEQ = args.vocab, args.seq

    if args.prepare:
        prepare(args)
        return 0
    if args.fleet or args.prefill_replicas:
        return serve_fleet(args)
    return serve(args)


if __name__ == "__main__":
    sys.exit(main())
