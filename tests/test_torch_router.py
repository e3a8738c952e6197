"""The serving fleet on the port against the JAX package's, on the CPU.

``deepspeed_tpu_torch.inference.router`` (``FleetRouter``, ``run_fleet``),
the KV handoff (``InferenceEngine.export_kv`` / ``import_kv``,
``checkpoint.write_kv_handoff`` / ``read_kv_handoff``, the scheduler's
``KVHandoff`` intake) held against ``deepspeed_tpu.inference`` in fp32 at
the JAX tests' tiny GPT-2 (2 layers, hidden 64, 4 heads, vocab 128,
``init_std`` 0.2), both packages' engines on the same numpy weights:

* greedy tokens and the router's counters (``evictions``, ``resubmits``,
  ``handoffs``, ``affinity_hits``) equal the JAX fleet's on the same
  traces, single replica, mixed, affinity, eviction and disaggregated;
  the JAX runs are made once for the module;
* handoff artifacts read both ways between the packages, and a request
  handed off either way continues with the JAX tokens; exported rows
  equal the JAX engine's at ``atol=1e-5`` (fp32, two frameworks' sums)
  and import bitwise into another port replica;
* the cases of the JAX package's ``tests/test_router.py`` through the
  port: refusals and guards, requeue timestamps, zombie completions,
  corrupt artifacts, the router JSONL under both validators, the live
  endpoints.  ``test_predicted_executables_include_handoff_programs`` is
  ROADMAP.md Queue 1 item 14 and has no counterpart here.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax

from deepspeed_tpu import checkpoint as jcheckpoint
from deepspeed_tpu.inference import InferenceEngine as JEngine
from deepspeed_tpu.inference import run_fleet as jrun_fleet
from deepspeed_tpu.inference import run_serve as jrun_serve
from deepspeed_tpu.inference import synthetic_requests as jsynthetic
from deepspeed_tpu.inference import Request as JRequest
from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2
from deepspeed_tpu.observability import schema as jschema
from deepspeed_tpu.resilience import chaos as jchaos
from deepspeed_tpu_torch import checkpoint
from deepspeed_tpu_torch.config import DeepSpeedConfig, DeepSpeedConfigError
from deepspeed_tpu_torch.inference import (ContinuousScheduler, FleetRouter,
                                           InferenceEngine, KVHandoff,
                                           Request, run_fleet, run_serve,
                                           synthetic_requests)
from deepspeed_tpu_torch.models import GPT2
from deepspeed_tpu_torch.observability import flightrec, schema
from deepspeed_tpu_torch.observability import health as health_mod
from deepspeed_tpu_torch.resilience import chaos

TINY = dict(vocab_size=128, max_seq_len=64, num_layers=2, hidden_size=64,
            num_heads=4, init_std=0.2)
#: the eviction runs' serve watchdog: far above a tiny decode's
#: milliseconds, so that only the injected stall fires it
WATCHDOG_S = 1.0
#: the shared-prefix trace: 3 pages of 8 tokens, then a tail
PREFIX_TOKENS = 24


def serve_config(fleet=None, obs=None, **inf):
    base = {"max_slots": 4, "max_tokens": 64, "prefill_bucket": 32,
            "page_tokens": 8, "dtype": "float32"}
    base.update(inf)
    if fleet is not None:
        base["fleet"] = fleet
    if obs is not None:
        base["observability"] = obs
    return {"train_micro_batch_size_per_gpu": 1, "inference": base}


@pytest.fixture(scope="module")
def params():
    model = JGPT2.from_size("tiny", **TINY)
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  model.init_params(jax.random.PRNGKey(0)))


def build(params, fleet=None, obs=None, **inf):
    return InferenceEngine(GPT2.from_size("tiny", device="meta", **TINY),
                           config=serve_config(fleet=fleet, obs=obs, **inf),
                           params=params, device="cpu")


def jbuild(params, fleet=None, obs=None, **inf):
    return JEngine(JGPT2.from_size("tiny", **TINY),
                   config=serve_config(fleet=fleet, obs=obs, **inf),
                   params=params)


def trace(n=10, seed=0):
    spec = dict(vocab=TINY["vocab_size"], seed=seed, prompt_min=2,
                prompt_max=8, new_min=4, new_max=14)
    return synthetic_requests(n, **spec), jsynthetic(n, **spec)


def prefix_trace(cls):
    rng = np.random.default_rng(5)
    sys_prompt = rng.integers(0, TINY["vocab_size"],
                              size=PREFIX_TOKENS).astype(int).tolist()
    reqs = []
    for i in range(8):
        tail = rng.integers(0, TINY["vocab_size"], size=int(
            rng.integers(2, 6))).astype(int).tolist()
        reqs.append(cls(rid=i, prompt=sys_prompt + tail, max_new_tokens=6))
    return reqs


def tokens(results):
    return {r.rid: list(r.tokens) for r in results}


def counters(summary):
    return {k: summary[k] for k in ("evictions", "resubmits", "handoffs",
                                    "affinity_hits", "n_replicas",
                                    "prefill_replicas", "requests")}


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one intra-op thread: the suite runs six workers on the
    host's cores, where one thread a core makes the replicas' small steps
    contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos.reset()
    jchaos.reset()
    yield
    chaos.reset()
    jchaos.reset()


def _warm(engines, prompt):
    for e in engines:
        e.generate([prompt], max_new_tokens=2)
        e.reset()


def _evict_run(engines, reqs, fleet_fn, chaos_mod, dump_dir):
    """The eviction mode: a stall at the first decode dispatch of the trace
    in whichever replica reaches it; that replica's watchdog fires, its
    /healthz turns 503 and the router resubmits the requests it still
    held (5 of the 10: a request needs 3 more decodes to finish)."""
    stall_at = max(e.decode_dispatches for e in engines) + 1
    chaos_mod.configure(stall_step=stall_at, stall_s=30.0)
    try:
        return fleet_fn(engines, reqs, poll_s=0.02)
    finally:
        chaos_mod.reset()


def _run_modes(params, pkg, tmp):
    """Every fleet mode of one package: ``{mode: (tokens, counters)}``."""
    jax_side = pkg == "jax"
    mk = jbuild if jax_side else build
    fleet_fn = jrun_fleet if jax_side else run_fleet
    serve_fn = jrun_serve if jax_side else run_serve
    chaos_mod = jchaos if jax_side else chaos
    reqs = trace()[1 if jax_side else 0]
    preqs = prefix_trace(JRequest if jax_side else Request)
    out = {}
    mixed = [mk(params), mk(params)]
    _warm(mixed, reqs[0].prompt)
    res = serve_fn(mixed[0], reqs)
    out["single"] = (tokens(res["results"]), None)
    mixed[0].reset()
    res = fleet_fn(mixed, reqs, poll_s=0.02)
    out["mixed"] = (tokens(res["results"]), counters(res["summary"]))
    for e in mixed:
        e.reset()
    res = fleet_fn(mixed, preqs, poll_s=0.02)
    out["affinity"] = (tokens(res["results"]), dict(
        counters(res["summary"]),
        reused=sum(e.pool.tokens_reused for e in mixed) > 0))
    dump_dir = os.path.join(tmp, pkg)
    wd = [mk(params, obs={"watchdog_timeout_s": WATCHDOG_S,
                          "flight_recorder_dir": dump_dir})
          for _ in range(2)]
    _warm(wd, reqs[0].prompt)
    res = _evict_run(wd, reqs, fleet_fn, chaos_mod, dump_dir)
    dumps = [f for f in os.listdir(dump_dir) if "watchdog" in f]
    stats = counters(res["summary"])
    # between the watchdog's fire (the stall's end) and the router's next
    # poll the wedged replica may finish a request, in either package:
    # the count of resubmits is the stalled replica's share less those
    resubmits = stats.pop("resubmits")
    out["eviction"] = (tokens(res["results"]), dict(
        stats, dumps=len(dumps), resubmitted_some=1 <= resubmits <= 5))
    dis = {"disaggregate": True}
    res = fleet_fn([mk(params, fleet=dis)], reqs,
                   prefill_engines=[mk(params, fleet=dis)], poll_s=0.02)
    out["disaggregated"] = (tokens(res["results"]),
                            counters(res["summary"]))
    return out


@pytest.fixture(scope="module")
def jax_modes(params, tmp_path_factory):
    return _run_modes(params, "jax", str(tmp_path_factory.mktemp("jfleet")))


@pytest.fixture(scope="module")
def torch_modes(params, tmp_path_factory):
    return _run_modes(params, "torch",
                      str(tmp_path_factory.mktemp("tfleet")))


@pytest.fixture(scope="module")
def single_reference(jax_modes):
    return trace()[0], jax_modes["single"][0]


# ------------------------------------------------------ against the JAX fleet
@pytest.mark.parametrize("mode", ["single", "mixed", "affinity", "eviction",
                                  "disaggregated"])
def test_fleet_matches_jax(jax_modes, torch_modes, mode):
    """Tokens and router counters equal the JAX fleet's, mode by mode."""
    mine = torch_modes
    assert mine[mode] == jax_modes[mode]
    if mode != "single":
        # a fleet arrangement is invisible in the tokens
        ref = mine["single"][0] if mode != "affinity" else None
        if ref is not None:
            assert mine[mode][0] == ref
    stats = mine[mode][1] or {}
    if mode == "mixed":
        assert stats["evictions"] == stats["resubmits"] == 0
    if mode == "affinity":
        assert stats["affinity_hits"] > 0 and stats["reused"]
    if mode == "eviction":
        assert stats["evictions"] == 1 and stats["resubmitted_some"]
        assert stats["dumps"] == 1
    if mode == "disaggregated":
        assert stats["handoffs"] == len(trace()[0])


# ------------------------------------------------------------- the router
def test_router_requires_an_engine():
    with pytest.raises(ValueError, match="at least one"):
        FleetRouter([])


def test_router_rejects_over_budget_request_at_submit(params):
    router = FleetRouter([build(params)], poll_s=0.05)
    try:
        with pytest.raises(ValueError):
            router.submit(Request(rid=1, prompt=list(range(200)),
                                  max_new_tokens=4))
        assert router.submitted == 0
    finally:
        router.close()


def test_completion_from_evicted_replica_is_dropped(params):
    from deepspeed_tpu_torch.inference.router import _Flight
    from deepspeed_tpu_torch.inference.scheduler import RequestResult
    router = FleetRouter([build(params), build(params)], poll_s=0.05)
    rep0, rep1 = router.replicas
    req = Request(rid=7, prompt=[1, 2, 3], max_new_tokens=4)
    router._inflight[7] = _Flight(req, 0.0, rep1, "mixed")

    def result():
        return RequestResult(rid=7, tokens=[1, 2], finish_reason="length",
                             ttft_s=0.1, itl_s=[], prompt_len=3)

    router._complete(rep0, result())          # zombie: not the owner
    assert not router.results and 7 in router._inflight
    router._complete(rep1, result())          # the owner lands
    assert len(router.results) == 1 and 7 not in router._inflight
    router.close()


def test_evacuate_preserves_original_timestamps(params):
    eng = build(params)
    sched = ContinuousScheduler(eng)
    t_orig = time.perf_counter() - 5.0
    reqs = trace(6, seed=2)[0]
    for r in reqs[:3]:
        sched.submit(r, now=t_orig)
    sched.step()
    for r in reqs[3:]:
        sched.submit(r, now=t_orig)
    assert sched.active > 0
    pairs = sched.evacuate()
    assert len(pairs) == 6 and all(t == t_orig for _, t in pairs)
    assert [r.rid for r, _ in pairs[:3]] == [r.rid for r in reqs[:3]]
    assert sched.active == 0 and sched.pending == 0
    assert eng.pool.gauges()["pages_in_use"] == 0
    sched2 = ContinuousScheduler(build(params))
    for r, t in pairs:
        sched2.submit(r, now=t)
    results = sched2.run()
    assert all(r.queue_wait_s >= 5.0 and r.ttft_s >= 5.0 for r in results)


def test_evacuate_returns_unimported_handoffs_as_requests(params):
    eng = build(params, fleet={"disaggregate": True})
    sched = ContinuousScheduler(eng)
    spec = eng.cache_spec
    k = torch.zeros((spec.layers, 3, spec.kv_heads_local, spec.head_dim))
    h = KVHandoff(req=Request(rid=1, prompt=[1, 2, 3], max_new_tokens=4),
                  prompt=[1, 2, 3], first_token=5, k=k, v=k.clone(),
                  n_tokens=3, t_enqueue=123.0, t_admit=124.0,
                  t_first_token=125.0)
    sched.submit_handoff(h)
    assert sched.pending == 1
    assert sched.evacuate() == [(h.req, 123.0)]


def test_all_replicas_dead_is_an_error_not_a_hang(params):
    router = FleetRouter([build(params)], poll_s=0.02)
    router.start()
    router.replicas[0].error = RuntimeError("driver died")
    with pytest.raises(RuntimeError, match="no progress"):
        router.serve(trace()[0][:2], timeout_s=30.0, stall_timeout_s=1.0)
    router.close()


def test_prefill_pool_death_degrades_to_mixed(params, single_reference):
    reqs, ref = single_reference
    dis = {"disaggregate": True}
    router = FleetRouter([build(params, fleet=dis)],
                         [build(params, fleet=dis)], poll_s=0.02)
    try:
        router.start()
        router._evict(router.prefill_pool[0])
        out = router.serve(reqs, stall_timeout_s=30.0)
        assert tokens(out["results"]) == ref
        assert out["summary"]["handoffs"] == 0
    finally:
        router.close()


def test_fleet_without_shared_sink_honors_replica_jsonl(
        params, single_reference, tmp_path):
    reqs, ref = single_reference
    path = str(tmp_path / "replica.jsonl")
    eng = build(params, obs={"jsonl_path": path, "window_iters": 4})
    out = run_fleet([eng], reqs, poll_s=0.02)
    assert tokens(out["results"]) == ref
    events = [json.loads(line) for line in open(path)]
    assert any(e["schema"] == schema.SERVE_SCHEMA_ID for e in events)
    assert sum(e["schema"] == schema.REQUEST_SCHEMA_ID
               for e in events) == len(reqs)


@pytest.mark.parametrize("case", ["greedy-only", "config-flag",
                                  "cache-specs"])
def test_disaggregation_guards(params, case):
    dis = {"disaggregate": True}
    if case == "greedy-only":
        with pytest.raises(ValueError, match="greedy-only"):
            FleetRouter([build(params, fleet=dis)],
                        [build(params, fleet=dis)], sampler=lambda x: 0)
    elif case == "config-flag":
        with pytest.raises(ValueError, match="disaggregate"):
            FleetRouter([build(params)], [build(params)])
    else:
        with pytest.raises(ValueError, match="KV specs diverge"):
            FleetRouter([build(params, fleet=dis)],
                        [build(params, fleet=dis, dtype="bfloat16")])


def test_router_removes_only_its_own_handoff_dir(params, tmp_path):
    router = FleetRouter([build(params)], poll_s=0.05)
    own = router.handoff_dir
    assert os.path.isdir(own)
    router.close()
    assert not os.path.exists(own)
    given = str(tmp_path / "handoffs")
    router = FleetRouter([build(params)], poll_s=0.05, handoff_dir=given)
    router.close()
    assert os.path.isdir(given)


def test_chaos_stall_ends_when_any_registered_watchdog_fires():
    ev_first, ev_stalled = threading.Event(), threading.Event()
    chaos.configure(stall_step=1, stall_s=30.0)
    chaos.add_stall_until(ev_first)
    chaos.add_stall_until(ev_stalled)
    ev_stalled.set()
    t0 = time.monotonic()
    chaos.maybe_stall(1)
    assert time.monotonic() - t0 < 5.0


# ----------------------------------------------------------- KV handoff
def _prefilled(eng, req):
    logits, _ = eng.admit(0, req.prompt, req.max_new_tokens)
    return int(np.argmax(np.asarray(logits, np.float32)))


def _decode_rest(eng, tok0, max_new_tokens):
    toks = [tok0]
    feed = np.zeros((eng.num_slots,), np.int32)
    active = np.zeros((eng.num_slots,), bool)
    while len(toks) < max_new_tokens:
        feed[0], active[0] = toks[-1], True
        step = eng.decode(feed, active)
        toks.append(int(np.argmax(np.asarray(step[0], np.float32))))
    return toks


def test_export_import_continues_byte_identically(params, single_reference):
    """Prefill on one port replica, export, import into another: the
    imported pool rows are bitwise the exported ones, the exported rows
    equal the JAX engine's export at atol 1e-5, and decoding continues
    with the JAX single replica's tokens."""
    reqs, ref = single_reference
    req = max(reqs, key=lambda r: r.max_new_tokens)
    dis = {"disaggregate": True}
    pre, dec = build(params, fleet=dis), build(params, fleet=dis)
    tok0 = _prefilled(pre, req)
    k, v, n = pre.export_kv(0)
    assert n == len(req.prompt) and k.dtype == torch.float32
    rows = torch.as_tensor(pre.pool.slot_rows(0)[:n], dtype=torch.long)
    assert torch.equal(k, pre._cache["k"][:, rows])
    assert torch.equal(v, pre._cache["v"][:, rows])
    jpre = jbuild(params, fleet=dis)
    jpre.admit(0, req.prompt, req.max_new_tokens)
    jk, jv, jn = jpre.export_kv(0)
    assert jn == n
    np.testing.assert_allclose(k.numpy(), jk, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), jv, atol=1e-5)
    grant = dec.import_kv(0, req.prompt, k, v, req.max_new_tokens)
    assert grant is not None and grant.reused_tokens == 0
    drows = torch.as_tensor(dec.pool.slot_rows(0)[:n], dtype=torch.long)
    assert torch.equal(dec._cache["k"][:, drows], k)
    assert torch.equal(dec._cache["v"][:, drows], v)
    assert int(dec._cache["pos"][0]) == n
    # nothing past the prompt and nothing in the drop row was written
    assert not dec._cache["k"][:, -1].any()
    assert _decode_rest(dec, tok0, req.max_new_tokens) == ref[req.rid]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_handoff_artifact_reads_both_ways(params, single_reference,
                                          tmp_path, writer):
    """A handoff written by either package, read by the other, continues
    the request with the JAX tokens on the reader's decode replica."""
    reqs, ref = single_reference
    req = max(reqs, key=lambda r: r.max_new_tokens)
    path = str(tmp_path / "h.kvh")
    dis = {"disaggregate": True}
    meta = {"rid": req.rid, "prompt": list(req.prompt),
            "max_new_tokens": req.max_new_tokens, "eos_id": None,
            "n_tokens": len(req.prompt), "t_enqueue": 1.0}
    if writer == "jax":
        jpre = jbuild(params, fleet=dis)
        logits, _ = jpre.admit(0, req.prompt, req.max_new_tokens)
        tok0 = int(np.argmax(np.asarray(logits, np.float32)))
        k, v, _ = jpre.export_kv(0)
        jcheckpoint.write_kv_handoff(path, k=k, v=v,
                                     meta=dict(meta, first_token=tok0))
        meta2, k2, v2 = checkpoint.read_kv_handoff(path)
        np.testing.assert_array_equal(k2.numpy(), k)
        np.testing.assert_array_equal(v2.numpy(), v)
        dec = build(params, fleet=dis)
        assert dec.import_kv(0, meta2["prompt"], k2, v2,
                             meta2["max_new_tokens"]) is not None
        got = _decode_rest(dec, meta2["first_token"],
                           meta2["max_new_tokens"])
    else:
        pre = build(params, fleet=dis)
        tok0 = _prefilled(pre, req)
        k, v, _ = pre.export_kv(0)
        checkpoint.write_kv_handoff(path, k=k, v=v,
                                    meta=dict(meta, first_token=tok0))
        meta2, k2, v2 = jcheckpoint.read_kv_handoff(path)
        np.testing.assert_array_equal(k2, k.numpy())
        np.testing.assert_array_equal(v2, v.numpy())
        jdec = jbuild(params, fleet=dis)
        assert jdec.import_kv(0, meta2["prompt"], k2, v2,
                              meta2["max_new_tokens"]) is not None
        got = _decode_rest(jdec, meta2["first_token"],
                           meta2["max_new_tokens"])
    assert meta2["first_token"] == tok0 and meta2["rid"] == req.rid
    assert got == ref[req.rid]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_handoff_artifact_roundtrip(tmp_path, dtype):
    path = str(tmp_path / "h.kvh")
    k = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(
        2, 3, 4, 5).to(dtype)
    v = -k
    meta = {"rid": 3, "prompt": [1, 2, 3], "max_new_tokens": 7,
            "eos_id": None, "first_token": 9, "n_tokens": 3,
            "t_enqueue": 1.0, "t_admit": 2.0, "t_first_token": 3.0}
    checkpoint.write_kv_handoff(path, k=k, v=v, meta=meta)
    meta2, k2, v2 = checkpoint.read_kv_handoff(path)
    assert meta2 == meta and k2.dtype == dtype
    assert torch.equal(k2, k) and torch.equal(v2, v)
    assert not os.path.exists(path + ".tmp")


def test_kv_handoff_corruption_raises_named_errors(tmp_path):
    path = str(tmp_path / "h.kvh")
    k = torch.ones((1, 2, 2, 2))
    checkpoint.write_kv_handoff(path, k=k, v=k, meta={"n_tokens": 2})
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])
    with pytest.raises(checkpoint.CheckpointReadError):
        checkpoint.read_kv_handoff(path)
    import pickle
    with open(path, "wb") as f:
        pickle.dump({"schema": "not.a.handoff"}, f)
    with pytest.raises(checkpoint.CheckpointReadError, match="schema"):
        checkpoint.read_kv_handoff(path)


def test_export_import_require_disaggregate_config(params):
    eng = build(params)
    with pytest.raises(RuntimeError, match="disaggregate"):
        eng.export_kv(0)
    with pytest.raises(RuntimeError, match="disaggregate"):
        eng.import_kv(0, [1, 2], np.zeros((2, 2, 4, 16), np.float32),
                      np.zeros((2, 2, 4, 16), np.float32), 4)


def test_import_kv_validates_shape_and_dtype(params):
    """The JAX engine's refusals, raised before the pool is touched."""
    eng = build(params, fleet={"disaggregate": True})
    spec = eng.cache_spec
    good = torch.zeros((spec.layers, 3, spec.kv_heads_local,
                        spec.head_dim))
    free = eng.pool.free_pages
    with pytest.raises(ValueError, match="shape mismatch"):
        eng.import_kv(0, [1, 2, 3], good[:, :2], good, 4)
    with pytest.raises(ValueError, match="dtype"):
        eng.import_kv(0, [1, 2, 3], good.half(), good.half(), 4)
    with pytest.raises(ValueError, match="v dtype"):
        eng.import_kv(0, [1, 2, 3], good, good.double(), 4)
    with pytest.raises(ValueError, match="v dtype"):
        eng.import_kv(0, [1, 2, 3], good.numpy(),
                      good.numpy().astype(np.float64), 4)
    with pytest.raises(ValueError, match="capacity"):
        big = torch.zeros((spec.layers, spec.capacity + 1,
                           spec.kv_heads_local, spec.head_dim))
        eng.import_kv(0, list(range(spec.capacity + 1)), big, big, 4)
    assert eng.pool.free_pages == free and not eng.pool.slot_pages(0)


def test_corrupt_handoff_fails_one_request_not_the_replica(
        params, single_reference, monkeypatch):
    reqs, ref = single_reference
    real = checkpoint.write_kv_handoff
    corrupted = []

    def corrupting(path, **kw):
        real(path, **kw)
        if not corrupted:
            corrupted.append(path)
            data = open(path, "rb").read()
            with open(path, "wb") as f:
                f.write(data[:len(data) // 2])
        return path

    monkeypatch.setattr(checkpoint, "write_kv_handoff", corrupting)
    dis = {"disaggregate": True}
    out = run_fleet([build(params, fleet=dis)], reqs,
                    prefill_engines=[build(params, fleet=dis)], poll_s=0.02)
    assert corrupted, "the corruption injection never ran"
    assert tokens(out["results"]) == ref
    assert out["summary"]["evictions"] == 0
    assert out["summary"]["handoffs"] == len(reqs) + 1


# ------------------------------------------------------------ telemetry
def test_router_jsonl_validates_under_both_validators(
        params, single_reference, tmp_path):
    reqs, ref = single_reference
    path = str(tmp_path / "router.jsonl")
    out = run_fleet([build(params), build(params)], reqs, poll_s=0.02,
                    jsonl_path=path)
    assert tokens(out["results"]) == ref
    assert not schema.validate_jsonl(path)
    assert not jschema.validate_jsonl(path)
    events = [json.loads(line) for line in open(path)]
    router_evs = [e for e in events if e["schema"] == schema.ROUTER_SCHEMA_ID]
    assert router_evs and router_evs[-1]["requests_completed"] == len(reqs)
    last = router_evs[-1]
    assert last["n_replicas"] == 2 and set(last["per_replica"]) == {"0", "1"}
    for load in last["per_replica"].values():
        assert {"slots_in_use", "queue_depth", "free_pages", "healthy",
                "role"} <= set(load)
    assert sum(e["schema"] == schema.REQUEST_SCHEMA_ID
               for e in events) == len(reqs)
    for cli in ("deepspeed_tpu_torch.observability",
                "deepspeed_tpu.observability"):
        proc = subprocess.run([sys.executable, "-m", cli, path],
                              capture_output=True, text=True, timeout=120,
                              env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "router" in proc.stdout


def test_router_and_replica_endpoints(params, single_reference):
    reqs, ref = single_reference
    ports = [_free_port() for _ in range(3)]
    router = FleetRouter([build(params), build(params)],
                         health_port=ports[0], replica_ports=ports[1:],
                         poll_s=0.02)
    try:
        assert router.obs is not None and router.obs.port == ports[0]
        assert [rep.port for rep in router.replicas] == ports[1:]
        out = router.serve(reqs)
        assert tokens(out["results"]) == ref
        base = f"http://127.0.0.1:{ports[0]}"
        with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
            assert r.getcode() == 200
        with urllib.request.urlopen(base + "/status", timeout=5) as r:
            status = json.loads(r.read())
        assert status["n_replicas"] == 2
        assert status["requests_completed"] == len(reqs)
        with urllib.request.urlopen(base + "/metrics", timeout=5) as r:
            parsed = health_mod.parse_prometheus_text(r.read().decode())
        assert parsed["dstpu_healthy"] == 1
        assert parsed["dstpu_healthy_replicas"] == 2
        assert parsed["dstpu_tokens_out"] > 0
        assert parsed["dstpu_process_uptime_s"] > 0
        for port in ports[1:]:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
                rep = health_mod.parse_prometheus_text(r.read().decode())
            assert {"dstpu_slots_in_use", "dstpu_process_uptime_s",
                    "dstpu_replica_generation"} <= set(rep)
    finally:
        router.close()


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_eviction_dump_names_the_stalled_decode(params, single_reference,
                                                tmp_path):
    """The wedged replica's flight-recorder dump loads and names the
    stalled decode dispatch (the JAX chaos test's last check)."""
    reqs, ref = single_reference
    dump_dir = str(tmp_path / "dumps")
    engines = [build(params, obs={"watchdog_timeout_s": WATCHDOG_S,
                                  "flight_recorder_dir": dump_dir})
               for _ in range(2)]
    _warm(engines, reqs[0].prompt)
    out = _evict_run(engines, reqs, run_fleet, chaos, dump_dir)
    assert tokens(out["results"]) == ref
    dumps = [f for f in os.listdir(dump_dir) if "watchdog" in f]
    assert len(dumps) == 1, dumps
    d = flightrec.load_dump(os.path.join(dump_dir, dumps[0]))
    assert d["reason"] == "watchdog"
    assert "serve_decode" in {e["kind"] for e in d["entries"]}


def test_fleet_config_guards():
    def cfg(fleet):
        return DeepSpeedConfig(serve_config(fleet=fleet))

    ok = cfg({"replicas": 2, "prefill_replicas": 1, "disaggregate": True,
              "health_port": 9000, "poll_s": 0.1, "affinity": False,
              "handoff_dir": "/tmp/h", "jsonl_path": "/tmp/r.jsonl"})
    assert ok.inference_fleet_replicas == 2
    assert ok.inference_fleet_prefill_replicas == 1
    assert ok.inference_fleet_disaggregate is True
    assert ok.inference_fleet_affinity is False
    for fleet, match in (({"replica": 2}, "unknown"),
                         ({"replicas": 2, "prefill_replicas": 1},
                          "disaggregate"),
                         ({"replicas": 2, "prefill_replicas": 2,
                           "disaggregate": True}, "DECODE"),
                         ({"poll_s": 0}, "poll_s"),
                         ({"health_port": 70000}, "65535"),
                         ({"replicas": -1}, ">= 0"), (17, "object")):
        with pytest.raises(DeepSpeedConfigError, match=match):
            cfg(fleet)
