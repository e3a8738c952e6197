"""Serve telemetry and replica health on the port, on the CPU.

``deepspeed_tpu_torch.inference.driver`` / ``observability`` against the
JAX package's (the JAX ``tests/test_serve_obs.py`` cases this mirrors):

* ``run_serve``'s JSONL (serve windows v3, request events, the startup
  event) is clean under both the port's and the JAX validator, and each
  event's keys equal the JAX engine's on the same trace and weights (the
  values that are times excluded); the tokens are the JAX engine's;
* greedy outputs and the deliberate-fence count are the same with the
  observability stack on or off, and fused decode reads the card once a
  D-block;
* ``/healthz`` answers 200 mid-serve and turns 503 once a chaos stall
  fires the serve watchdog, whose flight-recorder dump names the stalled
  decode dispatch; a crash mid-drain leaves the crash dump.
"""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from deepspeed_tpu.inference import InferenceEngine as JEngine
from deepspeed_tpu.inference import run_serve as jrun_serve
from deepspeed_tpu.inference import synthetic_requests as jsynthetic
from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2
from deepspeed_tpu.observability import schema as jschema
from deepspeed_tpu_torch.inference import (ContinuousScheduler,
                                           InferenceEngine, Request,
                                           ServeObservability,
                                           ServeTelemetry, observability,
                                           run_serve, synthetic_requests)
from deepspeed_tpu_torch.models import GPT2
from deepspeed_tpu_torch.observability import (detectors, fences, flightrec,
                                               schema)
from deepspeed_tpu_torch.observability.health import (HealthServer,
                                                      parse_prometheus_text)
from deepspeed_tpu_torch.resilience import chaos

TINY = dict(vocab_size=128, max_seq_len=64, num_layers=2, hidden_size=64,
            num_heads=4, init_std=0.2)
#: event fields that are wall-clock readings (their values differ run to
#: run; their keys are held all the same)
TIMES = {"ts", "elapsed_s"}


def tmodel():
    return GPT2.from_size("tiny", device="meta", **TINY)


def serve_config(obs=None, **inf):
    base = {"max_slots": 3, "max_tokens": 32, "prefill_bucket": 16,
            "page_tokens": 32, "dtype": "float32"}
    base.update(inf)
    if obs is not None:
        base["observability"] = obs
    return {"train_micro_batch_size_per_gpu": 1, "inference": base}


def trace(n=5, seed=3, mod=None):
    return (mod or synthetic_requests)(
        n, vocab=TINY["vocab_size"], seed=seed, prompt_min=3, prompt_max=10,
        new_min=3, new_max=7)


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        JGPT2.from_size("tiny", **TINY).init_params(jax.random.PRNGKey(0)))


@pytest.fixture(autouse=True)
def _clean_globals():
    chaos.reset()
    detectors.SERVE_COUNTERS.reset()
    yield
    chaos.reset()
    detectors.SERVE_COUNTERS.reset()


def engine(params, cfg=None):
    return InferenceEngine(tmodel(), config=cfg or serve_config(),
                           params=params, device="cpu")


def _events(path):
    return [json.loads(line) for line in open(path)]


def test_serve_jsonl_clean_and_keyed_as_jax(params, tmp_path):
    mine, theirs = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    out = run_serve(engine(params), trace(), jsonl_path=mine,
                    window_iters=3)
    jout = jrun_serve(JEngine(JGPT2.from_size("tiny", **TINY),
                              config=serve_config(), params=params),
                      trace(mod=jsynthetic), jsonl_path=theirs,
                      window_iters=3)
    assert ({r.rid: r.tokens for r in out["results"]}
            == {r.rid: r.tokens for r in jout["results"]})
    assert schema.validate_jsonl(mine) == []
    assert jschema.validate_jsonl(mine) == []
    for mod in ("deepspeed_tpu_torch.observability",
                "deepspeed_tpu.observability"):
        proc = subprocess.run([sys.executable, "-m", mod, mine],
                              capture_output=True, text=True)
        assert proc.returncode == 0, proc.stdout + proc.stderr
    tev, jev = _events(mine), _events(theirs)
    assert [e["schema"] for e in tev] == [e["schema"] for e in jev]
    for a, b in zip(tev, jev):
        assert set(a) == set(b)
        if a["schema"] == schema.SERVE_SCHEMA_ID:
            assert set(a["counters"]) == set(b["counters"])
            for key in ("window", "decode_iters", "tokens_out", "admitted",
                        "evicted", "slots", "kv_cache_gb", "free_pages",
                        "requests_completed", "slots_in_use"):
                assert a[key] == b[key], key
        if a["schema"] == schema.REQUEST_SCHEMA_ID:
            for key in ("rid", "slot", "prompt_tokens", "tokens_out",
                        "finish_reason", "prefix_hit", "pages_mapped"):
                assert a[key] == b[key], key
    assert out["summary"]["request_events"] == 5
    assert set(out["summary"]) == set(jout["summary"])


def test_fences_and_trajectory_neutral(params, tmp_path):
    """Tokens and the deliberate-fence count are the same with request
    events, JSONL, watchdog and detectors on or off; fused decode takes
    one read per admission and one per D-block, never one per token."""
    reqs = trace(6, seed=21)

    def clone():
        return [Request(rid=r.rid, prompt=list(r.prompt),
                        max_new_tokens=r.max_new_tokens) for r in reqs]

    f0 = fences.FENCE_COUNT
    base = run_serve(engine(params), clone())
    base_fences = fences.FENCE_COUNT - f0
    eng = engine(params, serve_config(obs={"watchdog_timeout_s": 30.0,
                                           "window_iters": 2}))
    f0 = fences.FENCE_COUNT
    on = run_serve(eng, clone(), jsonl_path=str(tmp_path / "s.jsonl"),
                   window_iters=2)
    assert fences.FENCE_COUNT - f0 == base_fences
    tokens = {r.rid: r.tokens for r in base["results"]}
    assert {r.rid: r.tokens for r in on["results"]} == tokens
    fused = engine(params, serve_config(decode_iters_per_dispatch=4))
    f0 = fences.FENCE_COUNT
    out = run_serve(fused, clone())
    assert {r.rid: r.tokens for r in out["results"]} == tokens
    assert (fences.FENCE_COUNT - f0
            == out["summary"]["admitted"] + fused.decode_dispatches)
    assert out["summary"]["decode_iters"] == 4 * fused.decode_dispatches


def _get(port, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=5) as r:
            return r.getcode(), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_health_endpoints_mid_serve(params, tmp_path):
    eng = engine(params, serve_config(obs={"watchdog_timeout_s": 30.0,
                                           "window_iters": 2}))
    obs = ServeObservability(eng)
    assert obs.watchdog is not None and eng.watchdog is obs.watchdog
    obs.health = HealthServer(0, obs)      # an OS-assigned port
    try:
        tel = ServeTelemetry(eng, jsonl_path=str(tmp_path / "s.jsonl"),
                             window_iters=2, observability=obs)
        obs.telemetry = tel
        sched = ContinuousScheduler(eng, on_event=tel.on_iteration,
                                    on_complete=tel.on_complete)
        obs.note_scheduler(sched)
        for r in trace(4, seed=5):
            sched.submit(r)
        for _ in range(3):                 # mid-serve: slots occupied
            tel.on_iteration(sched, sched.step())
        assert sched.active >= 1
        code, body = _get(obs.port, "/healthz")
        assert code == 200 and json.loads(body)["ok"] is True
        code, body = _get(obs.port, "/status")
        status = json.loads(body)
        assert code == 200 and status["slots_in_use"] >= 1
        assert status["pool"]["pages_in_use"] >= 1
        code, text = _get(obs.port, "/metrics")
        parsed = parse_prometheus_text(text)
        assert code == 200 and parsed["dstpu_healthy"] == 1
        assert parsed["dstpu_slots_total"] == eng.num_slots
        while sched.queue or sched.active:
            tel.on_iteration(sched, sched.step())
        tel.flush(sched)
        tel.close()
        parsed = parse_prometheus_text(_get(obs.port, "/metrics")[1])
        assert parsed["dstpu_requests_completed"] == 4
        assert "dstpu_window_tokens_per_sec" in parsed
    finally:
        obs.close()


def test_stalled_decode_watchdog_503_dump(params, tmp_path):
    """A chaos stall in a decode dispatch fires the serve watchdog:
    ``/healthz`` turns 503, the dump names the stalled decode, and the
    tokens equal a clean run's."""
    reqs = trace(3, seed=9)
    clean = run_serve(engine(params), [
        Request(rid=r.rid, prompt=list(r.prompt),
                max_new_tokens=r.max_new_tokens) for r in reqs])
    flightrec.RECORDER.configure(dump_dir=str(tmp_path))
    chaos.configure(stall_step=2, stall_s=30.0)
    eng = engine(params, serve_config(obs={
        "watchdog_timeout_s": 0.3, "flight_recorder_dir": str(tmp_path)}))
    obs = ServeObservability(eng)
    obs.health = HealthServer(0, obs)
    try:
        assert chaos._state.stall_until is obs.watchdog.fire_event
        code, _ = _get(obs.port, "/healthz")
        assert code == 200
        out = run_serve(eng, reqs, observability=obs)
        assert obs.watchdog.fired and not obs.healthy()
        code, body = _get(obs.port, "/healthz")
        assert code == 503 and json.loads(body)["ok"] is False
        parsed = parse_prometheus_text(_get(obs.port, "/metrics")[1])
        assert parsed["dstpu_healthy"] == 0
        payload = flightrec.load_dump(
            os.path.join(str(tmp_path), "flightrec_rank0_watchdog.json"))
        kinds = [e.get("kind") for e in payload["entries"]]
        assert any(str(k).startswith("serve_decode") for k in kinds)
        assert ({r.rid: r.tokens for r in out["results"]}
                == {r.rid: r.tokens for r in clean["results"]})
    finally:
        obs.close()


def test_serve_crash_dumps_flight_recorder(params, tmp_path):
    flightrec.RECORDER.configure(dump_dir=str(tmp_path))
    calls = []

    def exploding_sampler(row):
        calls.append(1)
        if len(calls) >= 3:
            raise RuntimeError("boom mid-drain")
        return int(np.argmax(row))

    eng = engine(params)
    assert not observability.configured(eng.config)
    with pytest.raises(RuntimeError, match="boom mid-drain"):
        run_serve(eng, trace(3, seed=11), sampler=exploding_sampler)
    payload = flightrec.load_dump(
        os.path.join(str(tmp_path), "flightrec_rank0_crash.json"))
    crash = [e for e in payload["entries"] if e["kind"] == "crash"]
    assert crash and crash[-1]["where"] == "serve"
