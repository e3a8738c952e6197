"""The port's fleet view, detectors, flight recorder and health endpoints
against the JAX package's, after ``tests/test_fleet.py``.

* The detectors (``StragglerDetector``, ``SpikeDetector``,
  ``WindowAnomalyDetector``, ``ServeAnomalyDetector``) of both packages
  flag the same windows on the same series (the cases of
  ``tests/test_fleet.py:148-249`` and a serving series).
* The flight recorder's ring bounds and dump format; the Prometheus text
  of a snapshot is the JAX package's, character for character.
* The health endpoints answer on a live CPU engine; ``/healthz`` turns
  503 once a watchdog fires.
* One gloo launch at dp 2 (``torch_rank_worker.py``'s ``fleet``
  scenario): rank 0 writes the fleet events of both hosts over the c10d
  store and rank 1 writes none, the StragglerDetector flags the rank that
  stalled on the host in its window only, the masters agree bitwise, and
  each rank's flight-recorder dump holds its boundary records.
"""

import json
import math
import os
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.observability import detectors as jdet
from deepspeed_tpu.observability import flightrec as jflightrec
from deepspeed_tpu.observability import health as jhealth
from deepspeed_tpu_torch.observability import __main__ as tcli
from deepspeed_tpu_torch.observability import detectors as tdet
from deepspeed_tpu_torch.observability import flightrec as tflightrec
from deepspeed_tpu_torch.observability import health as thealth
from deepspeed_tpu_torch.resilience import COUNTERS, Watchdog, chaos
from torch_rank_worker import SimpleModel
from torch_ranks import run_ranks


@pytest.fixture(autouse=True)
def _clean():
    chaos.reset()
    COUNTERS.reset()
    for mod in (tdet, jdet):
        mod.COUNTERS.reset()
        mod.SERVE_COUNTERS.reset()
    yield
    chaos.reset()
    COUNTERS.reset()


# ------------------------------------------------------------------ detectors

FLEETS = [
    {r: {"host_ms": 2.0 + 0.1 * r, "step": 10} for r in range(4)},
    {**{r: {"host_ms": 2.0 + 0.1 * r, "step": 10} for r in range(4)},
     2: {"host_ms": 900.0, "step": 10}},
    {0: {"host_ms": 1.0}, 1: {"host_ms": 40.0}},
    {0: {"host_ms": 2.0, "data_wait_ms": 0.0},
     1: {"host_ms": 2.0, "data_wait_ms": 800.0}},
    {0: {"host_ms": 0.02}, 1: {"host_ms": 1003.0}},
    {0: {"host_ms": None}, 1: {"host_ms": 5.0}},
]


def test_straggler_detectors_agree():
    got = [(tdet.StragglerDetector(2.0).check_fleet(f),
            jdet.StragglerDetector(2.0).check_fleet(f)) for f in FLEETS]
    assert [t for t, _ in got] == [j for _, j in got]
    assert [t["stragglers"] for t, _ in got] == [[], [2], [], [1], [1], []]
    assert tdet.COUNTERS.as_dict() == jdet.COUNTERS.as_dict()


SPIKES = [1.0, 1.1, 0.9, 1.0, 100.0, 100.0, 1.05, float("nan"), 1.0]


def test_spike_detectors_agree():
    t, j = tdet.SpikeDetector(3.0), jdet.SpikeDetector(3.0)
    flags = [(t.check(v), j.check(v)) for v in SPIKES]
    assert [a for a, _ in flags] == [b for _, b in flags] == [
        False, False, False, False, True, True, False, True, False]


WINDOWS = [{"loss_mean": 1.0 + 0.01 * i, "grad_norm": 1.0,
            "step_ms": 100.0, "data_wait_ms": 10.0, "step": i}
           for i in range(6)] + [
    {"loss_mean": 50.0, "grad_norm": 1.0, "step_ms": 100.0,
     "data_wait_ms": 10.0, "step": 6},
    {"loss_mean": 1.0, "grad_norm": 40.0, "step_ms": 100.0,
     "data_wait_ms": 90.0, "step": 7},
    {"loss_mean": 1.0, "grad_norm": 1.0, "step_ms": None,
     "data_wait_ms": None, "step": 8}]


def test_window_anomaly_detectors_agree():
    t = tdet.WindowAnomalyDetector(rank=0, spike_factor=5.0,
                                   starvation_frac=0.5)
    j = jdet.WindowAnomalyDetector(rank=0, spike_factor=5.0,
                                   starvation_frac=0.5)
    flags = [(t.check_window(dict(w)), j.check_window(dict(w)))
             for w in WINDOWS]
    assert [a for a, _ in flags] == [b for _, b in flags]
    assert flags[6][0] == ["loss_spike"]
    assert set(flags[7][0]) == {"grad_norm_spike", "data_starvation"}
    assert tdet.COUNTERS.as_dict() == jdet.COUNTERS.as_dict()


SERVE_WINDOWS = [
    dict(queue_depth=0, admitted=4, refusals_delta=0, spec_proposed_delta=0,
         spec_accepted_delta=0, lru_reclaims_delta=0, prefix_hits_delta=4),
    dict(queue_depth=8, admitted=0, refusals_delta=3, spec_proposed_delta=0,
         spec_accepted_delta=0, lru_reclaims_delta=0, prefix_hits_delta=0),
    dict(queue_depth=0, admitted=4, refusals_delta=0, spec_proposed_delta=64,
         spec_accepted_delta=2, lru_reclaims_delta=0, prefix_hits_delta=4),
    dict(queue_depth=0, admitted=4, refusals_delta=0, spec_proposed_delta=0,
         spec_accepted_delta=0, lru_reclaims_delta=20, prefix_hits_delta=1),
    dict(queue_depth=0, admitted=4, refusals_delta=0, spec_proposed_delta=4,
         spec_accepted_delta=0, lru_reclaims_delta=0, prefix_hits_delta=4),
]


def test_serve_anomaly_detectors_agree():
    t, j = tdet.ServeAnomalyDetector(), jdet.ServeAnomalyDetector()
    out = [(t.check_window(**w), j.check_window(**w)) for w in SERVE_WINDOWS]
    assert [a for a, _ in out] == [b for _, b in out]
    assert [bool(a) for a, _ in out] == [False, True, True, True, False]
    assert tdet.SERVE_COUNTERS.as_dict() == jdet.SERVE_COUNTERS.as_dict()


# ------------------------------------------------------------ flight recorder

def test_flight_recorder_ring_bounds_and_dump(tmp_path):
    for mod, name in ((tflightrec, "t"), (jflightrec, "j")):
        r = mod.FlightRecorder(capacity=8, rank=3)
        for i in range(20):
            r.record("boundary", step=i)
        entries = r.tail()
        assert len(entries) == 8
        assert [e["step"] for e in entries] == list(range(12, 20))
        assert "boundary step=19" in r.format_tail(4)
        path = r.dump("test", path=str(tmp_path / f"{name}.json"))
        assert r.dump("test") == path          # idempotent per reason
        payload = mod.load_dump(path)
        assert payload["rank"] == 3 and len(payload["entries"]) == 8
        r.configure(capacity=2)
        assert [e["step"] for e in r.tail()] == [18, 19]
        r.configure(capacity=0)
        r.record("boundary", step=99)
        assert r.tail() == [] and r.dump("off") is None
    t = json.loads((tmp_path / "t.json").read_text())
    j = json.loads((tmp_path / "j.json").read_text())
    assert set(t) == set(j)
    assert t["schema"] == j["schema"] == tflightrec.DUMP_SCHEMA_ID
    assert [{k: e[k] for k in ("seq", "kind", "step")} for e in t["entries"]] \
        == [{k: e[k] for k in ("seq", "kind", "step")} for e in j["entries"]]
    (tmp_path / "foreign.json").write_text(json.dumps({"schema": "x"}))
    for mod in (tflightrec, jflightrec):
        with pytest.raises(ValueError, match="not a flight-recorder dump"):
            mod.load_dump(str(tmp_path / "foreign.json"))


# ------------------------------------------------------------ health

SNAPSHOT = {"resilience/nan_skips": 2, "observability/fleet_windows": 0,
            "step": 12, "healthy": 1, "window_loss": 1.25e-05,
            "window_mfu": 0.4, "fleet_stragglers": 1, "flag": True,
            "name-with.dots": 3.5, "none": None, "inf": math.inf}


def test_prometheus_text_equals_jax():
    for labels in (None, {"rank": 3}, {"rank": 0, "host": "a"}):
        text = thealth.prometheus_text(SNAPSHOT, labels=labels)
        assert text == jhealth.prometheus_text(SNAPSHOT, labels=labels)
        assert thealth.parse_prometheus_text(text) == \
            jhealth.parse_prometheus_text(text)
    with pytest.raises(ValueError):
        thealth.parse_prometheus_text("bad line here\n")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_health_endpoints_on_a_live_engine(tmp_path):
    port = _free_port()
    eng = deepspeed_tpu_torch.initialize(
        model=SimpleModel(hidden_dim=8), device="cpu", config={
            "train_batch_size": 8, "steps_per_print": 10 ** 9,
            "optimizer": {"type": "Adam", "params": {"lr": 0.02}},
            "observability": {"report_window": 2, "health_port": port,
                              "jsonl_path": str(tmp_path / "e.jsonl")}})[0]
    assert eng.telemetry.health.port == port
    rng = np.random.default_rng(0)
    for _ in range(2):
        eng.train_batch((torch.from_numpy(
            rng.normal(size=(8, 8)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 8, size=(8,)))))
    eng.flush_telemetry()
    code, body = _get(port, "/healthz")
    assert code == 200 and json.loads(body)["ok"] is True
    code, body = _get(port, "/status")
    status = json.loads(body)
    assert code == 200 and status["step"] == 2
    assert status["last_window"]["window_steps"] == 2
    code, body = _get(port, "/metrics")
    metrics = thealth.parse_prometheus_text(body)
    assert code == 200 and metrics["dstpu_step"] == 2.0
    assert metrics["dstpu_healthy"] == 1.0
    assert metrics["dstpu_window_window_steps"] == 2.0
    assert _get(port, "/nope")[0] == 404
    # a fired watchdog: alive, not healthy
    wd = Watchdog(timeout_s=0.1, poll_s=0.02)
    with wd.armed("stuck"):
        chaos.chaos_stall(30.0, until=wd.fire_event)
    assert wd.fired
    code, body = _get(port, "/healthz")
    assert code == 503 and json.loads(body)["ok"] is False
    assert thealth.parse_prometheus_text(
        _get(port, "/metrics")[1])["dstpu_healthy"] == 0.0
    eng.telemetry.close()


def test_health_port_resolution(monkeypatch):
    """The config beats DSTPU_HEALTH_PORT; the base is offset by the rank."""
    monkeypatch.delenv(thealth.ENV_HEALTH_PORT, raising=False)
    assert thealth.resolve_health_port(0) is None
    assert thealth.resolve_health_port(9000, rank=2) == 9002
    monkeypatch.setenv(thealth.ENV_HEALTH_PORT, "9100")
    assert thealth.resolve_health_port(0, rank=1) == 9101
    assert thealth.resolve_health_port(9000, rank=0) == 9000
    monkeypatch.setenv(thealth.ENV_HEALTH_PORT, "x")
    assert thealth.resolve_health_port(0) is None


# ------------------------------------------------------ one launch at dp 2

STEPS, ROWS, STALL_AT = 4, 4, 2


def test_fleet_at_dp2_over_gloo(tmp_path):
    """Rank 0's log: a startup, 2 windows and 2 fleet events naming both
    hosts (rank 1's host_ms in the stalled window about 500 ms, flagged);
    rank 1 writes no log; the masters agree; each rank's flight-recorder
    dump holds its 4 boundaries."""
    rng = np.random.default_rng(0)
    inputs = {"x": rng.normal(size=(STEPS, 2 * ROWS, 8)).astype(np.float32),
              "y": rng.integers(0, 8, size=(STEPS, 2 * ROWS)).astype(
                  np.int64)}
    work = tmp_path / "work"
    work.mkdir()
    outs = run_ranks(tmp_path / "ranks", 2, {
        "scenario": "fleet", "work": str(work), "rows": ROWS,
        "steps": STEPS, "stall_at": STALL_AT, "stall_s": 1.0}, inputs)
    assert np.array_equal(outs[0]["master"], outs[1]["master"])
    assert not (work / "events_1.jsonl").exists()
    assert tcli.main([str(work / "events_0.jsonl")]) == 0
    events = [json.loads(line) for line in
              (work / "events_0.jsonl").read_text().splitlines()]
    fleet = [e for e in events if e["schema"] == "dstpu.telemetry.fleet"]
    assert [e["window"] for e in fleet] == [1, 2]
    for e in fleet:
        assert e["reported_hosts"] == e["n_hosts"] == 2
        assert sorted(e["per_host"]) == ["0", "1"]
        assert e["missing_hosts"] == []
    assert [e["stragglers"] for e in fleet] == [[], [1]]
    assert fleet[1]["per_host"]["1"]["host_ms"] > 400.0
    assert float(outs[1]["host_ms"]) > 400.0 > float(outs[0]["host_ms"])
    for r, o in enumerate(outs):
        dump = tflightrec.load_dump(str(o["dump"]))
        assert dump["rank"] == r
        assert [e["step"] for e in dump["entries"]
                if e["kind"] == "boundary"] == list(range(1, STEPS + 1))
        assert os.path.dirname(str(o["dump"])) == str(work)
