"""The port's observability layer (``deepspeed_tpu_torch/observability/``)
against the JAX package's, after ``tests/test_observability.py``.

* The same tiny GPT-2 (the JAX weights carried across, the forward in fp32
  on both sides, its loss multiplied by ``1 + mean(poison)`` so that a
  batch can carry a NaN) trains 4 steps through the JAX engine and the
  port with ``report_window: 2`` and a JSONL log, in fp32 and in fp16
  with a NaN at step 2.  The window events have the same keys; ``step``,
  ``window_steps`` and ``skipped`` are exact; ``loss``, ``loss_mean``,
  ``grad_norm`` and ``loss_scale`` agree within ``rtol=1e-5`` (the
  engine tests' fp32 tolerance; a NaN equals a NaN); the planner columns
  are null in the port.
* The spool on and off is bitwise (``train_batch``, ``forward`` /
  ``backward`` / ``step``, ``train_many``); in bf16 with the spool on the
  engine takes no counted fence between windows; a preemption drain
  flushes the final partial window.
* Both validator CLIs give the same verdicts on the same good and bad
  files; the registry's TensorBoard tags are the JAX package's; the
  scheduled trace window and the watchdog's hang capture write loadable
  Chrome traces; tensorboard, profile, dump_state and compile_cache no
  longer raise.
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.observability import __main__ as jcli
from deepspeed_tpu.observability import registry as jregistry
from deepspeed_tpu.observability import schema as jschema
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu_torch import resilience
from deepspeed_tpu_torch.models import GPT2
from deepspeed_tpu_torch.observability import __main__ as tcli
from deepspeed_tpu_torch.observability import fences
from deepspeed_tpu_torch.observability import registry as tregistry
from deepspeed_tpu_torch.observability import schema as tschema
from deepspeed_tpu_torch.observability.spool import MetricSpool
from deepspeed_tpu_torch.resilience import COUNTERS, chaos
from test_torch_zero import (MICRO, TINY, Fp32JGPT2, config, init_params,
                             lm_data)
from torch_rank_worker import SimpleModel, _fp32_forward, master_bytes

STEPS, WINDOW, ROWS = 4, 2, 2 * MICRO
#: the engine tests' fp32 tolerance
RTOL = 1e-5


class _ChaosGPT2(GPT2):
    def forward(self, tokens, labels, poison):
        return GPT2.forward(self, tokens, labels) * (
            1.0 + poison.float().mean())


class ChaosGPT2(_ChaosGPT2):
    """GPT-2 in fp32 whatever its parameters' dtype, its loss times ``1 +
    mean(poison)``: exactly the loss for zeros, NaN for a NaN."""

    _upcast = False
    forward = _fp32_forward(_ChaosGPT2)


class JChaosGPT2(Fp32JGPT2):
    """The JAX counterpart of ``ChaosGPT2``."""

    def apply(self, params, tokens, labels, poison):
        return super().apply(params, tokens, labels) * (
            1.0 + jnp.mean(poison.astype(jnp.float32)))


@pytest.fixture(autouse=True)
def _clean():
    chaos.reset()
    COUNTERS.reset()
    yield
    chaos.reset()
    COUNTERS.reset()


def _batches(nan_at=None):
    toks, labels = lm_data(STEPS, ROWS)
    out = []
    for i in range(STEPS):
        poison = np.zeros(ROWS, np.float32)
        if i == nan_at:
            poison[:] = np.nan
        out.append((toks[i], labels[i], poison))
    return out


def _obs_cfg(prec, path, **extra):
    cfg = config(1, 2, prec, observability={"report_window": WINDOW,
                                            "jsonl_path": str(path),
                                            **extra})
    return cfg


def _windows(path):
    with open(path) as f:
        events = [json.loads(line) for line in f if line.strip()]
    return [e for e in events if e["schema"] == tschema.SCHEMA_ID]


@pytest.fixture(scope="module", params=["fp32", "fp16"])
def both(request, tmp_path_factory):
    """The JAX engine's and the port's window events of one run each."""
    prec = request.param
    work = tmp_path_factory.mktemp(f"obs_{prec}")
    bs = _batches(nan_at=1 if prec == "fp16" else None)
    params = init_params()
    jeng, _, _, _ = deepspeed_tpu.initialize(
        config=_obs_cfg(prec, work / "jax.jsonl"),
        model=JChaosGPT2.from_size("tiny", **TINY), model_parameters=params,
        mesh=make_mesh(devices=jax.devices()[:1]))
    for b in bs:
        jeng.train_batch(b)
    jeng.flush_telemetry()
    teng = deepspeed_tpu_torch.initialize(
        config=_obs_cfg(prec, work / "port.jsonl"),
        model=ChaosGPT2.from_size("tiny", **TINY), model_parameters=params,
        device="cpu")[0]
    for b in bs:
        teng.train_batch(tuple(torch.from_numpy(x) for x in b))
    teng.flush_telemetry()
    return {"prec": prec, "jax": _windows(work / "jax.jsonl"),
            "port": _windows(work / "port.jsonl"),
            "skipped": (jeng.skipped_steps, teng.skipped_steps),
            "paths": (work / "jax.jsonl", work / "port.jsonl")}


def test_window_events_match_jax(both):
    jw, tw = both["jax"], both["port"]
    assert len(jw) == len(tw) == STEPS // WINDOW
    for j, t in zip(jw, tw):
        assert set(j) == set(t)
        for k in ("step", "window_steps", "skipped", "schema", "version",
                  "rank"):
            assert j[k] == t[k], k
        for k in ("loss", "loss_mean", "grad_norm", "loss_scale"):
            np.testing.assert_allclose(t[k], j[k], rtol=RTOL, err_msg=k)
        for k in ("predicted_peak_hbm_gb", "predicted_boundary_ms",
                  "predicted_profile", "hbm_drift", "boundary_drift"):
            assert t[k] is None, k
    want_skips = [1, 0] if both["prec"] == "fp16" else [0, 0]
    assert [t["skipped"] for t in tw] == want_skips
    assert both["skipped"] == (sum(want_skips),) * 2


def test_both_validators_accept_both_logs(both):
    for path in both["paths"]:
        assert tcli.main([str(path)]) == jcli.main([str(path)]) == 0


def _verdict_cases(tmp_path, good):
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"schema": tschema.SCHEMA_ID,
                               "version": 1}) + "\n")
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    garbage = tmp_path / "garbage.jsonl"
    garbage.write_text("{not json\n")
    unknown = tmp_path / "unknown.jsonl"
    unknown.write_text(json.dumps({"schema": "dstpu.telemetry.nope",
                                   "version": 1}) + "\n")
    return [good, bad, empty, garbage, unknown, tmp_path / "missing.jsonl"]


def test_validator_clis_agree(both, tmp_path):
    """The JAX test's cases (a good log, a v1 event missing its fields, an
    empty file) and more: both CLIs give the same exit code on each."""
    good = both["paths"][1]
    verdicts = [(tcli.main([str(p)]), jcli.main([str(p)]))
                for p in _verdict_cases(tmp_path, good)]
    assert [t for t, _ in verdicts] == [j for _, j in verdicts] == [
        0, 2, 2, 2, 2, 2]


def test_schema_validators_agree_on_shapes():
    base = {"schema": tschema.SCHEMA_ID, "version": tschema.SCHEMA_VERSION,
            "ts": 1.0, "step": 3, "window_steps": 3, "skipped": 0,
            "counters": {}}
    for name in tschema.FIELDS:
        base.setdefault(name, None)
    cases = [base, {**base, "version": 99}, {**base, "window_steps": 0},
             {**base, "skipped": 5}, {**base, "step": None},
             {**base, "skipped": True}, {**base, "loss": "x"},
             {k: v for k, v in base.items() if k != "host_ms"}]
    got = [tschema.validate_any(c) is None for c in cases]
    assert got == [jschema.validate_any(c) is None for c in cases]
    assert got == [True] + [False] * 7
    assert tschema.FIELDS.keys() == jschema.FIELDS.keys()
    assert tschema.FLEET_FIELDS.keys() == jschema.FLEET_FIELDS.keys()


# ---------------------------------------------------------- trajectory

def _simple(cfg):
    return deepspeed_tpu_torch.initialize(
        model=SimpleModel(hidden_dim=8), config=cfg, device="cpu")[0]


def _simple_cfg(prec="bf16", obs=None, **extra):
    cfg = {"train_batch_size": 8, "gradient_accumulation_steps": 2,
           "steps_per_print": 1,
           "optimizer": {"type": "Adam", "params": {"lr": 0.02}}, **extra}
    if prec == "bf16":
        cfg["bf16"] = {"enabled": True}
    if obs is not None:
        cfg["observability"] = obs
    return cfg


def _xy(i, rows=8):
    rng = np.random.default_rng(100 + i)
    return (torch.from_numpy(rng.normal(size=(rows, 8)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 8, size=(rows,))))


@pytest.mark.parametrize("api", ["train_batch", "split", "train_many"])
def test_spool_is_bitwise_and_fence_free(api, tmp_path):
    """Spool off and on (window 2): the masters bitwise after 4 steps; with
    the spool on, no counted fence in any step (bf16: no skip contract),
    where the spool-off run's throughput timer (steps_per_print=1) waits
    on its report steps."""
    def run(obs):
        extra = {"train_steps_per_dispatch": 2} if api == "train_many" \
            else {}
        eng = _simple(_simple_cfg(obs=obs, **extra))
        per_step = []
        if api == "train_many":
            for k in range(2):
                f0 = fences.FENCE_COUNT
                eng.train_many([_xy(2 * k), _xy(2 * k + 1)])
                per_step.append(fences.FENCE_COUNT - f0)
        for i in range(4 if api != "train_many" else 0):
            f0 = fences.FENCE_COUNT
            if api == "train_batch":
                eng.train_batch(_xy(i))
            else:
                x, y = _xy(i)
                for m in range(2):
                    loss = eng(x[4 * m:4 * m + 4], y[4 * m:4 * m + 4])
                    eng.backward(loss)
                    eng.step()
            per_step.append(fences.FENCE_COUNT - f0)
        eng.flush_telemetry()
        return eng, per_step

    off, off_fences = run(None)
    on, on_fences = run({"report_window": 2,
                         "jsonl_path": str(tmp_path / "e.jsonl")})
    assert master_bytes(on) == master_bytes(off)
    assert on_fences == [0] * len(on_fences)
    if api != "split":         # the split API starts no throughput timer
        assert sum(off_fences) > 0
    windows = _windows(tmp_path / "e.jsonl")
    assert [w["step"] for w in windows] == [2, 4]


def test_fp16_keeps_its_counted_overflow_read(tmp_path, caplog):
    """Under fp16 the boundary reads the skip flag (one counted fence per
    boundary, with the spool on too) and says so once."""
    cfg = dict(_simple_cfg("fp32"), fp16={"enabled": True,
                                          "initial_scale_power": 8},
               observability={"report_window": 2})
    with caplog.at_level(logging.WARNING):
        eng = _simple(cfg)
        deltas = []
        for i in range(2):
            f0 = fences.FENCE_COUNT
            eng.train_batch(_xy(i))
            deltas.append(fences.FENCE_COUNT - f0)
    assert deltas == [1, 1]
    assert sum("overflow read RETAINED" in r.message
               for r in caplog.records) == 1


def test_preemption_drain_flushes_the_partial_window(tmp_path):
    """SIGTERM at step 2 with a window of 4: the drain at step 3 delivers
    the 3-boundary window before the emergency save, and
    ``run_resumable`` dumps the flight recorder (``preempt``)."""
    from deepspeed_tpu_torch.data import ArrayDataset, DeepSpeedDataLoader
    from deepspeed_tpu_torch.observability import flightrec
    path = tmp_path / "e.jsonl"
    cfg = _simple_cfg("fp32", obs={"report_window": 4,
                                   "jsonl_path": str(path),
                                   "flight_recorder_dir": str(tmp_path)})
    cfg["gradient_accumulation_steps"] = 1
    rng = np.random.default_rng(0)
    ds = ArrayDataset(rng.normal(size=(64, 8)).astype(np.float32),
                      rng.integers(0, 8, size=(64,)).astype(np.int32))

    def step(engine, batch):
        engine.train_batch(batch)

    chaos.configure(sigterm_step=2, sigterm_rank=0)
    handler = resilience.PreemptionHandler(
        sentinel_file=str(tmp_path / "nope"))
    with pytest.raises(SystemExit) as ei:
        resilience.run_resumable(lambda: _simple(cfg), step, steps=8,
                                 save_dir=str(tmp_path / "ck"),
                                 data_loader=DeepSpeedDataLoader(
                                     ds, batch_size=8, seed=3),
                                 handler=handler)
    assert ei.value.code == resilience.RESUME_EXIT_CODE
    windows = _windows(path)
    assert [(w["step"], w["window_steps"]) for w in windows] == [(3, 3)]
    dump = flightrec.load_dump(str(tmp_path / "flightrec_rank0_preempt.json"))
    kinds = [e["kind"] for e in dump["entries"]]
    assert kinds[-4:] == ["preempt_agreed", "window", "checkpoint.save",
                          "preempt"]


def test_spool_overrun_guard_and_wrap(caplog):
    """The ring's wrap-safe read and its loud overrun (the JAX test)."""
    got = []
    spool = MetricSpool(4, lambda rows, pos: got.append((rows.copy(), pos)))
    buf = np.arange(16, dtype=np.float32).reshape(4, 4)
    spool._drained = 2
    spool._deliver(buf, 6)          # appends 2..5: rows 2, 3, 0, 1
    assert got[-1][1] == 6
    np.testing.assert_array_equal(got[-1][0], buf[[2, 3, 0, 1]])
    with caplog.at_level(logging.ERROR):
        spool._deliver(buf, 12)     # 6 undelivered in a ring of 4
    assert "overran" in caplog.text
    np.testing.assert_array_equal(got[-1][0], buf[[0, 1, 2, 3]])
    with pytest.raises(ValueError, match="exceed the report window"):
        spool.note_appends(5)
    assert spool.would_straddle(5) and not spool.would_straddle(2)


def test_spool_delivers_every_row_once_in_order_under_contention():
    """Appends on this thread, deliveries on the spool's thread, a switch
    interval of 1 us: every appended row reaches on_window exactly once,
    in append order, in windows of at most the ring's size (the lock and
    the flush's wait for the outstanding drains hold)."""
    import sys
    import threading
    got, lock = [], threading.Lock()

    def on_window(rows, pos):
        with lock:
            got.append((rows[:, 0].copy(), pos))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        spool = MetricSpool(3, on_window)
        for i in range(300):
            spool.append(torch.tensor(float(i)), 0.0, 1.0, False)
        spool.flush()
        assert spool._thread.is_alive()
    finally:
        sys.setswitchinterval(old)
    rows = np.concatenate([r for r, _ in got])
    np.testing.assert_array_equal(rows, np.arange(300, dtype=np.float32))
    assert [pos for _, pos in got] == list(range(3, 301, 3))


# ---------------------------------------------------------- registry tags

class _FakeWriter:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))


def test_registry_tags_equal_jax():
    """The same window, fleet and startup events and the same sources
    give the same TensorBoard tags and values in both packages."""
    window = {"step": 4, "window_steps": 2, "loss": 1.5, "loss_mean": 1.25,
              "grad_norm": 0.5, "loss_scale": 256.0, "skipped": 1,
              "step_ms": 12.0, "samples_per_sec": 100.0, "mfu": 0.25,
              "host_ms": 0.1, "data_wait_ms": None}
    fleet = {"schema": jschema.FLEET_SCHEMA_ID, "step": 4,
             "reported_hosts": 2, "step_ms_median": 12.0,
             "stragglers": [1], "missing_hosts": [], "skipped_total": 1}
    startup = {"schema": jschema.STARTUP_SCHEMA_ID, "step": 0,
               "time_to_first_step_s": 1.5, "restore_seconds": 0.25}
    sources = {"resilience": lambda: {"nan_skips": 2, "io_retries": 1},
               "samples": lambda: {"lr": 0.001}}
    out = []
    for mod in (tregistry, jregistry):
        reg, writer = mod.MetricRegistry(), _FakeWriter()
        reg.add_sink(mod.TensorboardSink(lambda w=writer: w))
        for group, fn in sources.items():
            reg.register(group, fn)
        reg.emit(dict(window), sample_count=32)
        reg.emit_event(dict(fleet), sample_count=32)
        reg.emit_event(dict(startup))
        out.append(writer.scalars)
    assert out[0] == out[1]
    assert ("Train/Resilience/nan_skips", 2.0, 32) in out[0]
    assert ("Train/Samples/lr", 0.001, 32) in out[0]


# ------------------------------------------------------------ tracing

def _load_trace(path):
    with open(path) as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def test_scheduled_trace_window_writes_a_chrome_trace(tmp_path):
    eng = _simple(_simple_cfg("fp32", obs={
        "trace_dir": str(tmp_path / "tr"), "trace_start_step": 1,
        "trace_num_steps": 2}))
    for i in range(4):
        eng.train_batch(_xy(i))
    path = tmp_path / "tr" / "steps_1_3.json"
    names = {str(e.get("name")) for e in _load_trace(path)}
    for span in ("dstpu/train_batch", "dstpu/fwd", "dstpu/bwd",
                 "dstpu/boundary"):
        assert span in names, span
    assert sorted(os.listdir(tmp_path / "tr")) == ["steps_1_3.json"]


def test_watchdog_hang_capture_writes_a_loadable_trace(tmp_path):
    """The watchdog's on_fire hook is the tracer's hang capture: a stall in
    the armed boundary fires it, and the capture is a loadable trace.
    The stall ends as soon as the watchdog fires (no sleep to race)."""
    cfg = _simple_cfg("fp32", obs={"trace_dir": str(tmp_path / "tr"),
                                   "hang_capture_s": 0.05,
                                   "flight_recorder_dir": str(tmp_path)},
                      resilience={"watchdog_timeout_s": 0.3})
    eng = _simple(cfg)
    wd = eng._watchdog
    wd.poll_s = 0.02
    assert wd.on_fire is not None
    eng.train_batch(_xy(0))
    chaos.configure(stall_step=1, stall_s=60.0)
    chaos.add_stall_until(wd.fire_event)
    eng.train_batch(_xy(1))
    assert wd.fired and COUNTERS.watchdog_fires == 1
    assert "recent flight-recorder entries" in wd.last_dump
    hangs = [f for f in os.listdir(tmp_path / "tr") if f.startswith("hang_")]
    deadline = 100
    while not hangs and deadline:       # the hook runs after the event
        import time
        time.sleep(0.05)
        deadline -= 1
        hangs = [f for f in os.listdir(tmp_path / "tr")
                 if f.startswith("hang_")]
    assert len(hangs) == 1
    for _ in range(100):
        try:
            _load_trace(tmp_path / "tr" / hangs[0])
            break
        except ValueError:              # still being written
            import time
            time.sleep(0.05)
    assert isinstance(_load_trace(tmp_path / "tr" / hangs[0]), list)
    assert os.path.exists(tmp_path / "flightrec_rank0_watchdog.json")


# ------------------------------------------ tensorboard, profile, dump_state

def test_item12_configs_train_on_the_cpu(tmp_path, caplog):
    """tensorboard, profile, dump_state, compile_cache and observability
    together: the engine trains, writes its events, its profile trace and
    its state dump (the refusals went with the port of item 12)."""
    from deepspeed_tpu_torch.utils import compile_cache
    cfg = _simple_cfg(
        "fp32",
        obs={"report_window": 2, "jsonl_path": str(tmp_path / "e.jsonl")},
        tensorboard={"enabled": True, "output_path": str(tmp_path / "tb"),
                     "job_name": "job"},
        profile={"enabled": True, "start_step": 1, "end_step": 2,
                 "output_path": str(tmp_path / "prof")},
        dump_state=True, compile_cache={"dir": str(tmp_path / "cc")})
    try:
        with caplog.at_level(logging.INFO):
            eng = _simple(cfg)
            for i in range(3):
                eng.train_batch(_xy(i))
            eng.flush_telemetry()
    finally:
        compile_cache.disable()
    assert "engine state:" in caplog.text
    assert eng.summary_writer is not None
    eng.summary_writer.flush()
    assert os.listdir(tmp_path / "tb" / "job")
    assert isinstance(_load_trace(tmp_path / "prof" / "trace.json"), list)
    assert [w["window_steps"] for w in _windows(tmp_path / "e.jsonl")] == [
        2, 1]
    eng.start_profile(str(tmp_path / "p2"))
    eng.train_batch(_xy(3))
    eng.stop_profile()
    assert isinstance(_load_trace(tmp_path / "p2" / "trace.json"), list)
