"""The port's host-concurrency analysis against the JAX package's.

``deepspeed_tpu_torch.analysis`` (``concurrency``, ``lockwatch``,
``report``) is a copy of the JAX package's pure-Python modules that reads
the port's own control plane:

* every seeded source of the JAX package's
  ``tests/test_concurrency_lint.py`` gives the same findings (code,
  severity, site, path) through both lints, and the case's own verdict;
* the port's blocking catalogue names the port's device fences
  (``torch.cuda.synchronize``, ``.item()``, ``.cpu()``, the counted reads)
  where the JAX one names ``block_until_ready``;
* the port's control plane (router, the engine's command lock and
  follower threads, scheduler, page pool, observability, resilience)
  lints clean, its static model holds the real locks and the
  thread-role contracts, and ``python -m deepspeed_tpu_torch.analysis``
  gives the JAX CLI's exit codes;
* lockwatch: plain locks when disarmed, order edges, counters and
  flight-recorder breadcrumbs when armed, the merge with the static graph,
  and the page pool under concurrent threads.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from deepspeed_tpu.analysis import concurrency as jconc
from deepspeed_tpu_torch import analysis
from deepspeed_tpu_torch.analysis import concurrency as conc
from deepspeed_tpu_torch.analysis import lockwatch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

INVERSION = """\
import threading

class Pair:
    def __init__(self):
        self._lock_a = threading.Lock()
        self._lock_b = threading.Lock()

    def forward(self):
        with self._lock_a:
            with self._lock_b:
                return 1

    def backward(self):
        with self._lock_b:
            with self._lock_a:
                return 2
"""

SELF_DEADLOCK = """\
import threading

class Once:
    def __init__(self):
        self._lock = threading.Lock()

    def outer(self):
        with self._lock:
            return self.inner()

    def inner(self):
        with self._lock:
            return 1
"""

HTTP_UNDER_LOCK = """\
import threading
import urllib.request

class Router:
    def __init__(self):
        self._lock = threading.Lock()
        self.replicas = []

    def pick(self):
        with self._lock:
            for rep in self.replicas:
                urllib.request.urlopen(rep, timeout=2.0)
            return self.replicas[0] if self.replicas else None
"""

HTTP_OUTSIDE = """\
import threading
import urllib.request

class Router:
    def __init__(self):
        self._lock = threading.Lock()
        self.replicas = []

    def pick(self):
        with self._lock:
            reps = list(self.replicas)
        for rep in reps:
            urllib.request.urlopen(rep, timeout=2.0)
        return reps[0] if reps else None
"""

RESOLVED_CALL = """\
import threading
import time

class Slow:
    def __init__(self):
        self._lock = threading.Lock()

    def nap_helper(self):
        time.sleep(1.0)

    def tick(self):
        with self._lock:
            self.nap_helper()
"""

UNLOCKED_WRITE = """\
import threading

class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self.total = 0

    def add(self, n):
        with self._lock:
            self.total += n

    def reset_fast(self):
        self.total = 0
"""

HOLDS = """\
import threading

class R:
    def __init__(self):
        self._lock = threading.Lock()
        self.m = {}

    # dstpu-thread: admission holds=R._lock
    def pick(self):
        self.m["k"] = 1
        return 1

    def good(self):
        with self._lock:
            return self.pick()

    def bad(self):
        return self.pick()
"""

ENQUEUE_ONLY = """\
import threading
import time

class Agg:
    def __init__(self):
        self._lock = threading.Lock()

    # dstpu-thread: drain-callback enqueue-only
    def publish(self, item):
        with self._lock:
            time.sleep(0.1)
"""

OWNER_BAD = """\
import threading

class R:
    def __init__(self):
        self._lock = threading.Lock()
        self.flights = {}

    # dstpu-thread: driver-callback owner-check=owner
    def complete(self, replica, rid):
        with self._lock:
            del self.flights[rid]
"""

OWNER_OK = """\
import threading

class R:
    def __init__(self):
        self._lock = threading.Lock()
        self.flights = {}

    # dstpu-thread: driver-callback owner-check=owner
    def complete(self, replica, rid):
        with self._lock:
            f = self.flights.get(rid)
            if f is None or f.owner is not replica:
                return
            del self.flights[rid]
"""

DANGLING = """\
import threading

X = 1
# dstpu-thread: orphan-role enqueue-only
Y = 2
"""

#: name -> (source, the codes of its error findings, of its warnings)
CASES = {
    "inversion": (INVERSION, {"concurrency.lock-order"}, set()),
    "inversion-fixed": (INVERSION.replace(
        "        with self._lock_b:\n            with self._lock_a:",
        "        with self._lock_a:\n            with self._lock_b:"),
        set(), set()),
    "self-deadlock": (SELF_DEADLOCK, {"concurrency.lock-order"}, set()),
    "rlock": (SELF_DEADLOCK.replace("threading.Lock()",
                                    "threading.RLock()"), set(), set()),
    "http-under-lock": (HTTP_UNDER_LOCK,
                        {"concurrency.blocking-under-lock"}, set()),
    "http-outside-lock": (HTTP_OUTSIDE, set(), set()),
    "resolved-call": (RESOLVED_CALL, {"concurrency.blocking-under-lock"},
                      set()),
    "allow-blocking": (HTTP_UNDER_LOCK.replace(
        "                urllib.request.urlopen(rep, timeout=2.0)",
        "                urllib.request.urlopen(rep, timeout=2.0)"
        "  # dstpu-lock: allow-blocking(test fixture)"), set(), set()),
    "unlocked-write": (UNLOCKED_WRITE,
                       {"concurrency.unlocked-guarded-write"}, set()),
    "guarded-write-fixed": (UNLOCKED_WRITE.replace(
        "    def reset_fast(self):\n        self.total = 0",
        "    def reset_fast(self):\n        with self._lock:\n"
        "            self.total = 0"), set(), set()),
    "init-exempt": (UNLOCKED_WRITE.replace(
        "    def reset_fast(self):",
        "    # dstpu-thread: construction init\n    def reset_fast(self):"),
        set(), set()),
    "holds": (HOLDS, {"concurrency.lock-contract"}, set()),
    "enqueue-only": (ENQUEUE_ONLY, {"concurrency.thread-role",
                                    "concurrency.blocking-under-lock"},
                     set()),
    "owner-check": (OWNER_BAD, {"concurrency.thread-role"}, set()),
    "owner-check-ok": (OWNER_OK, set(), set()),
    "dangling": (DANGLING, set(), {"concurrency.annotation"}),
}


def _key(rep):
    return sorted((f.code, f.severity, f.source, f.path) for f in rep)


@pytest.fixture(autouse=True)
def _lockwatch_clean():
    lockwatch.instrument(False)
    lockwatch.reset()
    lockwatch.configure(wait_warn_ms=lockwatch.DEFAULT_WAIT_WARN_MS,
                        hold_warn_ms=lockwatch.DEFAULT_HOLD_WARN_MS)
    yield
    lockwatch.instrument(False)
    lockwatch.reset()
    lockwatch.configure(wait_warn_ms=lockwatch.DEFAULT_WAIT_WARN_MS,
                        hold_warn_ms=lockwatch.DEFAULT_HOLD_WARN_MS)


@pytest.mark.parametrize("case", sorted(CASES))
def test_seeded_sources_give_the_jax_findings(tmp_path, case):
    source, errors, warnings = CASES[case]
    path = tmp_path / "mod_under_test.py"
    path.write_text(source)
    mine = conc.check_paths([str(path)])
    theirs = jconc.check_paths([str(path)])
    assert _key(mine) == _key(theirs), (mine.format("info"),
                                        theirs.format("info"))
    assert {f.code for f in mine.errors} == errors, mine.format("info")
    assert {f.code for f in mine.warnings} == warnings
    if case == "http-under-lock":
        err = mine.errors[0]
        assert "Router._lock" in err.message
        assert err.source.startswith(f"{path}:12"), err.source
    if case == "allow-blocking":
        assert any(f.code == "concurrency.allowed-blocking"
                   for f in mine.infos)
    if case == "holds":
        assert "R.bad" in mine.errors[0].source


FENCES = """\
import threading

import torch

from deepspeed_tpu_torch.observability import fences


class Drainer:
    def __init__(self):
        self._lock = threading.Lock()

    def sync(self):
        with self._lock:
            torch.cuda.synchronize()

    def scalar(self, x):
        with self._lock:
            return x.item()

    def host(self, x):
        with self._lock:
            return x.cpu()

    def counted(self, x):
        with self._lock:
            return fences.read_arrays(x)

    def outside(self, x):
        with self._lock:
            y = x
        return y.item()
"""


def test_the_port_catalogue_names_the_device_fences(tmp_path):
    """Where the JAX lint names ``block_until_ready`` and ``device_get``,
    the port's names its own fences: each under a lock is an error, and
    the same read after the lock is clean."""
    path = tmp_path / "fences_under_lock.py"
    path.write_text(FENCES)
    rep = conc.check_paths([str(path)])
    errs = [f for f in rep.errors
            if f.code == "concurrency.blocking-under-lock"]
    sites = sorted(f.source.split(" ")[1] for f in errs)
    assert sites == ["(Drainer.counted)", "(Drainer.host)",
                     "(Drainer.scalar)", "(Drainer.sync)"], \
        rep.format("info")
    assert all("Drainer._lock" in f.message for f in errs)


def test_shipped_control_plane_has_zero_findings():
    rep = conc.check_paths()
    assert not rep.errors and not rep.warnings, rep.format("warning")
    paths = conc.control_plane_paths()
    assert len(paths) == len(conc.CONTROL_PLANE) == 16
    assert all(os.path.isfile(p) and os.sep + "deepspeed_tpu_torch" + os.sep
               in p for p in paths)


def test_static_model_covers_the_real_locks():
    model, rep = conc.analyze_paths(conc.control_plane_paths())
    for expected in ("FleetRouter._lock", "PagePool._lock",
                     "MetricRegistry._lock", "FleetAggregator._lock",
                     "Watchdog._lock", "FlightRecorder._lock",
                     "InferenceEngine._command"):
        assert expected in model.locks, sorted(model.locks)
    assert model.locks["PagePool._lock"].reentrant
    assert not model.locks["InferenceEngine._command"].reentrant
    for role in ("router.FleetRouter._complete", "router.FleetRouter._pick",
                 "router.FleetRouter._handoff",
                 "fleet.FleetAggregator.publish",
                 "kvcache.PagePool._take_page",
                 "kvcache.PagePool._init_state",
                 "engine.InferenceEngine._run", "engine.InferenceEngine.close",
                 "engine._follow"):
        assert role in model.roles, sorted(model.roles)
    # the JAX control plane's static order graph, edge for edge
    jmodel, _ = jconc.analyze_paths(jconc.control_plane_paths())
    assert set(model.edges) == set(jmodel.edges)


def test_error_mode_raises_concurrency_lint_error(tmp_path):
    path = tmp_path / "m.py"
    path.write_text(INVERSION)
    rep = conc.check_paths([str(path)])
    with pytest.raises(analysis.ConcurrencyLintError) as ei:
        analysis.dispatch_report(rep, "error", where="test",
                                 error_cls=conc.ConcurrencyLintError)
    assert "concurrency.lock-order" in str(ei.value)
    analysis.dispatch_report(rep, "warn", where="test",
                             error_cls=conc.ConcurrencyLintError)
    rep = conc.check_paths([str(path)], suppress=["concurrency.lock-order"])
    assert not rep.errors and rep.suppressed_count >= 1


def test_router_build_runs_the_gate(monkeypatch):
    """``analysis.concurrency`` in the config lints the control plane at
    FleetRouter build: the engines accept the knob now."""
    calls = []
    monkeypatch.setattr(conc, "check_control_plane",
                        lambda mode, suppress, where: calls.append(
                            (mode, tuple(suppress), where)))
    from deepspeed_tpu_torch.inference import FleetRouter, InferenceEngine
    from deepspeed_tpu_torch.models import GPT2
    eng = InferenceEngine(
        GPT2.from_size("tiny", device="meta", vocab_size=128, max_seq_len=64,
                       num_layers=1, hidden_size=64, num_heads=4),
        config={"inference": {"max_slots": 2, "max_tokens": 32,
                              "prefill_bucket": 16, "dtype": "float32"},
                "analysis": {"concurrency": {
                    "mode": "error", "suppress": ["concurrency.x"]}}},
        device="cpu")
    FleetRouter([eng], poll_s=0.05).close()
    assert calls == [("error", ("concurrency.x",), "FleetRouter")]


@pytest.mark.parametrize("args,rc", [
    (["--concurrency", "--mode", "error"], 0),
    (["--concurrency", "--mode", "error", "--json", "--concurrency-path",
      "SEEDED"], 2),
    (["--concurrency", "--concurrency-path", "SEEDED"], 0),
    (["examples/gpt2/ds_config_serve.json"], 1),
    (["--concurrency", "--plan"], 1),
    ([], 1),
])
def test_cli_exit_codes(tmp_path, args, rc):
    seeded = tmp_path / "seeded.py"
    seeded.write_text(HTTP_UNDER_LOCK)
    args = [str(seeded) if a == "SEEDED" else a for a in args]
    out = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.analysis", *args],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode == rc, out.stdout + out.stderr
    if "--json" in args:
        doc = json.loads(out.stdout.strip().splitlines()[-1])
        assert doc["subject"] == "concurrency" and doc["errors"] >= 1
        assert "concurrency.blocking-under-lock" in {
            f["code"] for f in doc["findings"]}
    if rc == 1 and args:
        # a config on a host without a card needs --device cpu; --plan
        # needs a config (the config modes are ported: Queue 1 item 14)
        assert ("--device cpu" in out.stderr
                or "--plan needs a config" in out.stderr)


# --------------------------------------------------------------- lockwatch
def test_named_lock_plain_when_disarmed():
    lk = lockwatch.named_lock("T._lock")
    assert not isinstance(lk, lockwatch.InstrumentedLock)
    with lk:
        pass


def test_instrumented_lock_records_stats_and_edges():
    lockwatch.instrument(True)
    a = lockwatch.named_lock("T._a")
    b = lockwatch.named_lock("T._b")
    assert isinstance(a, lockwatch.InstrumentedLock)
    with a:
        with b:
            pass
    with a:
        pass
    snap = lockwatch.snapshot()
    assert snap["T._a"]["acquisitions"] == 2
    assert snap["T._b"]["acquisitions"] == 1
    assert ("T._a", "T._b") in lockwatch.observed_edges()
    assert ("T._b", "T._a") not in lockwatch.observed_edges()
    counters = lockwatch.counters()
    assert counters["lock_acquisitions.T._a"] == 2
    assert "lock_wait_ms.T._b" in counters
    assert "lock_held_ms.T._a" in counters


def test_instrumented_rlock_reentry_counts_once():
    lockwatch.instrument(True)
    lk = lockwatch.named_lock("T._r", rlock=True)
    with lk:
        with lk:
            assert lk.locked()
    assert not lk.locked()
    assert lockwatch.snapshot()["T._r"]["acquisitions"] == 1
    assert ("T._r", "T._r") not in lockwatch.observed_edges()


def test_contended_wait_leaves_a_flight_recorder_breadcrumb():
    from deepspeed_tpu_torch.observability.flightrec import RECORDER
    lockwatch.instrument(True)
    lockwatch.configure(wait_warn_ms=1.0, hold_warn_ms=10_000.0)
    lk = lockwatch.named_lock("T._contended")
    entered, release = threading.Event(), threading.Event()

    def holder():
        with lk:
            entered.set()
            release.wait(timeout=5)

    t = threading.Thread(target=holder, daemon=True)
    t.start()
    assert entered.wait(timeout=5)
    waiter_done = threading.Event()

    def waiter():
        threading.Timer(0.05, release.set).start()
        with lk:
            pass
        waiter_done.set()

    w = threading.Thread(target=waiter, daemon=True, name="t-waiter")
    w.start()
    assert waiter_done.wait(timeout=5)
    t.join(timeout=5)
    assert not t.is_alive()
    rows = [r for r in RECORDER.tail(64) if r.get("kind") == "lock_wait"
            and r.get("lock") == "T._contended"]
    assert rows and rows[-1]["waiter"] == "t-waiter"
    assert rows[-1]["wait_ms"] >= 1.0
    assert lockwatch.snapshot()["T._contended"]["contentions"] >= 1


def test_long_hold_leaves_a_lock_held_breadcrumb():
    from deepspeed_tpu_torch.observability.flightrec import RECORDER
    lockwatch.instrument(True)
    lockwatch.configure(wait_warn_ms=10_000.0, hold_warn_ms=0.0)
    lk = lockwatch.named_lock("T._held")
    with lk:
        pass
    rows = [r for r in RECORDER.tail(64) if r.get("kind") == "lock_held"
            and r.get("lock") == "T._held"]
    assert rows and rows[-1]["held_ms"] >= 0.0


def test_register_metrics_exports_through_the_registry():
    from deepspeed_tpu_torch.observability.registry import MetricRegistry
    lockwatch.instrument(True)
    lk = lockwatch.named_lock("T._m")
    with lk:
        pass
    reg = MetricRegistry()
    lockwatch.register_metrics(reg)
    assert reg.collect()["lockwatch"]["lock_acquisitions.T._m"] == 1


def test_merge_observed_flags_a_runtime_only_inversion():
    model, _ = conc.analyze_paths(conc.control_plane_paths())
    assert not conc.merge_observed(model, set()).errors
    assert not conc.merge_observed(
        model, {("MetricSpool._lock", "MetricRegistry._lock")}).errors
    rep = conc.merge_observed(
        model, {("MetricRegistry._lock", "MetricSpool._lock")})
    errs = [f for f in rep.errors if f.code == "concurrency.lock-order"]
    assert errs and "observed at runtime" in errs[0].message


def test_pagepool_refcount_integrity_under_concurrency():
    """Concurrent admit / publish / prepare_write / release on one pool
    with lockwatch armed: the refcounts sum exactly, the free list never
    holds a page twice, and the observed order edges merge clean."""
    from deepspeed_tpu_torch.inference.kvcache import KVCacheSpec, PagePool
    lockwatch.instrument(True)
    spec = KVCacheSpec(layers=1, slots=8, capacity=64, kv_heads_local=1,
                       head_dim=8, page_tokens=8, pool_pages=48)
    pool = PagePool(spec)
    assert isinstance(pool._lock, lockwatch.InstrumentedLock)
    stop = threading.Event()
    failures = []

    def worker(slot, seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(120):
                prompt = [int(x) for x in
                          rng.integers(0, 4, rng.integers(8, 33))]
                grant = pool.admit(slot, prompt, int(rng.integers(0, 16)))
                if grant is None:
                    continue
                if rng.random() < 0.5:
                    pool.publish(grant)
                pool.prepare_write(slot, range(len(prompt),
                                               len(prompt) + 4))
                pool.release(slot)
        except Exception as e:  # pragma: no cover - the failure signal
            failures.append(e)

    def reader():
        while not stop.is_set():
            assert pool.gauges()["free_pages"] >= 0
            pool.rows()

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(s, 100 + s),
                                    daemon=True) for s in range(spec.slots)]
        r = threading.Thread(target=reader, daemon=True)
        r.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stop.set()
        r.join(timeout=10)
    finally:
        sys.setswitchinterval(prev)
    assert not failures, failures
    assert not any(t.is_alive() for t in threads) and not r.is_alive()
    counts = np.zeros_like(pool._ref)
    for alloc in pool._alloc:
        for page in alloc:
            counts[page] += 1
    assert np.array_equal(pool._ref, counts) and int(pool._ref.sum()) == 0
    assert len(set(pool._free)) == len(pool._free)
    assert not (set(pool._free) & set(pool._lru))
    assert len(pool._free) + len(pool._lru) == spec.num_pages
    assert lockwatch.snapshot()["PagePool._lock"]["acquisitions"] > 0
    model, _ = conc.analyze_paths(conc.control_plane_paths())
    assert not conc.merge_observed(model,
                                   lockwatch.observed_edges()).errors


def test_telemetry_registers_lockwatch_counters_when_armed():
    """The training telemetry's registry carries lockwatch's counters once
    the sanitizer is armed (the JAX ``Telemetry.__init__``)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import GPT2
    lockwatch.instrument(True)
    lk = lockwatch.named_lock("T._tel")
    with lk:
        pass
    model = GPT2.from_size("tiny", vocab_size=64, max_seq_len=16,
                           num_layers=1, hidden_size=32, num_heads=2)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, device="cpu",
        config={"train_batch_size": 2,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                "observability": {"report_window": 2}})
    snap = engine._telemetry.registry.collect()
    assert snap["lockwatch"]["lock_acquisitions.T._tel"] == 1


def test_pagepool_reset_preserves_the_lock():
    from deepspeed_tpu_torch.inference.kvcache import KVCacheSpec, PagePool
    spec = KVCacheSpec(layers=1, slots=2, capacity=32, kv_heads_local=1,
                       head_dim=8, page_tokens=8)
    pool = PagePool(spec)
    lock_before = pool._lock
    assert pool.admit(0, [1, 2, 3, 4, 5, 6, 7, 8, 9], 4) is not None
    pool.reset()
    assert pool._lock is lock_before
    assert len(pool._free) == spec.num_pages
    assert pool.admit(0, [1, 2, 3, 4, 5, 6, 7, 8, 9], 4) is not None
