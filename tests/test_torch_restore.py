"""The port's parallel streaming restore and its compile cache (the kernel
build directory), after the JAX ``tests/test_checkpoint_restore.py``.

The restore plan (``checkpoint._RestorePlan``, ``_stream_leaves``,
``_place``) must be a pure wall-clock change: a reader pool of
``restore_threads`` with a readahead window, each leaf assembled as its
chunks land, and bitwise the same state as the serial path.  Held here:

* JAX files through the port: a JAX ZeRO-1 save at dp 2 restores in the
  port at dp 2 (gloo ranks; one launch, two loads) with 1 and 4 readers;
  a JAX ZeRO-3 save at dp 2 restores in one process at stage 3 and at
  stage 0 (dp 1, the shards concatenated) with 1 and 4 readers.  The two
  thread counts are bitwise equal, and both equal the JAX engine's own
  load of the same files (tolerance 0: a restore copies bits);
* a truncated chunk raises ``CheckpointReadError`` on both paths; the
  retry budget applies per reader; the readahead window bounds the reads
  in flight (a window under one chunk keeps one read in flight);
* the compile cache with ``subprocess.run`` and ``ctypes.CDLL`` patched in
  ``ops/_build.py``: a cold directory counts misses, a warm one hits and
  no misses; the engine enables it from the config and exports it; the
  launcher exports it to every attempt.
"""

import os
import threading
import types

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch import checkpoint as ck
from deepspeed_tpu_torch import weights
from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.resilience import COUNTERS, chaos
from deepspeed_tpu_torch.utils import compile_cache
from test_torch_zero import (MICRO, TINY, config, init_params, jax_engine,
                             lm_data, rank_inputs)
from test_torch_zero3_train import jax_leaves
from torch_rank_worker import Fp32GPT2
from torch_ranks import run_ranks

GAS = 2


def _restore(cfg, threads, readahead_mb=0.002):
    return dict(cfg, checkpoint={"restore_threads": threads,
                                 "restore_readahead_mb": readahead_mb})


@pytest.fixture(autouse=True)
def _clean():
    chaos.reset()
    yield
    chaos.reset()


# ------------------------------------------------- pooled == serial, JAX files

def test_jax_zero1_dp2_save_pooled_equals_serial(tmp_path):
    """One launch of two gloo ranks loads a JAX ZeRO-1 save at dp 2 twice,
    with 1 and with 4 readers: each rank's partitions, bitwise equal
    between the two, are its slice of the JAX engine's own load."""
    d = str(tmp_path / "ck")
    params = init_params()
    toks, labels = lm_data(2, 2 * GAS * MICRO)
    cfg = config(2, GAS, "bf16", {"stage": 1})
    jeng = jax_engine(cfg, 2, params)
    for i in range(2):
        jeng.train_batch((toks[i], labels[i]))
    jeng.save_checkpoint(d)
    jload = jax_engine(cfg, 2, init_params(9))
    jload.load_checkpoint(d)
    want = {"master": np.asarray(jload.master_flat),
            "m": np.asarray(jload.opt_state.m["flat"]),
            "v": np.asarray(jload.opt_state.v["flat"])}
    outs = run_ranks(tmp_path / "ranks", 2, {"scenario": "train", "runs": [
        {"config": _restore(cfg, 1), "steps": 0, "load": d, "weights": "w2",
         "fp32_compute": True},
        {"config": _restore(cfg, 4), "steps": 0, "load": d, "weights": "w2",
         "fp32_compute": True}]},
        rank_inputs(params, toks, labels, alt=init_params(8)))
    for r, o in enumerate(outs):
        for key in ("master", "m", "v"):
            serial, pooled = o[f"0/{key}"], o[f"1/{key}"]
            assert np.array_equal(serial, pooled), (r, key)
            part = serial.size
            w = want[key][r * part:(r + 1) * part]
            assert np.array_equal(serial[:w.size], w), (r, key)
        assert int(o["0/step"]) == int(o["1/step"]) == 2


@pytest.fixture(scope="module")
def jax_zero3_save(tmp_path_factory):
    """A JAX ZeRO-3 save at dp 2 (shard files per data rank) and the JAX
    engine's own load of it at dp 1."""
    d = str(tmp_path_factory.mktemp("z3") / "ck")
    params = init_params()
    toks, labels = lm_data(2, 16)
    cfg = config(2, 16 // (2 * MICRO), "bf16",
                 {"stage": 3, "overlap_comm": False})
    jeng = jax_engine(cfg, 2, params)
    for i in range(2):
        jeng.train_batch((toks[i], labels[i]))
    jeng.save_checkpoint(d, tag="t")
    jload = jax_engine(config(1, 16 // MICRO, "bf16",
                              {"stage": 3, "overlap_comm": False}), 1,
                       init_params(9))
    jload.load_checkpoint(d, tag="t")
    return d, jax_leaves(jload)


@pytest.mark.parametrize("stage", [3, 0])
def test_jax_zero3_save_pooled_equals_serial_across_topologies(
        jax_zero3_save, stage):
    """The dp 2 ZeRO-3 save at dp 1, stage 3 and stage 0: the shard records
    of each leaf are parts of one LazyParts, read by the pool; 1 and 4
    readers bitwise equal, and equal to the JAX engine's own load."""
    d, want = jax_zero3_save
    zero = {"stage": 3, "overlap_comm": False} if stage else None
    got = {}
    for threads in (1, 4):
        eng = deepspeed_tpu_torch.initialize(
            config=_restore(config(1, 16 // MICRO, "bf16", zero), threads),
            model=Fp32GPT2.from_size("tiny", **TINY),
            model_parameters=init_params(8), device="cpu")[0]
        COUNTERS.restore_seconds = 0.0
        assert eng.load_checkpoint(d, tag="t")[0] is not None
        assert COUNTERS.restore_seconds > 0.0
        got[threads] = {
            "master": {k: t.numpy().copy() for k, t in eng.master.items()},
            "m": {k: t.numpy().copy() for k, t in eng.opt_state.m.items()},
            "v": {k: t.numpy().copy() for k, t in eng.opt_state.v.items()},
            "params": {k: p.detach().float().numpy().copy()
                       for k, p in eng.module.named_parameters()}}
    for key in ("master", "m", "v", "params"):
        for name, x in got[1][key].items():
            assert np.array_equal(x, got[4][key][name]), (key, name)
    for key in ("master", "m", "v"):
        for name, x in want[key].items():
            assert np.array_equal(got[4][key][name], x), (key, name)


def test_load_params_only_pooled_equals_serial(jax_zero3_save):
    d, _ = jax_zero3_save
    a = ck.load_params_only(d, "t", threads=1)[1]
    b = ck.load_params_only(d, "t", threads=4, readahead_mb=1e-4)[1]
    fa, fb = weights.flatten_tree(a), weights.flatten_tree(b)
    assert sorted(fa) == sorted(fb)
    for name in fa:
        assert torch.equal(fa[name], fb[name]), name


# --------------------------------------------------------- failure modes

def _container(path, n=3, elems=4096):
    arrs = [np.arange(i * elems, (i + 1) * elems, dtype=np.float32)
            for i in range(n)]
    ck._write_file(str(path), {"leaves": arrs})
    return arrs, ck._load_obj(str(path))["leaves"]      # memmap views


@pytest.mark.parametrize("threads", [1, 4])
def test_truncated_chunk_raises_named_error(tmp_path, threads):
    """A chunk past the end of its file raises CheckpointReadError on the
    restoring thread: never short data, never a hang."""
    arrs, views = _container(tmp_path / "box.pt")
    with open(tmp_path / "box.pt", "r+b") as f:
        f.truncate(ck._HEADER_PREFIX + arrs[0].nbytes // 2)
    plan = ck._RestorePlan(threads=threads, io_retries=0)
    with pytest.raises(ck.CheckpointReadError, match="truncated"):
        list(ck._stream_leaves([ck.LazyParts.wrap(v) for v in views], plan))


def test_io_retry_budget_applies_per_reader(tmp_path):
    """Each chunk read has the whole io_retries budget: 3 injected failures
    with a budget of 3 succeed however the pool spreads them; with a
    budget of 0 any failure is fatal, as the named error."""
    arrs, views = _container(tmp_path / "box.pt", n=3)
    leaves = [ck.LazyParts.wrap(v) for v in views]
    chaos.configure(io_fail_reads=3)
    before = COUNTERS.io_retries
    out = list(ck._stream_leaves(leaves, ck._RestorePlan(threads=4,
                                                         io_retries=3)))
    chaos.reset()
    for got, want in zip(out, arrs):
        np.testing.assert_array_equal(got.numpy(), want)
    assert COUNTERS.io_retries - before == 3
    chaos.configure(io_fail_reads=100)
    with pytest.raises(ck.CheckpointReadError):
        list(ck._stream_leaves(leaves, ck._RestorePlan(threads=4,
                                                       io_retries=0)))


@pytest.mark.parametrize("readahead_mb,max_inflight", [(1e-6, 1),
                                                        (256.0, 4)])
def test_readahead_window_bounds_inflight(tmp_path, monkeypatch,
                                          readahead_mb, max_inflight):
    """A window smaller than one chunk still makes progress with one read
    in flight at a time, in order; a large one lets the pool fill."""
    arrs, views = _container(tmp_path / "box.pt", n=6)
    live, peak, lock = [0], [0], threading.Lock()
    real = ck._read_part

    def counted(part, pin=False):
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        try:
            threading.Event().wait(0.01)
            return real(part, pin)
        finally:
            with lock:
                live[0] -= 1

    monkeypatch.setattr(ck, "_read_part", counted)
    plan = ck._RestorePlan(threads=4, readahead_mb=readahead_mb,
                           io_retries=0)
    out = list(ck._stream_leaves([ck.LazyParts.wrap(v) for v in views],
                                 plan))
    for got, want in zip(out, arrs):
        np.testing.assert_array_equal(got.numpy(), want)
    assert 1 <= peak[0] <= max_inflight
    if max_inflight == 1:
        assert peak[0] == 1


def test_lazyparts_concat_matches_eager():
    parts = [torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * i
             for i in range(3)]
    lz = ck.LazyParts.concat(parts, 1)
    assert lz.shape == (2, 9)
    assert torch.equal(lz.materialize(), torch.cat(parts, 1))
    assert lz.nbytes == sum(p.numel() * 4 for p in parts)
    # nested composition keeps every chunk an independent part
    lz2 = ck.LazyParts.concat([lz, ck.LazyParts.wrap(parts[0])], 1)
    assert len(lz2.parts) == 4
    assert torch.equal(lz2.materialize(), torch.cat(parts + [parts[0]], 1))


def test_restore_plan_from_engine_config():
    eng = deepspeed_tpu_torch.initialize(
        config=dict(_restore(config(1, 1, "bf16"), 3, 64.0),
                    resilience={"io_retries": 5}),
        model=Fp32GPT2.from_size("tiny", **TINY), device="cpu")[0]
    plan = ck._RestorePlan.from_engine(eng)
    assert (plan.threads, plan.readahead_bytes, plan.io_retries) == (
        3, 64 * 2 ** 20, 5)
    auto = ck._RestorePlan.from_engine(None)
    assert auto.threads == ck._RestorePlan.auto_threads() >= 2


# ------------------------------------------------------------ compile cache

class _FakeLib:
    def __init__(self, path):
        self.path = path
        self.dstt_error_string = types.SimpleNamespace()


def _fake_nvcc(calls):
    def run(cmd, **kwargs):
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"\x7fELF")
        calls.append(out)
        return types.SimpleNamespace(returncode=0, stdout="", stderr="")
    return run


SOURCES = sorted(_build.CSRC.glob("*.cu"))


def test_compile_cache_cold_then_warm(tmp_path, monkeypatch):
    """The three libraries in a cold directory: three nvcc runs, three
    misses; a warm "relaunch" (the libraries not yet loaded in the
    process): three hits, no miss, no nvcc."""
    calls = []
    monkeypatch.setattr(_build.subprocess, "run", _fake_nvcc(calls))
    monkeypatch.setattr(_build.ctypes, "CDLL", _FakeLib)
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    d = str(tmp_path / "cc")
    try:
        assert compile_cache.enable(d) == d
        assert os.environ[compile_cache.ENV_DIR] == d
        h0, m0 = COUNTERS.compile_cache_hits, COUNTERS.compile_cache_misses
        libs = [_build.build_library(s)[0] for s in SOURCES]
        assert len(SOURCES) == 3 and len(calls) == 3
        assert COUNTERS.compile_cache_misses - m0 == 3
        assert COUNTERS.compile_cache_hits == h0
        assert all(os.path.dirname(lib.path) == d for lib in libs)
        h1, m1 = COUNTERS.compile_cache_hits, COUNTERS.compile_cache_misses
        again = [_build.build_library(s)[0] for s in SOURCES]
        assert len(calls) == 3
        assert COUNTERS.compile_cache_hits - h1 == 3
        assert COUNTERS.compile_cache_misses == m1
        assert [a.path for a in again] == [lib.path for lib in libs]
    finally:
        compile_cache.disable()
    assert compile_cache.ENV_DIR not in os.environ
    assert _build.build_dir() == _build.BUILD_DIR


def test_compile_cache_env_fallback(tmp_path, monkeypatch):
    """Without an enabled cache, DSTPU_COMPILE_CACHE_DIR (what the launcher
    exports) is where libraries build and load."""
    monkeypatch.setenv(compile_cache.ENV_DIR, str(tmp_path / "env_cc"))
    assert compile_cache.enabled_dir() is None
    assert _build.build_dir() == tmp_path / "env_cc"
    assert _build.library_path(SOURCES[0]).parent == tmp_path / "env_cc"


def test_compile_cache_engine_wiring(tmp_path):
    """The engine enables the cache from its config (the bare string and
    the object), exports the env fallback for relaunched workers, and a
    config without the block resolves to the exported directory; the
    size floor parses and has no effect."""
    d = str(tmp_path / "cc")
    try:
        for spec in (d, {"dir": d, "min_entry_size_bytes": 4096}):
            eng = deepspeed_tpu_torch.initialize(
                config=dict(config(1, 1, "bf16"), compile_cache=spec),
                model=Fp32GPT2.from_size("tiny", **TINY), device="cpu")[0]
            assert eng.compile_cache_dir == d
            assert os.environ[compile_cache.ENV_DIR] == d
            assert _build.build_dir() == tmp_path / "cc"
        plain = deepspeed_tpu_torch.config.DeepSpeedConfig(config(1, 1))
        assert compile_cache.resolve_dir(plain) == d
    finally:
        compile_cache.disable()


def test_launcher_propagates_compile_cache_dir(tmp_path):
    """``--compile_cache_dir`` reaches the first launch and the relaunch
    alike (the JAX test of the same name)."""
    from deepspeed_tpu_torch.launcher import launch
    from deepspeed_tpu_torch.launcher.run import encode_world_info
    from deepspeed_tpu_torch.resilience import RESUME_EXIT_CODE
    script = tmp_path / "worker.py"
    seen = tmp_path / "seen.txt"
    script.write_text(
        "import os, sys\n"
        f"with open({str(seen)!r}, 'a') as f:\n"
        "    f.write(os.environ.get('DSTPU_COMPILE_CACHE_DIR', 'MISSING')"
        " + '\\n')\n"
        f"lines = open({str(seen)!r}).read().splitlines()\n"
        f"sys.exit(0 if len(lines) >= 2 else {RESUME_EXIT_CODE})\n")
    rc = launch.main([
        f"--world_info={encode_world_info({'localhost': [0]})}",
        "--max_restarts=3", "--restart_backoff=0.01",
        f"--compile_cache_dir={tmp_path / 'cc'}", str(script)])
    assert rc == 0
    assert seen.read_text().splitlines() == [str(tmp_path / "cc")] * 2
