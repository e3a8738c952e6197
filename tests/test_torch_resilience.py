"""The port's resilience subsystem (``deepspeed_tpu_torch/resilience/``).

The JAX oracle is ``tests/test_resilience.py``; every case but the three
launcher tests (the port's ``launcher/`` is not ported yet) is ported here
on the port's engine, with the JAX exit codes and counter names: the
SIGTERM and sentinel-file drains with a bitwise resume, periodic saves and
discovery, a half-written tag skipped on resume, the mtime tie-break, the
NaN sentinel on and off (and through ``run_resumable``'s chaos point), IO
retry and an exhausted budget (writes and chunk reads), the watchdog (fire,
near miss, the abort exit code, the engine's armed regions and its stall
injection point), a corrupt ``latest`` falling back, the atomic pointer
and the counters.  Every fault is injected deterministically
(``resilience.chaos``); every resume is held bitwise.
"""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest

import deepspeed_tpu_torch
from deepspeed_tpu_torch import resilience
from deepspeed_tpu_torch.checkpoint import find_latest_valid_tag, validate_tag
from deepspeed_tpu_torch.data import ArrayDataset, DeepSpeedDataLoader
from deepspeed_tpu_torch.resilience import (COUNTERS, PreemptionHandler,
                                            RESUME_EXIT_CODE,
                                            WATCHDOG_EXIT_CODE, Watchdog,
                                            chaos)
from torch_rank_worker import SimpleModel, master_bytes

HIDDEN = 8

ZERO_CFG = {
    "train_batch_size": 8,
    "steps_per_print": 1000,
    "optimizer": {"type": "Adam", "params": {"lr": 0.02}},
    "fp16": {"enabled": True, "loss_scale": 128.0},
    "zero_optimization": True,
}

NAN_CFG = {
    "train_batch_size": 8,
    "steps_per_print": 1000,
    "optimizer": {"type": "Adam", "params": {"lr": 0.02}},
    "resilience": {"nan_sentinel": True},
}


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos.reset()
    COUNTERS.reset()
    yield
    chaos.reset()
    COUNTERS.reset()


def _engine_factory(cfg):
    def factory():
        return deepspeed_tpu_torch.initialize(
            model=SimpleModel(hidden_dim=HIDDEN), config=dict(cfg),
            device="cpu")[0]
    return factory


def _dataset(n=64, seed=0, dtype=np.float16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, HIDDEN)).astype(dtype)
    y = rng.integers(0, HIDDEN, size=(n,)).astype(np.int32)
    return ArrayDataset(x, y)


def _loader(dataset, seed=3):
    return DeepSpeedDataLoader(dataset, batch_size=8, seed=seed)


def _split_step(engine, batch):
    loss = engine(*batch)
    engine.backward(loss)
    engine.step()
    return loss


def _fp32_batch(i):
    rng = np.random.default_rng(100 + i)
    x = rng.normal(size=(8, HIDDEN)).astype(np.float32)
    y = rng.integers(0, HIDDEN, size=(8,)).astype(np.int32)
    return x, y


def _finite(engine):
    return np.isfinite(np.frombuffer(master_bytes(engine), np.float32)).all()


# ------------------------------------------------- preemption + auto-resume

def test_sigterm_drain_and_bitwise_resume(tmpdir):
    """SIGTERM before step 3's work: the drain lands after it (global step
    4) with an emergency tag and RESUME_EXIT_CODE; a fresh engine and
    loader resume and finish bitwise equal to the unbroken run."""
    factory = _engine_factory(ZERO_CFG)
    dataset = _dataset()
    unbroken = resilience.run_resumable(
        factory, _split_step, steps=6,
        save_dir=str(tmpdir.join("unbroken")), data_loader=_loader(dataset))
    ref = master_bytes(unbroken)

    save_dir = str(tmpdir.join("interrupted"))
    handler = PreemptionHandler(sentinel_file=str(tmpdir.join("nope")))
    chaos.configure(sigterm_step=3, sigterm_rank=0)
    try:
        with pytest.raises(SystemExit) as ei:
            resilience.run_resumable(factory, _split_step, steps=6,
                                     save_dir=save_dir,
                                     data_loader=_loader(dataset),
                                     handler=handler)
        assert ei.value.code == RESUME_EXIT_CODE
        tag = find_latest_valid_tag(save_dir)
        assert tag == "emergency/global_step4", tag
        with open(os.path.join(save_dir, "latest")) as f:
            assert f.read().strip() == tag
        handler.clear()
        resumed = resilience.run_resumable(factory, _split_step, steps=6,
                                           save_dir=save_dir,
                                           data_loader=_loader(dataset),
                                           handler=handler)
    finally:
        handler.uninstall()
    assert resumed.global_steps == 6
    assert COUNTERS.preemptions >= 1 and COUNTERS.restarts == 1
    assert COUNTERS.restore_seconds > 0
    assert master_bytes(resumed) == ref


def test_sentinel_file_drain(tmpdir):
    factory = _engine_factory(ZERO_CFG)
    sentinel = str(tmpdir.join("preempt"))
    handler = PreemptionHandler(sentinel_file=sentinel)
    seen = []

    def step_and_touch(engine, batch):
        _split_step(engine, batch)
        seen.append(engine.global_steps)
        if len(seen) == 2:
            open(sentinel, "w").close()

    try:
        with pytest.raises(SystemExit) as ei:
            resilience.run_resumable(factory, step_and_touch, steps=6,
                                     save_dir=str(tmpdir.join("ck")),
                                     data_loader=_loader(_dataset()),
                                     handler=handler)
    finally:
        handler.uninstall()
    assert ei.value.code == RESUME_EXIT_CODE
    assert find_latest_valid_tag(str(tmpdir.join("ck"))) == \
        "emergency/global_step2"


def test_periodic_saves_and_discovery(tmpdir):
    factory = _engine_factory(ZERO_CFG)
    save_dir = str(tmpdir.join("ck"))
    resilience.run_resumable(factory, _split_step, steps=5,
                             save_dir=save_dir,
                             data_loader=_loader(_dataset()),
                             save_interval=2)
    assert validate_tag(save_dir, "global_step2")
    assert validate_tag(save_dir, "global_step4")
    assert find_latest_valid_tag(save_dir) == "global_step4"
    _, client = factory().load_checkpoint(save_dir, tag="global_step4")
    assert client[resilience.DATA_ITER_KEY] == {
        "epoch": 0, "batch": 4, "seed": 3}


def test_resume_skips_half_written_tag(tmpdir):
    """A tag whose model header is durable but whose ZeRO files are gone
    passes discovery; its full load fails, ``restore_latest`` excludes it
    and restores the next-newest (``find_latest_valid_tag(exclude=)``), and
    raises when no candidate restores."""
    factory = _engine_factory(ZERO_CFG)
    save_dir = str(tmpdir.join("ck"))
    resilience.run_resumable(factory, _split_step, steps=3,
                             save_dir=save_dir,
                             data_loader=_loader(_dataset()),
                             save_interval=1)        # global_step1, 2
    for f in glob.glob(os.path.join(save_dir, "global_step2",
                                    "zero_pp_rank_*")):
        os.remove(f)
    assert find_latest_valid_tag(save_dir) == "global_step2"
    assert find_latest_valid_tag(save_dir, exclude=["global_step2"]) == \
        "global_step1"
    engine = factory()
    assert resilience.restore_latest(engine, save_dir,
                                     io_retries=0) == "global_step1"
    assert engine.global_steps == 1
    for f in glob.glob(os.path.join(save_dir, "global_step1",
                                    "zero_pp_rank_*")):
        os.remove(f)
    with pytest.raises(FileNotFoundError):
        resilience.restore_latest(factory(), save_dir, io_retries=0)


def test_discovery_mtime_tie_breaks_numerically(tmpdir):
    engine = _engine_factory(ZERO_CFG)()
    save_dir = str(tmpdir.join("ck"))
    for tag in ("global_step9", "global_step10"):
        engine.save_checkpoint(save_dir, tag=tag)
    for tag in ("global_step9", "global_step10"):
        os.utime(os.path.join(save_dir, tag, "mp_rank_00_model_states.pt"),
                 (1000.0, 1000.0))
    assert find_latest_valid_tag(save_dir) == "global_step10"


# ------------------------------------------------------------- NaN sentinel

def test_nan_sentinel_skips_poisoned_step():
    """fp32 + nan_sentinel: a non-finite batch skips the boundary (the
    master bitwise unchanged, counted) and training goes on finite."""
    engine = _engine_factory(NAN_CFG)()
    _split_step(engine, _fp32_batch(0))
    before = master_bytes(engine)
    _split_step(engine, chaos.poison_batch(_fp32_batch(1)))
    assert engine.overflow is True
    assert engine.skipped_steps == 1
    assert COUNTERS.nan_skips == 1
    assert master_bytes(engine) == before
    loss = _split_step(engine, _fp32_batch(2))
    assert np.isfinite(float(loss)) and _finite(engine)


def test_without_sentinel_nan_poisons_params():
    cfg = {k: v for k, v in NAN_CFG.items() if k != "resilience"}
    engine = _engine_factory(cfg)()
    _split_step(engine, _fp32_batch(0))
    _split_step(engine, chaos.poison_batch(_fp32_batch(1)))
    assert engine.overflow is False
    assert not _finite(engine)


def test_poison_batch_keeps_tensors_on_their_device():
    import torch
    x, y = _fp32_batch(0)
    px, py = chaos.poison_batch((torch.from_numpy(x), torch.from_numpy(y)))
    assert isinstance(px, torch.Tensor) and torch.isnan(px).all()
    assert torch.equal(py, torch.from_numpy(y))


def test_nan_sentinel_via_driver_chaos_point(tmpdir):
    factory = _engine_factory(NAN_CFG)
    chaos.configure(nan_step=2)
    engine = resilience.run_resumable(
        factory, _split_step, steps=4, save_dir=str(tmpdir.join("ck")),
        data_loader=_loader(_dataset(dtype=np.float32)))
    assert engine.global_steps == 4
    assert engine.skipped_steps == 1 and COUNTERS.nan_skips == 1
    assert _finite(engine)


# ------------------------------------------------------------ storage retry

def test_io_error_on_save_retries_then_succeeds(tmpdir):
    engine = _engine_factory(ZERO_CFG)()
    _split_step(engine, _fp32_batch(0))
    chaos.configure(io_fail_writes=2)
    save_dir = str(tmpdir.join("ck"))
    resilience.save_with_retry(engine, save_dir, tag="t0")   # io_retries=3
    assert COUNTERS.io_retries == 2
    assert validate_tag(save_dir, "t0")
    path, _ = _engine_factory(ZERO_CFG)().load_checkpoint(save_dir, tag="t0")
    assert path is not None


def test_io_retry_budget_exhausted_raises(tmpdir):
    engine = _engine_factory(ZERO_CFG)()
    chaos.configure(io_fail_writes=10)
    with pytest.raises(IOError, match="chaos: injected IO failure"):
        resilience.save_with_retry(engine, str(tmpdir.join("ck")), tag="t0",
                                   io_retries=2)
    assert COUNTERS.io_retries == 2


def test_io_error_on_chunk_read_retries(tmpdir):
    """The chunk reads of a restore go through the chaos read point and
    ``io_retry`` with ``resilience.io_retries``: two injected failures
    retry and the restore is bitwise; with a budget of 0 the failure
    surfaces as the restore's named ``CheckpointReadError``."""
    engine = _engine_factory(ZERO_CFG)()
    _split_step(engine, _fp32_batch(0))
    save_dir = str(tmpdir.join("ck"))
    engine.save_checkpoint(save_dir, tag="t0")
    chaos.configure(io_fail_reads=2)
    fresh = _engine_factory(ZERO_CFG)()
    fresh.load_checkpoint(save_dir, tag="t0")
    assert COUNTERS.io_retries == 2
    assert master_bytes(fresh) == master_bytes(engine)
    chaos.configure(io_fail_reads=1)
    strict = _engine_factory(dict(ZERO_CFG,
                                  resilience={"io_retries": 0}))()
    with pytest.raises(deepspeed_tpu_torch.checkpoint.CheckpointReadError,
                       match="injected IO read failure"):
        strict.load_checkpoint(save_dir, tag="t0")
    # the budget is the loading engine's: a read without an engine keeps
    # the default, whichever engine loaded last
    chaos.configure(io_fail_reads=1)
    assert deepspeed_tpu_torch.checkpoint.load_module_tree(
        save_dir, tag="t0") is not None
    assert COUNTERS.io_retries == 3


# ------------------------------------------------------------ hang watchdog

def test_watchdog_fires_and_names_stuck_frame():
    wd = Watchdog(timeout_s=0.3, abort=False, poll_s=0.05)
    with wd.armed("warmup step"):
        pass
    with wd.armed("stalled collective"):
        chaos.chaos_stall(30.0, until=wd.fire_event)
    assert wd.fired
    assert COUNTERS.watchdog_fires == 1
    assert "chaos_stall" in wd.last_dump
    assert "stalled collective" in wd.last_dump
    assert "warmup step" in wd.last_dump


def test_watchdog_near_miss_counter():
    wd = Watchdog(timeout_s=5.0, abort=False, near_miss_frac=0.02,
                  poll_s=0.05)
    with wd.armed("slowish step"):
        chaos.chaos_stall(0.2)
    assert not wd.fired
    assert COUNTERS.watchdog_near_misses == 1


def test_watchdog_abort_exit_code(tmpdir):
    """watchdog_abort: past the deadline the process exits with
    WATCHDOG_EXIT_CODE after the dump (the port imports no jax)."""
    script = tmpdir.join("stall.py")
    script.write(
        "from deepspeed_tpu_torch.resilience import Watchdog, chaos\n"
        "wd = Watchdog(timeout_s=0.3, abort=True, poll_s=0.05)\n"
        "with wd.armed('stuck step'):\n"
        "    chaos.chaos_stall(60.0)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, str(script)], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == WATCHDOG_EXIT_CODE, (proc.returncode,
                                                   proc.stderr)
    assert "chaos_stall" in proc.stderr
    assert "stuck step" in proc.stderr


def test_engine_stall_injection_fires_watchdog():
    """The config-keyed stall lands inside the engine's armed boundary:
    the watchdog fires and its dump names the stuck frame and the armed
    label (the JAX test's flight-recorder half waits for the port's
    observability)."""
    cfg = dict(NAN_CFG, resilience={"watchdog_timeout_s": 0.3})
    engine = _engine_factory(cfg)()
    engine._watchdog.poll_s = 0.05
    chaos.configure(stall_step=1, stall_s=1.5)
    _split_step(engine, _fp32_batch(0))      # boundary: global step 0 -> 1
    _split_step(engine, _fp32_batch(1))      # stalls at global step 1
    wd = engine._watchdog
    assert wd.fired
    assert "chaos_stall" in wd.last_dump
    assert "optimizer boundary step" in wd.last_dump
    assert COUNTERS.watchdog_fires >= 1


def test_engine_arms_watchdog_from_config():
    cfg = dict(NAN_CFG, resilience={"watchdog_timeout_s": 120.0})
    engine = _engine_factory(cfg)()
    assert engine._watchdog is not None
    _split_step(engine, _fp32_batch(0))
    labels = [lbl for lbl, _ in engine._watchdog.timings]
    assert "backward (fused fwd+bwd)" in labels
    assert "optimizer boundary step" in labels
    engine.train_batch(_fp32_batch(1))
    assert engine._watchdog.timings[-1][0] == "train_batch"


# --------------------------------------------- latest pointer + discovery

def test_corrupt_latest_falls_back_to_newest_valid_tag(tmpdir):
    engine = _engine_factory(ZERO_CFG)()
    _split_step(engine, _fp32_batch(0))
    save_dir = str(tmpdir.join("ck"))
    engine.save_checkpoint(save_dir, tag="older")
    _split_step(engine, _fp32_batch(1))
    engine.save_checkpoint(save_dir, tag="newer")
    for i, tag in enumerate(("older", "newer")):
        d = os.path.join(save_dir, tag)
        for f in os.listdir(d):
            os.utime(os.path.join(d, f), (1000 + i, 1000 + i))
    with open(os.path.join(save_dir, "latest"), "w"):
        pass
    path, _ = _engine_factory(ZERO_CFG)().load_checkpoint(save_dir)
    assert path is not None and path.endswith("newer"), path
    with open(os.path.join(save_dir, "latest"), "w") as f:
        f.write("gone_tag")
    path, _ = _engine_factory(ZERO_CFG)().load_checkpoint(save_dir)
    assert path is not None and path.endswith("newer"), path
    mfile = os.path.join(save_dir, "newer", "mp_rank_00_model_states.pt")
    with open(mfile, "wb") as f:
        f.write(b"DSTPUCK1garbage")
    assert not validate_tag(save_dir, "newer")
    assert find_latest_valid_tag(save_dir) == "older"
    import shutil
    shutil.rmtree(os.path.join(save_dir, "older"))
    path, client = _engine_factory(ZERO_CFG)().load_checkpoint(save_dir)
    assert path is None and client is None


def test_latest_pointer_written_atomically(tmpdir):
    engine = _engine_factory(ZERO_CFG)()
    _split_step(engine, _fp32_batch(0))
    save_dir = str(tmpdir.join("ck"))
    engine.save_checkpoint(save_dir, tag="t0")
    assert not os.path.exists(os.path.join(save_dir, "latest.tmp"))
    with open(os.path.join(save_dir, "latest")) as f:
        assert f.read() == "t0"


# ----------------------------------------------------------- the contract

def test_counters_and_exit_codes_match_jax():
    """The engine exports the JAX counter names; the exit codes, the
    restartable set and the agreement collective's single-process form
    are the JAX package's."""
    from deepspeed_tpu import resilience as jres
    engine = _engine_factory(NAN_CFG)()
    _split_step(engine, _fp32_batch(0))
    got = engine.resilience_counters()
    assert set(got) == set(jres.COUNTERS.as_dict()) == {
        "restarts", "preemptions", "nan_skips", "io_retries",
        "watchdog_near_misses", "watchdog_fires", "restore_seconds",
        "compile_cache_hits", "compile_cache_misses"}
    # no restore yet; no kernel library loaded or built on the CPU
    assert got["restore_seconds"] == 0.0
    assert got["compile_cache_hits"] == got["compile_cache_misses"] == 0
    _split_step(engine, chaos.poison_batch(_fp32_batch(1)))
    assert engine.resilience_counters()["nan_skips"] == 1
    assert (RESUME_EXIT_CODE, WATCHDOG_EXIT_CODE) == (
        jres.RESUME_EXIT_CODE, jres.WATCHDOG_EXIT_CODE)
    assert resilience.RESTARTABLE_EXIT_CODES == jres.RESTARTABLE_EXIT_CODES
    assert resilience.agree_any(True) is True
    assert resilience.agree_any(False) is False
