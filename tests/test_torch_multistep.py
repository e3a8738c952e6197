"""``engine.train_many`` and ``data.BlockPrefetcher`` of the port.

The JAX oracle is ``tests/test_multistep.py``: K steps through
``train_many`` are BITWISE equal to K ``train_batch`` calls (the masters,
global and skipped steps, the loss scale, the LR and the last loss), across
ZeRO stages 0/1/2/3, gas > 1, fp16 with skips mid-block (with an LR
scheduler) and the bf16 NaN sentinel.  Every training case of that file is
ported here against the port's own ``train_batch``; one case holds the
port's ``train_many`` against the JAX engine's (fp32, ``rtol=1e-6``: the
same Adam arithmetic on the same linear model).  The ZeRO-3 GPT-2 case
(really partitioned leaves) and a ZeRO-1 fp16 case with skips at dp 2 run
in one launch of two gloo ranks.

Also: the refusals of ``train_many`` with the JAX messages, the config's
``DSTPU_MULTISTEP`` escape hatch, ``BlockPrefetcher`` (grouping, the
trailing block, ``place`` on the producer thread, error propagation, one
shot), a preemption mid-block drained at the K boundary with a bitwise
resume, and the watchdog's deadline scaled by K.
"""

import os
import time

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu_torch import resilience
from deepspeed_tpu_torch.checkpoint import find_latest_valid_tag
from deepspeed_tpu_torch.config import DeepSpeedConfig, DeepSpeedConfigError
from deepspeed_tpu_torch.data import BlockPrefetcher, device_placer
from deepspeed_tpu_torch.resilience import (COUNTERS, PreemptionHandler,
                                            RESUME_EXIT_CODE, Watchdog, chaos)
from torch_rank_worker import TINY, SimpleModel, master_bytes
from torch_ranks import run_ranks

HIDDEN = 8


def base_config(**over):
    cfg = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
           "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Adam", "params": {"lr": 0.01}}}
    cfg.update(over)
    return cfg


def make_engine(cfg):
    return deepspeed_tpu_torch.initialize(
        model=SimpleModel(hidden_dim=HIDDEN), config=dict(cfg),
        device="cpu")[0]


def batch(i, n=16, dtype=np.float32, poison=False):
    rng = np.random.default_rng(1000 + i)
    x = rng.normal(size=(n, HIDDEN)).astype(dtype)
    if poison:
        x[0, 0] = np.inf
    y = rng.integers(0, HIDDEN, size=(n,)).astype(np.int32)
    return (x, y)


def trajectory_state(engine):
    return (master_bytes(engine), engine.global_steps, engine.skipped_steps,
            engine.optimizer.cur_scale,
            tuple(g["lr"] for g in engine.optimizer.param_groups))


@pytest.fixture(autouse=True)
def _clean():
    chaos.reset()
    COUNTERS.reset()
    yield
    chaos.reset()
    COUNTERS.reset()


PARITY_CASES = [
    ("stage0_fp32_gas2", base_config(), np.float32),
    ("stage0_bf16_gas2", base_config(bf16={"enabled": True}), np.float32),
    ("stage1_fp16", base_config(zero_optimization={"stage": 1},
                                fp16={"enabled": True,
                                      "loss_scale": 128.0}),
     np.float16),
    ("stage2_bf16", base_config(zero_optimization={"stage": 2},
                                bf16={"enabled": True}), np.float32),
    ("fp16_dynamic_sched", base_config(
        fp16={"enabled": True, "loss_scale": 0},
        scheduler={"type": "WarmupLR",
                   "params": {"warmup_num_steps": 10,
                              "warmup_max_lr": 0.01}}), np.float16),
    ("bf16_sentinel", base_config(bf16={"enabled": True},
                                  resilience={"nan_sentinel": True}),
     np.float32),
]


@pytest.mark.parametrize("name,cfg,dtype",
                         PARITY_CASES, ids=[c[0] for c in PARITY_CASES])
def test_parity_bitwise(name, cfg, dtype):
    K = 4
    e1, e2 = make_engine(cfg), make_engine(cfg)
    bs = [batch(i, dtype=dtype) for i in range(K)]
    serial = [e1.train_batch(b) for b in bs]
    last = e2.train_many(bs)
    assert trajectory_state(e1) == trajectory_state(e2)
    assert float(serial[-1]) == float(last)


def test_parity_fp16_skip_mid_block_with_scheduler():
    """A real overflow in the middle of a block under fp16 and an LR
    scheduler: the block skips that boundary, and the master, skip count
    and LR equal the serial run's bitwise."""
    cfg = base_config(
        fp16={"enabled": True, "loss_scale": 128.0},
        scheduler={"type": "WarmupLR",
                   "params": {"warmup_num_steps": 10,
                              "warmup_max_lr": 0.01}})
    K = 4
    e1, e2 = make_engine(cfg), make_engine(cfg)
    bs = [batch(0, dtype=np.float16),
          batch(1, dtype=np.float16, poison=True),   # skips mid-block
          batch(2, dtype=np.float16), batch(3, dtype=np.float16)]
    serial = [e1.train_batch(b) for b in bs]
    last = e2.train_many(bs)
    assert e1.skipped_steps == e2.skipped_steps == 1
    assert trajectory_state(e1) == trajectory_state(e2)
    assert float(serial[-1]) == float(last)


def test_bf16_sentinel_skip_mid_block_counts_once():
    """The NaN sentinel under bf16: the poisoned boundary is skipped in
    both runs and counted once in ``nan_skips`` by the block."""
    cfg = base_config(bf16={"enabled": True},
                      resilience={"nan_sentinel": True})
    bs = [batch(0), batch(1, poison=True), batch(2)]
    e1 = make_engine(cfg)
    for b in bs:
        e1.train_batch(b)
    assert COUNTERS.nan_skips == 1
    COUNTERS.reset()
    e2 = make_engine(cfg)
    e2.train_many(bs)
    assert COUNTERS.nan_skips == 1
    assert trajectory_state(e1) == trajectory_state(e2)


def test_train_many_k1_matches_train_batch():
    e1 = make_engine(base_config(bf16={"enabled": True}))
    e2 = make_engine(base_config(bf16={"enabled": True}))
    e1.train_batch(batch(0))
    e2.train_many([batch(0)])
    assert trajectory_state(e1) == trajectory_state(e2)


def test_train_many_matches_the_jax_engine():
    """The port's train_many against the JAX engine's train_many on the
    same linear model and batches (fp32 Adam, gas 2, K 4): the masters
    within ``rtol=1e-6, atol=1e-7``, and the returned loss against the
    JAX engine's last ``train_batch`` loss."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from simple_model import SimpleModel as JSimple
    model = SimpleModel(hidden_dim=HIDDEN)
    params = {"w": model.w.detach().numpy().copy(),
              "b": model.b.detach().numpy().copy()}
    from deepspeed_tpu.parallel.topology import make_mesh
    jeng, jserial = (deepspeed_tpu.initialize(
        model=JSimple(hidden_dim=HIDDEN), model_parameters=params,
        config=base_config(), mesh=make_mesh(devices=jax.devices()[:1]))[0]
        for _ in range(2))
    teng = deepspeed_tpu_torch.initialize(model=model, config=base_config(),
                                          device="cpu")[0]
    bs = [batch(i) for i in range(4)]
    jeng.train_many(bs)
    jl = [float(jserial.train_batch(b)) for b in bs]
    # the port returns the last step's loss, as its train_batch does
    np.testing.assert_allclose(float(teng.train_many(bs)), jl[-1],
                               rtol=1e-6)
    for name in ("w", "b"):
        np.testing.assert_allclose(teng.master[name].numpy(),
                                   np.asarray(jeng.master[name]),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    assert teng.global_steps == jeng.global_steps == 4


def test_train_many_rejects_mixed_formats_and_bad_leads():
    engine = make_engine(base_config(bf16={"enabled": True}))
    with pytest.raises(ValueError, match="share one"):
        engine.train_many([batch(0), batch(1, n=8)])
    with pytest.raises(ValueError, match="non-empty"):
        engine.train_many([])
    with pytest.raises(ValueError, match="not divisible"):
        engine.train_many([batch(0, n=15)])
    with pytest.raises(ValueError, match="disagree on the leading dim"):
        x, y = batch(0)
        engine.train_many([(x, y[:8])])


def test_scheduler_without_state_dict_is_refused():
    class Bare:
        def step(self):
            pass

    engine = deepspeed_tpu_torch.initialize(
        model=SimpleModel(hidden_dim=HIDDEN), config=base_config(),
        lr_scheduler=Bare(), device="cpu")[0]
    with pytest.raises(DeepSpeedConfigError, match="state_dict"):
        engine.train_many([batch(0), batch(1)])


def test_config_env_escape_hatches(monkeypatch):
    monkeypatch.setenv("DSTPU_MULTISTEP", "off")
    cfg = DeepSpeedConfig(base_config(train_steps_per_dispatch=8),
                          dp_world_size=1)
    assert cfg.train_steps_per_dispatch == 1
    monkeypatch.setenv("DSTPU_MULTISTEP", "4")
    cfg = DeepSpeedConfig(base_config(), dp_world_size=1)
    assert cfg.train_steps_per_dispatch == 4
    monkeypatch.setenv("DSTPU_MULTISTEP", "soon")
    with pytest.raises(DeepSpeedConfigError, match="DSTPU_MULTISTEP"):
        DeepSpeedConfig(base_config(), dp_world_size=1)
    monkeypatch.delenv("DSTPU_MULTISTEP")
    with pytest.raises(DeepSpeedConfigError, match="must be >= 1"):
        DeepSpeedConfig(base_config(train_steps_per_dispatch=0),
                        dp_world_size=1)
    # the engine takes the key now (it was refused before train_many)
    engine = make_engine(base_config(train_steps_per_dispatch=4))
    assert engine.config.train_steps_per_dispatch == 4


def test_block_prefetcher_groups_and_propagates():
    blocks = list(BlockPrefetcher(iter(range(7)), k=3))
    assert blocks == [[0, 1, 2], [3, 4, 5], [6]]
    assert list(BlockPrefetcher(iter(range(7)), k=3, drop_last=True)) \
        == [[0, 1, 2], [3, 4, 5]]
    placed = list(BlockPrefetcher(iter(range(4)), k=2,
                                  place=lambda b: b * 10))
    assert placed == [[0, 10], [20, 30]]

    def boom():
        yield 1
        raise RuntimeError("collate exploded")
    with pytest.raises(RuntimeError, match="collate exploded"):
        list(BlockPrefetcher(boom(), k=1))
    with pytest.raises(ValueError, match="k must be"):
        BlockPrefetcher(iter([]), k=0)
    once = BlockPrefetcher(iter(range(2)), k=1)
    list(once)
    with pytest.raises(RuntimeError, match="one-shot"):
        iter(once)


def test_block_prefetcher_places_batches_for_train_many():
    """``place=device_placer(device)`` stages every leaf as a tensor on
    the producer thread; the blocks train bitwise as the numpy ones."""
    seen = []

    def place(b):
        import threading
        seen.append(threading.current_thread().name)
        return device_placer("cpu")(b)

    blocks = list(BlockPrefetcher(iter([batch(i) for i in range(4)]), k=2,
                                  place=place))
    assert all(isinstance(x, torch.Tensor) for blk in blocks for b in blk
               for x in b)
    assert set(seen) == {"dstpu-block-prefetch"}
    e1 = make_engine(base_config(bf16={"enabled": True}))
    e2 = make_engine(base_config(bf16={"enabled": True}))
    for blk in blocks:
        e1.train_many(blk)
    e2.train_many([batch(i) for i in range(2)])
    e2.train_many([batch(i) for i in range(2, 4)])
    assert trajectory_state(e1) == trajectory_state(e2)


@pytest.fixture(scope="module")
def dp2_runs(tmp_path_factory):
    """Two gloo ranks: tiny GPT-2 at ZeRO-3 (bf16, gas 2; the leaves really
    partitioned over dp 2) and at ZeRO-1 fp16 with a loss scale of 2^32
    (the first boundaries overflow and skip), each as 4 ``train_batch``
    calls and as one ``train_many`` block of 4 fed by BlockPrefetcher."""
    from deepspeed_tpu.models import GPT2 as JGPT2
    from deepspeed_tpu_torch import weights
    jm = JGPT2.from_size("tiny", **TINY)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init_params(jax.random.PRNGKey(3)))
    inputs = {f"w/{k}": v for k, v in weights.flatten_tree(params).items()}
    rng = np.random.default_rng(5)
    toks = rng.integers(0, TINY["vocab_size"],
                        (4, 16, TINY["max_seq_len"])).astype(np.int32)
    labels = np.roll(toks, -1, axis=2)
    labels[..., -1] = -1
    inputs.update(tokens=toks, labels=labels)
    z3 = dict(base_config(bf16={"enabled": True},
                          zero_optimization={"stage": 3}),
              optimizer={"type": "Adam", "params": {"lr": 1e-3}})
    z1 = dict(base_config(fp16={"enabled": True, "initial_scale_power": 32},
                          zero_optimization={"stage": 1}),
              optimizer={"type": "Adam", "params": {"lr": 1e-3}})
    runs = []
    for cfg in (z3, z1):
        runs.append({"config": cfg, "steps": 4})
        runs.append({"config": cfg, "steps": 4, "train_many": 4,
                     "prefetch": True})
    outs = run_ranks(tmp_path_factory.mktemp("multistep"), 2,
                     {"scenario": "train", "runs": runs}, inputs,
                     timeout=200)
    return [[{k.split("/", 1)[1]: v for k, v in o.items()
              if k.startswith(f"{i}/")} for o in outs]
            for i in range(len(runs))]


@pytest.mark.parametrize("case", ["zero3_bf16", "zero1_fp16_skips"])
def test_parity_bitwise_at_dp2(dp2_runs, case):
    serial, many = (dp2_runs[0], dp2_runs[1]) if case == "zero3_bf16" \
        else (dp2_runs[2], dp2_runs[3])
    for r in range(2):
        a, b = serial[r], many[r]
        assert float(a["losses"][-1]) == float(b["losses"][-1])
        for key in ("master", "m", "v", "step", "skipped", "global_steps",
                    "cur_scale"):
            assert np.array_equal(a[key], b[key]), (r, key)
        for key in a:
            if key.startswith(("master/", "m/", "v/")):
                assert np.array_equal(a[key], b[key]), (r, key)
    if case == "zero3_bf16":
        assert any(int(v) >= 0 for k, v in serial[0].items()
                   if k.startswith("z3dim/"))
    else:
        assert int(serial[0]["skipped"]) >= 1


# ------------------------------------------------------ resilience x K

def test_preempt_mid_block_drains_at_k_boundary_bitwise(tmpdir):
    """A preemption request raised while a block is about to run drains
    at the NEXT K boundary, with an emergency checkpoint and a bitwise
    resume."""
    K, STEPS = 3, 9
    cfg = base_config(zero_optimization={"stage": 1},
                      fp16={"enabled": True, "loss_scale": 128.0},
                      train_steps_per_dispatch=K)

    def factory():
        return make_engine(cfg)

    def k_block(engine, _batch):
        start = engine.global_steps
        engine.train_many([batch(start + j, dtype=np.float16)
                           for j in range(K)])

    unbroken = resilience.run_resumable(
        factory, k_block, steps=STEPS, save_dir=str(tmpdir.join("unbroken")))
    ref = master_bytes(unbroken)

    sentinel = str(tmpdir.join("preempt"))
    handler = PreemptionHandler(sentinel_file=sentinel)
    save_dir = str(tmpdir.join("interrupted"))
    fired = []

    def k_block_interrupting(engine, _batch):
        start = engine.global_steps
        if start == K and not fired:
            fired.append(True)
            open(sentinel, "w").close()
        engine.train_many([batch(start + j, dtype=np.float16)
                           for j in range(K)])

    try:
        with pytest.raises(SystemExit) as ei:
            resilience.run_resumable(factory, k_block_interrupting,
                                     steps=STEPS, save_dir=save_dir,
                                     handler=handler)
        assert ei.value.code == RESUME_EXIT_CODE
        assert find_latest_valid_tag(save_dir) == \
            f"emergency/global_step{2 * K}"
        os.remove(sentinel)
        handler.clear()
        resumed = resilience.run_resumable(factory, k_block, steps=STEPS,
                                           save_dir=save_dir,
                                           handler=handler)
    finally:
        handler.uninstall()
    assert resumed.global_steps == STEPS
    assert master_bytes(resumed) == ref


def test_watchdog_deadline_scales_with_k():
    wd = Watchdog(timeout_s=0.3, poll_s=0.02)
    with wd.armed("k-block", deadline_scale=5):
        time.sleep(0.9)                  # 3x the base deadline
    assert not wd.fired
    assert COUNTERS.watchdog_near_misses == 0   # 0.9 < 0.8 * 1.5
    with wd.armed("single"):
        time.sleep(0.6)                  # past the unscaled deadline
        wd.fire_event.wait(timeout=2.0)
    assert wd.fired
    with pytest.raises(ValueError, match="deadline_scale"):
        wd._arm("bad", 0)


def test_train_many_arms_watchdog_scaled():
    engine = make_engine(base_config(
        bf16={"enabled": True}, resilience={"watchdog_timeout_s": 60.0}))
    seen = []
    real_armed = engine._watchdog.armed
    engine._watchdog.armed = (
        lambda label, deadline_scale=1.0:
        seen.append((label, deadline_scale)) or
        real_armed(label, deadline_scale=deadline_scale))
    engine.train_many([batch(0), batch(1), batch(2)])
    # armed once for the block: the backward and boundary inside ride it
    assert seen == [("train_many", 3)]
