"""The port's planners (``deepspeed_tpu_torch/analysis/``: memplan,
commplan, dispatchplan, stability, profiles), after ``tests/test_memplan.py``
and ``tests/test_dispatch_stability.py``.

* Fake against real: the fake-mode trace's predicted peak of a
  ``train_batch`` against the same trace's live bytes over a real CPU step,
  ZeRO 0-3 x activation checkpointing off / full (mp 2 and pp 2:
  ``tests/test_torch_analysis_ranks.py``).  Tolerance 10%, the JAX
  planner's contract with ``compiled.memory_analysis()``.
* The persistent breakdown equals the JAX engine's, key for key.
* ``FenceModel`` equals the fence counter over N steps for the JAX
  package's contracts (``test_contract_*``) in the port's form: its
  ``train_many`` is the serial step loop, so its skip read stays per step.
* The capacity gate: ``memory.fit`` / ``memory.budget`` /
  ``memory.budget-exceeded`` by the budget, ``MemoryPlanError`` at build in
  error mode naming the contributors, suppression by exact rule.
* Stability: a state leaf off the engine's dtype is
  ``stability.unpinned-sharding`` (after build and after
  ``load_checkpoint``); a serving program whose call signature varies with
  the prompt is ``stability.shape-varying``.
* Profiles, the dispatch plan's report and JSON, the telemetry's planner
  columns.
"""

import logging
import types

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu
from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2
from deepspeed_tpu.parallel.topology import make_mesh

import deepspeed_tpu_torch
from deepspeed_tpu_torch import analysis, weights
from deepspeed_tpu_torch.analysis import memplan, profiles, stability
from deepspeed_tpu_torch.inference import InferenceEngine
from deepspeed_tpu_torch.models import GPT2
from deepspeed_tpu_torch.observability import fences

TINY = dict(vocab_size=64, max_seq_len=16, num_layers=2, hidden_size=32,
            num_heads=4)
PEAK_TOL = 0.10


def _toks(rows=4, seed=0):
    t = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 64, (rows, 16)).astype(np.int64))
    return t, t.clone()


def _gpt2_engine(layers=TINY["num_layers"], **cfg):
    base = {"train_micro_batch_size_per_gpu": 4,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            "bf16": {"enabled": True}}
    return deepspeed_tpu_torch.initialize(
        model=GPT2.from_size("tiny", **dict(TINY, num_layers=layers)),
        device="cpu", config={**base, **cfg})[0]


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_fake_peak_matches_a_real_step(stage, remat):
    cfg = {"zero_optimization": {"stage": stage}} if stage else {}
    if remat:
        cfg["activation_checkpointing"] = {"enabled": True}
    eng = _gpt2_engine(layers=1, **cfg)      # one layer: the suite's time
    plan = eng.plan_capacity(_toks())
    fake = analysis.trace_engine(eng, _toks())["train_batch"]
    assert plan.peak_bytes == fake.total_peak
    real = analysis.trace_engine(eng, _toks(), fake=False)["train_batch"]
    assert abs(fake.total_peak / real.total_peak - 1) <= PEAK_TOL


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_persistent_breakdown_matches_jax(stage):
    zero = {"zero_optimization": {"stage": stage}} if stage else {}
    eng = _gpt2_engine(**zero)
    jm = JGPT2.from_size("tiny", **TINY)
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=jm, mesh=make_mesh(devices=jax.devices()[:1]), config={
            "train_micro_batch_size_per_gpu": 4,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            "bf16": {"enabled": True}, **zero},
        model_parameters=jm.init_params(jax.random.PRNGKey(0)))
    assert eng.plan_capacity(_toks()).persistent == {
        k: int(v) if not isinstance(v, str) else v
        for k, v in jeng.memory_estimate().items()}


# ======================================================= the FenceModel

class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((8, 1), 0.1))

    def forward(self, x, y):
        return ((x @ self.w.to(x.dtype))[:, 0].float() - y).pow(2).mean()


CONTRACTS = {
    "fused_fp16": dict(fp16={"enabled": True}),
    "fused_spooled": dict(bf16={"enabled": True},
                          observability={"report_window": 3}),
    "retained_read_with_scheduler": dict(
        fp16={"enabled": True}, observability={"report_window": 3},
        scheduler={"type": "WarmupLR", "params": {
            "warmup_min_lr": 0.0, "warmup_max_lr": 0.01,
            "warmup_num_steps": 4}}),
    "tput_report_cadence": dict(steps_per_print=2),
    "wall_clock_breakdown": dict(wall_clock_breakdown=True,
                                 gradient_accumulation_steps=2),
    "split_fp16": dict(fp16={"enabled": True}),
    "train_many_k2": dict(fp16={"enabled": True},
                          train_steps_per_dispatch=2),
}


@pytest.mark.parametrize("name", sorted(CONTRACTS))
def test_fence_model_matches_the_counter(name):
    cfg = {"train_micro_batch_size_per_gpu": 4,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
           "steps_per_print": 1000, **CONTRACTS[name]}
    eng = deepspeed_tpu_torch.initialize(model=_Linear(), device="cpu",
                                         config=cfg)[0]
    gas = eng.gradient_accumulation_steps()
    g = torch.Generator().manual_seed(0)
    batch = (torch.randn(4 * gas, 8, generator=g),
             torch.randn(4 * gas, generator=g))
    split = name == "split_fp16"
    micro = tuple(x[:4] for x in batch)
    plan = eng.plan_dispatch(micro if split else batch, fused=not split)
    steps = 6
    f0 = fences.FENCE_COUNT
    prior = eng.tput_timer.local_step_count
    if split:
        for _ in range(steps):
            eng.backward(eng(*micro))
            eng.step()
    elif name == "train_many_k2":
        for _ in range(steps // 2):
            eng.train_many([batch, batch])
    else:
        for _ in range(steps):
            eng.train_batch(batch)
    flushes = 1 if eng._spool is not None else 0
    eng.flush_telemetry()
    got = fences.FENCE_COUNT - f0
    assert got == plan.predict_fences(steps, prior_boundaries=prior,
                                      flushes=flushes)
    if name == "train_many_k2":
        # the port's serial train_many: one skip read per STEP (the JAX
        # engine's per-block read is ROADMAP Queue 2 B2's device gate)
        assert plan.fence_model.per_boundary == 1
        assert plan.fence_model.block_steps == 2
        assert plan.subject == "train_many"


# ===================================================== the capacity gate

@pytest.mark.parametrize("budget_gb,code", [
    (None, "memory.no-budget"), (4.0, "memory.fit"),
    (0.0001, "memory.budget-exceeded")])
def test_plan_report_severities(budget_gb, code):
    eng = _gpt2_engine()
    plan = eng.plan_capacity(_toks(), budget_gb=budget_gb)
    codes = {f.code for f in plan.to_report()}
    assert code in codes and "comm.wire" in codes
    if code == "memory.budget-exceeded":
        err = [f for f in plan.to_report() if f.code == code][0]
        assert "Top live-set contributors" in err.message
        assert "MiB" in err.message
    # near the budget: a warning
    near = eng.plan_capacity(_toks(), budget_gb=plan.peak_bytes * 1.05
                             / 2 ** 30)
    assert "memory.budget" in {f.code for f in near.to_report()}


@pytest.mark.parametrize("suppress,raises", [
    ([], True), (["memory.budget"], True),
    (["memory.budget-exceeded"], False), (["memory"], False)])
def test_engine_capacity_gate(suppress, raises):
    """``memory.budget`` (a warning) does not silence the distinct error
    ``memory.budget-exceeded``: suppression is by exact code or dotted
    prefix."""
    eng = _gpt2_engine(analysis={"mode": "error", "memory_budget_gb": 1e-4,
                                 "suppress": suppress})
    w0 = {k: v.detach().clone() for k, v in eng.module.named_parameters()}
    if raises:
        with pytest.raises(analysis.MemoryPlanError,
                           match="budget-exceeded"):
            eng.train_batch(_toks())
        assert all(torch.equal(v, w0[k])
                   for k, v in eng.module.named_parameters())
    else:
        assert np.isfinite(float(eng.train_batch(_toks())))


def test_zero3_prefetch_envelope():
    """Two gathered layers in the compute dtype; 0 at an odd depth."""
    def fake(depth):
        return types.SimpleNamespace(
            zero3=True, overlap_comm=True,
            _zero3_dims={"blocks.w": 1, "wte": 0},
            policy=types.SimpleNamespace(compute_dtype=torch.bfloat16),
            _global_shapes={"blocks.w": (depth, 32, 64), "wte": (64, 32)})
    assert memplan.zero3_prefetch_transient_bytes(fake(2)) == 2 * 32 * 64 * 2
    assert memplan.zero3_prefetch_transient_bytes(fake(3)) == 0


# ============================================================ stability

def test_unpinned_state_caught_after_build_and_after_restore(tmp_path,
                                                             monkeypatch):
    eng = _gpt2_engine(analysis={"mode": "error"})
    assert not eng.run_stability().errors
    eng.train_batch(_toks())
    eng.save_checkpoint(str(tmp_path))
    from deepspeed_tpu_torch import checkpoint
    real = checkpoint.load_checkpoint

    def load_off_dtype(engine, *a, **k):
        out = real(engine, *a, **k)
        name = next(iter(engine.master))
        engine.master[name] = engine.master[name].double()
        return out
    monkeypatch.setattr(checkpoint, "load_checkpoint", load_off_dtype)
    with pytest.raises(analysis.MemoryPlanError,
                       match="stability.unpinned-sharding"):
        eng.load_checkpoint(str(tmp_path))
    assert [f.code for f in eng.run_stability().errors] == [
        "stability.unpinned-sharding"]


def _serve(**inf):
    params = weights.unflatten_tree({
        n: p.detach() for n, p in GPT2.from_size(
            "tiny", device="cpu", generator=torch.Generator().manual_seed(0),
            **TINY).named_parameters()})
    cfg = {"max_slots": 2, "max_tokens": 16, "prefill_bucket": 8,
           "page_tokens": 4, "dtype": "float32", **inf}
    return InferenceEngine(GPT2.from_size("tiny", device="meta", **TINY),
                           config={"inference": cfg}, params=params,
                           device="cpu")


def test_serve_shape_varying_detected(monkeypatch):
    eng = _serve()
    assert not eng.run_stability().errors

    def unpadded(prompt_tokens, bucket=None):
        toks = np.asarray(prompt_tokens, np.int32).reshape(1, -1)
        return toks, toks.shape[1]
    monkeypatch.setattr(eng, "_pad_prompt", unpadded)
    assert "stability.shape-varying" in {
        f.code for f in eng.run_stability().errors}


def test_serve_graph_keys_predicted():
    """One CUDA graph per ``_program`` key: the prefill bucket, the tail
    bucket with prefix reuse, the decode step; a draft adds its prefill,
    its decode and the verify."""
    assert stability.predict_executables_serve(
        _serve(prefix_reuse=False)).total == 2
    assert stability.predict_executables_serve(
        _serve(prefix_reuse=True, tail_bucket=4)).total == 3


def test_serving_plan_prices_the_graphs_statics():
    """As CUDA graphs, each graph holds its inputs' copies and its outputs
    for the engine's life: the plan adds every other graph's to each
    program's eager peak (the CPU profile keeps no stream workspace)."""
    eng = _serve(prefix_reuse=True, tail_bucket=4)
    eng._graphs = {}                  # as on the card: programs graphed
    plan = eng.plan_capacity()
    assert len(plan.graph_static) == 3
    slots, cap = eng.num_slots, eng.cache_spec.capacity
    vocab = TINY["vocab_size"]
    # decode: tokens int64, active bool, rows and positions int32 in;
    # fp32 logits and the positions out, each in 512-byte blocks
    block = lambda n: -(-n // 512) * 512          # noqa: E731
    decode = [v for k, v in plan.graph_static.items()
              if k[0] == ("decode", False)]
    assert decode == [block(slots * 8) + block(slots) + block(slots * cap * 4)
                      + block(slots * 4) + block(slots * vocab * 4)
                      + block(slots * 4)]
    total = sum(plan.graph_static.values())
    want = max(p.peak_bytes + total - sum(
        plan.graph_static[k] for k in plan.graph_keys[p.subject])
        for p in plan.programs)
    assert plan.graph_workspace_bytes == 0
    assert plan.peak_bytes == want > plan.eager_peak_bytes
    eng._graphs = None
    assert eng.plan_capacity().peak_bytes == plan.eager_peak_bytes


# ============================================================= profiles

@pytest.mark.parametrize("name,want", [("h100", "h100"), ("cpu", "cpu"),
                                       ("v4-8", "cpu"), ("v5p", "cpu")])
def test_profile_resolve(name, want, caplog):
    with caplog.at_level(logging.WARNING):
        prof = profiles.resolve(name, torch.device("cpu"))
    assert prof.name == want
    if name.startswith("v"):
        assert prof is profiles.PROFILES["cpu"]
    assert prof.hbm_bytes > 0


def test_unknown_profile_raises():
    with pytest.raises(KeyError, match="unknown backend profile"):
        profiles.resolve("v9-8")


def test_cpu_profile_has_the_dot_copy_quirk():
    assert profiles.default_profile(torch.device("cpu")).lowp_dot_f32_copies
    assert not profiles.PROFILES["h100"].lowp_dot_f32_copies


# ======================================================= dispatch plans

@pytest.mark.parametrize("window,warns", [(4, False), (1, True)])
def test_dispatch_plan_report_and_json(window, warns):
    eng = _gpt2_engine(observability={"report_window": window})
    plan = eng.plan_dispatch(_toks())
    codes = [f.code for f in plan.to_report()]
    assert "dispatch.report" in codes
    assert ("dispatch.callback-per-step" in codes) == warns
    doc = plan.to_json()
    assert doc["per_kind"]["dispatch"] == plan.events[0].per_step > 0
    assert doc["fence_model"]["flush_fences"] == 1
    assert doc["executables"]["libraries"] == []     # no kernel on the CPU


def test_telemetry_predictions_filled(tmp_path):
    eng = _gpt2_engine(observability={"report_window": 2},
                       analysis={"mode": "warn"})
    eng.train_batch(_toks())
    pred = eng.telemetry.predictions
    assert pred["predicted_peak_hbm_gb"] > 0
    assert pred["predicted_profile"] == "cpu"
    assert pred["predicted_boundary_ms"] is not None
