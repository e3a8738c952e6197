"""The port's graph lint and wire planner across ranks
(``deepspeed_tpu_torch/analysis/``), after the multi-rank cases of
``tests/test_graph_lint.py`` and ``tests/test_memplan.py``.

One gloo launch of two CPU ranks (``tests/torch_rank_worker.py``, scenario
``lint``) holds every seeded case:

* one extra ``all_reduce`` on rank 1 is ``collective.divergent-order`` at
  the first ``train_batch`` in error mode, on both ranks, within seconds
  (the trace is fake: nothing reached the wire, so nothing hangs), and the
  program without it trains;
* divergent bucket shapes, an all-to-all layout divergence and an unmatched
  send / receive are caught;
* GPipe and 1F1B at pp 2 lint clean in error mode and train;
* at mp 2 and pp 2 the fake trace's peak equals a real step's live bytes
  (tolerance: 10%, the JAX planner's contract; they agree exactly);
* the wire bytes per axis of the fused step at dp 2 with ZeRO-0/1/2/3 and at
  mp 2, pp 2 and sp 2, held EXACTLY to the JAX plan of the same config once
  the named differences below are added (rank 0's plan: the port's pipeline
  ranks send different messages).
"""

import numpy as np
import pytest

import jax

import deepspeed_tpu
from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2
from deepspeed_tpu.models.pipeline_gpt2 import GPT2Pipelined as JGPT2Pipe
from deepspeed_tpu.parallel.topology import make_mesh
from torch_ranks import run_ranks

#: the worker's tiny GPT-2 (tests/torch_rank_worker.py TINY)
TINY = dict(vocab_size=64, max_seq_len=16, num_layers=2, hidden_size=32,
            num_heads=4)
BF16 = {"bf16": {"enabled": True}}
COMM = {
    "dp2_z0": dict(BF16),
    "dp2_z1": dict(BF16, zero_optimization={"stage": 1}),
    "dp2_z2": dict(BF16, zero_optimization={"stage": 2}),
    "dp2_z3": dict(BF16, zero_optimization={"stage": 3}),
    "mp2": dict(BF16, model_parallel_size=2),
    "pp2": dict(BF16, pipeline_parallel_size=2),
    "sp2": dict(BF16, context_parallel_size=2,
                sequence_parallel_impl="ring"),
}

_LOSS = ("JAX psums the reported loss over data (the port reports each "
         "rank's own)", 4)
#: JAX bytes per axis = the port's + these (bytes, each a named structural
#: difference between the two packages' programs, from the sites' sources)
COMM_DELTAS = {
    "dp2_z0": {"data": [_LOSS]},
    "dp2_z1": {"data": [_LOSS, (
        "the ZeRO all-gather of the updated partition: fp32 masters in "
        "JAX, the compute dtype (bf16) in the port", 28160)]},
    "dp2_z2": {"data": [_LOSS, (
        "the ZeRO all-gather of the updated partition: fp32 masters in "
        "JAX, the compute dtype (bf16) in the port", 28160)]},
    "dp2_z3": {"data": [_LOSS, (
        "JAX's backward gathers the scanned blocks' weights again (the "
        "forward's gathered weights are no residual); the port keeps "
        "them", 24576)]},
    "mp2": {"model": [
        ("JAX psums the model-replicated leaves' partial gradients "
         "(_psum_model_replicated); the port's get whole gradients "
         "(copy_to_model sums its input's gradient)", 1920),
        ("the vocab-parallel cross-entropy: JAX 5 reductions of [B, T] "
         "fp32 (its backward differentiates two), the port 3", 512),
        ("activation all-reduces of [B, T, h] bf16: JAX 12, the port 10 "
         "(4 row-parallel outputs, the embedding, 5 in the backward)",
         8192)]},
    "pp2": {"pipe": [
        ("JAX ppermutes every stage's carry on every tick (6 here), the "
         "port sends what its peer reads (3 on rank 0)", 6144),
        ("JAX gathers the last stage's output to every stage and "
         "scatters its cotangent back", 4096),
        ("the loss and scalar reductions: JAX 6 (24 B), the port 3 "
         "(16 B)", 8),
        ("the stage-replicated leaves' gradients: JAX psums them in "
         "bf16, the port in fp32 (comm.sum_fp32_)", -5248)]},
    "sp2": {"seq": [
        ("the gradients' sum over seq: JAX psums them in bf16, the port "
         "in fp32 (engine._seq_reduce)", -56064),
        ("the ring's shifts: JAX's backward replays the forward ring "
         "(12 ppermutes of k or v), the port shifts stacked [k, v] 4 "
         "times", 8192)],
            "data": [("JAX's loss psum over (data, seq) counts on the "
                      "data axis too", 4)]},
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rng = np.random.default_rng(0)
    inputs = {"x": rng.normal(size=(8, 8)).astype(np.float32),
              "y": rng.integers(0, 8, (8,)).astype(np.int64),
              "tokens": rng.integers(0, 64, (4, 16)).astype(np.int64)}
    return run_ranks(tmp_path_factory.mktemp("lint"), 2,
                     {"scenario": "lint", "comm": COMM}, inputs,
                     timeout=240)


@pytest.mark.parametrize("case,code", [
    ("a", "collective.divergent-order"),       # one extra all_reduce
    ("c", "collective.divergent-order"),       # bucket shapes
    ("d", "collective.divergent-order"),       # all-to-all layout
    ("e", "collective.ppermute-malformed"),    # unmatched send / recv
])
def test_seeded_collective_divergence_caught_on_every_rank(ranks, case,
                                                           code):
    for out in ranks:
        assert list(out[f"{case}/codes"]) == [code]
    if case == "a":
        # caught at the build gate in bounded time: no rank trained
        for out in ranks:
            assert "a/losses" not in out
            assert float(out["a/seconds"]) < 60
            assert "ranks 0 and 1" in str(out["a/message"])


def test_fixed_program_trains_clean(ranks):
    for out in ranks:
        assert np.all(np.isfinite(out["b/losses"]))


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_schedules_lint_clean(ranks, schedule):
    for out in ranks:
        assert list(out[f"f/{schedule}/codes"]) == [""]
        assert np.isfinite(float(out[f"f/{schedule}/loss"]))
    assert float(ranks[0][f"f/{schedule}/loss"]) == float(
        ranks[1][f"f/{schedule}/loss"])


@pytest.mark.parametrize("layout", ["mp", "pp"])
def test_fake_peak_matches_real_step(ranks, layout):
    """Tolerance 10% (the JAX planner's contract); here they are equal."""
    for out in ranks:
        fake, real = out[f"g/{layout}"]
        assert abs(fake / real - 1) <= 0.10
        assert fake == real


def _jax_comm(name):
    extra = dict(COMM[name])
    mp = int(extra.pop("model_parallel_size", 1))
    pp = int(extra.pop("pipeline_parallel_size", 1))
    sp = int(extra.pop("context_parallel_size", 1))
    dp = 2 // (mp * pp * sp)
    mesh = make_mesh(model_parallel_size=mp, context_parallel_size=sp,
                     pipeline_parallel_size=pp, devices=jax.devices()[:2])
    model = (JGPT2Pipe.from_size("tiny", num_micro_batches=2, **TINY)
             if pp > 1 else JGPT2.from_size("tiny", **TINY))
    eng, _, _, _ = deepspeed_tpu.initialize(
        model=model, mesh=mesh, config={
            "train_micro_batch_size_per_gpu": 4,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            **extra},
        model_parameters=model.init_params(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(
        0, 64, (4 * dp, 16)).astype(np.int32)
    plan = eng.plan_capacity((toks, toks), fused=True)
    return {a: b for a, b in plan.comm.per_axis_bytes().items() if b}


@pytest.mark.parametrize("name", sorted(COMM))
def test_commplan_bytes_per_axis_match_jax(ranks, name):
    port = {k.split("/")[2]: int(v) for k, v in ranks[0].items()
            if k.startswith(f"h/{name}/")}
    want = _jax_comm(name)
    deltas = COMM_DELTAS[name]
    assert set(port) | set(deltas) == set(want) | set(deltas)
    for axis, jax_bytes in want.items():
        named = sum(b for _, b in deltas.get(axis, ()))
        assert port.get(axis, 0) + named == jax_bytes, (
            axis, port.get(axis, 0), jax_bytes, deltas.get(axis))
