"""Serving at model_parallel_size 2 on the port against the JAX package.

``deepspeed_tpu_torch.inference.InferenceEngine`` at mp 2 runs as two
gloo CPU ranks, one process per model rank (one ``run_ranks`` launch of
``tests/torch_rank_worker.py``'s ``tp_serve`` scenario holds every mode:
one engine a mode on each rank, the leader driving, the follower serving
its commands).  It is held against ``deepspeed_tpu.inference``'s engine at
mp 2 (a ``shard_map`` over two of the rig's CPU devices) in fp32 at the
JAX tests' tiny GPT-2 (2 layers, hidden 64, 4 heads, vocab 128,
``init_std`` 0.2), both on the same numpy weights:

* prefill logits at ``atol=1e-4`` (the JAX test's) and within ``1e-5`` of
  the port at mp 1; the decode oracle against a full re-forward;
* greedy tokens identical to the JAX engine's under continuous and static
  batching, fused decode (D 4), speculative decoding (a 1-layer draft, J
  2, with prefix reuse) and int8; the fused and speculative programs are
  held to the JAX engine's greedy tokens, which equal them by
  construction; the port at mp 1 and ``run_fleet`` with the mp-2 engine
  as its replica give the same tokens;
* prefix reuse: tokens, hits and reused tokens equal the JAX engine's;
* int8: logits at ``atol=1e-4`` of the JAX engine's int8 and within the
  relative 0.05 of fp32; the scales equal on both ranks where replicated
  and, joined, the global tree's quantization where cut; per-rank weight
  bytes equal the JAX engine's per-device bytes;
* the KV handoff: the mp-2 export's global heads equal the JAX mp-2
  export at ``atol=1e-5``, and a prompt handed mp 1 -> mp 2 and mp 2 ->
  mp 1 decodes to the same tokens as the mp-2 engine's own prefill;
* accounting: the summaries count the mp chips, health and the startup
  event report ``model_parallel`` 2 and the programs as eager;
* a leader that raises inside ``lead`` stops the follower, which returns.

The JAX engines (three, module-scoped) run in this process.
"""

import json

import numpy as np
import pytest

import jax

from deepspeed_tpu.inference import ContinuousScheduler as JScheduler
from deepspeed_tpu.inference import InferenceEngine as JEngine
from deepspeed_tpu.inference import Request as JRequest
from deepspeed_tpu.inference import StaticScheduler as JStatic
from deepspeed_tpu.inference import quant as jquant
from deepspeed_tpu.inference import synthetic_requests as jsynthetic
from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2
from deepspeed_tpu_torch import weights
from torch_ranks import run_ranks

MP = 2
TINY = dict(vocab_size=128, max_seq_len=64, num_layers=2, hidden_size=64,
            num_heads=4, init_std=0.2)
SERVE = {"max_slots": 3, "max_tokens": 32, "prefill_bucket": 16,
         "page_tokens": 8, "dtype": "float32"}
TRACE = dict(n=8, vocab=TINY["vocab_size"], seed=7, prompt_min=2,
             prompt_max=14, new_min=2, new_max=12)
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9]]
HANDOFF_STEPS = 5
MODES = ["base", "fused", "spec", "int8", "raise"]


def jtiny(**over):
    return JGPT2.from_size("tiny", **{**TINY, **over})


def jcfg(**inf):
    return {"train_micro_batch_size_per_gpu": 1, "model_parallel_size": MP,
            "inference": {**SERVE, **inf}}


def _prefix_trace():
    """Six requests opening with one shared page of 8 tokens."""
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, TINY["vocab_size"], 8).tolist()
    return [[prefix + rng.integers(0, TINY["vocab_size"],
                                   int(rng.integers(2, 6))).tolist(),
             int(rng.integers(2, 6))] for _ in range(6)]


PREFIX_TRACE = _prefix_trace()


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        jtiny().init_params(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def ranks(params, tmp_path_factory):
    """Both ranks' outputs of the one launch."""
    spec = {"scenario": "tp_serve", "model_kw": TINY, "serve": SERVE,
            "trace": TRACE, "prefix_trace": PREFIX_TRACE,
            "prompts": PROMPTS, "oracle_steps": 4,
            "handoff_steps": HANDOFF_STEPS, "modes": MODES}
    inputs = {f"w/{k}": v for k, v in weights.flatten_tree(params).items()}
    return run_ranks(tmp_path_factory.mktemp("tp_serve"), MP, spec, inputs,
                     timeout=240)


@pytest.fixture(scope="module")
def leader(ranks):
    return ranks[0]


@pytest.fixture(scope="module")
def jbase(params):
    return JEngine(jtiny(), config=jcfg(fleet={"disaggregate": True}),
                   params=params)


@pytest.fixture(scope="module")
def jspec(params):
    dparams = {**params, "blocks": {k: v[:1] for k, v in
                                    params["blocks"].items()}}
    return JEngine(jtiny(), config=jcfg(prefix_reuse=True,
                                        speculative={"draft_tokens": 2}),
                   params=params, draft_model=jtiny(num_layers=1),
                   draft_params=dparams)


@pytest.fixture(scope="module")
def jint8(params):
    return JEngine(jtiny(), config=jcfg(quantize="int8"), params=params)


def _tokens(results):
    return {r.rid: list(r.tokens) for r in results}


def _mine(out, key):
    return {int(k): v for k, v in json.loads(str(out[key])).items()}


@pytest.fixture(scope="module")
def jtokens(jbase, jspec, jint8):
    """The JAX engines' greedy tokens on the trace, by mode."""
    def run(eng, sched=JScheduler):
        eng.reset()
        return _tokens(sched(eng).run(jsynthetic(**TRACE)))
    out = {"continuous": run(jbase), "static": run(jbase, JStatic),
           "spec": run(jspec), "int8": run(jint8)}
    jspec.reset()
    sched = JScheduler(jspec)
    out["prefix"] = _tokens(sched.run(
        [JRequest(rid=i, prompt=list(p), max_new_tokens=n)
         for i, (p, n) in enumerate(PREFIX_TRACE)]))
    out["prefix_counts"] = (sched.prefix_hits, sched.prefix_tokens_reused)
    return out


def test_prefill_logits_match_jax_and_mp1(leader, jbase):
    for i, p in enumerate(PROMPTS):
        jbase.reset()
        want = np.asarray(jbase.prefill(0, p), np.float32)
        np.testing.assert_allclose(leader[f"base/prefill/{i}"], want,
                                   atol=1e-4)
        np.testing.assert_allclose(leader[f"base/prefill/{i}"],
                                   leader[f"mp1/prefill/{i}"], atol=1e-5)
    jbase.reset()


def test_decode_oracle(leader):
    assert bool(leader["base/oracle_argmax_equal"])
    assert float(leader["base/oracle_err"]) <= 1e-4


@pytest.mark.parametrize("mode,key,want", [
    ("continuous", "base/continuous", "continuous"),
    ("static", "base/static", "static"),
    ("fused", "fused/continuous", "continuous"),
    ("spec", "spec/continuous", "spec"),
    ("int8", "int8/continuous", "int8"),
    ("mp1", "mp1/continuous", "continuous"),
    ("router", "base/fleet", "continuous"),
])
def test_greedy_tokens_match_jax_by_mode(leader, jtokens, mode, key, want):
    got = _mine(leader, key)
    assert len(got) == TRACE["n"] and all(got.values())
    assert got == jtokens[want]


def test_prefix_reuse_matches_jax(leader, jtokens):
    assert _mine(leader, "spec/prefix") == jtokens["prefix"]
    hits, reused = jtokens["prefix_counts"]
    assert hits == len(PREFIX_TRACE) - 1
    assert (int(leader["spec/prefix_hits"]),
            int(leader["spec/prefix_reused"])) == (hits, reused)


def test_fused_decode_reads_once_a_block(leader):
    """D 4: fewer dispatches than the trace's decode iterations."""
    summary = json.loads(str(leader["base/summary"]))
    assert 0 < int(leader["fused/dispatches"]) < summary["decode_iters"]


def test_int8_logits_scales_and_bytes(ranks, leader, jbase, jint8, params):
    for i, p in enumerate(PROMPTS):
        jint8.reset()
        want = np.asarray(jint8.prefill(0, p), np.float32)
        got = leader[f"int8/prefill/{i}"]
        np.testing.assert_allclose(got, want, atol=1e-4)
        jbase.reset()
        ref = np.asarray(jbase.prefill(0, p), np.float32)
        assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 0.05
    jint8.reset()
    jbase.reset()
    # the scales of the global tree, cut as the engine cuts it
    import jax.numpy as jnp
    qtree = weights.flatten_tree(jquant.quantize_tree(params, jnp.float32))
    cut = {"wte": 0, "blocks.qkv_w": 2, "blocks.fc_w": 2,
           "blocks.proj_w": None, "blocks.fc2_w": None}
    for name, dim in cut.items():
        mine = [r[f"int8/s/{name}"] for r in ranks]
        want = np.asarray(qtree[f"{name}.s"], np.float32)
        if dim is None:
            assert mine[0].tobytes() == mine[1].tobytes() == want.tobytes()
        else:
            np.testing.assert_array_equal(np.concatenate(mine, dim), want)
    assert [int(r["int8/weight_bytes"]) for r in ranks] == \
        [jint8.weight_bytes] * MP


def test_export_kv_matches_jax_mp2(leader, jbase):
    p = PROMPTS[0]
    jbase.reset()
    jbase.admit(0, p, HANDOFF_STEPS + 1)
    jk, jv, jn = jbase.export_kv(0)
    jbase.reset()
    assert jn == len(p)
    assert leader["base/export_k"].shape == (TINY["num_layers"], len(p),
                                             TINY["num_heads"], 16)
    np.testing.assert_allclose(leader["base/export_k"], jk, atol=1e-5)
    np.testing.assert_allclose(leader["base/export_v"], jv, atol=1e-5)


@pytest.mark.parametrize("route", ["12", "21"])
def test_handoff_across_model_parallel_degrees(leader, route):
    """An mp-1 export imported at mp 2 ("12") and the reverse ("21")
    decode as the mp-2 engine's own prefill does."""
    want = leader["handoff/22"]
    assert want.size == HANDOFF_STEPS
    np.testing.assert_array_equal(leader[f"handoff/{route}"], want)


def test_accounting_counts_the_model_group(leader):
    summary = json.loads(str(leader["base/summary"]))
    assert summary["mp"] == MP
    assert summary["tokens_per_sec_per_chip"] == pytest.approx(
        summary["tokens_per_sec"] / MP, abs=0.01)
    fleet = json.loads(str(leader["base/fleet_summary"]))
    assert fleet["n_replicas"] == 1
    assert fleet["tokens_per_sec_per_chip"] == pytest.approx(
        fleet["tokens_per_sec"] / MP, abs=0.01)
    health = json.loads(str(leader["base/health"]))
    assert health["model_parallel"] == MP and health["graphs"] is False
    startup = json.loads(str(leader["base/startup"]))
    assert startup["model_parallel"] == MP
    assert (startup["graphs"], startup["graphs_off_because"]) == \
        (False, "cpu")


def test_leader_exception_stops_the_follower(ranks):
    assert str(ranks[0]["raise/error"]) == "the leader failed"
    assert bool(ranks[1]["raise/follower_returned"])
    assert "raise/error" not in ranks[1]
