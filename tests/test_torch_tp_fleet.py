"""Several serving replicas at model_parallel_size 2 on the port against
the JAX package's fleet.

Every replica takes the same two gloo CPU ranks, as the JAX engine takes
the first two devices for each: every rank builds the same engines in one
order and serves them through ``inference.lead_fleet`` (the router and its
driver threads on model rank 0, a follower thread per engine on rank 1).
One ``run_ranks`` launch of ``tests/torch_rank_worker.py``'s ``tp_fleet``
scenario holds every mode.  The JAX side runs ``run_fleet`` over JAX
engines at mp 2 (two of the rig's CPU devices each), both on the same
numpy weights of ``tests/test_torch_tp_serving.py``'s tiny GPT-2 in fp32:

* mixed: two replicas; greedy tokens identical; ``requests``,
  ``tokens_out``, the chips counted (the sum of the replicas' mp),
  handoffs and evictions equal;
* affinity: that file's shared-prefix trace; tokens, affinity hits and
  whether a pool reused a prefix equal (as ``tests/test_torch_router.py``
  holds them at mp 1);
* disaggregated: one prefill and one decode replica; tokens and handoffs
  equal; one exported prompt's K and V equal to the JAX mp-2 export at
  ``atol=1e-5``;
* mixed degrees: a prefill at mp 2 with a decode at mp 1 on the leader,
  and the reverse; tokens equal to the JAX fleet of the same degrees;
* eviction: a chaos stall of one replica under a 1 s serve watchdog; one
  eviction, the mixed tokens, the evicted driver thread stopped and the
  follower threads returned;
* raise: the leader raises inside ``lead_fleet``; every follower returns;
* a world other than mp is refused on every rank, naming the layout;
* the command lock: leader threads sending commands while another thread
  closes the engine (a short switch interval) lose or cross none: every
  rank ran as many programs as the leader's threads saw return, and each
  thread ends on the stopped engine's error.

The JAX engines (three, module-scoped) run in this process.
"""

import json

import numpy as np
import pytest

import jax

from deepspeed_tpu.inference import InferenceEngine as JEngine
from deepspeed_tpu.inference import Request as JRequest
from deepspeed_tpu.inference import run_fleet as jrun_fleet
from deepspeed_tpu.inference import synthetic_requests as jsynthetic
from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2
from deepspeed_tpu_torch import weights
from test_torch_tp_serving import MP, PREFIX_TRACE, PROMPTS, SERVE, TINY, TRACE
from torch_ranks import run_ranks

#: the eviction run's serve watchdog: far above a tiny decode's
#: milliseconds, so that only the injected stall fires it
WATCHDOG_S = 1.0
MODES = ["mixed", "affinity", "disaggregated", "md21", "md12"]
#: leader threads sending commands while another thread closes the engine
RACE_THREADS = 4


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        JGPT2.from_size("tiny", **TINY).init_params(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def ranks(params, tmp_path_factory):
    """Both ranks' outputs of the one launch."""
    work = tmp_path_factory.mktemp("tp_fleet")
    spec = {"scenario": "tp_fleet", "model_kw": TINY, "serve": SERVE,
            "trace": TRACE, "prefix_trace": PREFIX_TRACE,
            "prompts": PROMPTS, "watchdog_s": WATCHDOG_S,
            "race_threads": RACE_THREADS, "race_s": 0.5, "work": str(work)}
    inputs = {f"w/{k}": v for k, v in weights.flatten_tree(params).items()}
    return run_ranks(work, MP, spec, inputs, timeout=240)


@pytest.fixture(scope="module")
def leader(ranks):
    return ranks[0]


def _jbuild(params, mp):
    return JEngine(JGPT2.from_size("tiny", **TINY), config={
        "train_micro_batch_size_per_gpu": 1, "model_parallel_size": mp,
        "inference": {**SERVE, "fleet": {"disaggregate": True}}},
        params=params)


def _tokens(results):
    return {r.rid: list(r.tokens) for r in results}


@pytest.fixture(scope="module")
def jax_fleet(params):
    """The JAX fleet's ``(tokens, summary)`` by mode (the port's ``a``,
    ``b`` and ``m`` are ``ja``, ``jb`` and ``jm``) and ``ja``'s export."""
    ja, jb, jm = _jbuild(params, MP), _jbuild(params, MP), _jbuild(params, 1)

    def fleet(engines, requests, prefill=(), **kw):
        for e in list(engines) + list(prefill):
            e.reset()
        res = jrun_fleet(engines, requests, prefill_engines=prefill,
                         poll_s=0.02, **kw)
        return _tokens(res["results"]), res["summary"]

    out = {"mixed": fleet([ja, jb], jsynthetic(**TRACE)),
           "affinity": fleet([ja, jb], [
               JRequest(rid=i, prompt=list(p), max_new_tokens=n)
               for i, (p, n) in enumerate(PREFIX_TRACE)], affinity=True)}
    out["affinity_reused"] = sum(e.pool.tokens_reused for e in (ja, jb)) > 0
    out["disaggregated"] = fleet([ja], jsynthetic(**TRACE), prefill=[jb])
    out["md21"] = fleet([jm], jsynthetic(**TRACE), prefill=[jb])
    out["md12"] = fleet([jb], jsynthetic(**TRACE), prefill=[jm])
    ja.reset()
    ja.admit(0, PROMPTS[0], 4)
    out["export"] = ja.export_kv(0)
    ja.reset()
    return out


def _mine(leader, mode):
    tokens = {int(k): v for k, v in
              json.loads(str(leader[f"{mode}/tokens"])).items()}
    return tokens, json.loads(str(leader[f"{mode}/summary"]))


def _chips(summary):
    """The chips a summary counted: its tokens/s over its tokens/s a chip."""
    return round(summary["tokens_per_sec"]
                 / summary["tokens_per_sec_per_chip"])


COUNTERS = ("requests", "tokens_out", "handoffs", "evictions", "resubmits",
            "n_replicas", "prefill_replicas")


@pytest.mark.parametrize("mode", MODES)
def test_fleet_matches_jax_at_mp2(leader, jax_fleet, mode):
    """Tokens and the router's counters equal the JAX fleet's, mode by
    mode; a fleet arrangement is invisible in the tokens."""
    mine, summary = _mine(leader, mode)
    want, jsummary = jax_fleet[mode]
    assert len(mine) and all(mine.values())
    assert mine == want
    assert {k: summary[k] for k in COUNTERS} == \
        {k: jsummary[k] for k in COUNTERS}
    assert _chips(summary) == _chips(jsummary)
    if mode != "affinity":
        assert mine == jax_fleet["mixed"][0]
    if mode == "mixed":
        assert summary["handoffs"] == summary["evictions"] == 0
        assert _chips(summary) == 2 * MP
    if mode == "affinity":
        assert summary["affinity_hits"] == jsummary["affinity_hits"] > 0
        assert jax_fleet["affinity_reused"]
        assert bool(leader["affinity/reused"])
    if mode in ("disaggregated", "md21", "md12"):
        assert summary["handoffs"] == TRACE["n"]
    if mode in ("md21", "md12"):
        assert _chips(summary) == MP + 1


def test_export_kv_matches_jax_mp2(leader, jax_fleet):
    jk, jv, jn = jax_fleet["export"]
    assert jn == len(PROMPTS[0])
    np.testing.assert_allclose(leader["export_k"], jk, atol=1e-5)
    np.testing.assert_allclose(leader["export_v"], jv, atol=1e-5)


def test_eviction_leaves_no_follower_behind(ranks, leader, jax_fleet):
    mine, summary = _mine(leader, "eviction")
    assert mine == jax_fleet["mixed"][0]
    assert summary["evictions"] == 1 and 1 <= summary["resubmits"]
    assert json.loads(str(leader["eviction/evicted_thread_alive"])) == \
        [False]
    assert bool(leader["eviction/stopped"])
    assert all(bool(r[f"{name}/follower_returned"]) for r in ranks[1:]
               for name in ("modes", "eviction"))


def test_leader_exception_returns_every_follower(ranks):
    assert str(ranks[0]["raise/error"]) == "the leader failed"
    assert all(bool(r["raise/follower_returned"]) for r in ranks[1:])
    assert all("raise/error" not in r for r in ranks[1:])


def test_a_world_other_than_mp_is_refused(ranks):
    """An engine at mp 4 in a world of 2 is refused on every rank, naming
    the layout: every replica takes exactly mp ranks."""
    for r in ranks:
        msg = str(r["refused"])
        assert "a process group of 2 ranks at model_parallel_size=4" in msg
        assert "every replica takes the same 4 ranks" in msg


def test_commands_never_cross_the_stop(ranks, leader):
    sent = int(leader["race/sent"])
    assert sent > 0 and int(leader["race/alive"]) == 0
    assert [int(r["race/done"]) for r in ranks] == [sent] * MP
    errors = json.loads(str(leader["race/errors"]))
    assert len(errors) == RACE_THREADS
    assert all("followers were stopped" in e for e in errors)
    assert all(bool(r["race/follower_returned"]) for r in ranks[1:])
