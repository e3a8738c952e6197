"""Sequence-parallel training of the port against the JAX engine at sp 2.

The port trains on two gloo CPU ranks, one seq group
(``tests/torch_rank_worker.py``: each rank takes the whole rows and the
engine cuts its block of the sequence); the JAX engine on its virtual CPU
mesh (``make_mesh(context_parallel_size=sp)``).  Both start from the same
numpy weights of the tiny GPT-2 (2 layers, hidden 32, 4 heads, seq 16) and
take the same batches, 3 steps, gas 2, fp32, Adam; the labels' last
position is ignored, so the blocks hold different valid counts and the
loss's count must be summed over the seq group.

* Ring and Ulysses at sp 2 against the JAX engine at sp 1 and (ring) at
  sp 2: losses and global grad norms within ``rtol=2e-4, atol=2e-5`` (the
  JAX ``test_sp_matrix`` tolerance: the ring folds its blocks in another
  order), the masters within ``rtol=1e-4, atol=1e-6``.
* The split API against the fused ``train_batch`` (``rtol=2e-5``, the
  JAX ``test_sp_fused_train_batch``), and gas 2 against gas 1 on the same
  8 rows (first update, ``rtol=1e-5, atol=1e-6``, the JAX
  ``test_sp_gas_scan``).
* BERT (no NSP, dense MLM labels, padded keys, so the ring's mask rotates)
  at sp 2 against the JAX BERT at sp 1, as GPT-2.  Its three refusals
  under sp > 1 (masked-positions MLM, NSP, the span logits), a model
  without ``batch_specs`` and an unknown ``sp_impl`` raise the JAX
  package's errors; ``memory_estimate()`` at sp 2 equals the JAX
  engine's.
* Checkpoints: seq ranks are replicas, so an sp 2 save is the files of an
  sp 1 save (same names, same byte counts), and each loads at the other
  sp, continuing within the trajectory tolerance; the JAX engine at sp 2
  loads the port's sp 2 save and the port at sp 2 the JAX engine's.
* Remat: the ring under ``"full"`` and Ulysses under ``"selective"``
  rematerialisation replay their shifts and all-to-alls in the backward,
  and equal the runs without remat bitwise (the same fp32 ops).
* The ``sequence_parallel_impl`` override acts on the engine's copy of
  the model (the JAX ``test_impl_override_does_not_mutate_shared_model``).
"""

import functools
import json
import os

import jax
import numpy as np
import pytest

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.config import DeepSpeedConfigError as JaxConfigError
from deepspeed_tpu.models import BertForPreTraining as JBert
from deepspeed_tpu.models import GPT2 as JGPT2
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu_torch import weights
from deepspeed_tpu_torch.config import DeepSpeedConfig, DeepSpeedConfigError
from deepspeed_tpu_torch.models import GPT2
from torch_rank_worker import TINY, TINY_BERT
from torch_ranks import run_ranks

SP, MICRO, GAS, STEPS, SAVE_AT = 2, 2, 2, 3, 2
VOCAB, SEQ = TINY["vocab_size"], TINY["max_seq_len"]
RTOL, ATOL = 2e-4, 2e-5
STATE_RTOL, STATE_ATOL = 1e-4, 1e-6
BERT_DENSE = ["ids", "mask", "tt", "mlm"]
MEM_KEYS = ("params_bytes", "optimizer_state_bytes",
            "grad_accumulator_bytes", "total_persistent_bytes", "n_params",
            "zero_stage")


def config(gas=GAS, micro=MICRO, **extra):
    cfg = {"train_batch_size": micro * gas,
           "gradient_accumulation_steps": gas,
           "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Adam",
                         "params": {"lr": 1e-3, "eps": 1e-6}}}
    cfg.update(extra)
    return cfg


def gpt2_params():
    jm = JGPT2.from_size("tiny", **TINY)
    return jax.tree_util.tree_map(np.asarray,
                                  jm.init_params(jax.random.PRNGKey(7)))


def bert_params():
    jm = JBert.from_size("tiny", **TINY_BERT)
    return jax.tree_util.tree_map(np.asarray,
                                  jm.init_params(jax.random.PRNGKey(5)))


def data(seed=0):
    rng = np.random.default_rng(seed)
    rows = MICRO * GAS
    toks = rng.integers(0, VOCAB, (STEPS, rows, SEQ)).astype(np.int32)
    labels = np.roll(toks, -1, axis=2)
    labels[..., -1] = -1
    ids = rng.integers(0, VOCAB, (STEPS, rows, SEQ)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[:, 0, SEQ - 5:] = 0
    mlm = np.where(rng.random(ids.shape) < 0.3, ids, -1).astype(np.int32)
    mlm[mask == 0] = -1
    pos = np.tile(np.arange(4, dtype=np.int32), (STEPS, rows, 1))
    return {"tokens": toks, "labels": labels, "ids": ids, "mask": mask,
            "tt": np.zeros_like(ids), "mlm": mlm, "pos": pos,
            "mlm_ids": np.take_along_axis(ids, pos, axis=2),
            "mlm_w": np.ones((STEPS, rows, 4), np.float32),
            "nsp": rng.integers(0, 2, (STEPS, rows)).astype(np.int32),
            "start": rng.integers(0, SEQ, (STEPS, rows)).astype(np.int32),
            "end": rng.integers(0, SEQ, (STEPS, rows)).astype(np.int32)}


def jax_run(sp, cfg, steps=STEPS, model="gpt2", keys=("tokens", "labels")):
    """The JAX engine's losses, grad norms, masters and memory estimate at
    sp (dp 1), computed once per module and arguments."""
    return _jax_run(sp, json.dumps(cfg, sort_keys=True), steps, model,
                    tuple(keys))


@functools.lru_cache(maxsize=None)
def _jax_run(sp, cfg, steps, model, keys):
    cfg = json.loads(cfg)
    jm = (JGPT2.from_size("tiny", **TINY) if model == "gpt2"
          else JBert.from_size("tiny", **TINY_BERT))
    params = gpt2_params() if model == "gpt2" else bert_params()
    engine, _, _, _ = deepspeed_tpu.initialize(
        config=cfg, model=jm, model_parameters=params,
        mesh=make_mesh(context_parallel_size=sp, devices=jax.devices()[:sp]))
    d = data()
    losses, norms = [], []
    for i in range(steps):
        losses.append(float(engine.train_batch(tuple(d[k][i] for k in keys))))
        norms.append(float(engine._last_grad_norm))
    master = weights.flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                         engine.master))
    return {"losses": losses, "grad_norms": norms, "master": master,
            "mem": engine.memory_estimate()}


def port_sp1(steps, save_dir=None, load_dir=None, first=0):
    """The port at sp 1 in this process: its losses (and a save after
    ``SAVE_AT`` steps, or a load before the first)."""
    engine = deepspeed_tpu_torch.initialize(
        config=config(), model=GPT2.from_size("tiny", **TINY),
        model_parameters=gpt2_params(), device="cpu")[0]
    if load_dir is not None:
        engine.load_checkpoint(load_dir)
    d = data()
    losses = []
    for i in range(first, first + steps):
        losses.append(float(engine.train_batch((d["tokens"][i],
                                                d["labels"][i]))))
        if save_dir is not None and i + 1 == SAVE_AT:
            engine.save_checkpoint(save_dir)
    return losses


def _sizes(path):
    return {f: os.path.getsize(os.path.join(path, f))
            for f in sorted(os.listdir(path))}


RUNS = {
    "ring": dict(config=config(), weights="g", save_after=SAVE_AT),
    "ulysses": dict(config=config(sequence_parallel_impl="ulysses"),
                    weights="g"),
    "split": dict(config=config(), weights="g", split=True),
    "gas1": dict(config=config(gas=1, micro=MICRO * GAS), weights="g",
                 steps=1),
    "gas2": dict(config=config(), weights="g", steps=1),
    "bert": dict(config=config(), weights="b", model="bert_dense",
                 batch_keys=BERT_DENSE),
    "load": dict(config=config(), weights="g", steps=1, first_batch=SAVE_AT),
    "load_jax": dict(config=config(), weights="g", steps=1,
                     first_batch=SAVE_AT),
    "ring_full": dict(config=config(activation_checkpointing={
        "enabled": True, "policy": "full"}), weights="g"),
    "ulysses_selective": dict(config=config(
        sequence_parallel_impl="ulysses", activation_checkpointing={
            "enabled": True, "policy": "selective"}), weights="g"),
    # the refusals, each at the point the JAX package raises it
    "nsp": dict(config=config(), model="bert", expect="forward",
                batch_keys=BERT_DENSE + ["nsp"]),
    "positions": dict(config=config(), model="bert", expect="forward",
                      batch_keys=["ids", "mask", "tt", "pos", "mlm_ids",
                                  "mlm_w"]),
    "span": dict(config=config(), model="squad", expect="forward",
                 batch_keys=["ids", "mask", "tt", "start", "end"]),
    "no_batch_specs": dict(config=config(), model="embedding",
                           expect="init"),
    "unknown_impl": dict(config=config(), model_kw={"sp_impl": "spiral"},
                         expect="forward"),
}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """One launch of two ranks at sp 2 with every run of ``RUNS``; the sp 1
    save the "load" run reads is made first, in this process."""
    work = tmp_path_factory.mktemp("sp_train")
    sp1_dir, sp2_dir = str(work / "sp1"), str(work / "sp2")
    jax_dir = str(work / "jax")
    sp1 = port_sp1(STEPS, save_dir=sp1_dir)
    jax_next = jax_sp2_save(jax_dir)
    inputs = {f"g/{k}": v for k, v in
              weights.flatten_tree(gpt2_params()).items()}
    inputs.update({f"b/{k}": v for k, v in
                   weights.flatten_tree(bert_params()).items()})
    inputs.update(data())
    runs = []
    for name, run in RUNS.items():
        run = dict(run, sp=SP, steps=run.get("steps", STEPS))
        if name == "ring":
            run["save_dir"] = sp2_dir
        if name == "load":
            run["load"] = sp1_dir
        if name == "load_jax":
            run["load"] = jax_dir
        if run["steps"] and "expect" in run:
            run["steps"] = 0
        runs.append(run)
    outs = run_ranks(work / "ranks", SP,
                     {"scenario": "train", "runs": runs}, inputs)
    per = {name: [{k.split("/", 1)[1]: v for k, v in o.items()
                   if k.startswith(f"{i}/")} for o in outs]
           for i, name in enumerate(RUNS)}
    return {"runs": per, "sp1": sp1, "sp1_dir": sp1_dir, "sp2_dir": sp2_dir,
            "jax_next": jax_next}


def jax_engine_sp2(key=7):
    jm = JGPT2.from_size("tiny", **TINY)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init_params(jax.random.PRNGKey(key)))
    return deepspeed_tpu.initialize(
        config=config(), model=jm, model_parameters=params,
        mesh=make_mesh(context_parallel_size=SP,
                       devices=jax.devices()[:SP]))[0]


def jax_sp2_save(save_dir):
    """The JAX engine at sp 2: ``SAVE_AT`` steps, a save into
    ``save_dir``, and its loss on the next batch."""
    engine, d = jax_engine_sp2(), data()
    for i in range(SAVE_AT):
        engine.train_batch((d["tokens"][i], d["labels"][i]))
    engine.save_checkpoint(save_dir)
    return float(engine.train_batch((d["tokens"][SAVE_AT],
                                     d["labels"][SAVE_AT])))


def assert_run(outs, want, rtol=RTOL, atol=ATOL):
    """Both seq ranks report the same loss and norm (the seq mean; the
    gradients agree after their seq sum), close to ``want``'s, and their
    masters are equal and close to ``want``'s."""
    for o in outs[1:]:
        np.testing.assert_array_equal(o["losses"], outs[0]["losses"])
        np.testing.assert_array_equal(o["grad_norms"], outs[0]["grad_norms"])
        np.testing.assert_array_equal(o["master"], outs[0]["master"])
    np.testing.assert_allclose(outs[0]["losses"], want["losses"], rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(outs[0]["grad_norms"], want["grad_norms"],
                               rtol=rtol, atol=atol)
    got = {k.split("/", 1)[1]: v for k, v in outs[0].items()
           if k.startswith("master/")}
    for name, w in want["master"].items():
        np.testing.assert_allclose(got[name], w, rtol=STATE_RTOL,
                                   atol=STATE_ATOL, err_msg=name)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_gpt2_sp2_matches_jax_sp1_and_sp2(port, impl):
    outs = port["runs"][impl]
    assert [list(o["topo/coords"]) for o in outs] == [[0, 0, 0, r]
                                                     for r in range(SP)]
    assert all(list(o["topo/seq"]) == list(range(SP)) for o in outs)
    # at sp 1 the JAX engine runs no sequence-parallel attention
    assert_run(outs, jax_run(1, config()))
    if impl == "ring":
        assert_run(outs, jax_run(SP, config()))
        # the port at sp 1 takes the same trajectory
        np.testing.assert_allclose(outs[0]["losses"], port["sp1"],
                                   rtol=RTOL, atol=ATOL)


def test_split_api_and_gas_match_fused(port):
    runs = port["runs"]
    np.testing.assert_allclose(runs["split"][0]["losses"],
                               runs["ring"][0]["losses"], rtol=2e-5,
                               atol=2e-6)
    for a, b in zip(runs["gas1"], runs["gas2"]):
        np.testing.assert_allclose(a["master"], b["master"], rtol=1e-5,
                                   atol=1e-6)


def test_bert_dense_mlm_sp2_matches_jax_sp1(port):
    assert_run(port["runs"]["bert"],
               jax_run(1, config(), model="bert", keys=BERT_DENSE))


@pytest.mark.parametrize("name,match", [
    ("nsp", "NotImplementedError: NSP pools the global"),
    ("positions", "NotImplementedError: masked-positions MLM gathers"),
    ("span", "NotImplementedError: span extraction softmaxes"),
    ("no_batch_specs", "DeepSpeedConfigError: context_parallel_size > 1 "
                       "requires the model to declare batch_specs"),
    ("unknown_impl", "ValueError: unknown sequence_parallel_impl 'spiral'"),
])
def test_refusals_raise_the_jax_errors(port, name, match):
    for o in port["runs"][name]:
        assert str(o["error"]).startswith(match), str(o["error"])


def test_memory_estimate_equals_jax(port):
    want = jax_run(SP, config(), steps=0)["mem"]
    for o in port["runs"]["ring"]:
        assert {k: int(o[f"mem/{k}"]) for k in MEM_KEYS} == {
            k: int(want[k]) for k in MEM_KEYS}


def test_sp2_save_is_the_sp1_save_and_loads_both_ways(port):
    tag = f"global_step{SAVE_AT}"
    sp2 = _sizes(os.path.join(port["sp2_dir"], tag))
    assert sp2 == _sizes(os.path.join(port["sp1_dir"], tag))
    assert list(sp2) == ["mp_rank_00_model_states.pt"]
    ring = port["runs"]["ring"][0]["losses"]
    # sp 2 -> sp 1, and sp 1 -> sp 2: the step after the save
    resumed = port_sp1(1, load_dir=port["sp2_dir"], first=SAVE_AT)
    np.testing.assert_allclose(resumed, ring[SAVE_AT:], rtol=RTOL,
                               atol=ATOL)
    for o in port["runs"]["load"]:
        np.testing.assert_allclose(o["losses"], port["sp1"][SAVE_AT:],
                                   rtol=RTOL, atol=ATOL)
    # across the packages at sp 2, both ways: the same state, the same
    # next step
    for o in port["runs"]["load_jax"]:
        np.testing.assert_allclose(o["losses"], [port["jax_next"]],
                                   rtol=RTOL, atol=ATOL)
    engine, d = jax_engine_sp2(key=8), data()
    engine.load_checkpoint(port["sp2_dir"], tag=f"global_step{SAVE_AT}")
    np.testing.assert_allclose(
        float(engine.train_batch((d["tokens"][SAVE_AT],
                                  d["labels"][SAVE_AT]))),
        ring[SAVE_AT], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("remat,impl", [("ring_full", "ring"),
                                        ("ulysses_selective", "ulysses")])
def test_remat_replays_the_seq_collectives(port, remat, impl):
    for a, b in zip(port["runs"][remat], port["runs"][impl]):
        np.testing.assert_array_equal(a["losses"], b["losses"])
        np.testing.assert_array_equal(a["master"], b["master"])


def test_impl_override_does_not_mutate_shared_model():
    model = GPT2.from_size("tiny", **TINY)
    engine = deepspeed_tpu_torch.initialize(
        config=config(sequence_parallel_impl="ulysses"), model=model,
        device="cpu")[0]
    assert model.config.sp_impl == "ring"
    assert engine.module.config.sp_impl == "ulysses"
    assert engine.module is not model
    # no override: the engine keeps the caller's model
    other = GPT2.from_size("tiny", **TINY)
    assert deepspeed_tpu_torch.initialize(
        config=config(), model=other, device="cpu")[0].module is other


def test_config_rejects_unknown_impl_as_jax():
    cfg = config(sequence_parallel_impl="spiral")
    with pytest.raises(JaxConfigError) as want:
        deepspeed_tpu.config.DeepSpeedConfig(cfg)
    with pytest.raises(DeepSpeedConfigError) as got:
        DeepSpeedConfig(cfg)
    assert str(got.value) == str(want.value)
