"""The engine's public surface against the JAX engine's: the config
getters, ``memory_estimate()`` and the package's ``init_distributed``.

``memory_estimate()`` runs on two gloo CPU ranks (``tests/
torch_rank_worker.py``): the tiny 4-layer GPT-2 of ``tests/
test_torch_pipeline.py`` in bf16 at dp 2 with ZeRO stages 0-3, and the
pipelined GPT-2 at pp 2; the JAX engine on its CPU mesh of the same
layout (``make_mesh(devices=jax.devices()[:2])``, and
``pipeline_parallel_size=2`` for the pipeline).  Every key must be equal
on every rank: the counts are exact.  Each estimate is also held to the
port's own live tensors, as ``tests/test_zero_memory.py`` holds the JAX
engine's: the parameters, the fp32 masters and moments (the owned
partition under ZeRO-1/2, the shards under ZeRO-3), and the accumulator
``backward()`` leaves for ``step()`` (under ZeRO-1 a flat buffer with the
layout's padding, which the estimate, like the JAX engine's, leaves out).
"""

import jax
import pytest

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import GPT2 as JGPT2
from deepspeed_tpu.models import GPT2Pipelined as JGPT2Pipelined
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu_torch import weights
from deepspeed_tpu_torch.models import GPT2
from test_torch_pipeline import TINY4, config, init_params, lm_data
from torch_ranks import run_ranks

KEYS = ("params_bytes", "optimizer_state_bytes", "grad_accumulator_bytes",
        "total_persistent_bytes", "n_params", "zero_stage")
CASES = {f"zero{z}": z for z in range(4)}
CASES["pp2"] = None


def case_config(name):
    z = CASES[name]
    extra = {} if not z else {"zero_optimization": {"stage": z}}
    return config(prec="bf16", **extra)


def case_run(name):
    run = {"name": name, "layers": 4, "steps": 1, "split": True,
           "config": case_config(name)}
    if name == "pp2":
        run.update(model="pipe", pp=2, micro_batches=2)
    return run


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    toks, labels = lm_data()
    inputs = {f"w/{k}": v for k, v in
              weights.flatten_tree(init_params()).items()}
    inputs.update(tokens=toks, labels=labels)
    runs = [case_run(name) for name in CASES]
    outs = run_ranks(tmp_path_factory.mktemp("engine_api"), 2,
                     {"scenario": "train", "runs": runs}, inputs)
    return {name: [{k.split("/", 1)[1]: v for k, v in o.items()
                    if k.startswith(f"{i}/")} for o in outs]
            for i, name in enumerate(CASES)}


def jax_estimate(name):
    if name == "pp2":
        model = JGPT2Pipelined.from_size("tiny", num_micro_batches=2,
                                         **TINY4)
        mesh = make_mesh(pipeline_parallel_size=2, devices=jax.devices()[:2])
    else:
        model = JGPT2.from_size("tiny", **TINY4)
        mesh = make_mesh(devices=jax.devices()[:2])
    engine, _, _, _ = deepspeed_tpu.initialize(
        config=case_config(name), model=model,
        model_parameters=init_params(), mesh=mesh)
    return engine.memory_estimate()


@pytest.mark.parametrize("name", list(CASES))
def test_memory_estimate_equals_jax(port, name):
    want = jax_estimate(name)
    for o in port[name]:
        assert {k: int(o[f"mem/{k}"]) for k in KEYS} == {
            k: int(want[k]) for k in KEYS}


@pytest.mark.parametrize("name", list(CASES))
def test_memory_estimate_matches_live_bytes(port, name):
    for o in port[name]:
        est = {k: int(o[f"mem/{k}"]) for k in KEYS}
        assert est["params_bytes"] == int(o["live/params"])
        assert est["optimizer_state_bytes"] == int(
            o["live/optimizer_state"])
        acc = 4 * int(o["acc_numel"])
        if name == "zero1":
            assert acc == 4 * int(o["padded"])
            assert est["grad_accumulator_bytes"] == 2 * est["params_bytes"]
        else:
            assert est["grad_accumulator_bytes"] == acc
    # the partitioned stages keep less than the replicated one
    stage0 = int(port["zero0"][0]["mem/optimizer_state_bytes"])
    assert int(port["zero1"][0]["mem/optimizer_state_bytes"]) < stage0
    assert int(port["pp2"][0]["mem/params_bytes"]) < int(
        port["zero0"][0]["mem/params_bytes"])


GETTERS = ("tensorboard_enabled", "sparse_gradients_enabled",
           "postscale_gradients", "gradient_predivide_factor")


@pytest.fixture(scope="module")
def engines():
    cfg = config(prescale_gradients=True, gradient_predivide_factor=4.0,
                 sparse_gradients=True)
    port = deepspeed_tpu_torch.initialize(
        config=cfg, model=GPT2.from_size("tiny", **TINY4),
        model_parameters=init_params(), device="cpu")[0]
    ref, _, _, _ = deepspeed_tpu.initialize(
        config=cfg, model=JGPT2.from_size("tiny", **TINY4),
        model_parameters=init_params(),
        mesh=make_mesh(devices=jax.devices()[:1]))
    return port, ref


@pytest.mark.parametrize("getter", GETTERS)
def test_getters_match_jax(engines, getter):
    port, ref = engines
    assert getattr(port, getter)() == getattr(ref, getter)()


def test_init_distributed_is_the_packages(monkeypatch):
    """``deepspeed_tpu_torch.init_distributed`` forwards to the topology's,
    and without a coordinator at one process it starts nothing."""
    from deepspeed_tpu_torch.parallel import topology
    import torch.distributed as dist
    seen = []
    real = topology.init_distributed
    monkeypatch.setattr(topology, "init_distributed",
                        lambda **kw: seen.append(kw))
    deepspeed_tpu_torch.init_distributed(coordinator_address="host:1",
                                         num_processes=2, process_id=1)
    assert seen == [dict(coordinator_address="host:1", num_processes=2,
                         process_id=1, use_mpi=False, device=None,
                         backend=None)]
    monkeypatch.setattr(topology, "init_distributed", real)
    for var in ("DSTPU_COORDINATOR", "DSTPU_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    assert deepspeed_tpu_torch.init_distributed() is None
    assert not dist.is_initialized()
