"""One rank of a multi-process CPU run of the PyTorch port (gloo).

Started by ``tests/torch_ranks.py:run_ranks`` as ``python
tests/torch_rank_worker.py <spec.json> <rank>``, once per rank, with the
JAX package's launch contract in the environment (``DSTPU_COORDINATOR`` a
``file://`` rendezvous, ``DSTPU_NUM_PROCESSES``, ``DSTPU_PROCESS_ID``).
It imports torch and the port only (never jax), reads its inputs from the
spec's ``inputs`` npz, runs the spec's scenario and writes its results to
``out_<rank>.npz`` beside the spec.

Scenarios:

* ``comm``: each case of ``spec["cases"]`` calls one function of
  ``deepspeed_tpu_torch.parallel.comm`` on this rank's row of the case's
  input; the output is ``<case name>``.
* ``train``: tiny GPT-2 from the inputs' weights through
  ``deepspeed_tpu_torch.initialize`` (the process group started by the
  engine from the environment), ``steps`` optimizer steps on this rank's
  block of each global batch (``train_batch``, or the split API with
  ``split``), optionally an inf injected into one rank's gradient, a save
  after ``save_after`` steps, a load before the first step.  Outputs: the
  losses, the fp32 master and moments (the owned partition under ZeRO, the
  whole flat layout otherwise), the step, skip and loss-scale counters.
  ``runs`` lists several such runs for one process group.
"""

import json
import os
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu_torch import weights, zero  # noqa: E402
from deepspeed_tpu_torch.models import GPT2  # noqa: E402
from deepspeed_tpu_torch.parallel import comm, topology  # noqa: E402

TINY = dict(vocab_size=64, max_seq_len=16, num_layers=2, hidden_size=32,
            num_heads=4, remat=False)


class Fp32GPT2(GPT2):
    """GPT-2 whose forward computes in fp32 whatever dtype its parameters
    hold: the bf16/fp16 weights are upcast on entry, and the grads reach
    them rounded to that dtype (as in the tests' JAX counterpart)."""

    _upcast = False

    def forward(self, tokens, labels):
        if self._upcast:
            return super().forward(tokens, labels)
        self._upcast = True
        try:
            return torch.func.functional_call(
                self, {k: p.float() for k, p in self.named_parameters()},
                (tokens, labels))
        finally:
            self._upcast = False


def _subgroups(world, pps, rank):
    """This rank's (within, across) gloo groups; every rank creates all."""
    topo = topology.Topology(device=torch.device("cpu"), rank=rank, dp=world,
                             group=torch.distributed.group.WORLD, pps=world)
    topo = topo.with_subgroups(pps)
    return (topo.within, topo.across)


def run_comm(spec, inputs, rank, world):
    import torch.distributed as dist
    topology.init_distributed(device="cpu")
    group = dist.group.WORLD
    subgroups = {}
    out = {}
    for case in spec["cases"]:
        pps = case.get("pps")
        if pps is not None and pps != world and pps not in subgroups:
            subgroups[pps] = _subgroups(world, pps, rank)
        sub = subgroups.get(pps)
        x = torch.from_numpy(np.array(inputs[case["input"]][rank]))
        if case.get("dtype") == "bf16":
            x = x.to(torch.bfloat16)
        kw = dict(case.get("kw", {}))
        fn = case["fn"]
        if fn == "allreduce_grads":
            n = x.numel() // 3
            res = comm.allreduce_grads({"a": x[:n].clone(), "b": x[n:]},
                                       group, world, **kw)
            y = torch.cat([res["a"], res["b"]])
        elif fn == "reduce_scatter_grads":
            y = comm.reduce_scatter_grads(x, group, world, subgroups=sub,
                                          partition_group_size=pps, **kw)
        elif fn == "reduce_scatter_grads_bucketed":
            part = x.numel() // (pps or world)
            bounds = comm.bucket_bounds(part, case["bucket"])
            y = comm.reduce_scatter_grads_bucketed(
                x, group, world, bounds, subgroups=sub,
                partition_group_size=pps, **kw)
        elif fn == "allgather_partition_bucket":
            y = comm.allgather_partition_bucket(x, group, world, pps, sub)
        elif fn == "allgather_params":
            y = comm.allgather_params(x, group, world, pps, sub)
        elif fn == "finish_subgroup_reduce":
            y = comm.finish_subgroup_reduce(x, world, pps, sub)
        elif fn == "overflow_any":
            y = comm.overflow_any(bool(x[0] > 0), group).reshape(1)
        else:
            raise ValueError(fn)
        out[case["name"]] = y.float().numpy()
    return out


def _flat_state(engine):
    """(master, m, v) as flat fp32 numpy: the owned partition under ZeRO,
    the whole layout in the JAX leaf order otherwise."""
    if engine.zero_flat:
        st = engine.opt_state
        return [t.numpy().copy() for t in (engine.master_flat, st.m["flat"],
                                           st.v["flat"])]
    meta = zero.make_flat_meta(engine.master, 1)
    return [zero.flatten_tree(d, meta)[:meta.total].numpy()
            for d in (engine.master, engine.opt_state.m, engine.opt_state.v)]


def run_train(spec, inputs, rank, world):
    """One engine's run (``spec``), or each of ``spec["runs"]`` in turn in
    this process, their outputs prefixed ``<i>/``."""
    if "runs" in spec:
        out = {}
        for i, run in enumerate(spec["runs"]):
            for k, v in run_train(run, inputs, rank, world).items():
                out[f"{i}/{k}"] = v
        return out
    prefix = spec.get("weights", "w") + "/"
    params = weights.unflatten_tree(
        {k[len(prefix):]: inputs[k] for k in inputs.files
         if k.startswith(prefix)})
    model = (Fp32GPT2 if spec.get("fp32_compute") else GPT2).from_size(
        "tiny", **TINY)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        config=spec["config"], model=model, model_parameters=params,
        param_groups=spec.get("param_groups"), device="cpu")
    assert engine.dp_world_size == world and engine.global_rank == rank
    if spec.get("load"):
        engine.load_checkpoint(spec["load"])
    gas = engine.gradient_accumulation_steps()
    micro = engine.train_micro_batch_size_per_gpu()
    rows = gas * micro
    losses, acc_numel = [], 0
    inject = spec.get("inject_inf")
    first = spec.get("first_batch", 0)
    for step in range(spec["steps"]):
        toks = inputs["tokens"][first + step][rank * rows:(rank + 1) * rows]
        labels = inputs["labels"][first + step][rank * rows:
                                                (rank + 1) * rows]
        if spec.get("split"):
            for i in range(gas):
                sl = slice(i * micro, (i + 1) * micro)
                loss = engine(toks[sl], labels[sl])
                engine.backward(loss)
                acc = engine._acc
                acc_numel = (acc.numel() if isinstance(acc, torch.Tensor)
                             else sum(t.numel() for t in acc.values()))
                if (inject and inject["rank"] == rank
                        and inject["step"] == step and i == gas - 1):
                    flat = acc if isinstance(acc, torch.Tensor) else next(
                        iter(acc.values()))
                    flat.view(-1)[inject.get("index", -1)] = float("inf")
                engine.step()
        else:
            loss = engine.train_batch((toks, labels))
        losses.append(float(loss))
        if spec.get("save_after") == step + 1:
            engine.save_checkpoint(spec["save_dir"])
    master, m, v = _flat_state(engine)
    ls = engine.loss_scale_state
    return {"losses": np.asarray(losses), "master": master, "m": m, "v": v,
            "step": np.asarray(engine.opt_state.step),
            "skipped": np.asarray(engine.skipped_steps),
            "global_steps": np.asarray(engine.global_steps),
            "cur_scale": np.asarray(float(ls.cur_scale)),
            "cur_hysteresis": np.asarray(int(ls.cur_hysteresis)),
            "acc_numel": np.asarray(acc_numel),
            "partition": np.asarray(engine.flat_meta.partition
                                    if engine.zero_flat else 0),
            "padded": np.asarray(engine.flat_meta.padded
                                 if engine.zero_flat else 0)}


def main():
    spec_path, rank = pathlib.Path(sys.argv[1]), int(sys.argv[2])
    spec = json.loads(spec_path.read_text())
    world = int(os.environ["DSTPU_NUM_PROCESSES"])
    torch.set_num_threads(1)
    inputs = np.load(spec["inputs"])
    run = {"comm": run_comm, "train": run_train}[spec["scenario"]]
    out = run(spec, inputs, rank, world)
    np.savez(spec_path.parent / f"out_{rank}.npz", **out)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
