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
  losses, the global grad norms (``grad_norms``), the fp32 master and
  moments (the owned partition under ZeRO, the
  whole flat layout otherwise), the step, skip and loss-scale counters.
  ``runs`` lists several such runs for one process group.  With
  ``mp`` > 1 the world is dp x mp (``model_parallel_size`` in the config,
  or ``mesh`` with ``"mesh": true``): the weights are the global tree, each
  rank takes its data rank's block, and the non-ZeRO state is written per
  leaf (``master/<name>``: this model rank's local slice).  ``model``
  ``"bert"`` trains a tiny BERT with NSP on the ``batch_keys`` inputs;
  ``loader`` records the first batch the engine's data loader gives;
  ``load_error`` records the ValueError a full load raises, then loads the
  weights only.  Under ZeRO-3 the per-leaf state is the rank's shards and
  ``z3dim/<name>`` each leaf's partition dim; ``model`` ``"embedding"``
  trains ``EmbeddingClassifier`` (the sparse-gradient model, with
  ``sparse_grad_specs``), ``"bert_fp32"`` a BERT computing in fp32.
  ``save_tag`` names the save's tag; ``files`` lists the tag directory
  after the save.  With ``pp`` > 1 (``pipeline_parallel_size``, or the
  ``mesh``) the world is dp x pp x mp and ``model`` ``"pipe"`` trains
  ``GPT2Pipelined`` (``micro_batches``, ``schedule``; ``fp32_compute``
  computes in fp32); ``layers`` sets the GPT-2s' depth; every rank
  writes its local
  leaves (its stage's, and under ZeRO-1/2 its stage's whole local layout
  gathered over the data group, ``master/<name>``), ``mem/<key>`` of
  ``memory_estimate()``, the live bytes (``live/params``,
  ``live/optimizer_state``), ``held`` (1F1B's most held stage inputs),
  the topology (``topo/coords``: dp, pp, mp rank; the global ranks of
  ``topo/model``, ``topo/pipe``, ``topo/data``), the warnings the port
  logged (``warnings``) and, with ``eval``, the eval-mode loss of the
  first batch (``eval_loss``) beside the train-mode one
  (``train_loss``).  A run of ``runs`` may name another ``scenario``.
* ``sparse``: each case of ``spec["cases"]`` runs
  ``deepspeed_tpu_torch.sparse.sparse_psum`` on this rank's row of its
  input (bf16 with ``bf16``) with the case's ``max_rows`` and knobs; the
  output is ``<case>``.
* ``pipe_raw``: the schedules of ``parallel.pipeline`` alone at pp =
  world: the blocks (``blk/<name>``, cut by stage) on the micro-batches
  ``x`` with the head ``sum(y * w)`` (the inputs named by the spec's
  ``x`` and ``w``, by default ``x`` and ``w``); for each of
  ``schedules``, outputs
  ``<schedule>/loss``, ``/dx``, ``/g/<name>`` (this stage's slices) and
  ``/held``.
* ``tp_layers``: each case of ``spec["cases"]`` runs one tensor-parallel
  layer of ``deepspeed_tpu_torch.models.layers`` on this model rank's
  slices of its global inputs (the world is one model group), and the
  backward of ``sum(y * dy)``; outputs ``<case>/y`` (local) and
  ``<case>/g<i>`` (the local gradient of float argument i).
* ``seq_attn``: the world is one seq group; each case of ``spec["cases"]``
  runs ``ring_attention`` or ``ulysses_attention`` (``impl``) on this
  rank's sequence block of the global ``q``, ``k``, ``v`` (and ``mask``
  with ``masked``) of its ``input`` prefix, and the backward of ``sum(y *
  dy)``; outputs ``<case>/y`` and ``<case>/dq``, ``/dk``, ``/dv`` (this
  rank's blocks) and the attention kernels' launch counts
  (``launches/<kernel>``).  ``device`` "cuda" runs it on the card.

MoE: ``model`` ``"moe"`` trains ``GPT2MoE`` and ``"moe_pipe"``
``GPT2MoEPipelined`` (``moe_kw``: ``num_experts``, ``router_top_k``,
``capacity_factor``, ...; ``fp32_compute`` computes in fp32); at mp > 1
the experts are cut over the model group.  ``train_many`` (a K) runs the
steps in blocks of K through ``engine.train_many`` (with ``prefetch``,
fed by ``data.BlockPrefetcher``).
* ``moe_grads``: the world is one model group; each case of
  ``spec["cases"]`` builds the tiny ``GPT2MoE`` of its ``moe_kw`` from the
  inputs' weights, cuts it to this rank's experts, and runs the loss and
  its backward on the whole batch ``tokens_g``/``labels_g``; outputs
  ``<case>/loss`` and ``<case>/g/<name>`` (this rank's local gradients).
* ``fleet``: ``SimpleModel`` at dp ``world`` with the fleet view on
  (``x``/``y`` [steps, rows * world, ...]); rank 1 stalls on the host
  before step ``stall_at``; outputs ``master`` (bytes), ``dump`` (the
  flight recorder's file) and ``host_ms`` (the last window's).

With ``sp`` > 1 (``context_parallel_size``, or the ``mesh``) the train
scenario's world is dp x pp x sp x mp: every rank of a seq group takes its
data rank's rows, the engine cuts the sequence; ``topo/coords`` then ends
with the seq rank and ``topo/seq`` lists the seq group.  ``model``
``"bert_dense"`` trains a tiny fp32-computing BERT without NSP on dense
MLM labels (``ids``, ``mask``, ``tt``, ``mlm``), ``"squad"`` the tiny
span model; ``model_kw`` overrides the GPT-2s' sizes.  ``expect``
``"init"`` or ``"forward"``: the run must raise there (at
``initialize``, or in the first forward), and its only output is
``error``, the exception's type and message.
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
from deepspeed_tpu_torch import sparse, weights, zero  # noqa: E402
from deepspeed_tpu_torch.models import (  # noqa: E402
    GPT2, BertForPreTraining, BertForQuestionAnswering, GPT2MoE,
    GPT2MoEPipelined, GPT2Pipelined)
from deepspeed_tpu_torch.models import layers as L  # noqa: E402
from deepspeed_tpu_torch.models import transformer as T  # noqa: E402
from deepspeed_tpu_torch.parallel import comm, pipeline, topology  # noqa: E402

TINY = dict(vocab_size=64, max_seq_len=16, num_layers=2, hidden_size=32,
            num_heads=4, remat=False)
TINY_BERT = dict(vocab_size=64, max_seq_len=16, num_layers=2, hidden_size=32,
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


class Fp32GPT2Pipelined(GPT2Pipelined):
    """``GPT2Pipelined`` computing in fp32 whatever dtype its parameters
    hold (as ``Fp32GPT2``)."""

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


class SimpleModel(torch.nn.Module):
    """One linear layer and a cross-entropy (the JAX tests'
    ``tests/simple_model.py:SimpleModel``): ``forward(x, y)`` on float
    rows ``x`` [B, H] and int classes ``y`` [B]; ``w`` starts from a numpy
    seed."""

    def __init__(self, hidden_dim: int = 8, seed: int = 0):
        super().__init__()
        rng = np.random.default_rng(seed)
        self.w = torch.nn.Parameter(torch.from_numpy(
            (rng.normal(size=(hidden_dim, hidden_dim)) * 0.1).astype(
                np.float32)))
        self.b = torch.nn.Parameter(torch.zeros(hidden_dim))

    def forward(self, x, y):
        logits = x @ self.w.to(x.dtype) + self.b.to(x.dtype)
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.gather(logp, 1, y.long()[:, None]).mean()


def master_bytes(engine) -> bytes:
    """The fp32 masters' bytes (the owned flat partition under ZeRO-1/2,
    else every leaf in name order): what the bitwise contracts compare."""
    if engine.zero_flat:
        return engine.master_flat.detach().cpu().numpy().tobytes()
    return b"".join(engine.master[k].detach().cpu().numpy().tobytes()
                    for k in sorted(engine.master))


def _fp32_forward(base):
    """``base.forward`` computing in fp32 whatever dtype the parameters
    hold (as ``Fp32GPT2``)."""
    def forward(self, *batch):
        if self._upcast:
            return base.forward(self, *batch)
        self._upcast = True
        try:
            return torch.func.functional_call(
                self, {k: p.float() for k, p in self.named_parameters()},
                batch)
        finally:
            self._upcast = False
    return forward


class Fp32GPT2MoE(GPT2MoE):
    """``GPT2MoE`` computing in fp32 (as ``Fp32GPT2``)."""

    _upcast = False
    forward = _fp32_forward(GPT2MoE)


class Fp32GPT2MoEPipelined(GPT2MoEPipelined):
    """``GPT2MoEPipelined`` computing in fp32 (as ``Fp32GPT2``)."""

    _upcast = False
    forward = _fp32_forward(GPT2MoEPipelined)


class Fp32Bert(BertForPreTraining):
    """BERT computing in fp32 whatever dtype its parameters hold (as
    ``Fp32GPT2``)."""

    _upcast = False

    def forward(self, *batch):
        if self._upcast:
            return super().forward(*batch)
        self._upcast = True
        try:
            return torch.func.functional_call(
                self, {k: p.float() for k, p in self.named_parameters()},
                batch)
        finally:
            self._upcast = False


class EmbeddingClassifier(torch.nn.Module):
    """An untied embedding table and a linear head (the JAX tests'
    ``EmbeddingClassifier``): few rows of the table are touched a step, so
    its gradient is row-sparse; ``sparse_grad_specs`` marks it."""

    def __init__(self, vocab=512, hidden=16, classes=4):
        super().__init__()
        self.emb = torch.nn.Parameter(torch.zeros(vocab, hidden))
        self.w = torch.nn.Parameter(torch.zeros(hidden, classes))

    def forward(self, toks, labels):
        e = self.emb[toks.long()].mean(dim=1)
        logp = torch.log_softmax(e @ self.w, dim=-1)
        return -torch.gather(logp, 1, labels.long()[:, None]).mean()

    def sparse_grad_specs(self, params=None):
        return {"emb": True, "w": False}


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


def run_sparse(spec, inputs, rank, world):
    import torch.distributed as dist
    topology.init_distributed(device="cpu")
    out = {}
    for case in spec["cases"]:
        x = torch.from_numpy(np.array(inputs[case["input"]][rank]))
        if case.get("bf16"):
            x = x.to(torch.bfloat16)
        y = sparse.sparse_psum(x, dist.group.WORLD, world, case["max_rows"],
                               **case.get("kw", {}))
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
    return [np.zeros(0, np.float32) if d is None
            else zero.flatten_tree(d, meta)[:meta.total].numpy()
            for d in (engine.master, engine.opt_state.m, engine.opt_state.v)]


def _zero_leaves(engine):
    """Under ZeRO-1/2, this rank's whole local layout of the master and
    moments, its data group's partitions gathered, per leaf."""
    st, topo = engine.opt_state, engine.topology
    out = {}
    for key, part in (("master", engine.master_flat), ("m", st.m["flat"]),
                      ("v", st.v["flat"])):
        flat = comm.allgather_params(part, topo.group, engine.dp_world_size,
                                     engine.zero_pps, engine._subgroups())
        out[key] = zero.unflatten_tree(flat, engine.flat_meta)
    return out


def _leaf_state(engine):
    """The masters and moments per leaf (local slices)."""
    out = {}
    trees = (_zero_leaves(engine) if engine.zero_flat else
             {"master": engine.master, "m": engine.opt_state.m,
              "v": engine.opt_state.v})
    for key, tree in trees.items():
        if tree is not None:
            out.update({f"{key}/{k}": t.numpy().copy()
                        for k, t in tree.items()})
    return out


_LAYERS = {
    "column": lambda x, w, b, group: L.column_parallel_linear(
        x, w, b, group=group),
    "row": lambda x, w, b, group: L.row_parallel_linear(x, w, b, group=group),
    "embedding": L.vocab_parallel_embedding,
    "logits": L.vocab_parallel_logits,
    "ce": L.vocab_parallel_cross_entropy,
    "attention": lambda x, qw, qb, pw, pb, mask, group, **kw:
        L.multihead_attention(x, qw, qb, pw, pb, attn_mask=mask,
                              group=group, **kw),
}


def run_tp_layers(spec, inputs, rank, world):
    """Each case on this model rank's slices (the world is one model
    group); the backward of ``sum(y * dy)`` gives every input its true
    gradient on this rank."""
    topology.init_distributed(device="cpu")
    topo = topology.make_topology({"model_parallel_size": world}, "cpu")
    assert topo.mp == world and topo.mp_rank == rank
    out = {}

    def local(key, dim):
        x = np.array(inputs[key])
        if dim is not None:
            x = np.split(x, world, axis=dim)[rank]
        return torch.from_numpy(np.ascontiguousarray(x))

    for case in spec["cases"]:
        args = [local(k, d) for k, d in zip(case["args"], case["dims"])]
        for a in args:
            if a.is_floating_point():
                a.requires_grad_()
        y = _LAYERS[case["fn"]](*args, group=topo.model_group,
                                **case.get("kw", {}))
        dy = local(case["dy"], case["out_dim"])
        (y * dy).sum().backward()
        out[f"{case['name']}/y"] = y.detach().numpy()
        for i, a in enumerate(args):
            if a.is_floating_point():
                out[f"{case['name']}/g{i}"] = a.grad.numpy()
    return out


def run_train(spec, inputs, rank, world):
    """One engine's run (``spec``), or each of ``spec["runs"]`` in turn in
    this process, their outputs prefixed ``<i>/``."""
    if "runs" in spec:
        out = {}
        for i, run in enumerate(spec["runs"]):
            fn = {"pipe_raw": run_pipe_raw, "moe_grads": run_moe_grads}.get(
                run.get("scenario"), run_train)
            for k, v in fn(run, inputs, rank, world).items():
                out[f"{i}/{k}"] = v
        return out
    import logging
    logged = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: logged.append(record.getMessage())
    port_logger = logging.getLogger("deepspeed_tpu_torch")
    port_logger.addHandler(handler)
    try:
        out = _train(spec, inputs, rank, world)
    finally:
        port_logger.removeHandler(handler)
    out["warnings"] = np.asarray("\n".join(logged))
    return out


def _train(spec, inputs, rank, world):
    prefix = spec.get("weights", "w") + "/"
    params = weights.unflatten_tree(
        {k[len(prefix):]: inputs[k] for k in inputs.files
         if k.startswith(prefix)})
    if spec.get("model") in ("bert", "bert_fp32"):
        cls = Fp32Bert if spec["model"] == "bert_fp32" else BertForPreTraining
        model = cls.from_size("tiny", use_nsp=True, **TINY_BERT)
    elif spec.get("model") == "bert_dense":
        model = Fp32Bert.from_size("tiny", use_nsp=False, **TINY_BERT)
    elif spec.get("model") == "squad":
        model = BertForQuestionAnswering.from_size("tiny", **TINY_BERT)
    elif spec.get("model") == "embedding":
        model = EmbeddingClassifier()
    elif spec.get("model") == "moe":
        cls = Fp32GPT2MoE if spec.get("fp32_compute") else GPT2MoE
        model = cls.from_size("tiny", **dict(TINY, **spec.get("moe_kw", {})))
    elif spec.get("model") == "moe_pipe":
        cls = (Fp32GPT2MoEPipelined if spec.get("fp32_compute")
               else GPT2MoEPipelined)
        model = cls.from_size(
            "tiny", num_micro_batches=spec.get("micro_batches", 2),
            schedule=spec.get("schedule", "gpipe"),
            **dict(TINY, num_layers=spec.get("layers", TINY["num_layers"]),
                   **spec.get("moe_kw", {})))
    elif spec.get("model") == "pipe":
        cls = Fp32GPT2Pipelined if spec.get("fp32_compute") else GPT2Pipelined
        model = cls.from_size(
            "tiny", num_micro_batches=spec.get("micro_batches", 2),
            schedule=spec.get("schedule", "gpipe"),
            **dict(TINY, num_layers=spec.get("layers", TINY["num_layers"])))
    else:
        model = (Fp32GPT2 if spec.get("fp32_compute") else GPT2).from_size(
            "tiny", **dict(TINY, num_layers=spec.get("layers",
                                                     TINY["num_layers"]),
                           **spec.get("model_kw", {})))
    mp, pp, sp = spec.get("mp", 1), spec.get("pp", 1), spec.get("sp", 1)
    config, mesh = dict(spec["config"]), None
    if spec.get("mesh"):
        mesh = deepspeed_tpu_torch.MeshConfig(model_parallel_size=mp,
                                              pipeline_parallel_size=pp,
                                              context_parallel_size=sp)
    else:
        if mp > 1:
            config["model_parallel_size"] = mp
        if pp > 1:
            config["pipeline_parallel_size"] = pp
        if sp > 1:
            config["context_parallel_size"] = sp
    keys = spec.get("batch_keys", ["tokens", "labels"])
    data = None
    if spec.get("loader"):
        data = list(zip(*(inputs[k][0] for k in keys)))
    expect = spec.get("expect")
    try:
        engine, _, loader, _ = deepspeed_tpu_torch.initialize(
            config=config, model=model, model_parameters=params or None,
            param_groups=spec.get("param_groups"), device="cpu", mesh=mesh,
            training_data=data)
        if expect == "forward":
            engine(*(inputs[k][0][:engine.train_micro_batch_size_per_gpu()]
                     for k in keys))
    except Exception as e:      # the error the run expects, recorded
        if expect is None:
            raise
        return {"error": np.asarray(f"{type(e).__name__}: {e}")}
    if expect is not None:
        raise AssertionError(f"the run did not raise at {expect}")
    assert (engine.dp_world_size * mp * pp * sp == world
            and engine.global_rank == rank)
    dpr = engine.topology.dp_rank
    load_error = ""
    if spec.get("load") and spec.get("load_error"):
        # the error a load must raise, then the weights-only load
        try:
            engine.load_checkpoint(spec["load"])
        except ValueError as e:
            load_error = str(e)
        engine.load_checkpoint(spec["load"], load_optimizer_states=False)
    elif spec.get("load"):
        engine.load_checkpoint(spec["load"])
    gas = engine.gradient_accumulation_steps()
    micro = engine.train_micro_batch_size_per_gpu()
    rows = gas * micro
    losses, norms, acc_numel = [], [], 0
    inject = spec.get("inject_inf")
    first = spec.get("first_batch", 0)
    for step in range(spec["steps"]):
        batch = [inputs[k][first + step][dpr * rows:(dpr + 1) * rows]
                 for k in keys]
        if spec.get("split"):
            for i in range(gas):
                sl = slice(i * micro, (i + 1) * micro)
                loss = engine(*(x[sl] for x in batch))
                engine.backward(loss)
                acc = engine._acc
                acc_numel = (acc.numel() if isinstance(acc, torch.Tensor)
                             else sum(t.numel() for t in acc.values()))
                if (inject and inject["rank"] == rank
                        and inject["step"] == step and i == gas - 1):
                    flat = acc if isinstance(acc, torch.Tensor) else acc[
                        inject.get("leaf", next(iter(acc)))]
                    flat.view(-1)[inject.get("index", -1)] = float("inf")
                engine.step()
        elif spec.get("train_many"):
            k = spec["train_many"]
            if step % k:
                continue
            blocks = [[inputs[kk][first + s][dpr * rows:(dpr + 1) * rows]
                       for kk in keys] for s in range(step, step + k)]
            if spec.get("prefetch"):
                from deepspeed_tpu_torch.data import BlockPrefetcher
                blocks = next(iter(BlockPrefetcher(iter(blocks), k)))
            loss = engine.train_many([tuple(b) for b in blocks])
        else:
            loss = engine.train_batch(tuple(batch))
        losses.append(float(loss))
        norms.append(float(engine._last_grad_norm))
        if spec.get("save_after") == step + 1:
            path = engine.save_checkpoint(spec["save_dir"],
                                          tag=spec.get("save_tag"))
            files = "\n".join(sorted(os.listdir(path)))
    master, m, v = _flat_state(engine)
    ls = engine.loss_scale_state
    extra = ({} if engine.zero_flat and pp == 1 and not spec.get("leaves")
             else _leaf_state(engine))
    if spec.get("eval"):
        batch = [inputs[k][first][dpr * micro:(dpr + 1) * micro]
                 for k in keys]
        extra["train_loss"] = np.asarray(float(engine(*batch)))
        engine._last_loss = None
        engine.eval()
        extra["eval_loss"] = np.asarray(float(engine(*batch)))
        engine.train()
    extra.update({f"mem/{k}": np.asarray(v)
                  for k, v in engine.memory_estimate().items()})
    st = engine.opt_state
    live = [engine.master_flat] if engine.zero_flat else list(
        engine.master.values())
    for moments in (st.m, st.v):
        live += [] if moments is None else list(moments.values())
    extra["live/optimizer_state"] = np.asarray(
        sum(t.numel() * t.element_size() for t in live))
    extra["live/params"] = np.asarray(
        sum(p.numel() * p.element_size()
            for p in engine.module.parameters()))
    extra["held"] = np.asarray(getattr(engine.module, "last_pipe_stats",
                                       {}).get("max_held_inputs", -1))
    topo = engine.topology
    extra["topo/coords"] = np.asarray([topo.dp_rank, topo.pp_rank,
                                       topo.mp_rank] + (
        [topo.sp_rank] if sp > 1 else []))
    for key, group in (("model", topo.model_group),
                       ("pipe", topo.pipe_group), ("data", topo.group),
                       ("seq", topo.seq_group)):
        extra[f"topo/{key}"] = np.asarray(
            [rank] if group is None
            else torch.distributed.get_process_group_ranks(group))
    extra["schedule"] = np.asarray(getattr(engine.module, "schedule", ""))
    if engine.zero3:
        extra.update({f"z3dim/{k}": np.asarray(d)
                      for k, d in engine._zero3_dims.items()})
    if spec.get("save_after"):
        extra["files"] = np.asarray(files)
    extra.update({f"param/{k}": p.detach().float().numpy().copy()
                  for k, p in engine.module.named_parameters()})
    if loader is not None:
        extra.update({f"loader/{i}": x.numpy()
                      for i, x in enumerate(next(iter(loader)))})
    return {**extra, "load_error": np.asarray(load_error),
            "losses": np.asarray(losses), "grad_norms": np.asarray(norms),
            "master": master,
            "m": m, "v": v,
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


def run_pipe_raw(spec, inputs, rank, world):
    """The schedules alone (see the module docstring)."""
    topology.init_distributed(device="cpu")
    topo = topology.make_topology({"pipeline_parallel_size": world}, "cpu")
    pipe = pipeline.PipeContext.from_topology(topo)
    cfg = T.TransformerConfig(**spec["config"])
    x = torch.from_numpy(np.array(inputs[spec.get("x", "x")]))
    w = torch.from_numpy(np.array(inputs[spec.get("w", "w")]))
    m = x.shape[0]
    blocks = {k[4:]: torch.from_numpy(np.array(inputs[k]))
              for k in inputs.files if k.startswith("blk/")}
    blocks = weights.shard_tree(blocks, {k: 0 for k in blocks}, world,
                                pipe.stage)
    out = {}
    for schedule in spec["schedules"]:
        params = {"x": x.clone().requires_grad_()}
        params.update({f"blocks.{k}": t.clone().requires_grad_()
                       for k, t in blocks.items()})
        stats = {}
        loss = pipeline.pipeline_loss(
            pipe, schedule, params, lambda p, i: p["x"][i],
            lambda p, u: (T.stack_apply(u, T.subtree(p, "blocks"), cfg),
                          0.0),
            lambda p, y, lab: torch.sum(y * lab), w, 1.0, m,
            act_shape=x.shape[1:], act_dtype=x.dtype, replicated=["x"],
            stats=stats)
        loss.backward()
        out[f"{schedule}/loss"] = loss.detach().numpy()
        out[f"{schedule}/dx"] = params["x"].grad.numpy()
        out[f"{schedule}/held"] = np.asarray(stats["max_held_inputs"])
        out.update({f"{schedule}/g/{k[7:]}": t.grad.numpy()
                    for k, t in params.items() if k.startswith("blocks.")})
    return out


def run_moe_grads(spec, inputs, rank, world):
    """The MoE GPT-2's loss and local gradients at ep = world (see the
    module docstring)."""
    topology.init_distributed(device="cpu")
    topo = topology.make_topology({"model_parallel_size": world}, "cpu")
    out = {}
    toks, labels = (torch.from_numpy(np.array(inputs[k]))
                    for k in ("tokens_g", "labels_g"))
    for case in spec["cases"]:
        prefix = case.get("weights", "w") + "/"
        model = GPT2MoE.from_size("tiny", **dict(TINY, **case["moe_kw"]))
        weights.params_from_numpy(model, weights.unflatten_tree(
            {k[len(prefix):]: inputs[k] for k in inputs.files
             if k.startswith(prefix)}))
        model.validate(world)
        weights.shard_module_(model, model.partition_specs(), world, rank)
        model.model_group = topo.model_group
        loss = model(toks, labels)
        loss.backward()
        out[f"{case['name']}/loss"] = loss.detach().numpy()
        out.update({f"{case['name']}/g/{k}": p.grad.numpy()
                    for k, p in model.named_parameters()})
    return out


def run_seq_attn(spec, inputs, rank, world):
    """Ring or Ulysses attention on this rank's sequence blocks (see the
    module docstring)."""
    from deepspeed_tpu_torch.models.ring_attention import ring_attention
    from deepspeed_tpu_torch.models.ulysses import ulysses_attention
    device = torch.device(spec.get("device", "cpu"))
    topology.init_distributed(device=device, backend="gloo")
    topo = topology.make_topology({"context_parallel_size": world}, device)
    assert topo.sp == world and topo.sp_rank == rank
    out = {}

    def block(key):
        x = np.array(inputs[key])
        n = x.shape[1] // world
        return torch.from_numpy(np.ascontiguousarray(
            x[:, rank * n:(rank + 1) * n])).to(device)

    for case in spec["cases"]:
        pre = case["input"]
        q, k, v = (block(f"{pre}/{n}").requires_grad_() for n in "qkv")
        mask = block(f"{pre}/mask") if case.get("masked") else None
        if case["impl"] == "ring":
            y = ring_attention(q, k, v, causal=case["causal"], kv_mask=mask,
                               group=topo.seq_group)
        else:
            y = ulysses_attention(q, k, v, causal=case["causal"],
                                  attn_mask=mask, group=topo.seq_group)
        (y.float() * block(f"{pre}/dy")).sum().backward()
        name = case["name"]
        out[f"{name}/y"] = y.detach().float().cpu().numpy()
        for n, t in zip("qkv", (q, k, v)):
            out[f"{name}/d{n}"] = t.grad.float().cpu().numpy()
    from deepspeed_tpu_torch.ops import block_attention, stream_attention
    for mod in (stream_attention, block_attention):
        out.update({f"launches/{k}": np.asarray(n)
                    for k, n in mod.LAUNCHES.items()})
    return out


def run_fleet(spec, inputs, rank, world):
    """The fleet view across the ranks: ``SimpleModel`` at dp ``world``,
    ``spec["steps"]`` train_batch steps on this rank's rows with
    ``report_window`` 2 and the fleet on (each rank's JSONL log path under
    ``spec["work"]``; only rank 0 writes one); rank 1 stalls
    ``spec["stall_s"]`` on the host (the chaos stall point) before step
    ``spec["stall_at"]``; each rank dumps its flight recorder ("fleet")."""
    from deepspeed_tpu_torch.observability import flightrec
    from deepspeed_tpu_torch.resilience import chaos
    work = spec["work"]
    rows = spec["rows"]
    cfg = {"train_batch_size": rows * world, "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Adam", "params": {"lr": 0.02}},
           "observability": {
               "report_window": 2, "fleet": True, "fleet_wait_s": 60.0,
               "jsonl_path": os.path.join(work, f"events_{rank}.jsonl"),
               "flight_recorder_dir": work}}
    engine = deepspeed_tpu_torch.initialize(
        model=SimpleModel(hidden_dim=8), config=cfg, device="cpu")[0]
    if rank == 1:
        chaos.configure(stall_step=spec["stall_at"], stall_s=spec["stall_s"])
    x, y = inputs["x"], inputs["y"]
    for i in range(spec["steps"]):
        engine.train_batch((
            torch.from_numpy(x[i, rank * rows:(rank + 1) * rows]),
            torch.from_numpy(y[i, rank * rows:(rank + 1) * rows])))
    engine.flush_telemetry()
    path = flightrec.RECORDER.dump("fleet")
    return {"master": np.frombuffer(master_bytes(engine), np.uint8),
            "dump": np.asarray(path),
            "host_ms": np.asarray(
                engine.telemetry.last_window_event["host_ms"])}


def main():
    spec_path, rank = pathlib.Path(sys.argv[1]), int(sys.argv[2])
    spec = json.loads(spec_path.read_text())
    world = int(os.environ["DSTPU_NUM_PROCESSES"])
    torch.set_num_threads(1)
    inputs = np.load(spec["inputs"])
    run = {"comm": run_comm, "train": run_train, "sparse": run_sparse,
           "tp_layers": run_tp_layers, "seq_attn": run_seq_attn,
           "pipe_raw": run_pipe_raw, "moe_grads": run_moe_grads,
           "fleet": run_fleet}[
        spec["scenario"]]
    out = run(spec, inputs, rank, world)
    np.savez(spec_path.parent / f"out_{rank}.npz", **out)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
