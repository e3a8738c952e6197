"""The serving engine: checkpoint -> tokens.

The port of ``deepspeed_tpu/inference/engine.py`` for one model replica.
``InferenceEngine`` loads a training checkpoint's weights through
``checkpoint.load_params_only`` (the module file only, streamed by the
restore plan's ``checkpoint.restore_threads`` readers; the ZeRO partition
files stay unread), or takes a JAX-layout tree (``params=``), or builds
the model's own init from ``seed``; it optionally int8-quantizes them on
the host (``inference/quant.py``), places them on the device in the
serving dtype, and sizes a refcounted KV page pool
(``inference/kvcache.py``).  Its programs are eager PyTorch over the
model's ``apply_extend`` / ``apply_decode``, which write the pool in
place:

* **prefill**: the extend program for one request at the prefill bucket
  width: the whole prompt at ``start`` 0, or after a prefix-cache hit only
  the tail at ``start`` = the reused tokens; a narrower tail bucket
  (``prefill_tail``) serves short tails;
* **decode**: one token step over every slot (the scheduler owns
  eviction), or ``decode_many``: D greedy iterations with the argmax, the
  EOS and the budget masks on the device and one host read per D;
* **spec_step**: J greedy draft steps, a width-(J+1) target verify
  through the extend path and the longest agreeing prefix, on the device,
  one host read per iteration; the emitted tokens equal target-only
  greedy decode by construction;
* **copy_page**: the ring layout's copy-on-write of a shared page;
* **export_kv / import_kv** (``inference.fleet.disaggregate``): a slot's
  written K/V rows read off the card for a prefill->decode handoff, and
  written into fresh pages of another replica's pool (``index_copy_``).

The JAX engine jits these programs; on the card each is captured here as
a CUDA graph (``_GraphedStep``) at its first call, one per program and
shape: the decode step of the target and of the draft, the extend at each
bucket width and the verify, so that a step costs one launch instead of
the ~1,900 of its 24 eager layers.  ``DSTPU_SERVE_GRAPHS=0`` runs them
eagerly, as the CPU always does.  A fused program runs the serial
program's step, so its per-row arithmetic is the serial one's.  Nothing
reads the card between the D iterations of ``decode_many`` or inside the
speculative step: the tokens come back in one counted fence
(``observability/fences.py``).

One engine is one replica; replicas go behind ``inference/router.py``'s
``FleetRouter``.  At ``model_parallel_size`` mp > 1 a replica is mp
processes, one per model rank, in a started process group of exactly mp
ranks (``parallel/topology.make_serving_topology``: the model group, dp
1, and a gloo control group on CPU tensors).  Several replicas take the
same mp ranks, as the JAX engine takes the first mp devices for each:
every rank builds them in one order, each with its own model and control
groups, and rank m holds model rank m of every replica.  Each rank holds
its slice of the weights (``partition_specs``; int8 quantized on the
global tree, then cut, so every rank has the same scales) and its
``heads / mp`` KV heads.  Model rank 0 is the leader: it alone runs the
page pool, the prefix index, the scheduler and the host positions, and
every public method that touches the card first sends its command and
host inputs (tokens, rows, slot, start, page ids, K/V rows) to the
followers, which run the same program on their slices in ``follow()``
until the leader's ``close()``.  ``lead(fn)`` runs ``fn(engine)`` on the
leader and stops the followers in a ``finally``; on a follower it runs
the loop.  ``lead_fleet(engines, fn)`` does so for several replicas: the
leader runs ``fn(engines)`` (the router and its driver threads), a
follower runs each engine's loop on a thread of its own.  A per-engine
command lock covers a command's broadcast with the program it starts, and
the stop: one engine's command stream never interleaves, whichever
threads drive and close it.  The programs run the model with its model
group; the logits a host reads come back over the whole vocabulary,
gathered on every rank, so the device argmax of the fused programs (ties
to the lowest index) gives every rank the same tokens without another
message.  A gloo model group cannot be captured in a CUDA graph, so at
mp > 1 the programs run eagerly.  ``export_kv`` returns the global heads
and ``import_kv`` takes them, so handoffs cross model-parallel degrees.

Graph lint and the static analyses (``run_graph_lint``, ``plan_capacity``,
``plan_dispatch``, ``run_stability``, ``predict_executables``) trace every
program production can dispatch once, fake (``analysis/graph.py``): the
build gates them per the config's ``graph_lint`` / ``analysis`` sections
(``error`` raises before the first request), on every model rank, the
ranks exchanging their collectives over the control group; after build
the leader's ``run_graph_lint`` sends its command like any other.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import socket
import threading
import time
from contextlib import nullcontext
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from deepspeed_tpu_torch import checkpoint
from deepspeed_tpu_torch import weights as weights_mod
from deepspeed_tpu_torch.analysis import lockwatch
from deepspeed_tpu_torch.config import DeepSpeedConfig, DeepSpeedConfigError
from deepspeed_tpu_torch.inference import kvcache, quant
from deepspeed_tpu_torch.observability import fences as obs_fences
from deepspeed_tpu_torch.observability.flightrec import RECORDER as _RECORDER
from deepspeed_tpu_torch.observability.tracing import annotate
from deepspeed_tpu_torch.parallel import comm
from deepspeed_tpu_torch.parallel.topology import (make_serving_topology,
                                                   resolve_device)
from deepspeed_tpu_torch.resilience import chaos as _chaos

logger = logging.getLogger(__name__)

_DTYPES = {
    "float32": torch.float32, "fp32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float16": torch.float16, "fp16": torch.float16,
}


def _resolve_dtype(name):
    try:
        return _DTYPES[str(name).strip().lower()]
    except KeyError:
        raise DeepSpeedConfigError(
            f"inference.dtype must be one of {sorted(set(_DTYPES))}, "
            f"got {name!r}")


def _map_tree(tree, fn):
    return {k: _map_tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _tree_leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tree_leaves(v)
        else:
            yield v


class _GraphedStep:
    """``fn(*inputs) -> outputs`` (tensors, fixed shapes) as a CUDA graph:
    the first call copies the inputs into static buffers, runs ``fn`` once
    on a side stream (the capture's warm-up) and captures it; every call
    then copies its inputs in and replays.  The outputs are the graph's
    own tensors, overwritten by the next replay.  ``fn`` must be
    idempotent on its state (the serving programs are: a replay after the
    warm-up writes the same K/V rows again).  Every warm-up and capture
    of the process on one device runs on one stream (:attr:`streams`): a
    stream's first matrix products allocate its cuBLAS workspaces for
    good, so one stream holds one set."""

    #: device -> the warm-up and capture stream (made at its first capture)
    streams: dict = {}

    def __init__(self, fn):
        self.fn = fn
        self.graph = None
        self.inputs = self.outputs = None

    def __call__(self, *inputs):
        if self.graph is None:
            self.inputs = [t.clone() for t in inputs]
            dev = inputs[0].device
            side = _GraphedStep.streams.get(dev)
            if side is None:
                side = _GraphedStep.streams[dev] = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.fn(*self.inputs)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            # thread_local: another thread's CUDA call (a telemetry drain)
            # during the capture is not an error
            with torch.cuda.graph(self.graph, stream=side,
                                  capture_error_mode="thread_local"):
                self.outputs = self.fn(*self.inputs)
        else:
            for buf, t in zip(self.inputs, inputs):
                buf.copy_(t)
        self.graph.replay()
        return self.outputs


def seeded_params(model, seed: int) -> dict:
    """The model's own initialisation from ``seed`` as a JAX-layout tree of
    CPU tensors: a fresh module of the model's class and config, built on
    the CPU by a generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    fresh = type(model)(model.config, generator=gen, device="cpu")
    return weights_mod.unflatten_tree(
        {n: p.detach() for n, p in fresh.named_parameters()})


class InferenceEngine:
    """Checkpoint-to-tokens serving engine: one replica, on one device per
    model rank."""

    def __init__(self, model, config=None, params=None,
                 checkpoint_dir: Optional[str] = None,
                 tag: Optional[str] = None, seed: int = 0,
                 draft_model=None, draft_params=None, device=None):
        if model is None:
            raise ValueError("InferenceEngine: model is required")
        self.module = model
        self._built_ts = time.time()
        self.restore_seconds = None
        self.first_token_ts = None
        self.first_dispatch_s = None

        cfg_src = config if config is not None else {}
        if isinstance(cfg_src, str):
            with open(cfg_src) as f:
                cfg_src = json.load(f)
        cfg_src = dict(cfg_src)
        # serving needs no batch triangle; satisfy the training config's
        # invariant with a unit micro batch when none is declared
        if not any(k in cfg_src for k in (
                "train_batch_size", "train_micro_batch_size_per_gpu")):
            cfg_src["train_micro_batch_size_per_gpu"] = 1
        self.config = DeepSpeedConfig(cfg_src, dp_world_size=1)
        self.device = resolve_device(device)

        from deepspeed_tpu_torch.utils import compile_cache as _compile_cache
        self.compile_cache_dir = _compile_cache.enable_from_config(
            self.config)
        # the serving mesh is the model group: dp 1 (data parallelism in
        # serving is replicas behind the router, not a mesh axis)
        self.mp_world_size = int(self.config.model_parallel_size or 1)
        self.serving = (make_serving_topology(self.mp_world_size,
                                              self.device)
                        if self.mp_world_size > 1 else None)
        self.model_group = (self.serving.model_group
                            if self.serving is not None else None)
        self.mp_rank = (self.serving.mp_rank
                        if self.serving is not None else 0)
        self._stopped = False
        # one command at a time: its broadcast with the program it starts,
        # or the stop (a driver thread and a closing thread share the
        # control group, and a broadcast of an object is two collectives)
        self._command_lock = lockwatch.named_lock("InferenceEngine._command")
        # the programs' CUDA graphs by (program, shape); None runs eagerly
        self._graphs, self.graphs_off_because = self._graph_mode()
        validate_fn = getattr(model, "validate", None)
        if validate_fn is not None:
            validate_fn(self.mp_world_size)

        self.compute_dtype = _resolve_dtype(self.config.inference_dtype)
        self.quantize = self.config.inference_quantize

        # ---- weights: the checkpoint / a host tree / the seeded init ----
        host = self._host_tree(model, checkpoint_dir, tag, params, seed,
                               stream="serve")
        if checkpoint_dir is not None:
            self.loaded_tag, host = host
        else:
            self.loaded_tag = None
        specs = model.partition_specs()
        if self.quantize == "int8":
            # on the global tree, then cut: every model rank has the same
            # per-output-channel scales, which the row-parallel products
            # need (they dequantize each partial before the sum)
            host = quant.quantize_tree(host, self.compute_dtype)
            specs = quant.quantize_specs(specs)
        self._param_specs = specs
        self.params = self._place(self._shard(host, specs))
        # this rank's bytes (the JAX engine's per-device count)
        self.weight_bytes = self._tree_bytes(self.params)
        del host

        # ---- the KV page pool ----
        max_tokens = (self.config.inference_max_tokens
                      or getattr(model.config, "max_seq_len", 1024))
        max_seq = getattr(model.config, "max_seq_len", None)
        if max_seq is not None:
            # rows past max_seq_len are never written (the schedulers
            # refuse requests beyond it): do not price them
            max_tokens = min(int(max_tokens), int(max_seq))
        auto = self.config.inference_max_slots in (0, None)
        hbm_bytes, used = (self._device_budget() if auto
                           and self.device.type == "cuda" else (None, 0))
        self.cache_spec = kvcache.spec_from_model(
            model, self.mp_world_size,
            slots=self.config.inference_max_slots,
            max_tokens=max_tokens, dtype=self.compute_dtype,
            layout=self.config.inference_kv_layout,
            page_tokens=self.config.inference_page_tokens,
            pool_pages=self.config.inference_pool_pages,
            hbm_bytes=hbm_bytes, weight_bytes=used)
        if auto and self.serving is not None:
            # every model rank must hold the same slots: the fewest any
            # rank's share of its card allows
            slots = torch.tensor([self.cache_spec.slots])
            dist.all_reduce(slots, op=dist.ReduceOp.MIN,
                            group=self.serving.control_group)
            self.cache_spec = dataclasses.replace(self.cache_spec,
                                                  slots=int(slots))
        # the default bucket: the capacity, clipped to the position range
        default_bucket = (min(self.cache_spec.capacity, int(max_seq))
                          if max_seq is not None
                          else self.cache_spec.capacity)
        self.prefill_bucket = (self.config.inference_prefill_bucket
                               or default_bucket)
        if self.prefill_bucket > self.cache_spec.capacity:
            raise DeepSpeedConfigError(
                f"inference.prefill_bucket ({self.prefill_bucket}) cannot "
                f"exceed the per-slot cache capacity "
                f"({self.cache_spec.capacity})")
        if max_seq is not None and self.prefill_bucket > max_seq:
            raise DeepSpeedConfigError(
                f"inference.prefill_bucket ({self.prefill_bucket}) exceeds "
                f"the model's max_seq_len ({max_seq})")

        # ---- prefix reuse: the page table and the narrow tail bucket ----
        self.prefix_reuse = bool(self.config.inference_prefix_reuse)
        tail = int(self.config.inference_tail_bucket
                   or self.cache_spec.page_tokens)
        self.tail_bucket = (min(tail, self.prefill_bucket)
                            if self.prefix_reuse
                            and min(tail, self.prefill_bucket)
                            < self.prefill_bucket else 0)
        # the host scheduler state lives on the leader only
        self.pool = (kvcache.PagePool(self.cache_spec) if self.is_leader
                     else None)
        self._host_pos = np.zeros((self.cache_spec.slots,), np.int64)
        self._cache = kvcache.init_cache(self.cache_spec, self.device)
        self._rows_src = None
        self._rows_dev = None

        # ---- speculative decoding: the draft model and its plain pool ----
        self.spec_draft_tokens = int(
            self.config.inference_spec_draft_tokens)
        self.draft_model = None
        self.draft_params = None
        self.draft_weight_bytes = 0
        self.draft_cache_spec = None
        self._draft_cache = None
        self._draft_rows = None
        if self.spec_draft_tokens > 0:
            self._init_draft(draft_model, draft_params, seed)

        self.decode_iters_per_dispatch = int(
            self.config.inference_decode_iters_per_dispatch)
        # prefill/decode disaggregation: export_kv / import_kv exist only
        # when the config declares the fleet disaggregated
        self.fleet_disaggregate = bool(
            self.config.inference_fleet_disaggregate)
        self._warned_fused_fallback = False
        # replica observability hooks (inference/observability.py): a
        # watchdog attached here arms around every dispatch; the decode
        # dispatch counter feeds the breadcrumbs and the chaos stall point
        self.watchdog = None
        self.decode_dispatches = 0
        # graph lint and the planners: every program traced once, gated
        self._serve_traces = None
        self._gate_programs()

    # ------------------------------------------------------------ helpers
    @property
    def num_slots(self) -> int:
        return self.cache_spec.slots

    @property
    def is_leader(self) -> bool:
        """Model rank 0: the rank that serves (always, at mp 1)."""
        return self.mp_rank == 0

    @property
    def graphs(self) -> bool:
        """Whether the programs run as CUDA graphs."""
        return self._graphs is not None

    def _graph_mode(self):
        """``(graphs dict or None, why they are off or None)``.  A gloo
        model group stages its collectives through the host, which a
        CUDA graph cannot capture; capturing NCCL collectives is untried
        (it waits for a machine with two cards), so at mp > 1 the
        programs run eagerly, and ``DSTPU_SERVE_GRAPHS=1`` there raises."""
        asked = os.environ.get("DSTPU_SERVE_GRAPHS")
        if self.device.type != "cuda":
            return None, "cpu"
        if self.serving is not None:
            why = f"{dist.get_backend(self.model_group)} model group"
            if asked == "1":
                raise RuntimeError(
                    f"DSTPU_SERVE_GRAPHS=1 at model_parallel_size "
                    f"{self.mp_world_size}: the programs cannot be CUDA "
                    f"graphs over a {why} (capturing the collectives "
                    f"waits for two cards, ROADMAP.md); unset it")
            return None, why
        if asked == "0":
            return None, "DSTPU_SERVE_GRAPHS=0"
        return {}, None

    def _shard(self, tree, specs):
        """This model rank's slice of the global ``tree``."""
        if self.serving is None:
            return tree
        return weights_mod.shard_tree(tree, specs, self.mp_world_size,
                                      self.mp_rank)

    def _device_budget(self):
        """``(bytes, bytes in use)`` that "auto" slots size against: the
        card's memory and what is already allocated on it (the weights).
        Model ranks that share one card (a gloo model group on one
        device) each take their share of both: ``mem_get_info`` sees
        every rank's allocations, so it is read after all of them placed
        their weights."""
        if self.serving is None:
            free, total = torch.cuda.mem_get_info(self.device)
            return total, total - free
        group = self.serving.control_group
        dist.barrier(group=group)
        free, total = torch.cuda.mem_get_info(self.device)
        props = torch.cuda.get_device_properties(self.device)
        card = (socket.gethostname(), str(getattr(props, "uuid",
                                                  self.device.index)))
        cards = [None] * self.mp_world_size
        dist.all_gather_object(cards, card, group=group)
        share = cards.count(card)
        return total // share, (total - free) // share

    def _host_tree(self, model, checkpoint_dir, tag, params, seed, stream):
        """The JAX-layout tree of ``model``'s weights, floating leaves in
        the compute dtype (what int8 quantizes, as in the JAX engine):
        ``(tag, tree)`` from ``checkpoint_dir`` (timed), else the tree from
        ``params`` (numpy or tensors, on any device), else the model's init
        from ``seed``."""
        cfg = self.config
        if checkpoint_dir is not None:
            t0 = time.perf_counter()
            loaded = checkpoint.load_params_only(
                checkpoint_dir, tag=tag, specs=model.partition_specs(),
                dtype=self.compute_dtype,
                threads=cfg.checkpoint_restore_threads,
                readahead_mb=cfg.checkpoint_restore_readahead_mb,
                io_retries=cfg.resilience_io_retries)
            if loaded is None:
                raise FileNotFoundError(
                    f"no valid checkpoint under {checkpoint_dir!r}")
            seconds = time.perf_counter() - t0
            if stream == "serve":
                self.restore_seconds = seconds
                from deepspeed_tpu_torch.resilience import COUNTERS
                COUNTERS.restore_seconds = seconds
            logger.info("%s restore: tag %s in %.2fs (params only)", stream,
                        loaded[0], seconds)
            return loaded
        if params is None:
            params = seeded_params(model, seed)

        def leaf(l):
            t = l if isinstance(l, torch.Tensor) else torch.tensor(
                np.asarray(l))
            return t.to(self.compute_dtype) if t.is_floating_point() else t
        return _map_tree(params, leaf)

    def _place(self, host):
        """The host tree on the device: floating leaves in the compute
        dtype (an int8 tree's scales already are), int8 payloads as
        they are.  A rank's slice gets its own contiguous storage, so the
        global tree is not kept alive on the CPU."""
        def leaf(t):
            dtype = (self.compute_dtype if t.is_floating_point()
                     else t.dtype)
            out = t.detach().to(device=self.device, dtype=dtype)
            if self.serving is not None and out.data_ptr() == t.data_ptr():
                out = out.clone()
            return out.contiguous()
        return _map_tree(host, leaf)

    @staticmethod
    def _tree_bytes(tree) -> int:
        return int(sum(t.numel() * t.element_size()
                       for t in _tree_leaves(tree)))

    def _init_draft(self, draft_model, draft_params, seed: int):
        """The speculative draft: a small model of the target's vocabulary,
        its weights from ``draft_params``, a second ``load_params_only``
        stream (``speculative.draft_checkpoint``) or its init from ``seed
        + 1``, and a plain per-slot pool (an identity page table; the
        draft never shares pages).  The draft is never quantized: its
        proposals only gate acceptance, the emitted tokens are the
        target's."""
        cfg = self.config
        if draft_model is None:
            size = cfg.inference_spec_draft_size
            if not size:
                raise DeepSpeedConfigError(
                    "inference.speculative.draft_tokens > 0 needs a draft "
                    "model: pass draft_model= or set "
                    "inference.speculative.draft_size (docs/inference.md)")
            from deepspeed_tpu_torch.models.gpt2 import GPT2
            tgt = self.module.config
            draft_model = GPT2.from_size(
                size, vocab_size=tgt.vocab_size, max_seq_len=tgt.max_seq_len,
                device="meta")
        self.draft_model = draft_model
        validate_fn = getattr(draft_model, "validate", None)
        if validate_fn is not None:
            validate_fn(self.mp_world_size)
        dvocab = getattr(draft_model.config, "vocab_size", None)
        tvocab = getattr(self.module.config, "vocab_size", None)
        if dvocab != tvocab:
            raise DeepSpeedConfigError(
                f"draft model vocab ({dvocab}) must equal the target's "
                f"({tvocab}) — speculative acceptance compares token ids")
        ck = (None if draft_params is not None
              else cfg.inference_spec_draft_checkpoint)
        dhost = self._host_tree(draft_model, ck,
                                cfg.inference_spec_draft_tag, draft_params,
                                seed + 1, stream="draft")
        if ck is not None:
            dhost = dhost[1]
        self.draft_params = self._place(
            self._shard(dhost, draft_model.partition_specs()))
        self.draft_weight_bytes = self._tree_bytes(self.draft_params)
        self.draft_cache_spec = kvcache.spec_from_model(
            draft_model, self.mp_world_size, slots=self.cache_spec.slots,
            max_tokens=self.cache_spec.capacity, dtype=self.compute_dtype,
            layout="paged", page_tokens=self.cache_spec.page_tokens)
        self._draft_cache = kvcache.init_cache(self.draft_cache_spec,
                                               self.device)
        cap = self.draft_cache_spec.capacity
        self._draft_rows = torch.arange(
            self.cache_spec.slots * cap, dtype=torch.int32,
            device=self.device).reshape(self.cache_spec.slots, cap)[
                :, :self.cache_spec.capacity]

    def _dev(self, x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device)

    def _rows(self) -> torch.Tensor:
        """The page table's [slots, capacity] row map on the device,
        uploaded again only after the table changed."""
        return self._rows_from(self._rows_changed())

    def _rows_changed(self):
        """The leader's page-table row map when it changed since the last
        upload, else None (the programs' copy is current)."""
        rows = self.pool.rows()
        if rows is self._rows_src:
            return None
        self._rows_src = rows
        return rows

    def _rows_from(self, rows) -> torch.Tensor:
        """The row map on the device, replaced by ``rows`` when given."""
        if rows is not None:
            self._rows_dev = self._dev(rows, torch.int32)
        return self._rows_dev

    # ------------------------------------------------ leader and followers
    # dstpu-thread: driver
    def _run(self, cmd: str, **args):
        """Program ``cmd`` on the host inputs ``args`` (numbers, numpy
        arrays, CPU tensors): at mp > 1 the leader first sends ``(cmd,
        args)`` to the followers, then every rank runs ``_do_<cmd>``, all
        under the command lock (a stop cannot fall between the two)."""
        if self.serving is None:
            return getattr(self, f"_do_{cmd}")(**args)
        if not self.is_leader:
            raise RuntimeError(
                f"model rank {self.mp_rank} is a follower: it serves "
                f"through follow(), the leader (model rank 0) calls "
                f"the engine")
        with self._command_lock:
            if self._stopped:
                raise RuntimeError("the followers were stopped (close())")
            self._command((cmd, args))
            return getattr(self, f"_do_{cmd}")(**args)

    def _command(self, msg=None):
        """The leader's ``msg`` on every rank of the control group."""
        box = [msg]
        # model rank 0 is global rank 0: every replica takes ranks 0..mp-1
        dist.broadcast_object_list(box, src=0,
                                   group=self.serving.control_group)
        return box[0]

    def follow(self) -> None:
        """A follower's loop: run each command the leader sends on this
        rank's slices, until the leader's stop."""
        if self.serving is None or self.is_leader:
            raise RuntimeError("follow() runs on a follower (model rank "
                               "> 0 at model_parallel_size > 1)")
        while True:
            cmd, args = self._command()
            if cmd == "stop":
                return
            getattr(self, f"_do_{cmd}")(**args)

    # dstpu-thread: closer
    def close(self) -> None:
        """Stop the followers (the leader, once; nothing at mp 1 or on a
        follower).  The engine serves no more after it.  Under the command
        lock: a command in flight ends first, and a driver thread that
        comes later finds the engine stopped."""
        if self.serving is None or not self.is_leader:
            return
        with self._command_lock:
            if self._stopped:
                return
            self._stopped = True
            self._command(("stop", {}))

    def lead(self, fn):
        """``fn(self)`` on the leader, the followers stopped in a
        ``finally`` (an exception on the leader never leaves a follower
        waiting for a command); the follower loop on a follower, which
        returns None.  The one-engine case of :func:`lead_fleet`."""
        return lead_fleet([self], lambda engines: fn(engines[0]))

    def _full_vocab(self, logits):
        """Vocab-sharded logits [..., vocab / mp] joined over the model
        group into the whole vocabulary, on every rank."""
        return comm.model_all_gather(logits, -1, self.model_group)

    def _program(self, key, fn, *inputs):
        """``fn(*inputs)``: eagerly, or through the CUDA graph of ``key``
        and the inputs' shapes."""
        if self._graphs is None:
            return fn(*inputs)
        key = (key,) + tuple(tuple(t.shape) for t in inputs)
        if key not in self._graphs:
            self._graphs[key] = _GraphedStep(fn)
        return self._graphs[key](*inputs)

    def _extend_fn(self, draft: bool):
        """The extend program: this rank's vocab slice of the logits
        [B, E, vocab / mp]."""
        model = self.draft_model if draft else self.module
        params = self.draft_params if draft else self.params
        cache = self._draft_cache if draft else self._cache
        group = self.model_group

        def extend(tokens, start, n_new, rows):
            model.model_group = group
            return model.apply_extend(params, tokens, cache["k"], cache["v"],
                                      start, n_new, rows)[0]
        return extend

    def _decode_fn(self, draft: bool):
        """The decode step: this rank's vocab slice of the logits [B,
        vocab / mp] and the advanced positions."""
        model = self.draft_model if draft else self.module
        params = self.draft_params if draft else self.params
        cache = self._draft_cache if draft else self._cache
        ring = False if draft else self.cache_spec.ring
        group = self.model_group

        def step(tokens, active, rows, pos):
            model.model_group = group
            logits, _, _, pos2 = model.apply_decode(
                params, tokens, cache["k"], cache["v"], pos, active, rows,
                ring=ring)
            return logits, pos2
        return step

    def capture_programs(self) -> None:
        """Capture every program this engine serves with as its CUDA graph
        now (a no-op eagerly): the extend at each bucket width, the decode
        step, and with a draft its decode, its extend and the verify.  The
        inputs point every K/V write at the drop row and activate no slot,
        so the pools, the positions and the page table are untouched.  A
        capture must not overlap another thread's CUDA work on the
        device, so replicas sharing a card capture here, one after the
        other, before their driver threads start (``FleetRouter.start``)."""
        if self._graphs is None:
            return
        dev, spec = self.device, self.cache_spec
        slots = spec.slots

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def drop(n, pool_spec, cap):
            return torch.full((n, cap), pool_spec.pool_rows,
                              dtype=torch.int32, device=dev)

        rows1 = drop(1, spec, spec.capacity)
        for bucket in {self.prefill_bucket, self.tail_bucket} - {0}:
            self._program(("extend", False), self._extend_fn(False),
                          zeros(1, bucket, dtype=torch.int64), zeros(1),
                          zeros(1), rows1)
        self._program(("decode", False), self._decode_fn(False),
                      zeros(slots, dtype=torch.int64),
                      zeros(slots, dtype=torch.bool),
                      drop(slots, spec, spec.capacity), zeros(slots))
        if self.draft_model is not None:
            dspec = self.draft_cache_spec
            drows = drop(slots, dspec, self._draft_rows.shape[1])
            self._program(("extend", True), self._extend_fn(True),
                          zeros(1, self.prefill_bucket, dtype=torch.int64),
                          zeros(1), zeros(1), drows[:1])
            self._program(("decode", True), self._decode_fn(True),
                          zeros(slots), zeros(slots, dtype=torch.bool),
                          drows, zeros(slots))
            self._program(("extend", False), self._extend_fn(False),
                          zeros(slots, self.spec_draft_tokens + 1),
                          zeros(slots), zeros(slots),
                          drop(slots, spec, spec.capacity))

    def max_total_tokens(self):
        """The hard per-request budget (prompt + generated): positions past
        the model's ``max_seq_len`` would reuse the last position
        embedding, and a paged cache clamps its write row at capacity, so
        the schedulers refuse such requests at submit time.  The ring
        layout is bounded by the position range only."""
        vals = []
        if not self.cache_spec.ring:
            vals.append(self.cache_spec.capacity)
        max_seq = getattr(self.module.config, "max_seq_len", None)
        if max_seq is not None:
            vals.append(int(max_seq))
        return min(vals) if vals else None

    # ------------------------------------------------------------ KV handoff
    def _require_disaggregate(self, what: str) -> None:
        if not self.fleet_disaggregate:
            raise RuntimeError(
                f"{what} needs inference.fleet.disaggregate: true "
                f"(the KV handoff programs were not built — "
                f"docs/inference.md \"Fleet serving\")")

    def export_kv(self, slot: int):
        """Read slot ``slot``'s written K/V rows off the card for a
        prefill->decode handoff: ``(k, v, n_tokens)``, ``k`` and ``v`` CPU
        tensors ``[layers, n_tokens, kv_heads, head_dim]`` in the cache
        dtype: the bytes the extend program wrote, so a replica importing
        them continues byte-identically.  One gather of the slot's rows
        on the card and one counted host read.  Needs
        ``inference.fleet.disaggregate``."""
        self._require_disaggregate("export_kv")
        n_tokens = int(self._host_pos[int(slot)])
        if n_tokens < 1:
            raise ValueError(
                f"slot {slot} holds no written rows — prefill it before "
                f"exporting")
        rows = self.pool.slot_rows(int(slot))[:n_tokens]
        _RECORDER.record("serve_export_kv", slot=int(slot),
                         tokens=n_tokens)
        with self._armed("serve_export_kv"), annotate("serve_export_kv"):
            kv = self._run("export_kv", rows=rows)
            obs_fences.count_fence()
            kv = kv.cpu()
        return kv[0], kv[1], n_tokens

    def _do_export_kv(self, rows):
        """``[2, layers, n, heads, d]``: the K and V rows ``rows``, every
        model rank's heads joined in rank order (the global heads)."""
        rows = self._dev(rows, torch.int64)
        kv = torch.stack([self._cache["k"].index_select(1, rows),
                          self._cache["v"].index_select(1, rows)])
        return comm.model_all_gather(kv, 3, self.model_group)

    def import_kv(self, slot: int, prompt_tokens, k_rows, v_rows,
                  max_new_tokens: int):
        """Admit ``slot`` from a KV handoff instead of a prefill: map the
        slot's pages (leading ones from the local prefix index when the
        prompt's page-aligned prefix is resident: those hold the same
        bytes and are never written), write the handed-off rows into the
        fresh pages with ``index_copy_`` (never the drop row, never a
        shared page, never past the prompt), publish the full prompt
        pages and pin the slot's position.  ``k_rows`` / ``v_rows``:
        tensors (or numpy arrays) ``[layers, n_tokens, kv_heads,
        head_dim]`` in the cache dtype.  Returns the ``AdmitGrant`` (None:
        a pool refusal, nothing allocated).  Shape, dtype and capacity
        are checked before anything is touched."""
        self._require_disaggregate("import_kv")
        toks = np.asarray(prompt_tokens, np.int32).reshape(-1)
        n_tokens = int(toks.size)
        spec = self.cache_spec
        heads_g = spec.kv_heads_local * spec.mp_size
        expect = (spec.layers, n_tokens, heads_g, spec.head_dim)
        k_rows = (k_rows if isinstance(k_rows, torch.Tensor)
                  else torch.from_numpy(np.asarray(k_rows)))
        v_rows = (v_rows if isinstance(v_rows, torch.Tensor)
                  else torch.from_numpy(np.asarray(v_rows)))
        if tuple(k_rows.shape) != expect or tuple(v_rows.shape) != expect:
            raise ValueError(
                f"KV handoff shape mismatch: k {tuple(k_rows.shape)} / "
                f"v {tuple(v_rows.shape)}, this replica expects "
                f"{expect} — prefill and decode pools must share "
                f"(layers, kv_heads, head_dim) and the prompt length")
        for name, arr in (("k", k_rows), ("v", v_rows)):
            if arr.dtype != spec.dtype:
                raise ValueError(
                    f"KV handoff {name} dtype {arr.dtype} != this "
                    f"replica's cache dtype {spec.dtype} — byte identity "
                    f"needs identical cache dtypes across the fleet (a "
                    f"silent cast here would corrupt pages)")
        if n_tokens > spec.capacity:
            raise ValueError(
                f"KV handoff of {n_tokens} tokens exceeds the per-slot "
                f"capacity ({spec.capacity})")
        self.release(slot)
        grant = self.pool.admit(int(slot), toks.tolist(),
                                int(max_new_tokens),
                                reuse=self.prefix_reuse)
        if grant is None:
            _RECORDER.record("serve_refusal", slot=int(slot),
                             prompt_tokens=n_tokens,
                             free_pages=self.pool.free_pages)
            return None
        start = grant.reused_tokens
        rows = self.pool.slot_rows(int(slot))[start:n_tokens]
        _RECORDER.record("serve_import_kv", slot=int(slot),
                         tokens=n_tokens, reused=start)
        t0 = time.perf_counter()
        with self._armed("serve_import_kv"), annotate("serve_import_kv"):
            k_new, v_new = k_rows[:, start:], v_rows[:, start:]
            if self.serving is not None:
                # the followers' copy goes over the control group
                k_new, v_new = k_new.cpu(), v_new.cpu()
            self._run("import_kv", slot=int(slot), rows=rows, k=k_new,
                      v=v_new, n_tokens=n_tokens)
        if self.prefix_reuse:
            self.pool.publish(grant)
        self._host_pos[int(slot)] = n_tokens
        if self.first_token_ts is None:
            # a pure-decode replica serves its first token at its first
            # import: the startup event's anchor
            self.first_token_ts = time.time()
            self.first_dispatch_s = time.perf_counter() - t0
        return grant

    def _do_import_kv(self, slot, rows, k, v, n_tokens):
        """Write the global-head rows ``k`` / ``v`` [layers, n, heads, d]
        into ``rows`` of this rank's pools (its ``heads / mp`` of them) and
        pin ``slot``'s position at ``n_tokens``."""
        rows = self._dev(rows, torch.int64)
        n_local = self.cache_spec.kv_heads_local
        heads = slice(self.mp_rank * n_local, (self.mp_rank + 1) * n_local)
        for pool, new in ((self._cache["k"], k), (self._cache["v"], v)):
            pool.index_copy_(1, rows, new[:, :, heads].to(self.device))
        self._cache["pos"][slot] = n_tokens

    # ------------------------------------------------- lint and planners
    def _gated_programs(self):
        """``(kind, run)`` of every program production can dispatch, each
        on inputs of its call's shapes: the admission extend (and the tail
        bucket's), the decode step, the fused decode or the speculative
        step, the draft's prefill, the ring's copy-on-write and the KV
        handoff pair."""
        slots, spec = self.num_slots, self.cache_spec
        cap = spec.capacity
        rows1 = np.zeros((1, cap), np.int32)
        rows = np.zeros((slots, cap), np.int32)
        tok = np.zeros((slots,), np.int64)
        act = np.zeros((slots,), bool)
        ivec = np.zeros((slots,), np.int32)

        def admit(bucket):
            return lambda: self._do_admit(np.zeros((1, bucket), np.int32),
                                          rows1, 0, 0, 1, None, 0)
        out = [("prefill", admit(self.prefill_bucket))]
        if self.tail_bucket:
            out.append(("prefill_tail", admit(self.tail_bucket)))
        out.append(("decode", lambda: self._do_decode(tok, act, rows)))
        if self.decode_iters_per_dispatch > 1:
            out.append(("decode_many", lambda: self._do_decode_many(
                rows, ivec, act, ivec, ivec)))
        if self.spec_draft_tokens > 0:
            out.append(("draft_prefill", lambda: self._extend_one(
                True, np.zeros((1, self.prefill_bucket), np.int32),
                self._draft_rows[:1], 0, 0, 1)))
            out.append(("spec_step", lambda: self._do_spec(
                rows, ivec, act, ivec, ivec)))
        if spec.ring:
            out.append(("copy_page", lambda: self._do_copy_page(0, 0)))
        if self.fleet_disaggregate:
            block = (spec.layers, cap, spec.kv_heads_local * spec.mp_size,
                     spec.head_dim)
            out.append(("export_kv", lambda: self._do_export_kv(
                np.zeros((cap,), np.int64))))
            out.append(("import_kv", lambda: self._do_import_kv(
                0, np.zeros((cap,), np.int64),
                torch.zeros(block, dtype=spec.dtype),
                torch.zeros(block, dtype=spec.dtype), 1)))
        return out

    def _traces(self):
        """The fake traces of every gated program (once per engine): the
        weights, pools and row maps are fakes for the duration and the
        programs run eagerly."""
        if self._serve_traces is not None:
            return self._serve_traces
        from deepspeed_tpu_torch.analysis import graph as G
        mode = G.new_fake_mode()
        saved = dict(self.__dict__)
        memo: dict = {}
        traces = {}
        try:
            state = G.fake_attrs(
                self, ["params", "_cache", "draft_params", "_draft_cache",
                       "_rows_dev", "_draft_rows"], mode, memo)
            self._graphs = G.TracedGraphs()
            for kind, run in self._gated_programs():
                with G.recording(kind, mode=mode, arguments=state) as rec:
                    run()
                traces[kind] = rec.trace()
        finally:
            self.__dict__.clear()
            self.__dict__.update(saved)
        self._serve_traces = traces
        return traces

    def _known_groups(self):
        if self.serving is None:
            return {}
        return {"model": tuple(range(self.mp_world_size))}

    def _do_graph_lint(self):
        """The passes over every program on this rank, the collectives
        exchanged with the other model ranks over the control group."""
        from deepspeed_tpu_torch import analysis
        failure, traces = None, {}
        try:
            traces = self._traces()
        except Exception as e:  # noqa: BLE001 - exchanged, then raised
            failure = e
        rep = analysis.lint_traces(
            traces, self._known_groups(),
            control_group=(self.serving.control_group
                           if self.serving is not None else None),
            rank=self.mp_rank, failure=failure)
        rep.subject = "serve"
        return rep.filtered(self.config.graph_lint_suppress)

    def run_graph_lint(self):
        """The passes over every serving program (the library and CLI
        surface, whatever ``graph_lint.mode``); at mp > 1 the leader's call
        is a command: every model rank traces."""
        return self._run("graph_lint")

    def run_stability(self, prompt_lengths=()):
        """The one-graph-per-program promise checked across prompt lengths
        and reuse offsets, and the weights' and pools' placements."""
        from deepspeed_tpu_torch.analysis import stability as stab
        return stab.check_inference_engine(
            self, prompt_lengths=prompt_lengths
        ).filtered(self.config.analysis_suppress)

    def predict_executables(self):
        """The CUDA graphs the serving path captures (``analysis.
        stability.predict_executables_serve``)."""
        from deepspeed_tpu_torch.analysis import stability as stab
        return stab.predict_executables_serve(self)

    def plan_dispatch(self, profile=None):
        """``{"prefill": DispatchPlan, "decode": DispatchPlan}``: one
        replay (graphed) or the traced launches (eager) per program, the
        stagings and the sampler's counted read per iteration."""
        from deepspeed_tpu_torch.analysis import dispatchplan, profiles
        launches = ({} if self._graphs is not None else
                    {k: t.launches() for k, t in self._traces().items()})
        return dispatchplan.plan_serve_dispatch(
            self, launches=launches,
            profile=profiles.for_plan(profile, self.config, self.device)[0])

    def plan_capacity(self, profile=None, budget_gb=None):
        """The capacity plan of every serving program with the persistent
        weights and KV pools (and the draft's)."""
        from deepspeed_tpu_torch.analysis import memplan, profiles
        _, prof, budget = profiles.for_plan(profile, self.config,
                                            self.device, budget_gb)
        persistent = {
            "params_bytes": self.weight_bytes,
            "optimizer_state_bytes": 0,
            "grad_accumulator_bytes": 0,
            "zero_stage": 0,
            "kv_cache_bytes": kvcache.cache_bytes(self.cache_spec),
        }
        if self.draft_cache_spec is not None:
            persistent["draft_params_bytes"] = self.draft_weight_bytes
            persistent["draft_kv_cache_bytes"] = kvcache.cache_bytes(
                self.draft_cache_spec)
        traces = self._traces()
        static, keys = {}, {}
        if self._graphs is not None:
            for kind, t in traces.items():
                keys[kind] = [p.key for p in t.programs]
                static.update((p.key, p.static_bytes) for p in t.programs)
        return memplan.CapacityPlan(
            programs=[memplan.analyze_trace(t, k) for k, t in traces.items()],
            persistent=persistent, profile=prof, budget_bytes=budget,
            graph_static=static, graph_keys=keys,
            graph_workspace_bytes=(prof.stream_workspace_bytes
                                   if static and self.device
                                   not in _GraphedStep.streams else 0))

    def _gate_programs(self):
        """The build-time gates (``graph_lint.mode`` / ``analysis.mode``),
        on every model rank: error mode raises before the first
        request."""
        from deepspeed_tpu_torch import analysis
        mode = self.config.graph_lint_mode
        if mode != "off":
            analysis.dispatch_report(self._do_graph_lint(), mode,
                                     where="serve", log=logger)
        amode = self.config.analysis_mode
        if amode != "off":
            plan = self.plan_capacity()
            rep = plan.to_report(subject="serve")
            rep.extend(self.run_stability())
            for p in self.plan_dispatch(profile=plan.profile).values():
                rep.extend(p.to_report())
            analysis.dispatch_report(
                rep.filtered(self.config.analysis_suppress), amode,
                where="serve", log=logger, label="capacity plan",
                info_hint="engine.plan_capacity().format_table() shows "
                          "the plan",
                error_cls=analysis.MemoryPlanError)

    # ------------------------------------------------------------- serving
    def attach_watchdog(self, watchdog) -> None:
        """Arm ``watchdog`` around every later prefill / decode /
        copy-on-write dispatch (the blocking host regions: the dispatch
        and the sampler's read).  The fused programs scale the deadline by
        their width (``decode_iters_per_dispatch`` / ``draft_tokens +
        1``)."""
        self.watchdog = watchdog

    def _armed(self, label: str, scale: float = 1.0):
        wd = self.watchdog
        return (wd.armed(label, deadline_scale=scale)
                if wd is not None else nullcontext())

    def reset(self):
        """Clear every slot and the whole prefix index; the pools are
        zeroed in place."""
        self.pool.reset()
        self._host_pos[:] = 0
        self._run("reset")

    def _do_reset(self):
        for cache in (self._cache, self._draft_cache):
            if cache is not None:
                for t in cache.values():
                    t.zero_()

    def _pad_prompt(self, prompt_tokens, bucket: Optional[int] = None):
        """Host-side bucket padding: every admissible prompt (or tail)
        length maps to the same ``[1, bucket]`` shape.  Returns ``(padded,
        length)``."""
        bucket = self.prefill_bucket if bucket is None else bucket
        toks = np.asarray(prompt_tokens, np.int32).reshape(-1)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :toks.size] = toks
        return padded, int(toks.size)

    def _extend_one(self, draft: bool, padded, rows, slot: int, start: int,
                    n_new: int):
        """One admission program: extend ``slot`` by ``n_new`` tokens from
        ``start`` at the bucket width of ``padded`` and return the last
        real token's logits row [1, vocab / mp]; sets the slot's
        position."""
        cache = self._draft_cache if draft else self._cache
        bucket = padded.shape[1]
        logits = self._program(
            ("extend", draft), self._extend_fn(draft),
            self._dev(padded, torch.int64), self._dev([start], torch.int32),
            self._dev([n_new], torch.int32), rows)
        cache["pos"][slot] = start + n_new
        last = min(max(n_new - 1, 0), bucket - 1)
        return logits[:, last]

    def admit(self, slot: int, prompt_tokens, max_new_tokens: int,
              reuse: Optional[bool] = None):
        """Admission with prefix reuse: map the slot's pages (leading ones
        from the prefix index when the prompt's page-aligned prefix is
        resident), prefill only the uncached tail, publish the new full
        prompt pages, and return ``(last-token logits row, reused
        tokens)``.  None, with nothing allocated or dispatched, when the
        pool cannot cover the request (the scheduler keeps it queued)."""
        toks = np.asarray(prompt_tokens, np.int32).reshape(-1)
        if toks.size < 1:
            raise ValueError("prefill: empty prompt")
        if toks.size > self.prefill_bucket:
            raise ValueError(
                f"prompt of {toks.size} tokens exceeds the prefill bucket "
                f"({self.prefill_bucket}) — raise "
                f"inference.prefill_bucket/max_tokens")
        if not (0 <= int(slot) < self.num_slots):
            raise ValueError(f"slot {slot} outside [0, {self.num_slots})")
        slot = int(slot)
        if reuse is None:
            reuse = self.prefix_reuse
        self.release(slot)
        grant = self.pool.admit(slot, toks.tolist(), int(max_new_tokens),
                                reuse=reuse)
        if grant is None:
            # refusals are the admission-starvation signal a post-mortem
            # must see in the ring
            _RECORDER.record("serve_refusal", slot=slot,
                             prompt_tokens=int(toks.size),
                             free_pages=self.pool.free_pages)
            return None
        start = grant.reused_tokens
        tail = toks[start:]
        bucket = self.prefill_bucket
        if self.tail_bucket and tail.size <= self.tail_bucket:
            bucket = self.tail_bucket
        padded, n_new = self._pad_prompt(tail, bucket)
        # the draft has no prefix index: it prefills the whole prompt
        # (cheap: that is what a draft is)
        dpad = (self._pad_prompt(toks, self.prefill_bucket)[0]
                if self.draft_model is not None else None)
        _RECORDER.record("serve_admit", slot=slot,
                         prompt_tokens=int(toks.size),
                         reused_tokens=int(start),
                         pages=len(self.pool.slot_pages(slot)))
        t0 = time.perf_counter()
        with self._armed("serve_prefill"), annotate("serve_prefill"):
            lrow = self._run("admit", padded=padded,
                             rows=self.pool.slot_rows(slot)[None], slot=slot,
                             start=int(start), n_new=n_new, dpad=dpad,
                             dn=int(toks.size))
            # the sampler's data dependency: one counted fence an admission
            out = obs_fences.read_arrays(lrow.float())[0][0]
        if self.prefix_reuse:
            self.pool.publish(grant)
        self._host_pos[slot] = toks.size
        if self.first_token_ts is None:
            self.first_token_ts = time.time()
            self.first_dispatch_s = time.perf_counter() - t0
        return out, grant.reused_tokens

    def _do_admit(self, padded, rows, slot, start, n_new, dpad, dn):
        """The admission programs: the target's extend (and the draft's
        whole-prompt prefill); the last real token's logits row over the
        whole vocabulary [1, vocab]."""
        lrow = self._extend_one(False, padded, self._dev(rows, torch.int32),
                                slot, start, n_new)
        if dpad is not None:
            with annotate("serve_draft_prefill"):
                self._extend_one(True, dpad, self._draft_rows[slot][None],
                                 slot, 0, dn)
        return self._full_vocab(lrow)

    def release(self, slot: int) -> None:
        """Evict ``slot``: decrement every page refcount (shared pages
        survive for other slots and the LRU prefix cache)."""
        if self.pool.slot_pages(int(slot)):
            _RECORDER.record("serve_evict", slot=int(slot),
                             pages=len(self.pool.slot_pages(int(slot))))
        self.pool.release(int(slot))
        self._host_pos[slot] = 0

    def prefill(self, slot: int, prompt_tokens) -> np.ndarray:
        """Prefill ``prompt_tokens`` into ``slot`` without prefix reuse
        (the full-prompt forward: the decode oracle's reference and the
        no-reuse baseline); returns the last prompt token's fp32 logits
        row.  It maps the slot's whole capacity, and raises where an
        overcommitted pool cannot (use :meth:`admit` to queue instead)."""
        toks = np.asarray(prompt_tokens, np.int32).reshape(-1)
        budget = max(0, self.cache_spec.capacity - toks.size)
        res = self.admit(slot, toks, budget, reuse=False)
        if res is None:
            raise RuntimeError(
                f"page pool exhausted: prefill needs the slot's full "
                f"{self.cache_spec.pages_per_slot}-page range but only "
                f"{self.pool.free_pages} page(s) are allocatable — "
                f"raise inference.pool_pages or admit() via a scheduler "
                f"that tolerates refusal (docs/inference.md)")
        return res[0]

    def copy_page(self, src: int, dst: int) -> None:
        """Ring-layout copy-on-write: page ``src``'s rows into page
        ``dst``, in every layer's k and v pool (a row copy, bitwise)."""
        self._run("copy_page", src=int(src), dst=int(dst))

    def _do_copy_page(self, src, dst):
        pt = self.cache_spec.page_tokens
        for t in (self._cache["k"], self._cache["v"]):
            t[:, dst * pt:(dst + 1) * pt] = t[:, src * pt:(src + 1) * pt]

    def _ring_write_barrier(self, active, width: int) -> None:
        """Before a decode-family dispatch on a ring cache with prefix
        reuse: make every page the next ``width`` writes touch exclusively
        owned (:meth:`copy_page`) and un-publish own pages whose content
        is about to diverge."""
        if not (self.cache_spec.ring and self.prefix_reuse):
            return
        for slot in np.flatnonzero(np.asarray(active, bool)):
            pos = int(self._host_pos[slot])
            copies = self.pool.prepare_write(int(slot),
                                             range(pos, pos + width))
            if copies:
                _RECORDER.record("serve_cow", slot=int(slot),
                                 copies=len(copies))
            for src, dst in copies:
                with self._armed("serve_copy_page"), \
                        annotate("serve_copy_page"):
                    self.copy_page(src, dst)

    def _decode_step(self, tokens, active, rows, draft: bool = False,
                     pos=None):
        """One decode step of the target (or the draft, whose positions
        are ``pos``) over every slot; returns ``(logits, pos')``, the
        target's positions advanced in place."""
        if not draft:
            pos = self._cache["pos"]
        logits, pos2 = self._program(("decode", draft),
                                     self._decode_fn(draft), tokens, active,
                                     rows, pos)
        if not draft:
            self._cache["pos"].copy_(pos2)
        return logits, pos2

    def decode(self, tokens, active) -> np.ndarray:
        """One decode iteration over every slot: ``tokens`` int [slots]
        (each slot's input), ``active`` bool [slots].  Returns fp32 logits
        [slots, vocab] (inactive rows are meaningless); the positions
        advance by ``active``."""
        active = np.asarray(active, bool)
        self._ring_write_barrier(active, 1)
        self.decode_dispatches += 1
        _RECORDER.record("serve_decode", dispatch=self.decode_dispatches,
                         active=int(active.sum()))
        with self._armed("serve_decode"), annotate("serve_decode"):
            # the chaos stall point: inside the armed region, so a stalled
            # decode fires the serve watchdog
            _chaos.maybe_stall(self.decode_dispatches)
            logits = self._run("decode", tokens=np.asarray(tokens),
                               active=active, rows=self._rows_changed())
            self._host_pos += active
            # one counted fence per decode iteration (the sampler's input)
            return obs_fences.read_arrays(logits.float())[0]

    def _do_decode(self, tokens, active, rows):
        """One decode step; its logits over the whole vocabulary."""
        logits, _ = self._decode_step(
            self._dev(tokens, torch.int64), self._dev(active, torch.bool),
            self._rows_from(rows))
        return self._full_vocab(logits)

    def _greedy(self, logits):
        """The device argmax over the fp32 view of the whole vocabulary:
        the first max, as the host sampler's ``np.argmax`` of the fp32
        logits row; at mp > 1 every rank gathers the vocab-sharded logits
        first, so every rank takes the same tokens."""
        return torch.argmax(self._full_vocab(logits).float(),
                            dim=-1).to(torch.int32)

    def decode_many(self, tokens, active, eos_ids, remaining):
        """D fused decode iterations (``inference.decode_iters_per_
        dispatch``; the greedy feedback on the device).  ``eos_ids`` int
        [slots] (-1: length-only stop), ``remaining`` int [slots] (tokens
        left per slot).  Returns ``(tokens [D, slots] int32, emitted [D,
        slots] bool)``: ``emitted[it, s]`` marks slot s active at
        iteration ``it``.  One counted fence per D iterations."""
        d = self.decode_iters_per_dispatch
        if d <= 1:
            raise RuntimeError(
                "decode_many needs inference.decode_iters_per_dispatch "
                "> 1 (the fused decode program was not built)")
        active_np = np.asarray(active, bool)
        self._ring_write_barrier(active_np, d)
        self.decode_dispatches += 1
        _RECORDER.record("serve_decode_many",
                         dispatch=self.decode_dispatches,
                         active=int(active_np.sum()), d=d)
        with self._armed("serve_decode_many", scale=float(d)), \
                annotate("serve_decode_many"):
            _chaos.maybe_stall(self.decode_dispatches)
            toks, emitted = self._run(
                "decode_many", rows=self._rows_changed(),
                tokens=np.asarray(tokens), active=active_np,
                eos_ids=np.asarray(eos_ids), remaining=np.asarray(remaining))
            # the sampler's fence, amortized: one read per D-block
            toks, emitted = obs_fences.read_arrays(toks, emitted)
        self._host_pos += emitted.sum(axis=0)
        return toks, emitted.astype(bool)

    def _do_decode_many(self, rows, tokens, active, eos_ids, remaining):
        return self._decode_block(
            self.decode_iters_per_dispatch, self._rows_from(rows),
            self._dev(tokens, torch.int32), self._dev(active, torch.bool),
            self._dev(eos_ids, torch.int32), self._dev(remaining, torch.int32))

    def _decode_block(self, d: int, rows, tokens, active, eos_ids,
                      remaining):
        """D greedy decode iterations on device tensors, with the EOS and
        budget masks: ``(tokens [D, slots], emitted [D, slots])`` on the
        device.  Nothing here reads the card."""
        toks_out, emitted_out = [], []
        for _ in range(d):
            logits, _ = self._decode_step(tokens, active, rows)
            nxt = self._greedy(logits)
            emitted = active
            remaining = remaining - active.to(torch.int32)
            hit_eos = (eos_ids >= 0) & (nxt == eos_ids)
            active = active & ~hit_eos & (remaining > 0)
            tokens = torch.where(emitted, nxt, tokens)
            toks_out.append(nxt)
            emitted_out.append(emitted)
        return torch.stack(toks_out), torch.stack(emitted_out)

    def spec_decode(self, tokens, active, eos_ids, remaining):
        """One speculative iteration: J greedy draft proposals, the target
        verify of width J + 1 through the extend path, and the longest
        agreeing prefix with the EOS and budget masks, all on the device.
        Same calling convention as :meth:`decode_many`; returns ``(tokens
        [J+1, slots], emitted [J+1, slots])``, the emitted tokens equal to
        target-only greedy decode.  One counted fence per iteration.

        Verify row ``i`` is the target's greedy successor of the history
        ending at fed token ``i``; a draft token is emitted only when it
        equals that successor, and the first mismatch still yields the
        target's own token.  K/V rows written for rejected positions are
        never visible: the position mask hides them and the next block
        overwrites each before its position enters a mask."""
        j = self.spec_draft_tokens
        if j <= 0:
            raise RuntimeError(
                "spec_decode needs inference.speculative.draft_tokens "
                "> 0 (the speculative program was not built)")
        active_np = np.asarray(active, bool)
        self.decode_dispatches += 1
        _RECORDER.record("serve_spec_step",
                         dispatch=self.decode_dispatches,
                         active=int(active_np.sum()), j=j)
        with self._armed("serve_spec_step", scale=float(j + 1)), \
                annotate("serve_spec_step"):
            _chaos.maybe_stall(self.decode_dispatches)
            toks, emitted = self._run(
                "spec", rows=self._rows_changed(), tokens=np.asarray(tokens),
                active=active_np, eos_ids=np.asarray(eos_ids),
                remaining=np.asarray(remaining))
            toks, emitted = obs_fences.read_arrays(toks, emitted)
        self._host_pos += emitted.sum(axis=0)
        return toks, emitted.astype(bool)

    def _do_spec(self, rows, tokens, active, eos_ids, remaining):
        return self._spec_block(
            self._rows_from(rows), self._dev(tokens, torch.int32),
            self._dev(active, torch.bool), self._dev(eos_ids, torch.int32),
            self._dev(remaining, torch.int32))

    def _spec_block(self, rows, tokens, active, eos_ids, remaining):
        """One speculative iteration on device tensors: ``(tokens [J+1,
        slots], emitted [J+1, slots])`` on the device, the target's
        positions advanced by the emitted counts.  Nothing here reads the
        card."""
        j = self.spec_draft_tokens
        pos = self._cache["pos"]
        # J + 1 draft steps: the first J propose; the last only writes d_J's
        # K/V, which a fully accepted block makes draft history
        feed, drafts = tokens, []
        for i in range(j + 1):
            dlogits, _ = self._decode_step(feed, active, self._draft_rows,
                                           draft=True, pos=pos + i)
            if i < j:
                feed = self._greedy(dlogits)
                drafts.append(feed)
        # the target verify over [t0, d1..dJ]
        vtokens = torch.stack([tokens] + drafts, dim=1)
        n_new = torch.where(active, j + 1, 0).to(torch.int32)
        vlogits = self._program(("extend", False), self._extend_fn(False),
                                vtokens, pos, n_new, rows)
        g = self._greedy(vlogits)                              # [slots, J+1]
        blk = active          # still emitting within this block
        act = active          # request still active after the block
        toks_out, emitted_out = [], []
        for i in range(j + 1):
            tok = g[:, i]
            emitted = blk
            remaining = remaining - emitted.to(torch.int32)
            hit_eos = (eos_ids >= 0) & (tok == eos_ids)
            stop = emitted & (hit_eos | (remaining <= 0))
            act = act & ~stop
            blk = emitted & act
            if i < j:
                # go on only while the draft agreed with the target
                blk = blk & (drafts[i] == tok)
            toks_out.append(tok)
            emitted_out.append(emitted)
        emitted = torch.stack(emitted_out)
        pos.add_(emitted.to(torch.int32).sum(dim=0))
        return torch.stack(toks_out), emitted

    def note_fused_decode_fallback(self, why: str) -> None:
        """One warning when a scheduler cannot use the configured fused
        decode / speculative program (a non-greedy sampler)."""
        if not self._warned_fused_fallback:
            self._warned_fused_fallback = True
            logger.warning(
                "inference: a fused decode path was configured but "
                "%s — falling back to one decode dispatch per iteration "
                "(docs/inference.md)", why)

    def slot_positions(self) -> np.ndarray:
        return self._cache["pos"].cpu().numpy()

    # ---------------------------------------------------------- telemetry
    def startup_event(self) -> dict:
        """The serve cold-start record, the training startup event's
        schema: ``time_to_first_step_s`` is build -> first token,
        ``first_dispatch_s`` the first prefill dispatch, with the restore
        latency and the compile-cache counters; beside them the model
        parallel degree and whether the programs are CUDA graphs (and
        why not)."""
        from deepspeed_tpu_torch.observability import health, schema
        from deepspeed_tpu_torch.resilience import COUNTERS
        return {
            "schema": schema.STARTUP_SCHEMA_ID,
            "version": 2,
            "ts": time.time(),
            "rank": health._process_rank(),
            "host": socket.gethostname(),
            "step": 0,
            "time_to_first_step_s": (
                round(self.first_token_ts - self._built_ts, 4)
                if self.first_token_ts is not None else None),
            "first_dispatch_s": (round(self.first_dispatch_s, 4)
                                 if self.first_dispatch_s is not None
                                 else None),
            "restore_seconds": (round(self.restore_seconds, 4)
                                if self.restore_seconds is not None
                                else None),
            "compile_cache_hits": COUNTERS.compile_cache_hits,
            "compile_cache_misses": COUNTERS.compile_cache_misses,
            # the port's own facts beside the schema's (the serve JSONL
            # keeps the schema's fields only)
            "model_parallel": self.mp_world_size,
            "graphs": self.graphs,
            "graphs_off_because": self.graphs_off_because,
        }

    # --------------------------------------------------------- convenience
    def generate(self, prompts, max_new_tokens: int = 16, eos_id=None,
                 sampler=None):
        """Greedy-generate for a list of token-id prompts through the
        continuous-batching scheduler; returns the generated token lists
        in prompt order."""
        from deepspeed_tpu_torch.inference.scheduler import (
            ContinuousScheduler, Request, greedy_sampler)
        sched = ContinuousScheduler(self, sampler=sampler or greedy_sampler)
        reqs = [Request(rid=i, prompt=list(p),
                        max_new_tokens=max_new_tokens, eos_id=eos_id)
                for i, p in enumerate(prompts)]
        results = sched.run(reqs)
        by_rid = {r.rid: r.tokens for r in results}
        return [by_rid[i] for i in range(len(reqs))]


def lead_fleet(engines, fn):
    """Serve several replicas at once on every rank: ``fn(engines)`` on the
    leader (model rank 0 of every engine: the router, its driver threads),
    every engine closed in a ``finally`` (an exception on the leader never
    leaves a follower waiting); on a follower each engine's ``follow()``
    on a thread of its own, on the engine's device, all joined, the first
    error raised again; it returns None there.  Every rank passes its
    engines in the order it built them; a rank that leads none of them
    holds only followers (an mp-1 engine is a leader: it stays on model
    rank 0)."""
    engines = list(engines)
    followers = [e for e in engines if not e.is_leader]
    if not followers:
        try:
            return fn(engines)
        finally:
            # every engine, even past a close that raised (its followers
            # would wait for ever); then the first error
            errors = []
            for eng in engines:
                try:
                    eng.close()
                except Exception as e:  # noqa: BLE001 - raised below
                    errors.append(e)
            if errors:
                raise errors[0]
    if len(followers) != len(engines):
        raise ValueError(
            "lead_fleet: a rank leads all of its engines or follows all "
            "of them (every replica's leader is model rank 0)")
    errors = []
    threads = [threading.Thread(target=_follow, args=(eng, errors),
                                name=f"dstpu-follower-{i}-mp{eng.mp_rank}")
               for i, eng in enumerate(engines)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return None


# dstpu-thread: follower
def _follow(eng, errors) -> None:
    """A follower thread of :func:`lead_fleet`: ``eng``'s loop on its
    device (a thread starts on the process's first card); an error goes
    to ``errors``."""
    try:
        with (torch.cuda.device(eng.device) if eng.device.type == "cuda"
              else nullcontext()):
            eng.follow()
    except BaseException as e:  # noqa: BLE001 - raised after the join
        errors.append(e)
