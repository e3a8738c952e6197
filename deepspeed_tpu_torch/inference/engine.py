"""The serving engine: checkpoint -> tokens, on one card.

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
* **copy_page**: the ring layout's copy-on-write of a shared page.

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

One engine is one replica at ``model_parallel_size`` 1.  The fleet
(replicas behind a router, prefill/decode disaggregation through
``export_kv`` / ``import_kv``, serving at mp > 1 across processes) is
ROADMAP.md Queue 1 item 13b; graph lint and the static analyses
(``plan_capacity``, ``plan_dispatch``, ``run_graph_lint``,
``run_stability``, ``predict_executables``) are item 14.  Each raises
``NotImplementedError`` naming its item.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import time
from contextlib import nullcontext
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch import checkpoint
from deepspeed_tpu_torch import weights as weights_mod
from deepspeed_tpu_torch.config import DeepSpeedConfig, DeepSpeedConfigError
from deepspeed_tpu_torch.inference import kvcache, quant
from deepspeed_tpu_torch.observability import fences as obs_fences
from deepspeed_tpu_torch.observability.flightrec import RECORDER as _RECORDER
from deepspeed_tpu_torch.observability.tracing import annotate
from deepspeed_tpu_torch.parallel.topology import resolve_device
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


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to deepspeed_tpu_torch yet (ROADMAP.md, "
        f"{item})")


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
    warm-up writes the same K/V rows again)."""

    def __init__(self, fn):
        self.fn = fn
        self.graph = None
        self.inputs = self.outputs = None

    def __call__(self, *inputs):
        if self.graph is None:
            self.inputs = [t.clone() for t in inputs]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.fn(*self.inputs)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            # thread_local: another thread's CUDA call (a telemetry drain)
            # during the capture is not an error
            with torch.cuda.graph(self.graph,
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
    """Checkpoint-to-tokens serving engine on one device."""

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
        self._refuse_unported()
        self.device = resolve_device(device)

        from deepspeed_tpu_torch.utils import compile_cache as _compile_cache
        self.compile_cache_dir = _compile_cache.enable_from_config(
            self.config)
        self.mp_world_size = 1
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
        if self.quantize == "int8":
            host = quant.quantize_tree(host, self.compute_dtype)
        self.params = self._place(host)
        self.weight_bytes = self._tree_bytes(self.params)

        # ---- the KV page pool ----
        max_tokens = (self.config.inference_max_tokens
                      or getattr(model.config, "max_seq_len", 1024))
        max_seq = getattr(model.config, "max_seq_len", None)
        if max_seq is not None:
            # rows past max_seq_len are never written (the schedulers
            # refuse requests beyond it): do not price them
            max_tokens = min(int(max_tokens), int(max_seq))
        hbm_bytes, used = None, 0
        if self.device.type == "cuda":
            # "auto" slots size against the card's own memory after the
            # weights (everything already allocated counts as weights)
            free, hbm_bytes = torch.cuda.mem_get_info(self.device)
            used = hbm_bytes - free
        self.cache_spec = kvcache.spec_from_model(
            model, self.mp_world_size,
            slots=self.config.inference_max_slots,
            max_tokens=max_tokens, dtype=self.compute_dtype,
            layout=self.config.inference_kv_layout,
            page_tokens=self.config.inference_page_tokens,
            pool_pages=self.config.inference_pool_pages,
            hbm_bytes=hbm_bytes, weight_bytes=used)
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
        self.pool = kvcache.PagePool(self.cache_spec)
        self._host_pos = np.zeros((self.cache_spec.slots,), np.int64)
        self._cache = kvcache.init_cache(self.cache_spec, self.device)
        self._rows_src = None
        self._rows_dev = None
        # the programs' CUDA graphs by (program, shape); None runs eagerly
        self._graphs = ({} if self.device.type == "cuda"
                        and os.environ.get("DSTPU_SERVE_GRAPHS", "1") != "0"
                        else None)

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
        self._warned_fused_fallback = False
        # replica observability hooks (inference/observability.py): a
        # watchdog attached here arms around every dispatch; the decode
        # dispatch counter feeds the breadcrumbs and the chaos stall point
        self.watchdog = None
        self.decode_dispatches = 0

    # ------------------------------------------------------------ helpers
    def _refuse_unported(self):
        cfg = self.config
        refused = [
            (int(cfg.model_parallel_size or 1) > 1,
             "serving at model_parallel_size > 1", "Queue 1 item 13b"),
            (cfg.graph_lint_mode != "off" or cfg.analysis_mode != "off"
             or cfg.analysis_concurrency_mode != "off",
             "graph lint / analysis", "Queue 1 item 14"),
        ]
        for hit, what, item in refused:
            if hit:
                raise _unported(what, item)

    @property
    def num_slots(self) -> int:
        return self.cache_spec.slots

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
        they are."""
        def leaf(t):
            dtype = (self.compute_dtype if t.is_floating_point()
                     else t.dtype)
            return t.detach().to(device=self.device, dtype=dtype)
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
        self.draft_params = self._place(dhost)
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
        rows = self.pool.rows()
        if rows is not self._rows_src:
            self._rows_src = rows
            self._rows_dev = self._dev(rows, torch.int32)
        return self._rows_dev

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
        model = self.draft_model if draft else self.module
        params = self.draft_params if draft else self.params
        cache = self._draft_cache if draft else self._cache

        def extend(tokens, start, n_new, rows):
            return model.apply_extend(params, tokens, cache["k"], cache["v"],
                                      start, n_new, rows)[0]
        return extend

    def _decode_fn(self, draft: bool):
        model = self.draft_model if draft else self.module
        params = self.draft_params if draft else self.params
        cache = self._draft_cache if draft else self._cache
        ring = False if draft else self.cache_spec.ring

        def step(tokens, active, rows, pos):
            logits, _, _, pos2 = model.apply_decode(
                params, tokens, cache["k"], cache["v"], pos, active, rows,
                ring=ring)
            return logits, pos2
        return step

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

    # -------------------------------------------- refused (items 13b, 14)
    def export_kv(self, slot: int):
        raise _unported("InferenceEngine.export_kv (KV handoff)",
                        "Queue 1 item 13b")

    def import_kv(self, *args, **kwargs):
        raise _unported("InferenceEngine.import_kv (KV handoff)",
                        "Queue 1 item 13b")

    def run_graph_lint(self):
        raise _unported("InferenceEngine.run_graph_lint", "Queue 1 item 14")

    def run_stability(self, prompt_lengths=()):
        raise _unported("InferenceEngine.run_stability", "Queue 1 item 14")

    def predict_executables(self):
        raise _unported("InferenceEngine.predict_executables",
                        "Queue 1 item 14")

    def plan_dispatch(self, profile=None):
        raise _unported("InferenceEngine.plan_dispatch", "Queue 1 item 14")

    def plan_capacity(self, profile=None, budget_gb=None):
        raise _unported("InferenceEngine.plan_capacity", "Queue 1 item 14")

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
        real token's logits row [1, vocab]; sets the slot's position."""
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
        rows = self._dev(self.pool.slot_rows(slot)[None], torch.int32)
        _RECORDER.record("serve_admit", slot=slot,
                         prompt_tokens=int(toks.size),
                         reused_tokens=int(start),
                         pages=len(self.pool.slot_pages(slot)))
        t0 = time.perf_counter()
        with self._armed("serve_prefill"), annotate("serve_prefill"):
            lrow = self._extend_one(False, padded, rows, slot, start, n_new)
            if self.draft_model is not None:
                # the draft has no prefix index: it prefills the whole
                # prompt (cheap: that is what a draft is)
                dpad, dn = self._pad_prompt(toks, self.prefill_bucket)
                with annotate("serve_draft_prefill"):
                    self._extend_one(True, dpad, self._draft_rows[slot][None],
                                     slot, 0, dn)
            # the sampler's data dependency: one counted fence an admission
            out = obs_fences.read_arrays(lrow.float())[0][0]
        if self.prefix_reuse:
            self.pool.publish(grant)
        self._host_pos[slot] = toks.size
        if self.first_token_ts is None:
            self.first_token_ts = time.time()
            self.first_dispatch_s = time.perf_counter() - t0
        return out, grant.reused_tokens

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
            logits, _ = self._decode_step(
                self._dev(tokens, torch.int64), self._dev(active, torch.bool),
                self._rows())
            self._host_pos += active
            # one counted fence per decode iteration (the sampler's input)
            return obs_fences.read_arrays(logits.float())[0]

    def _greedy(self, logits):
        """The device argmax over the fp32 view: the first max, as the host
        sampler's ``np.argmax`` of the fp32 logits row."""
        return torch.argmax(logits.float(), dim=-1).to(torch.int32)

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
            toks, emitted = self._decode_block(
                d, self._rows(), self._dev(tokens, torch.int32),
                self._dev(active_np, torch.bool),
                self._dev(eos_ids, torch.int32),
                self._dev(remaining, torch.int32))
            # the sampler's fence, amortized: one read per D-block
            toks, emitted = obs_fences.read_arrays(toks, emitted)
        self._host_pos += emitted.sum(axis=0)
        return toks, emitted.astype(bool)

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
            toks, emitted = self._spec_block(
                self._rows(), self._dev(tokens, torch.int32),
                self._dev(active_np, torch.bool),
                self._dev(eos_ids, torch.int32),
                self._dev(remaining, torch.int32))
            toks, emitted = obs_fences.read_arrays(toks, emitted)
        self._host_pos += emitted.sum(axis=0)
        return toks, emitted.astype(bool)

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
        latency and the compile-cache counters."""
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
