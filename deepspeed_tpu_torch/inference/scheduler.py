"""Request scheduling: continuous batching vs the static baseline.

The port of ``deepspeed_tpu/inference/scheduler.py``, pure host code.
Continuous batching (the serving default): every decode iteration runs
ALL active slots as one compiled step, and between iterations the
scheduler admits queued requests into whatever slots just freed
(EOS / max-token eviction) — no slot ever idles waiting for the longest
request in a "batch" to finish.  The static scheduler is the honest
baseline the bench compares against: it forms fixed batches in arrival
order and decodes each batch until its LAST member finishes, so short
requests burn decode iterations producing nothing and later batches
queue behind the stragglers.

Per-slot bookkeeping is position/length arithmetic only — the KV cache
itself lives on device (inference/kvcache.py) and each slot's attention
is masked strictly by its own position, so a slot's output stream is
IDENTICAL whether it shares iterations with 0 or ``slots-1`` neighbours.

A decode replica of a disaggregated fleet (``inference/router.py``)
takes prefilled requests as ``KVHandoff`` records through
``submit_handoff``: admission imports their K/V rows into a free slot
(``InferenceEngine.import_kv``) instead of dispatching a prefill.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request."""
    rid: int
    prompt: List[int]                 # prompt token ids (non-empty)
    max_new_tokens: int = 16
    eos_id: Optional[int] = None      # stop token (None = length-only)

    def __post_init__(self):
        if not self.prompt:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.rid}: max_new_tokens must be >= 1")


@dataclasses.dataclass
class RequestResult:
    """Completed request: generated tokens + the whole lifecycle as
    numbers (seconds, measured host-side at token delivery) — the
    per-request record the summary percentiles and the
    ``dstpu.telemetry.request`` events are derived from."""
    rid: int
    tokens: List[int]
    finish_reason: str                # "eos" | "length"
    ttft_s: Optional[float] = None    # enqueue -> first token
    itl_s: List[float] = dataclasses.field(default_factory=list)
    prompt_len: int = 0
    # ---- lifecycle breakdown: submit -> admit -> first token
    # -> eviction, plus the admission's page-table facts
    queue_wait_s: Optional[float] = None   # submit -> admission dispatch
    prefill_s: Optional[float] = None      # admission dispatch -> 1st token
    finished_ts: Optional[float] = None    # completion wall time
    slot: Optional[int] = None             # decode slot served in
    prefix_hit: bool = False               # admission reused shared pages
    reused_tokens: int = 0                 # prompt tokens not re-prefilled
    pages_mapped: int = 0                  # page-table entries mapped

    @property
    def decode_s(self) -> Optional[float]:
        """First token -> last token (sum of inter-token gaps); None on a
        one-token request."""
        return sum(self.itl_s) if self.itl_s else None

    @property
    def itl_mean_s(self) -> Optional[float]:
        """The request's mean inter-token gap — its ONE ITL sample in the
        per-request percentiles.  Robust under fused decode: within a
        D-block all but the first gap are honestly ~0, but the mean is
        total decode time over tokens, comparable across D."""
        return (sum(self.itl_s) / len(self.itl_s)) if self.itl_s else None


def greedy_sampler(logits_row: np.ndarray) -> int:
    """Deterministic argmax over the full-vocab logits row — the decode
    oracle's sampler (docs/inference.md)."""
    return int(np.argmax(logits_row))


def percentile(xs, p: float) -> Optional[float]:
    """Nearest-rank percentile (None on empty) — shared by the latency
    report and the bench leg."""
    if not xs:
        return None
    xs = sorted(xs)
    k = max(0, min(len(xs) - 1, int(round(p / 100.0 * (len(xs) - 1)))))
    return float(xs[k])


def latency_samples_ms(results):
    """``(ttft_ms, itl_ms)`` pooled sample lists over completed results
    (every per-token gap is one ITL sample).  Kept for the pooled
    ``itl_mean_ms`` and raw-sample consumers; the summary PERCENTILES
    come from :func:`request_latency_ms` — pooled per-token percentiles
    are degenerate under fused decode (D-1 of every D gaps are ~0, so
    the per-token p50 honestly collapses to 0 at D>1)."""
    return ([r.ttft_s * 1e3 for r in results if r.ttft_s is not None],
            [dt * 1e3 for r in results for dt in r.itl_s])


def request_latency_ms(results):
    """``(ttft_ms, itl_ms, queue_wait_ms)`` PER-REQUEST sample lists —
    one sample per completed request (a request's ITL sample is its mean
    inter-token gap, :attr:`RequestResult.itl_mean_s`).  The one owner
    of the summary/telemetry percentile inputs: percentiles over these
    stay meaningful at any ``decode_iters_per_dispatch``."""
    return ([r.ttft_s * 1e3 for r in results if r.ttft_s is not None],
            [r.itl_mean_s * 1e3 for r in results
             if r.itl_mean_s is not None],
            [r.queue_wait_s * 1e3 for r in results
             if r.queue_wait_s is not None])


def latency_summary(results, elapsed_s: float, n_chips: int = 1) -> dict:
    """tokens/s(/chip) + p50/p99 TTFT / inter-token latency / queue wait
    over a completed trace (milliseconds, like the telemetry events).

    Percentiles are PER-REQUEST (:func:`request_latency_ms`): each
    completed request contributes one TTFT, one queue-wait and one
    mean-ITL sample, so the tail measures slow REQUESTS — and stays
    comparable across ``decode_iters_per_dispatch`` (the old pooled
    per-token p50 read 0 at D>1).  ``itl_mean_ms`` remains the pooled
    per-token mean, the cross-D throughput-per-token number
    (docs/inference.md "Fused decode")."""
    ttft, itl_req, queue_wait = request_latency_ms(results)
    _, itl_pooled = latency_samples_ms(results)
    tokens = sum(len(r.tokens) for r in results)
    tps = tokens / elapsed_s if elapsed_s > 0 else None
    return {
        "requests": len(results),
        "tokens_out": tokens,
        "elapsed_s": round(elapsed_s, 4),
        "tokens_per_sec": None if tps is None else round(tps, 2),
        "tokens_per_sec_per_chip": (None if tps is None
                                    else round(tps / max(1, n_chips), 2)),
        "ttft_p50_ms": percentile(ttft, 50),
        "ttft_p99_ms": percentile(ttft, 99),
        "itl_p50_ms": percentile(itl_req, 50),
        "itl_p99_ms": percentile(itl_req, 99),
        "itl_mean_ms": (round(float(np.mean(itl_pooled)), 4)
                        if itl_pooled else None),
        "queue_wait_p50_ms": percentile(queue_wait, 50),
        "queue_wait_p99_ms": percentile(queue_wait, 99),
    }


def _stops(req: Request, tok: int, n_generated: int) -> bool:
    return ((req.eos_id is not None and tok == req.eos_id)
            or n_generated >= req.max_new_tokens)


def _check_request(engine, req: Request) -> None:
    """Submit-time admission checks: a bad request must be rejected
    BEFORE it enters a drain, not explode mid-iteration and discard
    every in-flight neighbour's work.  Two budgets: the prefill bucket
    (prompt length) and the engine's total-token budget
    (``max_total_tokens``: position-embedding range, plus paged-cache
    capacity — past either, decode would silently clamp and the
    exactness contract would break)."""
    if len(req.prompt) > engine.prefill_bucket:
        raise ValueError(
            f"request {req.rid}: prompt of {len(req.prompt)} tokens "
            f"exceeds the prefill bucket ({engine.prefill_bucket}) — "
            f"raise inference.prefill_bucket/max_tokens")
    budget = engine.max_total_tokens()
    if budget is not None and len(req.prompt) + req.max_new_tokens > budget:
        raise ValueError(
            f"request {req.rid}: prompt ({len(req.prompt)}) + "
            f"max_new_tokens ({req.max_new_tokens}) exceeds the "
            f"per-request token budget ({budget} = min of paged cache "
            f"capacity and the model's max_seq_len); shorten the "
            f"request, raise inference.max_tokens, or use the ring "
            f"layout's sliding window (docs/inference.md)")


@dataclasses.dataclass
class KVHandoff:
    """A prefilled request in flight between pools: the prefill
    replica's output (first token + the slot's written KV rows) plus the
    lifecycle timestamps the decode replica must PRESERVE — TTFT was
    measured when the prefill produced the first token, and queue wait
    keeps anchoring at the user's original submit."""
    req: Request
    prompt: List[int]            # the full prompt (page hashing + admit)
    first_token: int             # sampled from the prefill's logits row
    k: object                    # [L, n_tokens, kv_heads(global), d]
    v: object                    # (CPU tensors or numpy arrays)
    n_tokens: int                # rows written (== len(prompt))
    t_enqueue: float             # the user's ORIGINAL submit time
    t_admit: float               # prefill admission dispatch start
    t_first_token: float         # first-token sample time (TTFT anchor)
    path: Optional[str] = None   # sealed artifact file (router cleanup)


class _Slot:
    """Host-side mirror of one decode slot."""

    __slots__ = ("req", "generated", "last_token", "t_enqueue", "t_last",
                 "ttft", "itl", "queue_wait", "prefill_s", "prefix_hit",
                 "reused_tokens", "pages_mapped")

    def __init__(self, req: Request, first_token: int, t_enqueue: float,
                 now: float, t_admit: Optional[float] = None,
                 reused_tokens: int = 0, pages_mapped: int = 0):
        self.req = req
        self.generated = [first_token]
        self.last_token = first_token
        self.t_enqueue = t_enqueue
        self.t_last = now
        self.ttft = now - t_enqueue
        self.itl = []
        # lifecycle breakdown: queue wait ends when the admission
        # dispatch starts; prefill is dispatch -> first token
        self.queue_wait = (t_admit - t_enqueue
                           if t_admit is not None else None)
        self.prefill_s = now - t_admit if t_admit is not None else None
        self.prefix_hit = reused_tokens > 0
        self.reused_tokens = int(reused_tokens)
        self.pages_mapped = int(pages_mapped)


class ContinuousScheduler:
    """Admit-into-free-slots continuous batching over one
    :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine`.

    ``step()`` is one scheduler iteration: admission (prefill each newly
    admitted request — its first token counts as TTFT), then ONE decode
    program dispatch covering every active slot, then eviction.  Run to
    drain with :meth:`run`."""

    def __init__(self, engine, sampler: Callable = greedy_sampler,
                 on_event: Optional[Callable] = None,
                 on_complete: Optional[Callable] = None):
        self.engine = engine
        self.sampler = sampler
        self.on_event = on_event          # telemetry hook (driver.py)
        self.on_complete = on_complete    # per-request record hook:
                                          # called with each RequestResult
                                          # at eviction (request events)
        self.queue: List[tuple] = []      # (request, t_enqueue)
        self.handoffs: List[KVHandoff] = []   # prefilled, awaiting import
        self.slots: List[Optional[_Slot]] = [None] * engine.num_slots
        self.results: List[RequestResult] = []
        self.decode_iters = 0
        self.admitted = 0
        self.evicted = 0
        # prefix-reuse / speculative telemetry (serve schema v2 columns)
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        self.admission_refusals = 0
        self.spec_proposed = 0
        self.spec_accepted = 0

    # ------------------------------------------------------------- intake
    def submit(self, request: Request, now: Optional[float] = None):
        """Queue a request.  ``now`` overrides the enqueue timestamp —
        a fleet router resubmitting a request displaced by replica
        death passes the ORIGINAL arrival time, so queue-wait/TTFT
        percentiles keep measuring from the user's submit instead of
        silently resetting (the :meth:`evacuate` contract)."""
        _check_request(self.engine, request)
        self.queue.append((request, time.perf_counter()
                           if now is None else now))

    def submit_handoff(self, handoff: KVHandoff) -> None:
        """Queue a PREFILLED request (KV handed off from a prefill
        replica): admission imports the rows into a free slot instead of
        dispatching a prefill — the decode pool's intake.  The request
        must fit this engine's budgets exactly like a fresh submit."""
        _check_request(self.engine, handoff.req)
        self.handoffs.append(handoff)

    def _admit_handoffs(self) -> int:
        """Import queued handoffs into free slots; returns tokens landed
        (each handoff arrives WITH its first token).  A pool refusal
        keeps the remaining handoffs queued — transient, like the regular
        admission path."""
        admitted_tokens = 0
        for i in range(len(self.slots)):
            if not self.handoffs or self.slots[i] is not None:
                continue
            h = self.handoffs[0]
            grant = self.engine.import_kv(
                i, h.prompt, h.k, h.v, h.req.max_new_tokens)
            if grant is None:
                self.admission_refusals += 1
                break            # pool exhausted: no later slot differs
            self.handoffs.pop(0)
            if grant.reused_tokens:
                self.prefix_hits += 1
                self.prefix_tokens_reused += grant.reused_tokens
            # lifecycle bookkeeping PRESERVES the prefill-side times: TTFT
            # anchored at the prefill's first-token sample, queue wait at
            # the user's original submit
            self.slots[i] = _Slot(
                h.req, h.first_token, h.t_enqueue, h.t_first_token,
                t_admit=h.t_admit, reused_tokens=grant.reused_tokens,
                pages_mapped=len(self.engine.pool.slot_pages(i)))
            self.admitted += 1
            admitted_tokens += 1
            if _stops(h.req, h.first_token, 1):
                self._evict(i)
        return admitted_tokens

    @property
    def active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def pending(self) -> int:
        return len(self.queue) + len(self.handoffs)

    def evacuate(self) -> List[tuple]:
        """Pull every in-flight AND queued request back out as
        ``(request, t_enqueue)`` pairs, releasing their engine slots —
        the replica-eviction path (docs/inference.md "Fleet serving").

        The pairs carry each request's ORIGINAL arrival timestamp: a
        request displaced by replica death must re-enter the surviving
        replica's queue via ``submit(req, now=t_enqueue)``, so its queue
        wait and TTFT keep accruing from the user's submit.  Resubmitting
        with a fresh timestamp would silently reset TTFT at the exact
        moment the fleet is slowest — the tail percentiles would lie.
        Partial generations are discarded: greedy decode re-derives the
        identical token stream from the prompt (the exactness contract),
        so nothing is lost but the wasted iterations.

        In-flight requests come first (they arrived before anything
        still queued), each pool page they held is released, and the
        scheduler is left empty and reusable."""
        pairs = []
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            self.slots[i] = None
            self.engine.release(i)
            pairs.append((s.req, s.t_enqueue))
        # un-imported handoffs re-enter as plain requests (the surviving
        # replica re-prefills; greedy identity makes that loss-free)
        pairs.extend((h.req, h.t_enqueue) for h in self.handoffs)
        self.handoffs = []
        pairs.extend(self.queue)
        self.queue = []
        return pairs

    # ------------------------------------------------------------ stepping
    def step(self) -> dict:
        """One scheduler iteration; returns the iteration's stats."""
        eng = self.engine
        # 0) handed-off prefills land first: they arrived before
        # anything still queued and their KV is already paid for
        admitted_now = self._admit_handoffs() if self.handoffs else 0
        # 1) admission: fill free slots from the queue (every queued
        # request already passed the submit-time budget checks).  A
        # prefix-cache hit maps the prompt's page-aligned prefix to
        # shared pages and prefills only the tail; a page-pool refusal
        # (capacity exhausted) keeps the request QUEUED — active slots
        # release pages as they finish, so the refusal is transient
        for i in range(len(self.slots)):
            if not self.queue or self.slots[i] is not None:
                continue
            req, t_enq = self.queue[0]
            t_admit = time.perf_counter()
            res = eng.admit(i, req.prompt, req.max_new_tokens)
            if res is None:
                self.admission_refusals += 1
                break            # pool exhausted: no later slot differs
            self.queue.pop(0)
            logits, reused = res
            now = time.perf_counter()
            if reused:
                self.prefix_hits += 1
                self.prefix_tokens_reused += reused
            tok = self.sampler(logits)
            pool = getattr(eng, "pool", None)
            self.slots[i] = _Slot(
                req, tok, t_enq, now, t_admit=t_admit,
                reused_tokens=reused,
                pages_mapped=(len(pool.slot_pages(i)) if pool is not None
                              else 0))
            self.admitted += 1
            admitted_now += 1
            if _stops(req, tok, 1):
                self._evict(i)

        # 2) decode over every active slot: ONE iteration per dispatch,
        # or — with inference.decode_iters_per_dispatch > 1 and the
        # greedy sampler — D iterations fused into one dispatch
        # (admission/eviction every D tokens; docs/inference.md "Fused
        # decode").  A custom sampler cannot ride the fused path (the
        # token feedback closes on device via argmax), so it falls back
        # loudly to the per-iteration loop.
        tokens_out = admitted_now
        active_idx = [i for i, s in enumerate(self.slots) if s is not None]
        d = int(getattr(eng, "decode_iters_per_dispatch", 1))
        j = int(getattr(eng, "spec_draft_tokens", 0))
        fused = d > 1
        spec = j > 0
        if (fused or spec) and self.sampler is not greedy_sampler:
            eng.note_fused_decode_fallback(
                "the scheduler's sampler is not the greedy sampler (the "
                "fused program closes the token loop with argmax)")
            fused = spec = False
        if active_idx and spec:
            # speculative iteration: ONE dispatch = J draft proposals +
            # target verify + acceptance; up to J+1 tokens land per
            # active slot, token-identical to target-only greedy decode
            # (docs/inference.md "Speculative decoding")
            n = len(self.slots)
            feed = np.zeros((n,), np.int32)
            active = np.zeros((n,), bool)
            eos_ids = np.full((n,), -1, np.int32)
            remaining = np.zeros((n,), np.int32)
            for i in active_idx:
                s = self.slots[i]
                feed[i] = s.last_token
                active[i] = True
                if s.req.eos_id is not None:
                    eos_ids[i] = s.req.eos_id
                remaining[i] = s.req.max_new_tokens - len(s.generated)
            toks, emitted = eng.spec_decode(feed, active, eos_ids,
                                            remaining)
            now = time.perf_counter()
            self.decode_iters += 1
            self.spec_proposed += j * len(active_idx)
            for it in range(toks.shape[0]):
                for i in active_idx:
                    if not emitted[it, i]:
                        continue
                    s = self.slots[i]
                    tok = int(toks[it, i])
                    s.generated.append(tok)
                    s.itl.append(now - s.t_last)
                    s.t_last = now
                    s.last_token = tok
                    tokens_out += 1
                    if it > 0:
                        # tokens past the first are ACCEPTED draft
                        # proposals (the first is the target's own)
                        self.spec_accepted += 1
            for i in active_idx:
                s = self.slots[i]
                if _stops(s.req, s.last_token, len(s.generated)):
                    self._evict(i)
        elif active_idx and fused:
            n = len(self.slots)
            feed = np.zeros((n,), np.int32)
            active = np.zeros((n,), bool)
            eos_ids = np.full((n,), -1, np.int32)
            remaining = np.zeros((n,), np.int32)
            for i in active_idx:
                s = self.slots[i]
                feed[i] = s.last_token
                active[i] = True
                if s.req.eos_id is not None:
                    eos_ids[i] = s.req.eos_id
                remaining[i] = s.req.max_new_tokens - len(s.generated)
            toks, emitted = eng.decode_many(feed, active, eos_ids,
                                            remaining)
            now = time.perf_counter()
            self.decode_iters += d
            for it in range(toks.shape[0]):
                for i in active_idx:
                    if not emitted[it, i]:
                        continue
                    s = self.slots[i]
                    tok = int(toks[it, i])
                    s.generated.append(tok)
                    s.itl.append(now - s.t_last)
                    s.t_last = now
                    s.last_token = tok
                    tokens_out += 1
            for i in active_idx:
                s = self.slots[i]
                if _stops(s.req, s.last_token, len(s.generated)):
                    self._evict(i)
        elif active_idx:
            feed = np.zeros((len(self.slots),), np.int32)
            for i in active_idx:
                feed[i] = self.slots[i].last_token
            active = np.zeros((len(self.slots),), bool)
            active[active_idx] = True
            logits = eng.decode(feed, active)
            now = time.perf_counter()
            self.decode_iters += 1
            for i in active_idx:
                s = self.slots[i]
                tok = self.sampler(logits[i])
                s.generated.append(tok)
                s.itl.append(now - s.t_last)
                s.t_last = now
                s.last_token = tok
                tokens_out += 1
                if _stops(s.req, tok, len(s.generated)):
                    self._evict(i)

        return {
            "admitted": admitted_now,
            "tokens_out": tokens_out,
            "active": len(active_idx),
            "queue_depth": len(self.queue) + len(self.handoffs),
        }

    def _evict(self, slot_idx: int):
        s = self.slots[slot_idx]
        reason = ("eos" if s.req.eos_id is not None
                  and s.generated[-1] == s.req.eos_id else "length")
        self.slots[slot_idx] = None
        self.evicted += 1
        # refcount-- on every page the slot mapped: shared pages survive
        # for their other readers / the LRU prefix cache
        self.engine.release(slot_idx)
        result = RequestResult(
            rid=s.req.rid, tokens=list(s.generated), finish_reason=reason,
            ttft_s=s.ttft, itl_s=list(s.itl),
            prompt_len=len(s.req.prompt),
            queue_wait_s=s.queue_wait, prefill_s=s.prefill_s,
            finished_ts=time.time(), slot=slot_idx,
            prefix_hit=s.prefix_hit, reused_tokens=s.reused_tokens,
            pages_mapped=s.pages_mapped)
        self.results.append(result)
        if self.on_complete is not None:
            self.on_complete(result)

    def run(self, requests=None, max_iters: int = 100000) -> list:
        """Drain: submit ``requests`` (optional) and iterate until every
        slot and the queue are empty.  Returns results in completion
        order."""
        for r in (requests or []):
            self.submit(r)
        it = 0
        while self.queue or self.handoffs or self.active:
            stats = self.step()
            if self.on_event is not None:
                self.on_event(self, stats)
            it += 1
            if it >= max_iters:
                raise RuntimeError(
                    f"scheduler did not drain in {max_iters} iterations "
                    f"({self.active} active, {len(self.queue)} queued)")
        return self.results


class StaticScheduler:
    """The baseline: fixed batches in arrival order, each decoded until
    its LAST request finishes (finished slots keep burning iterations;
    their extra tokens are discarded).  Shares the engine, sampler and
    result shape with :class:`ContinuousScheduler` so the bench compares
    exactly the same trace."""

    def __init__(self, engine, sampler: Callable = greedy_sampler):
        self.engine = engine
        self.sampler = sampler
        self.decode_iters = 0
        self.results: List[RequestResult] = []

    def run(self, requests) -> list:
        eng = self.engine
        n_slots = eng.num_slots
        for r in requests:
            _check_request(eng, r)
        t0 = time.perf_counter()
        enq = {r.rid: t0 for r in requests}
        for start in range(0, len(requests), n_slots):
            batch = requests[start:start + n_slots]
            slots = {}
            for i, req in enumerate(batch):
                t_admit = time.perf_counter()
                logits = eng.prefill(i, req.prompt)
                now = time.perf_counter()
                tok = self.sampler(logits)
                slots[i] = _Slot(req, tok, enq[req.rid], now,
                                 t_admit=t_admit)
            done = {i: _stops(s.req, s.last_token, 1)
                    for i, s in slots.items()}
            while not all(done.values()):
                feed = np.zeros((n_slots,), np.int32)
                active = np.zeros((n_slots,), bool)
                for i, s in slots.items():
                    feed[i] = s.last_token
                    active[i] = True      # finished slots still decode —
                    # the static baseline's waste is the point
                logits = eng.decode(feed, active)
                now = time.perf_counter()
                self.decode_iters += 1
                for i, s in slots.items():
                    if done[i]:
                        continue
                    tok = self.sampler(logits[i])
                    s.generated.append(tok)
                    s.itl.append(now - s.t_last)
                    s.t_last = now
                    s.last_token = tok
                    if _stops(s.req, tok, len(s.generated)):
                        done[i] = True
            for i, s in slots.items():
                reason = ("eos" if s.req.eos_id is not None
                          and s.generated[-1] == s.req.eos_id else "length")
                self.results.append(RequestResult(
                    rid=s.req.rid, tokens=list(s.generated),
                    finish_reason=reason, ttft_s=s.ttft,
                    itl_s=list(s.itl), prompt_len=len(s.req.prompt),
                    queue_wait_s=s.queue_wait, prefill_s=s.prefill_s,
                    finished_ts=time.time(), slot=i))
        return self.results
