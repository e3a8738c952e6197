"""KV-cache management for the serving engine: a refcounted page pool.

The port of ``deepspeed_tpu/inference/kvcache.py``.  The device state is a
flat page POOL: ``k``/``v`` ``[L, pages * page_tokens + 1, n_local_heads,
d]``, rows stacked on the layer axis, the last row the drop row that
writes aimed past the pages land in (``models/layers.py``).  Every slot
sees its logical ``[capacity]`` token range through a host-side PAGE TABLE
(:class:`PagePool`): slot ``s``'s logical row ``t`` lives at flat row
``table[s, t // page_tokens] * page_tokens + t % page_tokens``.  The model
functions receive the resolved ``[slots, capacity]`` row map each dispatch
and gather / scatter through it.

Indirection buys PREFIX SHARING: prompts are hashed per page (chained, so
a hit on page ``i`` proves pages ``0..i`` match), and an admission whose
prefix is already resident maps its leading table entries to the SHARED
pages, refcounted, and prefills only the tail.  Same weights and same
tokens give the same page bytes, so attending a reused page is the same
as re-prefilling it.  The bookkeeping rules:

* a page is **published** (hash-indexed, reusable) only once every row is
  written: a partial page is never shared;
* release decrements refcounts; a published page at refcount 0 parks on
  an LRU list and stays hittable until the allocator reclaims it;
* the paged layout never writes a shared page, so copy-on-write exists
  only for the ring layout, whose wrap-around would overwrite shared rows:
  the engine copies the page out (and un-publishes its own stale pages)
  before the overwriting dispatch.

Sizing is arithmetic: :func:`cache_bytes` is the pool's exact cost, and
:func:`plan_slots` solves for the slot count whose pages fit a memory size
after the weights (on the card, ``torch.cuda.mem_get_info``).
``pool_pages`` overcommits: fewer pages than ``slots x pages_per_slot``
is legal, and admission refuses (queues) when the pool is exhausted.
``PagePool._lock`` comes from ``analysis.lockwatch.named_lock``: a plain
``threading.RLock`` unless the lock sanitizer is armed.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import List, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.analysis import lockwatch

LAYOUTS = ("paged", "ring")


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """Resolved shape of the serving KV page pool on ONE model shard."""
    layers: int
    slots: int                   # concurrent decode slots
    capacity: int                # tokens per slot (page-rounded)
    kv_heads_local: int          # heads held by this model shard
    head_dim: int
    mp_size: int = 1             # model-parallel degree (global heads =
                                 # kv_heads_local * mp_size)
    dtype: object = torch.bfloat16
    layout: str = "paged"
    page_tokens: int = 128
    pool_pages: int = 0          # 0 = slots * pages_per_slot (no
                                 # overcommit; every slot can always
                                 # hold its full capacity)

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(
                f"kv_layout must be one of {LAYOUTS}, got {self.layout!r}")
        if self.slots < 1 or self.capacity < 1:
            raise ValueError(
                f"KV cache needs slots >= 1 and capacity >= 1 (got "
                f"slots={self.slots}, capacity={self.capacity})")
        if self.pool_pages and self.pool_pages < self.pages_per_slot:
            raise ValueError(
                f"pool_pages ({self.pool_pages}) smaller than one slot's "
                f"page count ({self.pages_per_slot}) — not even a single "
                f"request could ever be admitted")

    @property
    def ring(self) -> bool:
        return self.layout == "ring"

    @property
    def pages_per_slot(self) -> int:
        return -(-self.capacity // max(1, self.page_tokens))

    @property
    def num_pages(self) -> int:
        """Pages in the pool (the allocation granularity)."""
        return int(self.pool_pages) or self.slots * self.pages_per_slot

    @property
    def pool_rows(self) -> int:
        """Flat token rows in the pool: ``num_pages * page_tokens``."""
        return self.num_pages * max(1, self.page_tokens)

    @property
    def global_shape(self):
        """Shape of the priced k/v pool over every model shard's heads (the
        JAX layout; ``cache_bytes`` prices one shard's slice of it)."""
        return (self.layers, self.pool_rows,
                self.kv_heads_local * self.mp_size, self.head_dim)

    @property
    def device_shape(self):
        """Shape of one shard's k/v tensor on the device: the pool's rows
        plus the drop row (``models/layers.py``), which writes aimed past
        the pages land in."""
        return (self.layers, self.pool_rows + 1, self.kv_heads_local,
                self.head_dim)


def itemsize(dtype) -> int:
    """Bytes of one element of a torch or numpy dtype."""
    return (dtype.itemsize if isinstance(dtype, torch.dtype)
            else np.dtype(dtype).itemsize)


def round_to_pages(tokens: int, page_tokens: int) -> int:
    """Capacity rounded UP to whole pages (the allocation granularity)."""
    page_tokens = max(1, int(page_tokens))
    return -(-int(tokens) // page_tokens) * page_tokens


def cache_bytes(spec: KVCacheSpec) -> int:
    """Exact per-device bytes of the k + v POOL (``pool_rows`` is the
    priced quantity — page-table/pos bookkeeping is noise)."""
    per_tok = spec.kv_heads_local * spec.head_dim
    return 2 * spec.layers * spec.pool_rows * per_tok * itemsize(spec.dtype)


def plan_slots(layers: int, kv_heads_local: int, head_dim: int,
               capacity: int, dtype, *, hbm_bytes: int,
               weight_bytes: int, headroom_frac: float = 0.1,
               slot_cap: int = 256, page_tokens: int = 128) -> int:
    """Max decode slots whose page share fits: ``(HBM·(1-headroom) -
    weights) / per-slot-page-bytes``, capped at ``slot_cap`` (beyond a
    few hundred slots decode is compute-bound, not memory-bound — more slots
    only add latency).  The per-slot cost is its PAGES
    (``ceil(capacity / page_tokens) * page_tokens`` rows), the pool's
    allocation granularity.  Raises when not even one slot fits — a
    serving config that cannot hold a single request must fail at build,
    not OOM on the first prompt."""
    rows = round_to_pages(capacity, page_tokens)
    per_slot = (2 * layers * rows * kv_heads_local * head_dim
                * itemsize(dtype))
    budget = int(hbm_bytes * (1.0 - headroom_frac)) - int(weight_bytes)
    slots = budget // per_slot if per_slot > 0 else 0
    if slots < 1:
        raise ValueError(
            f"KV cache does not fit: {weight_bytes / 2**30:.2f} GiB of "
            f"weights + {per_slot / 2**20:.1f} MiB per slot exceed "
            f"{hbm_bytes / 2**30:.2f} GiB of device memory (headroom "
            f"{headroom_frac:.0%}) — lower max_tokens, quantize, or use "
            f"a bigger card")
    return int(min(slots, slot_cap))


def init_cache(spec: KVCacheSpec, device=None):
    """Zeroed cache state of one shard on ``device``: ``{"k", "v", "pos"}``
    with k/v the flat page pools (``device_shape``: the drop row last).
    ``pos[s]`` is slot s's NEXT absolute position (0 = empty); inactive
    slots keep pos frozen."""
    return {
        "k": torch.zeros(spec.device_shape, dtype=spec.dtype, device=device),
        "v": torch.zeros(spec.device_shape, dtype=spec.dtype, device=device),
        "pos": torch.zeros((spec.slots,), dtype=torch.int32, device=device),
    }


def spec_from_model(model, mp_size: int, *, slots: int, max_tokens: int,
                    dtype, layout: str = "paged",
                    page_tokens: int = 128, pool_pages: int = 0,
                    hbm_bytes: Optional[int] = None,
                    weight_bytes: int = 0) -> KVCacheSpec:
    """Build the cache spec for an engine-protocol LM: dims from the
    model's ``kv_cache_dims`` hook, capacity page-rounded, and — when
    ``slots`` is 0 ("auto") — the slot count solved against ``hbm_bytes``
    (the engine passes the card's memory) via :func:`plan_slots`."""
    dims_fn = getattr(model, "kv_cache_dims", None)
    if dims_fn is None:
        raise ValueError(
            f"{type(model).__name__} does not expose kv_cache_dims(mp) — "
            f"KV-cached serving needs the per-shard (layers, kv_heads, "
            f"head_dim) declaration (models/gpt2.py)")
    layers, kv_heads_local, head_dim = dims_fn(mp_size)
    capacity = round_to_pages(max_tokens, page_tokens)
    if slots in (0, None):
        if hbm_bytes is None:
            raise ValueError(
                "inference.max_slots=0 (auto) needs a device memory size to "
                "size against: the card's (torch.cuda.mem_get_info); on "
                "the CPU set inference.max_slots")
        slots = plan_slots(layers, kv_heads_local, head_dim, capacity,
                           dtype, hbm_bytes=hbm_bytes,
                           weight_bytes=weight_bytes,
                           page_tokens=page_tokens)
    return KVCacheSpec(layers=layers, slots=int(slots), capacity=capacity,
                       kv_heads_local=kv_heads_local, head_dim=head_dim,
                       mp_size=int(mp_size), dtype=dtype, layout=layout,
                       page_tokens=page_tokens,
                       pool_pages=int(pool_pages or 0))


# --------------------------------------------------------------- hashing

def prefix_page_hashes(tokens: Sequence[int], page_tokens: int,
                       max_pages: Optional[int] = None) -> List[bytes]:
    """Chained digests of the full pages of ``tokens``: hash ``i`` covers
    tokens ``[0, (i+1)*page_tokens)`` (each digest folds in the previous
    one), so equal hash ``i`` ⇒ the ENTIRE prefix through page ``i`` is
    equal — a single dict hit proves the whole chain."""
    pt = max(1, int(page_tokens))
    n = len(tokens) // pt
    if max_pages is not None:
        n = min(n, max_pages)
    out, prev = [], b""
    for i in range(n):
        h = hashlib.blake2b(digest_size=16)
        h.update(prev)
        h.update(np.asarray(tokens[i * pt:(i + 1) * pt],
                            np.int64).tobytes())
        prev = h.digest()
        out.append(prev)
    return out


@dataclasses.dataclass
class AdmitGrant:
    """One admission's page-table outcome (host bookkeeping only)."""
    slot: int
    reused_tokens: int           # page-aligned prefix served from cache
    reused_pages: int
    new_pages: int
    hashes: List[bytes]          # full-prompt page hash chain (for
                                 # publish() once the tail is written)
    prompt_tokens: int


class PagePool:
    """Host-side refcounted page table over the device page pool.

    Owns which flat page every (slot, slot-page) table entry maps to,
    page refcounts, the prefix-hash index of published (reusable) pages,
    and an LRU of published pages no live request references.  The
    device never sees any of this — programs take the resolved
    ``rows()`` int32 map per dispatch."""

    def __init__(self, spec: KVCacheSpec):
        # the pool is the ONE serving structure mutated by the driver
        # thread (admit/release/publish/prepare_write through the
        # scheduler) while observability threads read gauges() for
        # /metrics and the router's load signal — every public method
        # holds this lock.  RLock: admit() re-enters through lookup()
        # and _take_page()
        self._lock = lockwatch.named_lock("PagePool._lock", rlock=True)
        self._init_state(spec)

    # dstpu-thread: construction init
    def _init_state(self, spec: KVCacheSpec) -> None:
        self.spec = spec
        self.pt = max(1, int(spec.page_tokens))
        self.num_pages = spec.num_pages
        self._free: List[int] = list(range(self.num_pages))
        self._ref = np.zeros((self.num_pages,), np.int64)
        self._index = {}             # chain hash -> page id (published)
        self._hash_of = {}           # page id -> chain hash
        self._lru = OrderedDict()    # published, refcount-0 pages
        self._alloc: List[List[int]] = [[] for _ in range(spec.slots)]
        self._shared: List[int] = [0] * spec.slots   # leading hit pages
        # UNALLOCATED table entries resolve to the DROP row (== pool
        # rows) in rows(): a write aimed past a slot's allocation is
        # dropped by scatter_kv_rows instead of corrupting page 0, and
        # a read there clips to the last row, whose value the position
        # mask zeroes — never trusted, never written
        self._table = np.zeros((spec.slots, spec.pages_per_slot), np.int32)
        self._rows = None            # cached [slots, capacity] row map
        # cumulative telemetry (the serve v2/v3 columns read these)
        self.hits = 0
        self.tokens_reused = 0
        self.refusals = 0
        self.cow_copies = 0
        # published LRU pages reclaimed by the allocator — each one is a
        # cached prefix lost; the thrash detector watches the rate
        self.lru_reclaims = 0

    # ------------------------------------------------------------ queries
    @property
    def free_pages(self) -> int:
        """Pages allocatable RIGHT NOW (free + reclaimable LRU)."""
        with self._lock:
            return len(self._free) + len(self._lru)

    def refcount(self, page: int) -> int:
        with self._lock:
            return int(self._ref[page])

    def slot_pages(self, slot: int) -> List[int]:
        with self._lock:
            return list(self._alloc[slot])

    def shared_pages(self, slot: int) -> int:
        """Leading pages of ``slot`` that were mapped from the index at
        admission (the reused prefix)."""
        with self._lock:
            return self._shared[slot]

    def is_published(self, page: int) -> bool:
        with self._lock:
            return page in self._hash_of

    def gauges(self) -> dict:
        """Live pool state as flat numbers — the ``/metrics`` gauges and
        the serve v3 window columns (docs/observability.md "Serving
        view").  Pure host bookkeeping reads, no device interaction."""
        with self._lock:
            return {
                "pool_pages": self.num_pages,
                "free_pages": len(self._free) + len(self._lru),
                "lru_pages": len(self._lru),     # published, refcount 0
                "published_pages": len(self._hash_of),
                "pages_in_use": int(np.sum(self._ref > 0)),
                "shared_pages": int(np.sum(self._ref > 1)),
                "prefix_hits": self.hits,
                "prefix_tokens_reused": self.tokens_reused,
                "admission_refusals": self.refusals,
                "cow_copies": self.cow_copies,
                "lru_reclaims": self.lru_reclaims,
            }

    def rows(self) -> np.ndarray:
        """The resolved ``[slots, capacity]`` int32 flat-row map the
        decode-family programs consume (cached; invalidated by any
        table mutation).  Entries past a slot's allocation are the DROP
        row (``pool_rows``): writes there are dropped in-program, reads
        clip to the last row and are position-masked — so a program
        that aims past the allocation (e.g. a speculative verify block
        wider than the slot's remaining budget) can never touch a page
        another request owns."""
        with self._lock:
            if self._rows is None:
                pages = self._table.astype(np.int64)       # [slots, P]
                base = pages * self.pt                     # row of page 0
                offs = np.arange(self.spec.capacity, dtype=np.int64)
                rows = base[:, offs // self.pt] \
                    + (offs % self.pt)[None, :]
                drop = self.spec.pool_rows
                for s in range(self.spec.slots):
                    n_alloc = len(self._alloc[s])
                    rows[s, n_alloc * self.pt:] = drop
                self._rows = rows.astype(np.int32)
            return self._rows

    def slot_rows(self, slot: int) -> np.ndarray:
        """Flat rows of one slot's logical [capacity] range."""
        return self.rows()[slot]

    # --------------------------------------------------------- allocation
    # dstpu-thread: internal holds=PagePool._lock
    def _take_page(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        if self._lru:
            page, _ = self._lru.popitem(last=False)    # oldest cached
            self._unpublish(page)
            self.lru_reclaims += 1
            return page
        return None

    # dstpu-thread: internal holds=PagePool._lock
    def _unpublish(self, page: int) -> None:
        h = self._hash_of.pop(page, None)
        if h is not None and self._index.get(h) == page:
            del self._index[h]
        self._lru.pop(page, None)

    def lookup(self, prompt: Sequence[int],
               hashes: Optional[List[bytes]] = None) -> List[int]:
        """Longest chain of published pages covering a page-aligned
        prefix of ``prompt``, leaving at least one token to forward
        (the first generated token's logits need a real forward).
        A prefix shorter than one page can never hit.  ``hashes``
        (the full prompt chain) skips re-hashing when the caller
        already computed it — admit() hashes each prompt exactly
        once."""
        max_pages = (len(prompt) - 1) // self.pt
        if hashes is None:
            hashes = prefix_page_hashes(prompt, self.pt,
                                        max_pages=max_pages)
        with self._lock:
            pages = []
            for h in hashes[:max_pages]:
                page = self._index.get(h)
                if page is None:
                    break
                pages.append(page)
            return pages

    def admit(self, slot: int, prompt: Sequence[int], budget_tokens: int,
              reuse: bool = True) -> Optional[AdmitGrant]:
        """Map ``slot``'s table for a request of ``len(prompt) +
        budget_tokens`` tokens: leading entries from the prefix index
        (refcount++), the rest freshly allocated.  Returns ``None`` —
        and counts a refusal — when the pool cannot cover the new pages
        (the scheduler keeps the request queued; nothing is
        half-allocated).  The ring layout always maps its full window
        (writes wrap within it)."""
        total = len(prompt) + max(0, int(budget_tokens))
        if self.spec.ring:
            pages_needed = self.spec.pages_per_slot
        else:
            pages_needed = min(-(-total // self.pt),
                               self.spec.pages_per_slot)
        hashes = prefix_page_hashes(prompt, self.pt)   # hashed ONCE
        with self._lock:
            if self._alloc[slot] or self._shared[slot]:
                raise RuntimeError(
                    f"slot {slot} admitted while still holding pages — "
                    f"release() first")
            hit: List[int] = (self.lookup(prompt, hashes=hashes)
                              if reuse else [])
            hit = hit[:pages_needed]
            n_new = pages_needed - len(hit)
            # allocatable = free + reclaimable LRU, MINUS the LRU pages
            # this very admission is about to revive as hits — counting
            # them as reclaimable would pass the check and then run the
            # allocator dry mid-admission
            lru_hits = sum(1 for p in hit if self._ref[p] == 0)
            if n_new > len(self._free) + len(self._lru) - lru_hits:
                self.refusals += 1
                return None
            for page in hit:
                if self._ref[page] == 0:
                    self._lru.pop(page, None)    # revive from the LRU
                self._ref[page] += 1
            fresh = []
            for _ in range(n_new):
                page = self._take_page()
                assert page is not None, "refusal check out of sync"
                fresh.append(page)
            for page in fresh:
                self._ref[page] += 1
            pages = hit + fresh
            self._alloc[slot] = pages
            self._shared[slot] = len(hit)
            self._table[slot, :len(pages)] = np.asarray(pages, np.int32)
            self._table[slot, len(pages):] = 0
            self._rows = None
            reused_tokens = len(hit) * self.pt
            if reuse:
                self.hits += 1 if hit else 0
                self.tokens_reused += reused_tokens
            return AdmitGrant(slot=slot, reused_tokens=reused_tokens,
                              reused_pages=len(hit), new_pages=n_new,
                              hashes=hashes, prompt_tokens=len(prompt))

    def publish(self, grant: AdmitGrant) -> None:
        """Index ``grant``'s full prompt pages for future hits — call
        AFTER the tail prefill wrote them (a published page must be
        complete).  Pages whose hash is already indexed elsewhere are
        skipped (first writer wins).  Ring layouts publish too — their
        wrap-around is fenced by :meth:`prepare_write`, which
        un-publishes (or copies) a page before its content diverges."""
        with self._lock:
            pages = self._alloc[grant.slot]
            for i, h in enumerate(grant.hashes):
                if i >= len(pages):
                    break
                page = pages[i]
                if h in self._index or page in self._hash_of:
                    continue
                self._index[h] = page
                self._hash_of[page] = h

    def release(self, slot: int) -> None:
        """Eviction: refcount-- every page the slot references; a page
        reaching 0 parks on the LRU when published (still hittable) or
        returns to the free list."""
        with self._lock:
            for page in self._alloc[slot]:
                self._ref[page] -= 1
                assert self._ref[page] >= 0, \
                    f"refcount underflow on {page}"
                if self._ref[page] == 0:
                    if page in self._hash_of:
                        self._lru[page] = None
                    else:
                        self._free.append(page)
            self._alloc[slot] = []
            self._shared[slot] = 0
            self._table[slot, :] = 0
            self._rows = None

    # ------------------------------------------------------ copy-on-write
    def prepare_write(self, slot: int, write_positions) -> List[tuple]:
        """Ring-wrap write barrier: for each cache row the next dispatch
        will write for ``slot``, make sure the page is EXCLUSIVELY
        OWNED.  Returns ``[(src_page, dst_page), ...]`` copies the
        caller must execute on device BEFORE the dispatch (copy-on-write
        of still-shared pages); stale published own pages are simply
        un-published (their content is about to diverge from the hashed
        prefix).  Paged layouts never need this: reuse is page-aligned
        and writes land past the prompt, in pages allocated fresh."""
        copies = []
        if not self.spec.ring:
            return copies
        cap = self.spec.capacity
        with self._lock:
            pages = self._alloc[slot]
            seen = set()
            for p_abs in write_positions:
                pi = (int(p_abs) % cap) // self.pt
                if pi in seen or pi >= len(pages):
                    continue
                seen.add(pi)
                page = pages[pi]
                if self._ref[page] > 1:
                    fresh = self._take_page()
                    if fresh is None:
                        raise RuntimeError(
                            "page pool exhausted during copy-on-write "
                            "— lower inference.max_slots or raise "
                            "pool_pages")
                    self._ref[page] -= 1
                    self._ref[fresh] += 1
                    pages[pi] = fresh
                    self._table[slot, pi] = fresh
                    if pi < self._shared[slot]:
                        self._shared[slot] = pi
                    self._rows = None
                    self.cow_copies += 1
                    copies.append((page, fresh))
                elif page in self._hash_of:
                    # sole owner about to overwrite a published page:
                    # the indexed hash no longer describes the content
                    self._unpublish(page)
            return copies

    def reset(self) -> None:
        with self._lock:
            self._init_state(self.spec)
