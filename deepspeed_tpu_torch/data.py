"""Data loading: host-side batching, then placement on the engine's device.

The port of ``deepspeed_tpu/data.py``.  ``DeepSpeedDataLoader`` yields
collated batches of a dataset, with the reference's shuffle,
``default_rng(seed + epoch).permutation(n)``, so both packages feed the
same rows at each step, and a ``state_dict`` that resumes an epoch mid-way.
Under data parallelism every rank draws the same global batch of
``micro x dp`` rows and collates only its own: rank ``r`` gets rows ``[r *
micro, (r + 1) * micro)``, the block of the global batch that the JAX
loader places on device ``r`` of the ``data`` axis.  The position, and so
the ``state_dict``, is the same on every rank.  With ``num_workers``
> 0 a producer thread collates ahead of the consumer (``prefetch_depth``
batches); with ``device_prefetch`` it also stages each batch in pinned host
memory and copies it to the device without blocking, so the copy of the
next batch overlaps the current step.  ``BlockPrefetcher`` groups batches
into the K-blocks of ``engine.train_many``.

Dataset protocol: anything indexable with ``len()`` whose items are tuples,
lists or dicts of numpy-convertible leaves, or arrays.  ``ArrayDataset``
and ``FileDataset`` collate through the native row gather
(``deepspeed_tpu_torch.native``).
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from deepspeed_tpu_torch import native
from deepspeed_tpu_torch.constants import ROUTE_TRAIN


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [_tree_map(fn, *leaves) for leaves in zip(tree, *rest)]
        return type(tree)(out)
    return fn(tree, *rest)


def default_collate(samples):
    """Stack a list of samples into one batch (``np.stack`` per leaf)."""
    return _tree_map(lambda *leaves: np.stack(leaves), samples[0],
                     *samples[1:])


def _iter_prefetched(items: Iterator[Any], depth: int, name: str):
    """Drain ``items`` on a daemon producer thread, keeping up to ``depth``
    of them ready for the consumer.  Abandoning the returned iterator (a
    break, or garbage collection) stops the producer instead of leaving it
    blocked on a full queue; a producer exception re-raises in the
    consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
    stop = threading.Event()
    sentinel = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in items:
                if not put(item):
                    return
            put(sentinel)
        except BaseException as e:  # surfaced in the consumer
            put(e)

    t = threading.Thread(target=produce, daemon=True, name=name)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join()


def to_device(leaf, device) -> torch.Tensor:
    """One batch leaf as a tensor on ``device``: through a pinned host
    buffer and a ``non_blocking`` copy to a CUDA device."""
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device, non_blocking=True)
    arr = np.asarray(leaf)
    if not (arr.flags.writeable and arr.flags.c_contiguous):
        arr = np.array(arr)      # torch.from_numpy needs a writable array
    t = torch.from_numpy(arr)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class DeepSpeedDataLoader:
    """Batch iterator.

    Args:
      dataset: indexable dataset (see the module docstring).
      batch_size: rows per global batch (micro-batch x dp).
      dp_rank, dp_size: this rank's place in the data-parallel group; each
        batch holds rows ``[dp_rank * batch_size / dp_size, ...)`` of the
        global batch.
      device: where batches go, as torch tensors; None keeps host numpy
        batches.
      route: 'train' shuffles each epoch; other routes are sequential.
      tput_timer: optional ThroughputTimer, ``start()``-ed on every batch.
      drop_last: drop the trailing ragged batch.
      num_workers: > 0 collates on a producer thread, ``prefetch_depth``
        batches ahead.
      device_prefetch: with workers, copy each batch to ``device`` on the
        producer thread as well.
    """

    def __init__(self,
                 dataset,
                 batch_size: int,
                 device=None,
                 route: str = ROUTE_TRAIN,
                 collate_fn: Optional[Callable] = None,
                 tput_timer=None,
                 seed: int = 0,
                 drop_last: bool = True,
                 num_workers: int = 0,
                 prefetch_depth: int = 2,
                 device_prefetch: bool = False,
                 dp_rank: int = 0,
                 dp_size: int = 1):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.dp_rank, self.dp_size = int(dp_rank), int(dp_size)
        self.device = None if device is None else torch.device(device)
        self.route = route
        self.collate_fn = collate_fn or default_collate
        self.tput_timer = tput_timer
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.num_workers = int(num_workers)
        self.prefetch_depth = max(1, int(prefetch_depth))
        self.device_prefetch = bool(device_prefetch)
        if self.batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if (self.dp_size <= 0 or self.batch_size % self.dp_size
                or not 0 <= self.dp_rank < self.dp_size):
            raise ValueError(
                f"batch_size {self.batch_size} must split evenly over "
                f"dp_size {self.dp_size}, and dp_rank {self.dp_rank} lie "
                f"in [0, dp_size)")
        self.local_batch_size = self.batch_size // self.dp_size
        n = len(dataset)
        self.len = (n // self.batch_size if drop_last
                    else (n + self.batch_size - 1) // self.batch_size)
        # batches yielded in the current epoch, and the skip count the next
        # __iter__ honours after load_state_dict
        self._batch_pos = 0
        self._resume_pos = 0

    def set_epoch(self, epoch: int) -> None:
        """DistributedSampler.set_epoch equivalent: reseeds the shuffle."""
        self.epoch = int(epoch)

    def state_dict(self) -> dict:
        """The iterator's position: the epoch, the batches consumed in it
        and the shuffle seed (each epoch's permutation is
        ``default_rng(seed + epoch)``, so the three pin the sample stream).
        Taken at a step boundary, a fresh loader given it yields exactly
        the batches the interrupted run never consumed."""
        return {"epoch": int(self.epoch), "batch": int(self._batch_pos),
                "seed": int(self.seed)}

    def load_state_dict(self, sd: dict) -> None:
        pos = int(sd["batch"])
        if not 0 <= pos <= self.len:
            raise ValueError(
                f"data iterator state batch={pos} is outside this loader's "
                f"epoch ({self.len} batches): a different dataset or batch "
                f"size than the saving run?")
        self.epoch = int(sd["epoch"])
        self.seed = int(sd.get("seed", self.seed))
        self._resume_pos = pos
        self._batch_pos = pos

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.route == ROUTE_TRAIN:
            return np.random.default_rng(self.seed + self.epoch).permutation(n)
        return np.arange(n)

    def _place(self, batch):
        if self.device is None:
            return batch
        return _tree_map(lambda leaf: to_device(leaf, self.device), batch)

    def __len__(self) -> int:
        return self.len

    def _make_batch(self, sel: np.ndarray):
        """Datasets with ``collate_gather`` (ArrayDataset, FileDataset)
        gather rows through the native gather; others collate per sample."""
        gather = getattr(self.dataset, "collate_gather", None)
        if gather is not None and self.collate_fn is default_collate:
            return gather(sel)
        return self.collate_fn([self.dataset[int(i)] for i in sel])

    def _batches(self, idx: np.ndarray, start: int):
        lo = self.dp_rank * self.local_batch_size
        for b in range(start, self.len):
            rows = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield self._make_batch(rows[lo:lo + self.local_batch_size])

    def __iter__(self) -> Iterator[Any]:
        idx = self._indices()
        # a restored mid-epoch position holds for one pass: the epoch's
        # permutation is (seed, epoch)-deterministic, so skipping the first
        # `start` batches replays the interrupted epoch's remainder
        start = self._resume_pos
        self._resume_pos = 0
        self._batch_pos = start
        if self.num_workers > 0:
            prefetch = self.device_prefetch
            produced = (self._place(b) if prefetch else b
                        for b in self._batches(idx, start))
            for batch in _iter_prefetched(produced, self.prefetch_depth,
                                          "dstt-io-prefetch"):
                if self.tput_timer is not None:
                    self.tput_timer.start()
                self._batch_pos += 1
                yield batch if prefetch else self._place(batch)
        else:
            for batch in self._batches(idx, start):
                if self.tput_timer is not None:
                    self.tput_timer.start()
                self._batch_pos += 1
                yield self._place(batch)
        self.epoch += 1
        self._batch_pos = 0


def device_placer(device) -> Callable:
    """A ``place`` for ``BlockPrefetcher``: every leaf of a batch staged
    to ``device`` (``to_device``: pinned memory, a non-blocking copy)."""
    return lambda batch: _tree_map(lambda x: to_device(x, device), batch)


class BlockPrefetcher:
    """Group a batch iterator into K-blocks for ``engine.train_many``,
    staging block i + 1 on a producer thread while block i trains (the
    JAX ``data.BlockPrefetcher``).

    Each yielded block is a LIST of K batches, the ``train_many``
    argument.  With ``place`` (a callable on one batch, e.g.
    ``device_placer(engine.device)``) every batch is staged to the device
    ON THE PRODUCER thread, from pinned host memory with non-blocking
    copies, so with ``depth >= 2`` the next block's copies overlap the
    current block's steps.  A trailing partial block (fewer than K batches
    left) is yielded as is; ``drop_last=True`` discards it.  One-shot: a
    second iteration raises ``RuntimeError``, as in the JAX package."""

    def __init__(self, batch_iter, k: int, place: Optional[Callable] = None,
                 depth: int = 2, drop_last: bool = False):
        if k < 1:
            raise ValueError(f"BlockPrefetcher: k must be >= 1, got {k}")
        self.batch_iter = iter(batch_iter)
        self.k = int(k)
        self.place = place
        self.depth = max(1, int(depth))
        self.drop_last = bool(drop_last)
        self._consumed = False

    def _blocks(self):
        block = []
        for batch in self.batch_iter:
            if self.place is not None:
                batch = self.place(batch)
            block.append(batch)
            if len(block) == self.k:
                yield block
                block = []
        if block and not self.drop_last:
            yield block

    def __iter__(self) -> Iterator[list]:
        # one-shot: the producer thread consumes the upstream iterator; a
        # second producer over it would make block membership racy
        if self._consumed:
            raise RuntimeError(
                "BlockPrefetcher is one-shot: its upstream batch "
                "iterator is already (being) consumed — construct a new "
                "prefetcher over a fresh iterator")
        self._consumed = True
        return _iter_prefetched(self._blocks(), self.depth,
                                "dstpu-block-prefetch")


class FileDataset:
    """Memmap-backed pre-tokenized dataset: one ``<name>.npy`` per field and
    a ``manifest.json`` with the field order.  Rows stream from disk
    through the native gather; nothing is loaded up front.

    Write side: ``FileDataset.save(dir, ids=..., mask=...)``
    (``tokenization.build_mlm_arrays`` gives BERT pretraining's fields)."""

    def __init__(self, directory: str):
        self.directory = directory
        with open(os.path.join(directory, "manifest.json")) as f:
            self.fields = json.load(f)["fields"]
        self.arrays = [np.load(os.path.join(directory, f"{name}.npy"),
                               mmap_mode="r") for name in self.fields]
        n = len(self.arrays[0])
        if any(len(a) != n for a in self.arrays):
            raise ValueError("fields disagree on the sample count")
        self.n = n

    @staticmethod
    def save(directory: str, **fields) -> str:
        os.makedirs(directory, exist_ok=True)
        for name, arr in fields.items():
            np.save(os.path.join(directory, f"{name}.npy"),
                    np.ascontiguousarray(arr))
        with open(os.path.join(directory, "manifest.json"), "w") as f:
            json.dump({"fields": list(fields)}, f)
        return directory

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        out = tuple(np.asarray(a[i]) for a in self.arrays)
        return out if len(out) > 1 else out[0]

    def collate_gather(self, indices):
        out = tuple(native.gather_rows(a, indices) for a in self.arrays)
        return out if len(out) > 1 else out[0]


class ArrayDataset:
    """Arrays with a leading sample axis as an indexable dataset."""

    def __init__(self, *arrays):
        self.arrays = [np.ascontiguousarray(a) for a in arrays]
        n = len(self.arrays[0])
        if any(len(a) != n for a in self.arrays):
            raise ValueError("all arrays must share the leading dimension")
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        out = tuple(a[i] for a in self.arrays)
        return out if len(out) > 1 else out[0]

    def collate_gather(self, indices):
        out = tuple(native.gather_rows(a, indices) for a in self.arrays)
        return out if len(out) > 1 else out[0]
