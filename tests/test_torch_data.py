"""The port's data loader and native row gather against the JAX package's.

The scenarios of ``tests/test_dataloader.py`` and ``tests/test_native_io.py``
on ``deepspeed_tpu_torch.data`` and ``deepspeed_tpu_torch.native``: for the
same dataset, seed and epoch both loaders yield the same rows at every step
(compared exactly), a mid-epoch ``state_dict`` resumes where the run left
off with and without the producer thread, and the native gather equals
numpy.  Batches placed on a device arrive as torch tensors.
"""

import threading
import time

import numpy as np
import pytest
import torch

from deepspeed_tpu import data as jdata
from deepspeed_tpu import tokenization as jtok
from deepspeed_tpu_torch import data as tdata
from deepspeed_tpu_torch import native
from deepspeed_tpu_torch import tokenization as ttok
from deepspeed_tpu_torch.constants import ROUTE_EVAL, ROUTE_TRAIN


def make_arrays(n=64, d=4):
    x = np.arange(n * d, dtype=np.float32).reshape(n, d)
    y = np.arange(n, dtype=np.int32)
    return x, y


def as_numpy(batch):
    return [b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
            for b in batch]


@pytest.mark.parametrize("num_workers", [0, 1])
@pytest.mark.parametrize("route", [ROUTE_TRAIN, ROUTE_EVAL])
def test_same_rows_per_step_as_the_jax_loader(route, num_workers):
    x, y = make_arrays()
    kw = dict(batch_size=16, route=route, seed=11, num_workers=num_workers)
    jl = jdata.DeepSpeedDataLoader(jdata.ArrayDataset(x, y), **kw)
    tl = tdata.DeepSpeedDataLoader(tdata.ArrayDataset(x, y), **kw)
    for _ in range(2):                       # two epochs: the reshuffle too
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) == 4
        for j, t in zip(jb, tb):
            for a, b in zip(as_numpy(j), as_numpy(t)):
                np.testing.assert_array_equal(a, b)
    assert jl.epoch == tl.epoch == 2


def test_len_drop_last_and_eval_order():
    x, y = make_arrays(n=30)
    ds = tdata.ArrayDataset(x, y)
    assert len(tdata.DeepSpeedDataLoader(ds, batch_size=16)) == 1
    dl = tdata.DeepSpeedDataLoader(ds, batch_size=16, drop_last=False,
                                   route=ROUTE_EVAL)
    assert len(dl) == 2
    xb, yb = next(iter(dl))
    np.testing.assert_array_equal(yb, np.arange(16))
    np.testing.assert_array_equal(xb, x[:16])


def test_set_epoch_reproduces_a_shuffle():
    x, y = make_arrays()
    dl = tdata.DeepSpeedDataLoader(tdata.ArrayDataset(x, y), batch_size=64,
                                   seed=7)
    (_, y1), = list(dl)
    (_, y2), = list(dl)
    assert not np.array_equal(y1, y2)
    assert sorted(y1.tolist()) == list(range(64))
    dl.set_epoch(0)
    np.testing.assert_array_equal(next(iter(dl))[1], y1)


def test_tput_timer_hook_and_custom_collate():
    class Timer:
        count = 0

        def start(self):
            self.count += 1

    x, y = make_arrays()
    ds = tdata.ArrayDataset(x, y)
    t = Timer()
    dl = tdata.DeepSpeedDataLoader(ds, batch_size=16, tput_timer=t)
    list(dl)
    assert t.count == len(dl) == 4
    dl = tdata.DeepSpeedDataLoader(
        ds, batch_size=4, collate_fn=lambda samples: {"n": len(samples)})
    assert next(iter(dl)) == {"n": 4}


@pytest.mark.parametrize("num_workers", [0, 1])
def test_state_dict_mid_epoch_resume(num_workers):
    """A fresh loader given a mid-epoch state yields exactly the batches
    the interrupted run never consumed, then reshuffles on schedule; the
    JAX loader resumed from the same state yields the same rows."""
    x, y = make_arrays()
    ds = tdata.ArrayDataset(x, y)
    ref = tdata.DeepSpeedDataLoader(ds, batch_size=16, seed=9)
    ref_batches = list(ref) + list(ref)

    dl = tdata.DeepSpeedDataLoader(ds, batch_size=16, seed=9,
                                   num_workers=num_workers)
    it = iter(dl)
    consumed = [next(it) for _ in range(2)]
    for got, want in zip(consumed, ref_batches[:2]):
        np.testing.assert_array_equal(got[1], want[1])
    state = dl.state_dict()
    assert state == {"epoch": 0, "batch": 2, "seed": 9}
    it.close()

    resumed = tdata.DeepSpeedDataLoader(ds, batch_size=16, seed=123,
                                        num_workers=num_workers)
    resumed.load_state_dict(state)
    tail = list(resumed) + list(resumed)
    assert len(tail) == 2 + 4
    for got, want in zip(tail, ref_batches[2:]):
        np.testing.assert_array_equal(got[1], want[1])
    assert resumed.state_dict() == {"epoch": 2, "batch": 0, "seed": 9}

    jres = jdata.DeepSpeedDataLoader(jdata.ArrayDataset(x, y),
                                     batch_size=16, seed=0)
    jres.load_state_dict(state)
    for got, want in zip(list(jres), tail[:2]):
        np.testing.assert_array_equal(np.asarray(got[1]), want[1])


def test_load_state_dict_rejects_foreign_position():
    x, y = make_arrays()
    dl = tdata.DeepSpeedDataLoader(tdata.ArrayDataset(x, y), batch_size=16)
    with pytest.raises(ValueError, match="outside this loader's epoch"):
        dl.load_state_dict({"epoch": 0, "batch": 99, "seed": 0})


def test_file_dataset_round_trips_and_reads_the_jax_files(tmp_path):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 100, size=(32, 16)).astype(np.int32)
    w = rng.normal(size=(32, 4)).astype(np.float32)
    d = tdata.FileDataset.save(str(tmp_path / "ds"), ids=ids, w=w)
    fds = tdata.FileDataset(d)
    assert len(fds) == 32 and isinstance(fds.arrays[0], np.memmap)
    a, b = fds[5]
    np.testing.assert_array_equal(a, ids[5])
    np.testing.assert_array_equal(b, w[5])
    ga, gb = fds.collate_gather(np.array([3, 1, 2]))
    np.testing.assert_array_equal(ga, ids[[3, 1, 2]])
    np.testing.assert_array_equal(gb, w[[3, 1, 2]])
    # the JAX package's writer and reader share the layout
    jfds = jdata.FileDataset(d)
    np.testing.assert_array_equal(jfds[7][0], fds[7][0])
    d2 = jdata.FileDataset.save(str(tmp_path / "jds"), ids=ids)
    dl = tdata.DeepSpeedDataLoader(tdata.FileDataset(d2), batch_size=4,
                                   route=ROUTE_EVAL, num_workers=1)
    np.testing.assert_array_equal(np.concatenate(list(dl)), ids)


def test_device_prefetch_gives_tensors_on_the_device():
    x, y = make_arrays()
    dl = tdata.DeepSpeedDataLoader(tdata.ArrayDataset(x, y), batch_size=8,
                                   device="cpu", num_workers=1,
                                   device_prefetch=True, route=ROUTE_EVAL)
    xb, yb = next(iter(dl))
    assert isinstance(xb, torch.Tensor) and xb.device.type == "cpu"
    np.testing.assert_array_equal(yb.numpy(), np.arange(8))


@pytest.mark.parametrize("shape,dtype", [
    ((64, 16), np.float32),
    ((64, 8, 4), np.float16),
    ((64,), np.int32),
    ((64, 33), np.int8),          # odd row size
])
def test_native_gather_matches_numpy(shape, dtype):
    assert native.available()
    rng = np.random.default_rng(0)
    src = (rng.normal(size=shape) * 10).astype(dtype)
    idx = rng.integers(0, shape[0], size=41)
    native.reset_routes()
    np.testing.assert_array_equal(native.gather_rows(src, idx), src[idx])
    assert native.ROUTES == {"native": 1, "numpy": 0}


def test_native_gather_large_bounds_and_negatives():
    rng = np.random.default_rng(1)
    src = rng.normal(size=(4096, 512)).astype(np.float32)   # > 1 MB: threads
    idx = rng.permutation(4096)[:2048]
    np.testing.assert_array_equal(native.gather_rows(src, idx), src[idx])
    small = np.arange(12, dtype=np.float32).reshape(6, 2)
    np.testing.assert_array_equal(native.gather_rows(small, [-1, 0, -6]),
                                  small[[-1, 0, -6]])
    for bad in ([0, 6], [-7]):
        with pytest.raises(IndexError):
            native.gather_rows(small, np.asarray(bad))


def test_numpy_fallback_is_exact_and_recorded(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_tried", True)
    native.reset_routes()
    src = np.arange(20, dtype=np.float32).reshape(10, 2)
    idx = np.asarray([3, 1, 7])
    np.testing.assert_array_equal(native.gather_rows(src, idx), src[idx])
    assert native.ROUTES == {"native": 0, "numpy": 1}


def test_early_break_stops_the_producer():
    rng = np.random.default_rng(3)
    ds = tdata.ArrayDataset(rng.normal(size=(256, 8)).astype(np.float32))
    dl = tdata.DeepSpeedDataLoader(ds, batch_size=8, num_workers=1)
    it = iter(dl)
    next(it)
    it.close()          # what a break and garbage collection do

    def alive():
        return any(t.name == "dstt-io-prefetch" and t.is_alive()
                   for t in threading.enumerate())

    deadline = time.time() + 5
    while alive() and time.time() < deadline:
        time.sleep(0.05)
    assert not alive()


def test_producer_errors_reach_the_consumer():
    class Broken:
        def __len__(self):
            return 32

        def __getitem__(self, i):
            if i > 10:
                raise RuntimeError("boom")
            return np.zeros((2,), np.float32)

    dl = tdata.DeepSpeedDataLoader(Broken(), batch_size=16, num_workers=1,
                                   route=ROUTE_EVAL)
    with pytest.raises(RuntimeError, match="boom"):
        list(dl)


def test_build_mlm_arrays_matches_the_jax_copy():
    text = ("the quick brown fox jumps over the lazy dog . " * 300)
    words = sorted(set(text.split()))
    got = ttok.build_mlm_arrays(
        [text], ttok.BertTokenizer(ttok.Vocab(list(ttok.SPECIAL_TOKENS)
                                              + words)),
        seq_len=32, max_predictions=5, seed=1, n_samples=8)
    want = jtok.build_mlm_arrays(
        [text], jtok.BertTokenizer(jtok.Vocab(list(jtok.SPECIAL_TOKENS)
                                              + words)),
        seq_len=32, max_predictions=5, seed=1, n_samples=8)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("dp", [2, 4])
def test_per_rank_rows_equal_the_jax_shards(dp):
    """Rank r of dp yields rows [r * micro, (r + 1) * micro) of each global
    batch: the shard the JAX loader places on device r of the data axis,
    step by step, over two epochs."""
    import jax
    from deepspeed_tpu.parallel.topology import make_mesh
    x, y = make_arrays()
    micro = 4
    jl = jdata.DeepSpeedDataLoader(jdata.ArrayDataset(x, y),
                                   batch_size=micro * dp, seed=5,
                                   mesh=make_mesh(devices=jax.devices()[:dp]))
    jbatches = list(jl) + list(jl)
    devices = jax.devices()[:dp]
    for r in range(dp):
        tl = tdata.DeepSpeedDataLoader(tdata.ArrayDataset(x, y),
                                       batch_size=micro * dp, seed=5,
                                       dp_rank=r, dp_size=dp)
        tbatches = list(tl) + list(tl)
        assert len(tbatches) == len(jbatches) == 2 * (64 // (micro * dp))
        for jb, tb in zip(jbatches, tbatches):
            for jleaf, tleaf in zip(jb, tb):
                shard = next(s for s in jleaf.addressable_shards
                             if s.device == devices[r])
                assert tleaf.shape[0] == micro
                np.testing.assert_array_equal(np.asarray(shard.data), tleaf)


def test_state_dict_resume_holds_per_rank():
    """Each rank's loader, resumed from its own mid-epoch state, yields the
    rows that rank would have read next; the state is the same on every
    rank."""
    x, y = make_arrays()
    dp, micro = 2, 4
    states, refs = [], []
    for r in range(dp):
        kw = dict(batch_size=micro * dp, seed=3, dp_rank=r, dp_size=dp)
        ref = list(tdata.DeepSpeedDataLoader(tdata.ArrayDataset(x, y), **kw))
        dl = tdata.DeepSpeedDataLoader(tdata.ArrayDataset(x, y), **kw)
        it = iter(dl)
        for _ in range(3):
            next(it)
        states.append(dl.state_dict())
        it.close()
        resumed = tdata.DeepSpeedDataLoader(tdata.ArrayDataset(x, y), **kw)
        resumed.load_state_dict(states[-1])
        tail = list(resumed)
        assert len(tail) == len(ref) - 3
        for got, want in zip(tail, ref[3:]):
            np.testing.assert_array_equal(got[1], want[1])
        refs.append(ref)
    assert states[0] == states[1] == {"epoch": 0, "batch": 3, "seed": 3}
    # the ranks read disjoint rows that together make the global batch
    for b0, b1 in zip(*refs):
        assert not set(b0[1]) & set(b1[1])
    with pytest.raises(ValueError, match="split evenly"):
        tdata.DeepSpeedDataLoader(tdata.ArrayDataset(x, y), batch_size=6,
                                  dp_rank=0, dp_size=4)
