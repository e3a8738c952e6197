"""Ring and Ulysses attention of the port against the JAX functions.

The port runs on gloo CPU ranks (``tests/torch_rank_worker.py``, scenario
``seq_attn``: the world is one seq group of sp ranks, each holding its
sequence block); the JAX ``ring_attention`` and ``ulysses_attention``
under ``shard_map`` on a ``seq`` mesh of the same sp (the oracles of
``tests/test_ring_attention.py`` and ``test_ulysses.py``), their
gradients taken through the ``shard_map`` from outside.  Both take the
same numpy q, k, v, padding mask and upstream gradient ``dy``; the port's
backward of ``sum(y * dy)`` on every rank gives each rank its blocks of
dq, dk and dv, the ring's and Ulysses' backward carrying the other ranks'
shares to it; causal and not, with the padding mask, and at sp 2 without
it.  fp32; forward and gradients within ``rtol=1e-5,
atol=1e-6`` (``dy`` is scaled so that the gradients are O(1), as the
outputs are).  The masks pad the trailing keys of one row and mask a
random fifth of the other's, so a query block may meet a key block with
no valid key (the ring's ``-1e30`` rows).

On the card (``cuda``-marked, skipped here): the same cases on CUDA
tensors in two processes sharing the card over gloo, against this file's
CPU results within the attention tolerance; Ulysses' local attention at
T 256 and 512 goes through the streaming kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from deepspeed_tpu.models.ring_attention import ring_attention as jring
from deepspeed_tpu.models.ulysses import ulysses_attention as julysses
from torch_ranks import run_ranks

RTOL, ATOL = 1e-5, 1e-6
#: the upstream gradient's scale (the gradients O(1), as the outputs)
DY = 0.1
#: on the card against the CPU, |err| <= ATTN_ATOL * max|want| + ATTN_RTOL
#: * |want|: chip_smoke.py's attention tolerance (the kernels' fp32 online
#: softmax over 64-row tiles against the plain version's whole rows)
ATTN_RTOL, ATTN_ATOL = 2e-2, 1e-2
B, N, D = 2, 4, 8


def inputs(T, seed):
    rng = np.random.default_rng(seed)
    x = {n: rng.standard_normal((B, T, N, D)).astype(np.float32)
         for n in "qkv"}
    x["dy"] = (rng.standard_normal((B, T, N, D)) * DY).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[0, T - T // 4 - 3:] = 0
    mask[1] = rng.random(T) > 0.2
    x["mask"] = mask
    return x


def cases(sp, T=32):
    """``(inputs, cases)``: ring and Ulysses, causal and not, with the
    padding mask (and at sp 2 without it too), on one set of inputs."""
    inp = {f"x/{k}": v for k, v in inputs(T, seed=sp).items()}
    out = []
    for impl in ("ring", "ulysses"):
        for causal in (True, False):
            for masked in ((False, True) if sp == 2 else (True,)):
                out.append(dict(name=f"{impl}-{causal}-{masked}", impl=impl,
                                causal=causal, masked=masked, input="x"))
    return inp, out


def jax_case(case, inp, sp):
    """The JAX function under ``shard_map``: its global output and the
    gradients of ``sum(y * dy)`` with respect to q, k and v."""
    mesh = Mesh(np.array(jax.devices()[:sp]).reshape(sp), ("seq",))
    pre = case["input"]
    q, k, v, dy, mask = (jnp.asarray(inp[f"{pre}/{n}"]) for n in
                         ("q", "k", "v", "dy", "mask"))
    causal, masked = case["causal"], case["masked"]
    fn = jring if case["impl"] == "ring" else julysses
    key = "kv_mask" if case["impl"] == "ring" else "attn_mask"
    seq = P(None, "seq")
    f = jax.shard_map(
        lambda a, b, c, m: fn(a, b, c, causal=causal,
                              **{key: m if masked else None}),
        mesh=mesh, in_specs=(seq,) * 4, out_specs=seq, check_vma=False)

    def loss(a, b, c):
        return jnp.sum(f(a, b, c, mask) * dy)
    y, grads = jax.jit(lambda a, b, c: (f(a, b, c, mask), jax.grad(
        loss, argnums=(0, 1, 2))(a, b, c)))(q, k, v)
    return np.asarray(y), [np.asarray(g) for g in grads]


def _joined(outs, key):
    return np.concatenate([o[key] for o in outs], axis=1)


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_and_ulysses_match_jax(sp, tmp_path):
    inp, cs = cases(sp)
    outs = run_ranks(tmp_path, sp, {"scenario": "seq_attn", "cases": cs},
                     inp)
    for case in cs:
        y, grads = jax_case(case, inp, sp)
        name = case["name"]
        np.testing.assert_allclose(_joined(outs, f"{name}/y"), y, rtol=RTOL,
                                   atol=ATOL, err_msg=f"{name} forward")
        for n, g in zip("qkv", grads):
            np.testing.assert_allclose(_joined(outs, f"{name}/d{n}"), g,
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} d{n}")
