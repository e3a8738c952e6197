"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc (they build
``deepspeed_tpu_torch/csrc/fused_optim.cu``, ``stream_attention.cu`` and
``block_attention.cu``); without a card they skip.  On a machine with one, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: tests/conftest.py sets up the JAX package's CPU test rig,
which these tests do not use.)  Tolerances: optimizer fp32 ``rtol=1e-5,
atol=1e-6``; the kernels contract multiply-adds to FMAs and sum the norms in
another order than the plain versions.  Attention: see ``ATTN_TOL``.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import block_attention as battn
from deepspeed_tpu_torch.ops import cuda_optim
from deepspeed_tpu_torch.ops import dispatch_attention as dattn
from deepspeed_tpu_torch.ops import stream_attention as sattn

pytestmark = pytest.mark.cuda
ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
SIZES = [1, 3, 4, 5, 1000, 4096 * 37 + 3]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def state(n, dev, seed=0, offset=0):
    """p, g, m, v on the card; ``offset`` > 0 makes views that are not
    16-byte aligned (the kernels' scalar path)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(4):
        x = rng.normal(size=n + offset).astype(np.float32)
        if i == 3:
            x = np.abs(x) * 0.01
        out.append(torch.tensor(x, device=dev)[offset:])
    return out


def scal_row(dev, step_size=1e-3, wd=0.01, lr=2e-3, combined_scale=4.0):
    return cuda_optim.make_scalars([(0.9, 0.999, step_size, wd, lr)],
                                   torch.tensor(combined_scale, device=dev),
                                   dev)[0]


def close(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", SIZES)
def test_lamb_kernel_matches_plain(dev, n, offset):
    k = state(n, dev, offset=offset)
    p = [t.clone() for t in k]
    scal = scal_row(dev)
    cuda_optim.reset_launch_counts()
    cuda_optim.fused_lamb_update(*k, scal, eps=1e-8, min_coeff=0.01,
                                 max_coeff=10.0)
    assert cuda_optim.LAUNCHES == {"lamb_phase1": 1, "lamb_phase2": 1,
                                   "adam": 0}
    u, parts = cuda_optim.lamb_phase1_plain(p[0], p[1], p[2], p[3], scal,
                                            eps=1e-8)
    cuda_optim.lamb_phase2_plain(p[0], u, parts, scal, min_coeff=0.01,
                                 max_coeff=10.0)
    torch.cuda.synchronize()
    close([k[0], k[2], k[3]], [p[0], p[2], p[3]])


def test_lamb_zero_norm_takes_coefficient_one(dev):
    p, g, m, v = state(1000, dev, seed=3)
    p.zero_()
    scal = scal_row(dev, wd=0.0, combined_scale=1.0)
    u, parts = cuda_optim.lamb_phase1(p, g, m, v, scal, eps=1e-8)
    want = -1e-3 * u
    cuda_optim.lamb_phase2(p, u, parts, scal, min_coeff=0.01, max_coeff=0.5)
    torch.testing.assert_close(p, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("decoupled", [False, True])
@pytest.mark.parametrize("eps_inside_sqrt", [False, True])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 5, 4096 * 37 + 3])
def test_adam_kernel_matches_plain(dev, n, offset, eps_inside_sqrt,
                                   decoupled):
    k = state(n, dev, seed=5, offset=offset)
    p = [t.clone() for t in k]
    scal = scal_row(dev)
    cuda_optim.reset_launch_counts()
    cuda_optim.fused_adam_update(*k, scal, eps=1e-8,
                                 eps_inside_sqrt=eps_inside_sqrt,
                                 decoupled=decoupled)
    assert cuda_optim.LAUNCHES["adam"] == 1
    cuda_optim.adam_plain(*p, scal, eps=1e-8,
                          eps_inside_sqrt=eps_inside_sqrt,
                          decoupled=decoupled)
    torch.cuda.synchronize()
    close(k[:1] + k[2:], p[:1] + p[2:])


@pytest.mark.parametrize("start,stop", [(0, 4096 * 37), (128 * 5, 128 * 900),
                                        (37, 4096 * 11 + 5), (3, 4)])
def test_adam_kernel_on_a_view_of_a_flat_buffer(dev, start, stop):
    """The ZeRO update's operands: slices of one flat fp32 buffer each
    (a 128-aligned bucket takes the float4 path, a leaf cut at any element
    the scalar one); nothing outside the slice moves."""
    n = 4096 * 40
    k = state(n, dev, seed=7)
    p = [t.clone() for t in k]
    scal = scal_row(dev)
    cuda_optim.reset_launch_counts()
    cuda_optim.fused_adam_update(*(t[start:stop] for t in k), scal,
                                 eps=1e-8, decoupled=True)
    assert cuda_optim.LAUNCHES["adam"] == 1
    before = [t.clone() for t in p]
    cuda_optim.adam_plain(*(t[start:stop] for t in p), scal, eps=1e-8,
                          decoupled=True)
    torch.cuda.synchronize()
    close(k[:1] + k[2:], p[:1] + p[2:])
    for got, was in zip(k, before):
        assert torch.equal(got[:start], was[:start])
        assert torch.equal(got[stop:], was[stop:])


def test_flat_update_launches_once_per_segment_with_its_row(dev):
    """``Adam.update_flat`` on a flat partition cut at leaf boundaries:
    one launch per segment, each with its leaf's hypers, equal to the
    plain version run segment by segment with the same rows."""
    from deepspeed_tpu_torch.ops import optim as optim_mod
    n = 4096 * 9 + 77
    p, g, m, v = state(n, dev, seed=11)
    ref = [t.clone() for t in (p, g, m, v)]
    segs = [(0, 1000, "a"), (1000, 1003, "b"), (1003, 4096 * 5, None),
            (4096 * 5, n, "a")]
    lr = {"a": 3e-3, "b": 1e-2}
    wd = {"a": 0.1}
    opt = optim_mod.AdamW(lr=1e-3, weight_decay=0.01)
    st = optim_mod.OptimizerState(step=4, m={"flat": m}, v={"flat": v})
    cuda_optim.reset_launch_counts()
    opt.update_flat(p, g, st, segs, lr=lr, weight_decay=wd,
                    combined_scale=torch.tensor(2.0, device=dev))
    assert cuda_optim.LAUNCHES["adam"] == len(segs) and st.step == 4
    rows = []
    for _, _, name in segs:
        lr_l, b1, b2, wd_l = opt._resolve(name, lr, None, None, wd)
        rows.append((b1, b2, opt._step_size(lr_l, 5, b1, b2), wd_l, lr_l))
    scal = cuda_optim.make_scalars(rows, torch.tensor(2.0, device=dev), dev)
    for i, (a, b, _) in enumerate(segs):
        cuda_optim.adam_plain(*(t[a:b] for t in ref), scal[i], eps=opt.eps,
                              decoupled=True)
    torch.cuda.synchronize()
    close([p, m, v], [ref[0], ref[2], ref[3]])


def test_wrappers_refuse_bad_inputs(dev):
    p, g, m, v = state(64, dev)
    scal = scal_row(dev)
    with pytest.raises(TypeError, match="float32"):
        cuda_optim.fused_adam_update(p.double(), g, m, v, scal, eps=1e-8)
    with pytest.raises(ValueError, match="elements"):
        cuda_optim.fused_adam_update(p, g[:10], m, v, scal, eps=1e-8)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_optim.fused_adam_update(p, g.view(8, 8).t(), m, v, scal,
                                     eps=1e-8)
    with pytest.raises(ValueError, match="is on cpu"):
        cuda_optim.fused_adam_update(p, g.cpu(), m, v, scal, eps=1e-8)
    u, parts = cuda_optim.lamb_phase1(p, g, m, v, scal, eps=1e-8)
    with pytest.raises(ValueError, match="partials"):
        cuda_optim.lamb_phase2(p, u, parts[:0], scal, min_coeff=0.0,
                               max_coeff=1.0)


# ---------------------------------------------------------------- attention

#: (rtol, atol as a fraction of the largest |want|).  The kernels run the
#: online softmax over 64-row tiles (32 in fp32) where the plain versions
#: take the whole row, so the rescaled p is rounded to bf16/fp16 at other
#: values, and the sums (dQ over kv tiles too) run in another order.
ATTN_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 1e-2),
            torch.float16: (5e-3, 2e-3)}


def attn_inputs(dev, dtype, T, d, B=2, n=2, seed=0):
    """qg, kg, vg, dog [B*n, T, d] and the key mask [B*n, 1, T], with the
    tail of one row's keys masked out."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.tensor(rng.normal(size=(B * n, T, d)),
                                dtype=dtype, device=dev) for _ in range(4))
    mask = torch.ones((B, T))
    mask[1, T - T // 4 - 3:] = 0.0
    return q, k, v, do, sattn.mask_gtd(mask.to(dev), B, T, n)


def attn_close(got, want, dtype):
    rtol, frac = ATTN_TOL[dtype]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=frac * float(w.float().abs().max()))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,d", [(256, 16), (256, 128), (512, 64),
                                 (256, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
def test_stream_attention_kernels_match_plain(dev, dtype, T, d, causal):
    q, k, v, do, mask = attn_inputs(dev, dtype, T, d)
    sattn.reset_launch_counts()
    o, lse = sattn.stream_fwd(q, k, v, mask, causal)
    po, plse = sattn.stream_fwd_plain(q, k, v, mask, causal)
    torch.cuda.synchronize()
    attn_close([o], [po], dtype)
    torch.testing.assert_close(lse, plse, rtol=1e-4, atol=1e-4)
    # the backward kernels on the plain forward's o and lse
    delta = (do.float() * po.float()).sum(-1)[:, None, :]
    args = (q, k, v, mask, do, plse, delta, causal)
    want = sattn.stream_bwd_plain(*args)
    fused = sattn.stream_bwd_fused(*args)
    dk, dv = sattn.stream_dkv(*args)
    dq = sattn.stream_dq(*args)
    torch.cuda.synchronize()
    attn_close(fused, want, dtype)
    attn_close((dq, dk, dv), want, dtype)
    assert sattn.LAUNCHES == {"stream_fwd": 1, "stream_bwd_fused": 1,
                              "stream_dkv": 1, "stream_dq": 1}


def _fwd_and_fused(q, k, v, do, mask, causal):
    """The forward and fused backward kernels, each against its plain
    version (the backward on the plain forward's o and lse)."""
    dtype = q.dtype
    sattn.reset_launch_counts()
    o, lse = sattn.stream_fwd(q, k, v, mask, causal)
    po, plse = sattn.stream_fwd_plain(q, k, v, mask, causal)
    delta = (do.float() * po.float()).sum(-1)[:, None, :]
    args = (q, k, v, mask, do, plse, delta, causal)
    got = sattn.stream_bwd_fused(*args)
    want = sattn.stream_bwd_plain(*args)
    torch.cuda.synchronize()
    attn_close([o], [po], dtype)
    torch.testing.assert_close(lse, plse, rtol=1e-4, atol=1e-4)
    attn_close(got, want, dtype)
    assert sattn.LAUNCHES == {"stream_fwd": 1, "stream_bwd_fused": 1,
                              "stream_dkv": 0, "stream_dq": 0}


#: head dims in (128, 256]: the DP-256 instantiations (the forward one
#: block an SM, dq one warpgroup of 64 rows a block, dkv and the fused
#: backward two warps to each 16 keys, each with 128 columns of dK and
#: dV); d 136 and 200 zero-fill columns d..255
D256_SHAPES = [(256, 256), (512, 256), (1024, 256), (256, 136), (512, 200)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,d", [(256, 16), (256, 64), (256, 128),
                                 (512, 16), (512, 64), (512, 128),
                                 (1024, 16), (1024, 64), (1024, 128),
                                 (192, 64)] + D256_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_stream_hopper_kernels_match_plain(dev, dtype, T, d, causal):
    """The register-accumulator forward (wgmma) and fused backward
    (mma.sync, dQ partials) over several kv tiles, every head-dim padding
    and a T that is not a multiple of the forward's 128-row block."""
    _fwd_and_fused(*attn_inputs(dev, dtype, T, d, seed=T + d), causal)


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_stream_kernels_fully_masked_row(dev, dtype, d):
    """A batch row with every key masked scores -1e9 everywhere, so its
    attention is uniform over all T keys (non-causal: under causal the
    kernels, like the Pallas grid, visit only the tiles up to the query's,
    where the plain versions take the whole row)."""
    B, n, T = 2, 2, 512
    q, k, v, do, _ = attn_inputs(dev, dtype, T, d, B=B, n=n, seed=9)
    mask = torch.ones((B, T), device=dev)
    mask[0] = 0.0
    mask[1, T // 2:] = 0.0
    maskg = sattn.mask_gtd(mask, B, T, n)
    _fwd_and_fused(q, k, v, do, maskg, False)
    o, _ = sattn.stream_fwd(q, k, v, maskg, False)
    uniform = v[:n].float().mean(dim=1, keepdim=True).expand(n, T, d)
    attn_close([o[:n]], [uniform.to(dtype)], dtype)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,d", [(512, 64), (1024, 64), (1024, 128),
                                 (1024, 256)])
def test_stream_fused_backward_is_deterministic(dev, T, d, causal):
    """Bitwise repeatable dQ, summed across kv blocks through partials and
    tickets, with 128-key blocks (d 64) and 64-key blocks (d 128, 256)."""
    q, k, v, do, mask = attn_inputs(dev, torch.bfloat16, T, d, seed=4)
    o, lse = sattn.stream_fwd(q, k, v, mask, causal)
    delta = (do.float() * o.float()).sum(-1)[:, None, :]
    args = (q, k, v, mask, do, lse, delta, causal)
    first = sattn.stream_bwd_fused(*args)
    for _ in range(3):
        for a, b in zip(first, sattn.stream_bwd_fused(*args)):
            assert torch.equal(a, b)


def test_stream_fused_scratch_reused_across_shapes(dev):
    """The fused backward's cached scratch (the int counters, then the
    partials; the fp32 route's sum) stays right when shapes and types
    change between calls: a wider counter block is zeroed, a narrower one
    found zero."""
    cases = [(torch.bfloat16, 1024, 128, 2), (torch.float16, 2048, 64, 2),
             (torch.float32, 256, 64, 2), (torch.bfloat16, 512, 64, 2),
             (torch.bfloat16, 1024, 128, 4), (torch.float16, 2048, 64, 2)]
    for dtype, T, d, B in cases:
        q, k, v, do, mask = attn_inputs(dev, dtype, T, d, B=B, seed=T)
        _fwd_and_fused(q, k, v, do, mask, True)


#: the split pair's shapes: every head-dim padding (d 40 and 64 in 64,
#: d 128, D256_SHAPES), one to 32 kv tiles, and a dq block whose second
#: warpgroup lies past T (T 192)
SPLIT_SHAPES = [(T, d) for T in (256, 512, 1024, 2048) for d in (64, 128)
                ] + [(192, 64), (256, 40)] + D256_SHAPES


def _split_pair(q, k, v, do, mask, causal):
    """dq, dk, dv of the split pair on the plain forward's o and lse, and
    the plain backward's."""
    po, plse = sattn.stream_fwd_plain(q, k, v, mask, causal)
    delta = (do.float() * po.float()).sum(-1)[:, None, :]
    args = (q, k, v, mask, do, plse, delta, causal)
    sattn.reset_launch_counts()
    dk, dv = sattn.stream_dkv(*args)
    dq = sattn.stream_dq(*args)
    want = sattn.stream_bwd_plain(*args)
    torch.cuda.synchronize()
    assert sattn.LAUNCHES == {"stream_fwd": 0, "stream_bwd_fused": 0,
                              "stream_dkv": 1, "stream_dq": 1}
    return (dq, dk, dv), want, args


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,d", SPLIT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_stream_split_pair_hopper_kernels_match_plain(dev, dtype, T, d,
                                                       causal):
    """The bf16/fp16 split pair (dkv: mma.sync with register dK/dV; dq:
    wgmma with register dQ) on padded keys."""
    got, want, _ = _split_pair(*attn_inputs(dev, dtype, T, d, seed=T + d),
                               causal)
    attn_close(got, want, dtype)


@pytest.mark.parametrize("T,d", [(512, 64), (1024, 128), (192, 64),
                                 (512, 256)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_stream_split_pair_fully_masked_row(dev, dtype, T, d):
    """A batch row with every key masked (its lse that of an all -1e9 row)
    and one with half its keys masked, non-causal (under causal the
    kernels, like the Pallas grid, skip the tiles after the query's where
    the plain versions take the whole row)."""
    B, n = 2, 2
    q, k, v, do, _ = attn_inputs(dev, dtype, T, d, B=B, n=n, seed=13)
    mask = torch.ones((B, T), device=dev)
    mask[0] = 0.0
    mask[1, T // 2:] = 0.0
    got, want, _ = _split_pair(q, k, v, do, sattn.mask_gtd(mask, B, T, n),
                               False)
    attn_close(got, want, dtype)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,d", [(512, 64), (2048, 64), (1024, 128),
                                 (1024, 256)])
def test_stream_split_pair_is_deterministic(dev, T, d, causal):
    """Bitwise repeatable dK, dV and dQ: every block owns its outputs."""
    q, k, v, do, mask = attn_inputs(dev, torch.bfloat16, T, d, seed=4)
    first, _, args = _split_pair(q, k, v, do, mask, causal)
    for _ in range(2):
        again = (sattn.stream_dq(*args),) + sattn.stream_dkv(*args)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_fused_scratch_mirror_matches_the_library(dev):
    """The port's Python mirror of the fused scratch size (the ``auto``
    gate's, which the CPU needs too) is ``dstt_stream_bwd_fused_scratch``."""
    import ctypes
    lib = sattn.build()
    for dtype, code in sattn._DTYPE_CODE.items():
        for G in (1, 3, 32, 128):
            for T in (64, 192, 256, 512, 1024, 2048, 8192):
                for d in (8, 40, 64, 72, 128, 136, 256):
                    counters = ctypes.c_longlong(-1)
                    words = lib.dstt_stream_bwd_fused_scratch(
                        code, G, T, d, ctypes.byref(counters))
                    assert sattn.fused_scratch_words(dtype, G, T, d) == (
                        words, counters.value), (dtype, G, T, d)


def test_stream_backward_auto_takes_the_pair_past_the_budget(dev,
                                                             monkeypatch):
    """A long-T shape whose fused scratch exceeds the committed budget, in
    ``auto``: the split pair launches, no fused scratch is allocated, and
    the grads match the plain backward's."""
    monkeypatch.delenv("DSTPU_STREAM_BWD", raising=False)
    B, n, T, d = 4, 4, 4096, 64
    q, k, v, do, mask = attn_inputs(dev, torch.bfloat16, T, d, B=B, n=n,
                                    seed=21)
    assert 4 * sattn.fused_scratch_words(q.dtype, *q.shape)[0] > \
        sattn.STREAM_FUSED_SCRATCH_BUDGET
    po, plse = sattn.stream_fwd_plain(q, k, v, mask, True)
    scratch = {key: (e[0].data_ptr(), e[0].numel())
               for key, e in sattn._scratch.items()}
    sattn.reset_launch_counts()
    got = sattn.stream_backward(q, k, v, mask, po, plse, do, True)
    torch.cuda.synchronize()
    assert sattn.LAUNCHES == {"stream_fwd": 0, "stream_bwd_fused": 0,
                              "stream_dkv": 1, "stream_dq": 1}
    assert {key: (e[0].data_ptr(), e[0].numel())
            for key, e in sattn._scratch.items()} == scratch
    delta = (do.float() * po.float()).sum(-1)[:, None, :]
    attn_close(got, sattn.stream_bwd_plain(q, k, v, mask, do, plse, delta,
                                           True), torch.bfloat16)


@pytest.mark.parametrize("causal", [False, True])
def test_stream_fp32_route_and_split_pair_match_plain(dev, causal):
    """The fp32 forward and fused backward, and the split pair in every
    type (fp32: the first kernels; bf16/fp16: the Hopper pair), at
    T 1024."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        q, k, v, do, mask = attn_inputs(dev, dtype, 1024, 64, seed=11)
        if dtype == torch.float32:
            _fwd_and_fused(q, k, v, do, mask, causal)
        po, plse = sattn.stream_fwd_plain(q, k, v, mask, causal)
        delta = (do.float() * po.float()).sum(-1)[:, None, :]
        args = (q, k, v, mask, do, plse, delta, causal)
        dq, (dk, dv) = sattn.stream_dq(*args), sattn.stream_dkv(*args)
        torch.cuda.synchronize()
        attn_close((dq, dk, dv), sattn.stream_bwd_plain(*args), dtype)


def test_stream_attention_autograd_on_the_card(dev, monkeypatch):
    """The autograd function through the kernels (both backward modes)
    against the same function on the CPU (plain versions)."""
    rng = np.random.default_rng(7)
    x = [rng.normal(size=(2, 256, 4, 32)).astype(np.float32)
         for _ in range(4)]
    mask = np.ones((2, 256), np.float32)
    mask[0, 200:] = 0.0

    def run(device):
        q, k, v = (torch.tensor(a, device=device, requires_grad=True)
                   for a in x[:3])
        out = sattn.stream_attention(q, k, v, torch.tensor(mask,
                                                           device=device))
        (out * torch.tensor(x[3], device=device)).sum().backward()
        return [t.detach().cpu() for t in (out, q.grad, k.grad, v.grad)]

    want = run("cpu")
    for mode in ("fused", "split"):
        monkeypatch.setenv("DSTPU_STREAM_BWD", mode)
        attn_close(run(dev), want, torch.float32)


def test_stream_wrappers_refuse_bad_inputs(dev):
    q, k, v, do, mask = attn_inputs(dev, torch.bfloat16, 256, 32)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        sattn.stream_fwd(q.double(), k.double(), v.double(), mask, False)
    with pytest.raises(ValueError, match="multiple of 64"):
        sattn.stream_fwd(q[:, :200], k[:, :200], v[:, :200],
                         mask[..., :200].contiguous(), False)
    with pytest.raises(ValueError, match="contiguous"):
        sattn.stream_fwd(q, k.transpose(0, 1).contiguous().transpose(0, 1),
                         v, mask, False)
    with pytest.raises(ValueError, match="mask must be"):
        sattn.stream_fwd(q, k, v, mask.half(), False)
    with pytest.raises(ValueError, match="is on cpu"):
        sattn.stream_fwd(q, k.cpu(), v, mask, False)
    wide = torch.zeros((4, 256, 264), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="up to 256"):
        sattn.stream_fwd(wide, wide, wide, mask, False)


# ------------------------------------------------------ whole-tile attention

#: (rtol, atol as a fraction of the largest |want|).  The kernels and the
#: plain versions compute the same fp32 probabilities up to the order of
#: the sums, so a bf16/fp16 cast of p or dS can round the other way.
BLOCK_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 1e-2),
             torch.float16: (5e-3, 2e-3)}


def block_inputs(dev, dtype, T, d, B=2, n=3, seed=0):
    """q, k, v as views of one packed [B, T, n, 3, d] tensor (the model's
    layout), dO [B, T, n, d], and a [B, T] key mask with a padded tail in
    row 1 and every key masked in row 0 (a uniform row)."""
    rng = np.random.default_rng(seed)
    qkv = torch.tensor(rng.normal(size=(B, T, n, 3, d)), dtype=dtype,
                       device=dev)
    do = torch.tensor(rng.normal(size=(B, T, n, d)), dtype=dtype,
                      device=dev)
    mask = torch.ones((B, T), device=dev)
    mask[0] = 0.0
    mask[1, T - T // 4 - 3:] = 0.0
    return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :], do, mask


def block_close(got, want, dtype):
    rtol, frac = BLOCK_TOL[dtype]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=frac * float(w.float().abs().max()))


#: T below one warpgroup's 64 rows (16, 48), a T that is not a multiple of
#: 64 (48), two warpgroups (128), and head dims below, at and past a
#: multiple of 16 (16, 32, 40, 64): the wgmma kernels pad d to 64
BLOCK_SHAPES = [(64, 32), (128, 64), (128, 32), (48, 16)] + [
    (T, d) for T in (16, 48, 64, 128) for d in (16, 40, 64)
    if (T, d) not in ((128, 64), (48, 16))]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,d", BLOCK_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
def test_block_attention_kernels_match_plain(dev, dtype, T, d, causal):
    """Both routes (fp32: the FMA kernels; bf16/fp16: wgmma) on padded
    keys (under causal the exact skip) and a fully masked row."""
    q, k, v, do, mask = block_inputs(dev, dtype, T, d)
    battn.reset_launch_counts()
    o = battn.block_fwd(q, k, v, mask, causal)
    grads = battn.block_bwd(q, k, v, mask, do, causal)
    want_o = battn.block_fwd_plain(q, k, v, mask, causal)
    want = battn.block_bwd_plain(q, k, v, mask, do, causal)
    torch.cuda.synchronize()
    assert battn.LAUNCHES == {"block_fwd": 1, "block_bwd": 1,
                              "block_fwd_wide": 0, "block_bwd_wide": 0}
    assert o.is_contiguous() and all(g.is_contiguous() for g in grads)
    block_close([o], [want_o], dtype)
    block_close(grads, want, dtype)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_block_backward_is_deterministic(dev, dtype, causal):
    q, k, v, do, mask = block_inputs(dev, dtype, 128, 64, seed=4)
    first = battn.block_bwd(q, k, v, mask, do, causal)
    for _ in range(3):
        for a, b in zip(first, battn.block_bwd(q, k, v, mask, do, causal)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
def test_block_causal_skip_takes_whole_rows_where_needed(dev, dtype):
    """Causal, T 128, batch rows whose first keys are masked: with the
    first unmasked key at 0 the first 64-row block skips the second key
    block; at 5 and 64 it must take the whole row (its first rows are
    uniform over all T keys); at 70 both blocks hold uniform rows."""
    T, d = 128, 64
    q, k, v, do, _ = block_inputs(dev, dtype, T, d, B=4, seed=6)
    mask = torch.ones((4, T), device=dev)
    for row, first in enumerate((0, 5, 64, 70)):
        mask[row, :first] = 0.0
    o = battn.block_fwd(q, k, v, mask, True)
    grads = battn.block_bwd(q, k, v, mask, do, True)
    want = battn.block_bwd_plain(q, k, v, mask, do, True)
    torch.cuda.synchronize()
    block_close([o], [battn.block_fwd_plain(q, k, v, mask, True)], dtype)
    block_close(grads, want, dtype)
    # row 1's first 5 queries attend uniformly over all T keys
    uniform = v[1, :, :].float().mean(dim=0).expand(5, -1, -1)
    block_close([o[1, :5]], [uniform.to(dtype)], dtype)


def test_block_launch_limit_holds_for_a_later_longer_seq(dev):
    """The bf16/fp16 kernels set their shared-memory limit once per
    process: a first launch at T 64 must leave room for a later one at
    T 128 (a fresh process, so these are the first launches)."""
    script = (
        "import torch\n"
        "from deepspeed_tpu_torch.ops import block_attention as battn\n"
        "dev = torch.device('cuda', 0)\n"
        "for T in (64, 128):\n"
        "    q, k, v, do = (torch.randn(2, T, 3, 64, device=dev,\n"
        "                   dtype=torch.bfloat16) for _ in range(4))\n"
        "    mask = torch.ones(2, T, device=dev)\n"
        "    o = battn.block_fwd(q, k, v, mask, True)\n"
        "    g = battn.block_bwd(q, k, v, mask, do, True)\n"
        "    torch.cuda.synchronize()\n"
        "    want = battn.block_fwd_plain(q, k, v, mask, True)\n"
        "    assert (o.float() - want.float()).abs().max() < 0.05, T\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("fwd_impl,bwd_impl", [
    ("block", "block"), ("block", "xla"), ("xla", "block")])
def test_block_attention_autograd_on_the_card(dev, fwd_impl, bwd_impl):
    """The autograd functions through the kernels against the same
    functions on the CPU (plain versions)."""
    rng = np.random.default_rng(7)
    x = [rng.normal(size=(2, 128, 4, 32)).astype(np.float32)
         for _ in range(4)]
    mask = np.ones((2, 128), np.float32)
    mask[0, 100:] = 0.0

    def run(device):
        q, k, v = (torch.tensor(a, device=device, requires_grad=True)
                   for a in x[:3])
        m = torch.tensor(mask, device=device)
        if fwd_impl == bwd_impl:
            out = battn.fused_attention(q, k, v, m, True)
        else:
            out = dattn.dispatch_attention(q, k, v, m, True, fwd_impl,
                                           bwd_impl)
        (out * torch.tensor(x[3], device=device)).sum().backward()
        return [t.detach().cpu() for t in (out, q.grad, k.grad, v.grad)]

    want = run("cpu")
    battn.reset_launch_counts()
    block_close(run(dev), want, torch.float32)
    assert battn.LAUNCHES == {"block_fwd": int(fwd_impl == "block"),
                              "block_bwd": int(bwd_impl == "block"),
                              "block_fwd_wide": 0, "block_bwd_wide": 0}


def test_block_wrappers_refuse_bad_inputs(dev):
    q, k, v, do, mask = block_inputs(dev, torch.bfloat16, 128, 32)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        battn.block_fwd(q.double(), k.double(), v.double(), mask, False)
    with pytest.raises(ValueError, match="multiple of 8 up to 512"):
        battn.block_fwd(q[:, :124], k[:, :124], v[:, :124],
                        mask[:, :124].contiguous(), False)
    wq, wk, wv, _, wmask = block_inputs(dev, torch.bfloat16, 64, 136)
    with pytest.raises(ValueError, match="d a multiple of 8 up to 128"):
        battn.block_fwd(wq, wk, wv, wmask, False)
    with pytest.raises(ValueError, match="share one layout"):
        battn.block_fwd(q, k.contiguous(), v, mask, False)
    with pytest.raises(ValueError, match="do must be contiguous"):
        battn.block_bwd(q, k, v, mask, do.transpose(1, 2).contiguous()
                        .transpose(1, 2), False)
    with pytest.raises(ValueError, match="mask must be"):
        battn.block_fwd(q, k, v, mask.half(), False)
    with pytest.raises(ValueError, match="is on cpu"):
        battn.block_fwd(q, k, v, mask.cpu(), False)


# ------------------------- whole-tile attention, route 0 at head dims past 64

#: the bf16/fp16 route-0 kernels pad a head dim in (64, 128] to 128: d 72
#: (one 16-byte chunk past 64), 96 (GPT-2 large) and 128 (the 8b preset),
#: at T below one warpgroup's 64 rows (16, 48), at 64, and at two
#: warpgroups (96, 128)
WG_WIDE_SHAPES = [(T, d) for T in (16, 48, 64, 96, 128) for d in (72, 96,
                                                                   128)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,d", WG_WIDE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_block_route0_head_dim_128_match_plain(dev, dtype, T, d, causal):
    """Route 0's DP-128 kernels on padded keys (under causal the exact
    skip) and a fully masked row, against the plain versions."""
    assert not battn.wide_route(T, d, dtype)
    q, k, v, do, mask = block_inputs(dev, dtype, T, d)
    battn.reset_launch_counts()
    o = battn.block_fwd(q, k, v, mask, causal)
    grads = battn.block_bwd(q, k, v, mask, do, causal)
    want_o = battn.block_fwd_plain(q, k, v, mask, causal)
    want = battn.block_bwd_plain(q, k, v, mask, do, causal)
    torch.cuda.synchronize()
    assert battn.LAUNCHES == {"block_fwd": 1, "block_bwd": 1,
                              "block_fwd_wide": 0, "block_bwd_wide": 0}
    assert o.is_contiguous() and all(g.is_contiguous() for g in grads)
    block_close([o], [want_o], dtype)
    block_close(grads, want, dtype)


@pytest.mark.parametrize("d", [96, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_block_route0_head_dim_128_backward_is_deterministic(dev, dtype,
                                                             causal, d):
    q, k, v, do, mask = block_inputs(dev, dtype, 128, d, seed=4)
    first = battn.block_bwd(q, k, v, mask, do, causal)
    for _ in range(3):
        for a, b in zip(first, battn.block_bwd(q, k, v, mask, do, causal)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_block_route0_head_dim_128_causal_skip(dev, dtype):
    """The causal skip of the DP-128 kernels, as
    test_block_causal_skip_takes_whole_rows_where_needed at d 96."""
    T, d = 128, 96
    q, k, v, do, _ = block_inputs(dev, dtype, T, d, B=4, seed=6)
    mask = torch.ones((4, T), device=dev)
    for row, first in enumerate((0, 5, 64, 70)):
        mask[row, :first] = 0.0
    o = battn.block_fwd(q, k, v, mask, True)
    grads = battn.block_bwd(q, k, v, mask, do, True)
    want = battn.block_bwd_plain(q, k, v, mask, do, True)
    torch.cuda.synchronize()
    block_close([o], [battn.block_fwd_plain(q, k, v, mask, True)], dtype)
    block_close(grads, want, dtype)
    uniform = v[1, :, :].float().mean(dim=0).expand(5, -1, -1)
    block_close([o[1, :5]], [uniform.to(dtype)], dtype)


# ------------------------------------- whole-tile attention, the wide route

#: every shape of the JAX gate past the route-0 kernels (T a multiple of 16
#: up to 128 with d up to 64 in fp32, up to 128 in bf16 and fp16): T not a
#: multiple of 16 (8, 24, 72, 136, 264, 504), T past 128 (136-512), d past
#: 64 (96, 128) and below it (8, 40); each pads d to 64, 96 or 128 (fp32:
#: 64 or 128).  (128, 96) and (128, 128) are the wide route's in fp32 only.
WIDE_SHAPES = [(8, 8), (24, 64), (72, 96), (128, 96), (128, 128), (136, 64),
               (176, 128), (264, 40), (504, 64), (512, 128)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,d", WIDE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
def test_block_wide_kernels_match_plain(dev, dtype, T, d, causal):
    """The wide route on padded keys (under causal its skip) and a fully
    masked row, against the plain versions, counted on its own keys (on
    route 0's where the shape is route 0's in this type)."""
    wide = int(battn.wide_route(T, d, dtype))
    assert wide or (T == 128 and dtype != torch.float32)
    q, k, v, do, mask = block_inputs(dev, dtype, T, d)
    battn.reset_launch_counts()
    o = battn.block_fwd(q, k, v, mask, causal)
    grads = battn.block_bwd(q, k, v, mask, do, causal)
    want_o = battn.block_fwd_plain(q, k, v, mask, causal)
    want = battn.block_bwd_plain(q, k, v, mask, do, causal)
    torch.cuda.synchronize()
    assert battn.LAUNCHES == {"block_fwd": 1 - wide, "block_bwd": 1 - wide,
                              "block_fwd_wide": wide, "block_bwd_wide": wide}
    assert o.is_contiguous() and all(g.is_contiguous() for g in grads)
    block_close([o], [want_o], dtype)
    block_close(grads, want, dtype)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
def test_block_wide_backward_is_deterministic(dev, dtype, causal):
    q, k, v, do, mask = block_inputs(dev, dtype, 176, 96, seed=4)
    first = battn.block_bwd(q, k, v, mask, do, causal)
    for _ in range(3):
        for a, b in zip(first, battn.block_bwd(q, k, v, mask, do, causal)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
def test_block_wide_causal_skip_takes_whole_rows_where_needed(dev, dtype):
    """Causal, T 264: batch rows whose first unmasked key is 0, 5, 64, 70
    and 200.  A query block (or, in the dkv kernel, a query tile) may skip
    the keys after it only when its first row is at or past that key."""
    T, d = 264, 64
    firsts = (0, 5, 64, 70, 200)
    q, k, v, do, _ = block_inputs(dev, dtype, T, d, B=len(firsts), seed=6)
    mask = torch.ones((len(firsts), T), device=dev)
    for row, first in enumerate(firsts):
        mask[row, :first] = 0.0
    o = battn.block_fwd(q, k, v, mask, True)
    grads = battn.block_bwd(q, k, v, mask, do, True)
    want = battn.block_bwd_plain(q, k, v, mask, do, True)
    torch.cuda.synchronize()
    block_close([o], [battn.block_fwd_plain(q, k, v, mask, True)], dtype)
    block_close(grads, want, dtype)
    # row 4's first 200 queries attend uniformly over all T keys
    uniform = v[4].float().mean(dim=0).expand(200, -1, -1)
    block_close([o[4, :200]], [uniform.to(dtype)], dtype)


def test_block_wide_launch_limit_holds_for_a_later_longer_seq(dev):
    """The wide kernels' shared memory grows with T and their limit is set
    once per process, at the size of T 512: a first launch at T 72 must
    leave room for a later one at T 512 (a fresh process)."""
    script = (
        "import torch\n"
        "from deepspeed_tpu_torch.ops import block_attention as battn\n"
        "dev = torch.device('cuda', 0)\n"
        "for dt in (torch.bfloat16, torch.float32):\n"
        "    for T in (72, 512):\n"
        "        q, k, v, do = (torch.randn(1, T, 1, 128, device=dev,\n"
        "                       dtype=dt) for _ in range(4))\n"
        "        mask = torch.ones(1, T, device=dev)\n"
        "        o = battn.block_fwd(q, k, v, mask, True)\n"
        "        g = battn.block_bwd(q, k, v, mask, do, True)\n"
        "        torch.cuda.synchronize()\n"
        "        want = battn.block_fwd_plain(q, k, v, mask, True)\n"
        "        assert (o.float() - want.float()).abs().max() < 0.05, T\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ------------------------------------------- sequence-parallel attention

def _seq_inputs(T, d, seed):
    rng = np.random.default_rng(seed)
    x = {n: rng.standard_normal((2, T, 4, d)).astype(np.float32)
         for n in "qkv"}
    x["dy"] = (rng.standard_normal((2, T, 4, d)) * 0.1).astype(np.float32)
    mask = np.ones((2, T), np.int32)
    mask[0, T - T // 4 - 3:] = 0
    mask[1] = rng.random(T) > 0.2
    x["mask"] = mask
    return x


def test_seq_attention_on_the_card(dev, tmp_path):
    """Ring and Ulysses on CUDA tensors in two processes sharing the card
    over gloo, against the same cases on the CPU (the plain versions),
    within fp32's ``ATTN_TOL``: the ring's plain ops at seq 64; Ulysses' local
    attention over the full sequence through the whole-tile kernels at
    seq 64 (causal) and the streaming kernels at 256 and 512."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_ranks import run_ranks
    sattn.build()
    battn.build()
    inp, cases = {}, []
    for T, impl, causal, masked in ((64, "ring", True, True),
                                    (64, "ring", False, True),
                                    (64, "ulysses", True, False),
                                    (256, "ulysses", True, False),
                                    (512, "ulysses", False, True)):
        pre = f"T{T}"
        if f"{pre}/q" not in inp:
            inp.update({f"{pre}/{k}": v
                        for k, v in _seq_inputs(T, 64, T).items()})
        cases.append(dict(name=f"{impl}-{T}-{causal}", impl=impl,
                          causal=causal, masked=masked, input=pre))
    spec = {"scenario": "seq_attn", "cases": cases}
    cpu = run_ranks(tmp_path / "cpu", 2, spec, inp)
    gpu = run_ranks(tmp_path / "gpu", 2, dict(spec, device="cuda"), inp,
                    cuda=True)
    for c, g in zip(cpu, gpu):
        for key, want in c.items():
            if not key.startswith("launches/"):
                attn_close([torch.from_numpy(g[key])],
                           [torch.from_numpy(want)], torch.float32)
        # each rank's Ulysses runs: one forward and one backward each
        assert g["launches/block_fwd"] == g["launches/block_bwd"] == 1
        assert g["launches/stream_fwd"] == 2
        assert g["launches/stream_dkv"] + g[
            "launches/stream_bwd_fused"] == 2


# ------------------------------------------------------ Mixture of Experts

def test_gpt2_moe_step_on_the_card(dev):
    """A tiny GPT2MoE (top-2, 4 experts, seq 128: the whole-tile kernels'
    fp32 route) takes 2 Adam steps through ``initialize`` on the card and
    on the CPU from the same weights: the losses and masters agree within
    ``rtol=1e-4, atol=1e-5``, and the card's steps launched the kernels."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import weights
    from deepspeed_tpu_torch.models import GPT2MoE
    cuda_optim.build()
    battn.build()
    kw = dict(num_experts=4, router_top_k=2, capacity_factor=2.0,
              num_layers=2, hidden_size=64, num_heads=2, vocab_size=128,
              max_seq_len=128, remat=False)
    ref = GPT2MoE.from_size("tiny", generator=torch.Generator().manual_seed(
        0), **kw)
    params = weights.params_to_numpy(ref)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 128, (4, 128)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    cfg = {"train_batch_size": 4, "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}

    def run(device):
        eng = deepspeed_tpu_torch.initialize(
            config=cfg, model=GPT2MoE.from_size("tiny", **kw),
            model_parameters=params, device=device)[0]
        losses = [float(eng.train_batch((toks, labels))) for _ in range(2)]
        return losses, {k: t.detach().cpu() for k, t in eng.master.items()}

    want_l, want_m = run("cpu")
    cuda_optim.reset_launch_counts()
    battn.reset_launch_counts()
    got_l, got_m = run(dev)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4)
    for k, w in want_m.items():
        np.testing.assert_allclose(got_m[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert cuda_optim.LAUNCHES["adam"] == 2 * len(want_m)
    assert battn.LAUNCHES == {"block_fwd": 4, "block_bwd": 4,
                              "block_fwd_wide": 0, "block_bwd_wide": 0}
