"""The CUDA optimizer kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc (they build
``deepspeed_tpu_torch/csrc/fused_optim.cu``); without a card they skip.  On
a machine with one, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: tests/conftest.py sets up the JAX package's CPU test rig,
which these tests do not use.)  Tolerance: fp32 ``rtol=1e-5, atol=1e-6``;
the kernels contract multiply-adds to FMAs and sum the norms in another
order than the plain versions.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import cuda_optim

pytestmark = pytest.mark.cuda
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
