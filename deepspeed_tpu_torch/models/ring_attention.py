"""Ring attention: exact attention over a sequence-sharded ring.

The port of ``deepspeed_tpu/models/ring_attention.py``.  The sequence is
cut over the seq group (``parallel/topology.py``): rank ``s`` holds query,
key and value block ``s``.  The K/V blocks (and the padding mask) go round
the ring, one ``comm.seq_ring_shift`` per step, and each rank folds the
block it holds into a running softmax (running max ``m``, partition sum
``l``, weighted accumulator ``o``), so the full ``[T, T]`` score matrix
never exists.  The arithmetic is the JAX function's, op for op, in fp32
tensor ops (the JAX package runs it as einsums outside any Pallas kernel):

* at step ``i`` rank ``s`` holds the block of rank ``src = (s - i) %
  sp``; causally, ``src < s`` attends fully, ``src == s`` takes the local
  triangle, ``src > s`` is masked, and its scores are still computed;
* masked scores are ``-1e30``, not ``-inf``: a query row whose keys are
  all masked averages its values uniformly, as in the JAX function;
* the output is ``o / max(l, 1e-30)``.

Autograd runs through the shifts (``seq_ring_shift``'s backward sends the
gradient back round the ring), so the gradients of K and V reach the rank
that holds them.  Peak score memory per step is one fp32 ``[B, n, T / sp,
T / sp]`` block, kept per step and layer for the backward.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.parallel import comm

_NEG = -1e30


def ring_attention(q, k, v, *, causal=True, kv_mask=None, group=None,
                   scale=None):
    """q, k, v: [B, Tl, n, d], this rank's sequence block; ``kv_mask``
    optional [B, Tl] with 1 = attend (it rotates with K and V); ``group``
    the seq group (None: one rank, the plain masked attention).  Returns
    [B, Tl, n, d] in q's dtype."""
    sp = 1 if group is None else dist.get_world_size(group)
    my = 0 if group is None else dist.get_rank(group)
    B, Tl, n, d = q.shape
    # the JAX scale, 1 / sqrt(d) computed in fp32
    scale = (1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
             if scale is None else torch.tensor(scale, dtype=torch.float32)
             ).to(q.device)
    qf = q.float()
    m = torch.full((B, n, Tl), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, n, Tl), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, Tl, n, d), dtype=torch.float32, device=q.device)
    local_tri = torch.tril(torch.ones((Tl, Tl), dtype=torch.bool,
                                      device=q.device))
    # K and V travel as one tensor: one shift a step
    kv_cur = torch.stack([k, v])
    mask_cur = kv_mask
    for i in range(sp):
        k_cur, v_cur = kv_cur[0], kv_cur[1]
        src = (my - i) % sp
        scores = torch.einsum("btnd,bsnd->bnts", qf, k_cur.float()) * scale
        if causal:
            block_mask = (local_tri if src == my else torch.full_like(
                local_tri, src < my))
            scores = torch.where(block_mask, scores, _NEG)
        if mask_cur is not None:
            scores = torch.where(mask_cur[:, None, None, :].bool(), scores,
                                 _NEG)
        m_new = torch.maximum(m, torch.amax(scores, dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        o = (o * corr.permute(0, 2, 1)[..., None]
             + torch.einsum("bnts,bsnd->btnd", p, v_cur.float()))
        m = m_new
        if i + 1 < sp:
            kv_cur = comm.seq_ring_shift(kv_cur, group)
            if mask_cur is not None:
                mask_cur = _shift_mask(mask_cur, group)
    denom = torch.clamp(l.permute(0, 2, 1), min=1e-30)[..., None]
    return (o / denom).to(q.dtype)


@torch.no_grad()
def _shift_mask(mask, group):
    return comm.seq_ring_shift(mask.detach(), group)
