"""Ulysses sequence parallelism: a head <-> sequence all-to-all.

The port of ``deepspeed_tpu/models/ulysses.py``.  Where the ring rotates
K/V blocks round the seq group, Ulysses exchanges once per attention: one
all-to-all of the packed ``[B, T / sp, n_local, 3, d]`` qkv cuts the head
dim ``sp`` ways and joins the sequence, so each rank holds the FULL
sequence for ``n_local / sp`` heads and runs the port's own
``layers.core_attention`` on it.  So the attention plan applies
unchanged: on the card, the streaming kernels from seq 256 and the
whole-tile kernels for short causal shapes.  The inverse all-to-all gives
each rank its sequence block of every local head back.  The padding mask
is gathered over the seq group.  Both exchanges are differentiable
(``comm.seq_all_to_all``: the backward is the inverse exchange).

The degree is capped by the heads: ``n_local % sp == 0``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.models import layers as L
from deepspeed_tpu_torch.parallel import comm


def ulysses_attention_packed(qkv, *, causal=True, attn_mask=None,
                             group=None):
    """qkv: [B, Tl, n_local, 3, d] packed head-major, this rank's sequence
    block; ``attn_mask`` optional [B, Tl] with 1 = attend; ``group`` the
    seq group.  Returns [B, Tl, n_local, d]."""
    sp = 1 if group is None else dist.get_world_size(group)
    B, Tl, n, three, d = qkv.shape
    if n % sp:
        raise ValueError(
            f"ulysses attention needs local heads ({n}) divisible by the "
            f"sequence-parallel degree ({sp}); use sp_impl='ring' for "
            f"head-limited models, or lower context_parallel_size")
    # [B, Tl, n, 3, d] -> [B, Tl * sp, n / sp, 3, d]
    g = comm.seq_all_to_all(qkv, 2, 1, group)
    qg, kg, vg = g[..., 0, :], g[..., 1, :], g[..., 2, :]
    mask_full = None
    if attn_mask is not None:
        mask_full = comm.seq_all_gather(attn_mask, 1, group)
    ctx = L.core_attention(qg, kg, vg, causal=causal, attn_mask=mask_full)
    # the inverse exchange: the sequence cut back, the heads rejoined
    return comm.seq_all_to_all(ctx, 1, 2, group)


def ulysses_attention(q, k, v, *, causal=True, attn_mask=None, group=None):
    """``ulysses_attention_packed`` on unpacked q, k, v [B, Tl, n_local,
    d]."""
    return ulysses_attention_packed(
        torch.stack([q, k, v], dim=3), causal=causal, attn_mask=attn_mask,
        group=group)
