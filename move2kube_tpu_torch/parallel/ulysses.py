"""Ulysses-style sequence parallelism, the port of
``move2kube_tpu/parallel/ulysses.py``: the second scheme on a seq group
beside ring attention.

Two all-to-alls (:func:`~move2kube_tpu_torch.parallel.overlap.
all_to_all`) reshard ``[b, S, h, d]`` (this rank's tokens, every head)
into ``[b, s, h/P, d]`` (every token, this rank's heads: rank r's
``[r h/P, (r+1) h/P)``), attention runs whole on them, and the output
goes back. The local attention is the port's ``flash_attention`` (its
kernels on the card); the reference computes it with an einsum and an
fp32 softmax (``_full_attention``), the same function.

GQA: K/V go through the exchange at their own head count when ``P``
divides it: rank r's query heads then read exactly its K/V heads
``[r kvh/P, (r+1) kvh/P)``. Otherwise K/V are repeated up to the query
heads first, as the reference repeats them before attention.
"""

from __future__ import annotations

import torch.distributed as dist

from move2kube_tpu_torch.ops.attention import flash_attention
from move2kube_tpu_torch.parallel.overlap import all_to_all


def ulysses_attention(q, k, v, group, causal: bool = True,
                      scale: float | None = None):
    """Exact attention over sequence-sharded inputs through a head
    all-to-all over ``group``. ``q`` ``[b, S, h, d]``, ``k``/``v`` ``[b,
    S, kvh, d]``; ``h`` must divide by the group's size. Returns ``[b, S,
    h, d]``. A group of one (or None) is one flash call."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    n = dist.get_world_size(group) if group is not None else 1
    if q.shape[2] % n:
        raise ValueError(
            f"heads ({q.shape[2]}) not divisible by |seq| ({n}); use "
            "ring_attention instead")
    if k.shape[2] % n:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    # [b, S, h, d] -> [b, s, h/P, d]: gather the sequence, scatter heads
    qf, kf, vf = (all_to_all(t, group, 2, 1) for t in (q, k, v))
    of = flash_attention(qf, kf, vf.contiguous(), causal=causal, scale=scale)
    # [b, s, h/P, d] -> [b, S, h, d]: scatter the sequence, gather heads
    return all_to_all(of, group, 1, 2)
