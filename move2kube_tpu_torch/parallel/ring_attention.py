"""Ring attention: exact attention over sequence-sharded inputs, the port
of ``move2kube_tpu/parallel/ring_attention.py``.

Each rank of a seq group holds ``S`` consecutive tokens of the same rows,
rank r the positions ``[r S, (r+1) S)``. Q stays local; K/V travel one
rank on per step (:func:`~move2kube_tpu_torch.parallel.overlap.seq_hop`,
the reference's ``ppermute``), so at step t rank r attends to the block
of rank ``(r - t) mod n``. The result is exact: each block's output and
logsumexp are merged by logsumexp in fp32, which is the reference's
online softmax over the blocks.

The reference computes each block as an einsum with a ``[b, h, S, S]``
fp32 score block and lets autograd keep one per step and layer; its
docstring names the replacement for long shards, "flash per block +
lse-merge, whole-ring custom_vjp". This is that replacement, on the
port's flash kernels (``ops/attention.py``), as one
``torch.autograd.Function`` over the whole ring:

- forward: at step t, ``flash_attention_fwd`` of the local queries over
  the block held, causal on the diagonal block (t = 0), full on a block
  before the rank's own; under ``causal`` a block after the rank's own
  (``r - t < 0``) is skipped. The reference computes it under a -1e30
  bias, and it adds exactly 0 once merged (``exp(-1e30 - m)`` is 0 in
  fp32), so skipping it is the same function. The forward keeps the
  merged output and the whole row's logsumexp, nothing per block.
- backward: ``delta = rowsum(dO . O)`` once (``flash_bwd_delta``), then
  the ring again: each live block's ``dq``, ``dk`` and ``dv`` from the
  backward kernels with the whole row's logsumexp and delta (the block's
  share of the row's gradient). ``dq`` adds up locally; ``dk`` and ``dv``
  add up in fp32 accumulators that travel with their K/V and arrive home
  after n hops.

K/V travel at their own head count: the kernels read a GQA group of
query heads per K/V head, so the ring moves a quarter of the bytes for
Llama-8B's 32 over 8 heads and computes what repeating K/V first
computes. CUDA tensors launch the kernels; CPU tensors take their plain
versions (the choice is ``ops/attention.py``'s, by where the tensors
lie).

Every rank of the group runs the same hops in the same order, each a
paired send and receive, so a block recomputed under remat issues its
hops again in step with its peers.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from move2kube_tpu_torch.ops.attention import (
    flash_attention_bwd,
    flash_attention_fwd,
    flash_bwd_delta,
)
from move2kube_tpu_torch.parallel import overlap


def _merge(acc, lse_acc, o, lse):
    """Two partial softmaxes of the same rows, by logsumexp: ``acc`` and
    ``o`` ``[b, s, h, d]`` (``acc`` fp32), ``lse`` fp32 ``[b, h, s]``."""
    if acc is None:
        return o.float(), lse
    new = torch.logaddexp(lse_acc, lse)
    a = torch.exp(lse_acc - new).transpose(1, 2)[..., None]
    b = torch.exp(lse - new).transpose(1, 2)[..., None]
    return acc * a + o.float() * b, new


def _live(r: int, t: int, causal: bool) -> bool:
    """Whether rank r's queries see any key of the block it holds at step
    t (rank ``(r - t) mod n``'s)."""
    return not causal or t <= r


def ring_forward(q, k, v, group, causal: bool, scale: float):
    """``(o, lse)`` of the local queries over the whole group's keys: ``o``
    in q's type, ``lse`` fp32 ``[b, h, S]``."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    acc = lse_acc = None
    for t in range(n):
        if _live(r, t, causal):
            o_t, lse_t = flash_attention_fwd(q, k, v, causal and t == 0,
                                             scale, want_lse=True)
            acc, lse_acc = _merge(acc, lse_acc, o_t, lse_t)
        if t < n - 1:
            k, v = overlap.seq_hop([k, v], group)
    return acc.to(q.dtype), lse_acc


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        o, lse = ring_forward(q, k, v, group, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        n, r = dist.get_world_size(group), dist.get_rank(group)
        g = g.contiguous()
        delta = flash_bwd_delta(o, g) if g.is_cuda else None
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for t in range(n):
            if _live(r, t, causal):
                dq_t, dk_t, dv_t = flash_attention_bwd(
                    q, k, v, o, lse, g, causal and t == 0, scale, delta)
                dq += dq_t.float()
                dk += dk_t.float()
                dv += dv_t.float()
            # the accumulators travel with their block; after n hops each
            # is home
            if t < n - 1:
                k, v, dk, dv = overlap.seq_hop([k, v, dk, dv], group)
            else:
                dk, dv = overlap.seq_hop([dk, dv], group)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def ring_attention(q, k, v, group, causal: bool = True,
                   scale: float | None = None):
    """Exact attention of this rank's queries over the keys of every rank
    of ``group`` (a seq group; rank r holds positions ``[r S, (r+1) S)``),
    differentiable. ``q`` ``[b, S, h, d]``, ``k``/``v`` ``[b, S, kvh,
    d]`` with ``kvh`` dividing ``h`` (GQA, as ``flash_attention`` takes
    it); returns ``[b, S, h, d]`` in q's type. A group of one (or None)
    is one flash call."""
    from move2kube_tpu_torch.ops.attention import flash_attention

    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if group is None or dist.get_world_size(group) == 1:
        return flash_attention(q, k, v, causal=causal, scale=scale)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        return ring_forward(q, k, v, group, causal, scale)[0]
    return _RingAttention.apply(q, k.contiguous(), v.contiguous(), group,
                                causal, scale)
