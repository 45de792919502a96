"""Chunked cross-entropy for LM heads: the port of
``move2kube_tpu/ops/crossentropy.py``.

The unfused loss upcasts the whole ``[N, V]`` logit tensor to fp32 and
builds a second ``[N, V]`` log-softmax. The chunked loss runs an online
logsumexp over vocab chunks instead (running max and sum of exponentials,
one ``[N, chunk]`` fp32 tile live at a time), and its backward writes
``(softmax(logits) - onehot(labels)) * g / N`` chunk by chunk:

- :func:`fused_cross_entropy` works on logits the model already made;
- :func:`fused_linear_cross_entropy` folds the lm-head product into the
  chunk loop, so the ``[N, V]`` logits never exist: the forward computes
  ``hidden @ W[chunk]^T`` per chunk in fp32, the backward recomputes each
  chunk and contracts it straight into ``d_hidden`` and ``dW[chunk]``.

The JAX package leaves these to XLA (no Pallas kernel), so the port runs
them as ``torch`` products; this is module work, not a kernel. Unlike the
JAX module there is no ``M2KT_FUSED_CE``/``M2KT_CE_CHUNK`` ladder and no
fallback: the chunk is an argument, and the train step folds the head
whenever the vocab spans more than one chunk (what the ladder's ``auto``
does).

On a tensor mesh whose head rows divide the vocab,
:func:`fused_linear_cross_entropy` with a ``group`` runs the same loop on
this rank's rows and merges the ranks' logsumexps (Megatron's
vocab-parallel loss).

Weight layout: the port's head is ``lm_head.weight`` ``[V, D]``
(``nn.Linear``), so :func:`fused_linear_cross_entropy` takes ``[V, D]``
where the JAX function takes ``[D, V]``; its gradient comes back ``[V,
D]``.
"""

from __future__ import annotations

import torch

DEFAULT_CHUNK = 2048
_NEG_INF = -1e30


def pick_chunk(vocab: int, requested: int) -> int:
    """Largest divisor of ``vocab`` <= ``requested`` (the chunk loop is
    ``vocab // chunk`` iterations; a non-divisor would drop columns).
    Pathological vocabs whose best divisor is tiny (primes) collapse to
    a single chunk rather than thousands of slivers."""
    c = max(1, min(int(requested), int(vocab)))
    while vocab % c:
        c -= 1
    if c < 128 and vocab > 128:
        return vocab
    return c


def reference_cross_entropy(logits, labels) -> torch.Tensor:
    """The unfused baseline: full fp32 upcast + log_softmax + gather."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = logp.gather(-1, labels[..., None].long())
    return -picked.mean()


def _online_lse(n, vocab: int, chunk: int, block, labels, device):
    """Online logsumexp over ``vocab // chunk`` chunks; ``block(lo)`` gives
    the fp32 ``[n, chunk]`` logits of columns ``lo:lo+chunk``. Returns
    ``(lse, picked)``: each row's logsumexp and its label's logit."""
    m = torch.full((n,), _NEG_INF, dtype=torch.float32, device=device)
    s = torch.zeros(n, dtype=torch.float32, device=device)
    picked = torch.zeros(n, dtype=torch.float32, device=device)
    for lo in range(0, vocab, chunk):
        blk = block(lo)
        m2 = torch.maximum(m, blk.max(dim=1).values)
        s = s * torch.exp(m - m2) + torch.exp(blk - m2[:, None]).sum(dim=1)
        idx = (labels - lo).clamp(0, chunk - 1)
        val = blk.gather(1, idx[:, None])[:, 0]
        hit = (labels >= lo) & (labels < lo + chunk)
        picked = torch.where(hit, val, picked)
        m = m2
    return m + torch.log(s), picked


def _softmax_minus_onehot(blk, lse, labels, lo: int, scale):
    """``(exp(blk - lse) - onehot(labels)[:, lo:lo+chunk]) * scale``."""
    p = torch.exp(blk - lse[:, None])
    col = lo + torch.arange(blk.shape[1], device=blk.device)
    p = p - (col[None, :] == labels[:, None]).float()
    return p * scale


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, chunk: int):
        n, v = logits.shape
        labels = labels.long()
        lse, picked = _online_lse(
            n, v, chunk, lambda lo: logits[:, lo:lo + chunk].float(), labels,
            logits.device)
        ctx.save_for_backward(logits, labels, lse)
        ctx.chunk = chunk
        return (lse - picked).mean()

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        n, v = logits.shape
        chunk = ctx.chunk
        scale = g.float() / n
        dl = torch.empty_like(logits)
        for lo in range(0, v, chunk):
            blk = logits[:, lo:lo + chunk].float()
            dl[:, lo:lo + chunk] = _softmax_minus_onehot(
                blk, lse, labels, lo, scale).to(dl.dtype)
        return dl, None, None


def fused_cross_entropy(logits, labels,
                        chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Chunked online-logsumexp CE over the last axis of ``logits`` (any
    leading shape; ``labels`` matches the leading shape). The chunk is
    :func:`pick_chunk` of the vocab and ``chunk``."""
    v = logits.shape[-1]
    c = pick_chunk(v, chunk)
    return _FusedCE.apply(logits.reshape(-1, v), labels.reshape(-1), c)


class _FusedLinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, weight, labels, chunk: int, group, lo: int):
        n = hidden.shape[0]
        v = weight.shape[0]
        h32 = hidden.float()
        labels = labels.long() - lo
        lse, picked = _online_lse(
            n, v, chunk, lambda c: h32 @ weight[c:c + chunk].float().T,
            labels, hidden.device)
        if group is not None:
            lse, picked = _merge_ranks(lse, picked, group)
        ctx.save_for_backward(hidden, weight, labels, lse)
        ctx.chunk, ctx.group = chunk, group
        return (lse - picked).mean()

    @staticmethod
    def backward(ctx, g):
        hidden, weight, labels, lse = ctx.saved_tensors
        n = hidden.shape[0]
        v = weight.shape[0]
        chunk = ctx.chunk
        h32 = hidden.float()
        scale = g.float() / n
        dh = torch.zeros(h32.shape, dtype=torch.float32, device=h32.device)
        dw = torch.empty_like(weight)
        for c in range(0, v, chunk):
            wc = weight[c:c + chunk].float()
            p = _softmax_minus_onehot(h32 @ wc.T, lse, labels, c, scale)
            dh += p @ wc
            dw[c:c + chunk] = (p.T @ h32).to(dw.dtype)
        if ctx.group is not None:
            from move2kube_tpu_torch.parallel import overlap

            dh = overlap.all_reduce_tensor(dh, ctx.group)
        return dh.to(hidden.dtype), dw, None, None, None, None


def _merge_ranks(lse, picked, group):
    """The whole vocab's logsumexp and target logit from every rank's over
    its rows. Every rank's pair is gathered in rank order and merged in
    that order, so every rank gets the same bits; one rank owns each
    target, the others add exact zeros."""
    from move2kube_tpu_torch.parallel import overlap

    every = overlap.ring_all_gather(torch.stack([lse, picked])[None],
                                    group, 0)
    top = every[:, 0].amax(dim=0)
    total = torch.zeros_like(top)
    for r in range(every.shape[0]):
        total = total + torch.exp(every[r, 0] - top)
    picked = every[0, 1]
    for r in range(1, every.shape[0]):
        picked = picked + every[r, 1]
    return top + torch.log(total), picked


def fused_linear_cross_entropy(hidden, weight, labels,
                               chunk: int = DEFAULT_CHUNK, group=None,
                               rank: int = 0) -> torch.Tensor:
    """CE of ``hidden @ weight^T`` against ``labels`` without ever building
    the ``[N, V]`` logits. ``hidden``: ``[..., D]``; ``weight``: ``[V, D]``
    (the ``nn.Linear`` layout, the transpose of the JAX function's
    ``[D, V]``). Products and the logsumexp run in fp32; the gradients
    come back in ``hidden``'s and ``weight``'s types.

    With a ``group``, the head's rows are split over it (Megatron's
    vocab-parallel loss): ``weight`` is this rank's rows ``[V/t, D]``,
    rank r's ``[r V/t, (r+1) V/t)``. Each rank runs the loop on its rows,
    the ranks' logsumexps merge in rank order (the same bits on every
    rank), the backward is softmax minus one-hot on the local rows, and
    the hidden state's gradient is summed over the group."""
    v = weight.shape[0]
    c = pick_chunk(v, chunk)
    flat = hidden.reshape(-1, hidden.shape[-1])
    return _FusedLinearCE.apply(flat, weight, labels.reshape(-1), c, group,
                                rank * v)


def lm_head_weight(params: dict):
    """The LM-head weight ``[V, D]`` of the port's head layouts, from a
    ``name -> tensor`` parameter dict, or None when there is no head it
    knows: ``Llama``'s separate ``lm_head``, or GPT-2's head tied to the
    token embedding ``wte`` (already ``[V, D]``: the JAX function returns
    its ``[D, V]`` transpose). The tied weight is the embedding's own
    tensor, so its gradient sums both uses, the lookup and the head."""
    for name in ("lm_head.weight", "wte.weight"):
        if name in params:
            return params[name]
    return None


def linear_lm_loss(hidden, weight, input_ids, chunk: int = DEFAULT_CHUNK,
                   group=None, rank: int = 0,
                   targets=None) -> torch.Tensor:
    """Next-token-prediction loss straight from the pre-head hidden
    states ``[b, s, D]``: shift, flatten, head-folded chunked CE (on this
    rank's head rows over ``group``, as in
    :func:`fused_linear_cross_entropy`). ``targets`` ``[b, t]`` (t <= s),
    when given, are the labels of the first t positions in place of the
    shifted ``input_ids`` (a seq rank's shard, whose last target is the
    next shard's first token)."""
    if targets is None:
        hidden, targets = hidden[:, :-1, :], input_ids[:, 1:]
    else:
        hidden = hidden[:, :targets.shape[1], :]
    return fused_linear_cross_entropy(hidden, weight, targets, chunk, group,
                                      rank)
