"""Bucketed ring all-reduce and compute-overlapped gradient accumulation:
the port of ``move2kube_tpu/parallel/overlap.py`` (its data-parallel
half; the FSDP prefetch is ROADMAP Queue 1 item 9b).

:func:`ring_all_reduce` flattens every tensor into one fp32 bucket, pads
it to a multiple of the group size n and splits it into n chunks, then
runs the reference's schedule over single-neighbour hops
(``dist.batch_isend_irecv``): a reduce-scatter in which rank r receives
the travelling partial sum and adds its chunk ``(r - 1 - s) mod n`` at
hop s, so after n - 1 hops rank r owns the sum of chunk ``(r + 1) mod
n``, then an all-gather that circulates the owned chunks for n - 1 more
hops. Each chunk is summed in the reference's order, and every rank
receives the owner's sum of every chunk it does not own, so all ranks end
with the same bits, equal to the reference's ring on the same inputs.

Where the bytes go depends on the group's backend (``dist.get_backend``):
under NCCL the bucket stays on the card; gloo's point-to-point takes CPU
tensors, so a bucket on a card is copied once into pinned host memory,
reduced there and copied back (the additions are IEEE fp32 on either
side, so the bits do not depend on where they run). :data:`RING_STATS`
counts the bytes and, on the host path, the copy and ring seconds.

:func:`overlapped_accum_grads` folds ``k`` microbatches into one update
with microbatch i's ring reduce running while microbatch i+1's forward
and backward do: under NCCL the hops and additions are queued on a side
stream ordered by events against the backward that produced the bucket
and the step that reads the result; under gloo the reduce runs on a
worker thread. The ring runs on a process group of its own
(:func:`ring_group`), so the collectives of the main thread (BatchNorm's
statistics, the preemption vote, the checkpoint barrier) never interleave
with it; the worker is joined before the step returns.
"""

from __future__ import annotations

import threading
import time

import torch
import torch.distributed as dist

# what the rings moved since the last reset: calls, fp32 bytes reduced,
# and on the host path (a card's bucket in a gloo group) the seconds of
# the two copies and of the hops and additions on the host
RING_STATS = {"calls": 0, "bytes": 0, "copy_s": 0.0, "ring_s": 0.0}

_RING_GROUPS: dict = {}


def reset_ring_stats() -> None:
    RING_STATS.update(calls=0, bytes=0, copy_s=0.0, ring_s=0.0)


def _leaves(tree) -> list:
    """A tree's tensors in the reference's order: a dict by sorted key
    (as ``jax.tree_util`` flattens it), a sequence in its order."""
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return list(tree)


def _flatten_bucket(tree):
    """Every leaf concatenated into one fp32 bucket, and what undoes it."""
    leaves = _leaves(tree)
    meta = (tree, [t.shape for t in leaves], [t.dtype for t in leaves])
    bucket = torch.cat([t.reshape(-1).float() for t in leaves])
    return bucket, meta


def _unflatten_bucket(bucket, meta):
    tree, shapes, dtypes = meta
    out, offset = [], 0
    for shape, dtype in zip(shapes, dtypes):
        size = shape.numel()
        out.append(bucket[offset:offset + size].view(shape).to(dtype))
        offset += size
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), out))
    return out


def _exchange(send, recv, nxt: int, prv: int, group) -> None:
    ops = [dist.P2POp(dist.isend, send, nxt, group),
           dist.P2POp(dist.irecv, recv, prv, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()


def _ring(bucket, group):
    """The sum of ``bucket`` (1-D fp32, on the group's device) across
    ``group`` by the reference's schedule."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    ranks = dist.get_process_group_ranks(group)
    nxt, prv = ranks[(r + 1) % n], ranks[(r - 1) % n]
    size = bucket.numel()
    pad = (-size) % n
    if pad:
        bucket = torch.cat([bucket, bucket.new_zeros(pad)])
    chunks = bucket.view(n, -1)
    # reduce-scatter: after hop s the travelling sum covers chunk
    # r - 1 - s of s + 2 ranks; after n - 1 hops rank r holds chunk r + 1
    total = chunks[r].clone()
    recv = torch.empty_like(total)
    for s in range(n - 1):
        _exchange(total, recv, nxt, prv, group)
        total = recv + chunks[(r - 1 - s) % n]
    # all-gather: the owned chunks go round the ring
    out = torch.empty_like(chunks)
    out[(r + 1) % n] = total
    for s in range(n - 1):
        _exchange(out[(r - s + 1) % n], out[(r - s) % n], nxt, prv, group)
    flat = out.view(-1)
    return flat[:size] if pad else flat


def _on_host(group, bucket) -> bool:
    return bucket.is_cuda and dist.get_backend(group) != "nccl"


def _ring_bucket(bucket, group, stream=None):
    """:func:`_ring` where the backend can run it: a card's bucket in a
    non-NCCL group through one pinned host copy and back. ``stream``:
    the side stream the copies run on (the current one when None)."""
    RING_STATS["calls"] += 1
    RING_STATS["bytes"] += bucket.numel() * 4
    if not _on_host(group, bucket):
        return _ring(bucket, group)
    stream = stream or torch.cuda.current_stream(bucket.device)
    t0 = time.perf_counter()
    host = torch.empty(bucket.shape, dtype=bucket.dtype, pin_memory=True)
    with torch.cuda.stream(stream):
        host.copy_(bucket, non_blocking=True)
    stream.synchronize()
    t1 = time.perf_counter()
    reduced = _ring(host, group)
    t2 = time.perf_counter()
    with torch.cuda.stream(stream):
        out = reduced.to(bucket.device, non_blocking=True)
    stream.synchronize()
    t3 = time.perf_counter()
    RING_STATS["copy_s"] += (t1 - t0) + (t3 - t2)
    RING_STATS["ring_s"] += t2 - t1
    return out


def ring_all_reduce(tree, group=None):
    """Sum ``tree`` (a dict of tensors by name, or a sequence) across
    ``group`` (default: the world) with the bucketed ring; returns the
    same structure, each leaf in its own dtype. Identical on every rank.
    A group of one returns ``tree`` as it is."""
    group = group or dist.group.WORLD
    if dist.get_world_size(group) == 1:
        return tree
    bucket, meta = _flatten_bucket(tree)
    return _unflatten_bucket(_ring_bucket(bucket, group), meta)


def ring_group(group=None):
    """A process group of the same ranks and backend as ``group`` (the
    world by default), kept for the ring alone. Collective over the
    world the first time for each set of ranks: every rank makes it at
    the same point of its program."""
    group = group or dist.group.WORLD
    ranks = tuple(dist.get_process_group_ranks(group))
    key = (ranks, dist.get_backend(group))
    if key not in _RING_GROUPS:
        _RING_GROUPS[key] = dist.new_group(list(ranks), backend=key[1])
    return _RING_GROUPS[key]


def is_pure_data_parallel(mesh) -> bool:
    """True when every device sits on the ``data`` axis (parameters are
    then replicated, the precondition for the ring paths). ``mesh`` is a
    ``DeviceMesh`` with the six axes (or anything with a ``shape`` and
    ``mesh_dim_names``)."""
    try:
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    except (AttributeError, TypeError):
        return False
    data = shape.get("data", 1)
    return data > 1 and all(v == 1 for k, v in shape.items() if k != "data")


class _Pending:
    """One reduce in flight: :meth:`result` returns the reduced bucket,
    ready for the current stream."""

    def __init__(self, bucket, group) -> None:
        self._out = None
        self._error = None
        self._thread = None
        self._done = None
        if bucket.is_cuda:
            dev = bucket.device
            side = torch.cuda.Stream(device=dev)
            # the backward that produced the bucket comes first
            side.wait_stream(torch.cuda.current_stream(dev))
            bucket.record_stream(side)
        if not _on_host(group, bucket) and bucket.is_cuda:
            # NCCL: hops and additions queued on the side stream; the host
            # goes on to the next backward at once
            with torch.cuda.stream(side):
                self._out = _ring_bucket(bucket, group)
                self._done = torch.cuda.Event()
                self._done.record(side)
            return

        def run():
            try:
                self._out = _ring_bucket(
                    bucket, group, side if bucket.is_cuda else None)
            except BaseException as e:  # noqa: BLE001 - re-raised in result()
                self._error = e

        self._thread = threading.Thread(target=run, name="m2kt-ring",
                                        daemon=True)
        self._thread.start()

    def result(self):
        if self._thread is not None:
            self._thread.join()
            if self._error is not None:
                raise self._error
        if self._out.is_cuda:
            consumer = torch.cuda.current_stream(self._out.device)
            if self._done is not None:
                consumer.wait_event(self._done)
            # made on the side stream, read on this one
            self._out.record_stream(consumer)
        return self._out


def _grad_bucket(params):
    """The parameters' gradients as one fp32 bucket (zeros for a
    parameter without one, as the reference's tree holds it)."""
    return _flatten_bucket([p.grad if p.grad is not None
                            else torch.zeros_like(p) for p in params])


def set_reduced_grads(params, bucket, meta, divisor: int) -> None:
    """Write ``bucket / divisor`` back into each parameter's ``.grad``."""
    for p, g in zip(params, _unflatten_bucket(bucket / divisor, meta)):
        p.grad = g


def overlapped_accum_grads(params, loss_fn, batches, group):
    """Mean loss and mean gradients over the microbatches ``batches``
    (a sequence; ``loss_fn(microbatch) -> scalar``), with each
    microbatch's pending reduction overlapped against the next one's
    forward and backward. The gradients land in the parameters' ``.grad``
    already averaged over ``len(batches) x n`` (n the group's size), the
    same on every rank; the loss comes back as the group's mean.

    Microbatch i's gradients are its own (``.grad`` is cleared before
    each backward); the reduced buckets are summed in microbatch order,
    then divided once, as the reference's scan accumulates them."""
    params = list(params)
    n = dist.get_world_size(group)
    acc, pending, meta, losses = None, None, None, []
    for mb in batches:
        for p in params:
            p.grad = None
        loss = loss_fn(mb)
        loss.backward()
        losses.append(loss.detach())
        bucket, meta = _grad_bucket(params)
        if pending is not None:
            reduced = pending.result()
            acc = reduced if acc is None else acc + reduced
        pending = _Pending(bucket, group)
    reduced = pending.result()
    acc = reduced if acc is None else acc + reduced
    k = len(losses)
    set_reduced_grads(params, acc, meta, k * n)
    loss = torch.stack(losses).sum() / k
    return group_mean(loss, group)


def group_mean(value, group):
    """The mean of a scalar tensor over ``group``, through the ring (so
    every rank reads the same bits)."""
    n = dist.get_world_size(group)
    if n == 1:
        return value
    (total,) = ring_all_reduce([value.detach().reshape(1)], group)
    return (total / n).reshape(())


def reduce_grads(params, group) -> None:
    """The single reduction of a step without accumulation: the
    parameters' gradients summed by the ring and divided by the group's
    size, back in ``.grad``."""
    params = list(params)
    bucket, meta = _grad_bucket(params)
    set_reduced_grads(params, _ring_bucket(bucket, group), meta,
                      dist.get_world_size(group))


def broadcast_model(model, group) -> None:
    """Every parameter and buffer of ``model`` from the group's first rank
    (a card's tensors through the host in a gloo group)."""
    src = dist.get_process_group_ranks(group)[0]
    host = dist.get_backend(group) != "nccl"
    with torch.no_grad():
        for t in [*model.parameters(), *model.buffers()]:
            buf = t.detach().cpu() if host and t.is_cuda else t.detach()
            dist.broadcast(buf, src, group=group)
            if buf is not t:
                t.copy_(buf)
