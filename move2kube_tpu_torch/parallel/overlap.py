"""Bucketed ring all-reduce, the FSDP rings, compute-overlapped gradient
accumulation, the collectives of a model split over tensor and expert
ranks and the collective decode matmul: the port of
``move2kube_tpu/parallel/overlap.py``.

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
worker thread. The ring runs on process groups of its own
(:func:`mesh_ring_group`), so the collectives of the main thread
(BatchNorm's statistics, the preemption vote, the checkpoint barrier)
never interleave with it; the worker is joined before the step returns.

FSDP (ZeRO-3): :func:`ring_all_gather` rebuilds a leaf from its shards in
n - 1 single-neighbour hops, each received slice written at its global
offset, and :func:`ring_reduce_scatter` sums a full gradient over the
group with the all-reduce's travelling partial sum plus one alignment
hop, so rank r owns slice r (the reference's ``NamedSharding`` layout).
:func:`prefetched_fsdp_accum_grads` gathers the sharded leaves once a
step and overlaps microbatch k's pending reduction (a reduce-scatter a
sharded leaf, one bucketed all-reduce for the replicated ones) with
microbatch k+1's backward, as :func:`overlapped_accum_grads` does;
:func:`sequential_fsdp_accum_grads` is the reference's GSPMD scan, which
re-gathers every microbatch (``M2KT_FSDP_PREFETCH=off``, and any data x
fsdp mesh) and reduce-scatters each full gradient inside the backward as
soon as it is whole. Memory: both schedules hold the gathered tree (and,
under a compute dtype, its cast copy) through a microbatch's backward;
the prefetched one also holds the full gradients of a microbatch while
they wait for their reduction, up to two trees of them while the
previous microbatch's reduction overlaps the next backward, freeing each
leaf's as it is reduced; the sequential one holds one leaf's at a time. :data:`RING_STATS` counts each kind apart: ``calls``,
``bytes``, ``copy_s`` and ``ring_s`` the all-reduce, the ``ag_`` and
``rs_`` keys the gathers and reduce-scatters (bytes in the leaf's own
dtype).

Tensor and expert parallelism (Megatron's two operators, as
``torch.autograd.Function``s over the same ring): :func:`column_entry`
(identity forward, ring all-reduce of the input's gradient backward)
enters a region where each rank computes its own heads, columns or
experts, and :func:`row_exit` (ring all-reduce forward, identity
backward) leaves it, summing the ranks' partial products;
:func:`gather_split` all-gathers a split activation (its backward keeps
this rank's slice) and :func:`sum_over` sums a value every rank then uses
(its backward sums the gradients back). GSPMD inserts these collectives
in the reference; here the model calls them. Their bytes and seconds are
``RING_STATS``' ``tp_`` keys.

Sequence parallelism: :func:`seq_hop` sends tensors one rank on along a
seq group's ring (the reference's ``ppermute``, the K/V hop of ring
attention) and :func:`all_to_all` reshards an activation between its
sequence and head dimensions (the reference's tiled ``all_to_all``,
Ulysses' two exchanges), built from the same paired point-to-point
exchanges, through pinned host memory for a card's tensor in a gloo
group. Their bytes (each rank's sent bytes) and seconds are
``RING_STATS``' ``sp_`` keys. :func:`collective_decode_matmul` is the
reference's row-parallel decode product with the reduce-scatter's hops
interleaved with the per-chunk partial products.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch
import torch.distributed as dist

# what the rings moved since the last reset: calls, fp32 bytes reduced,
# and on the host path (a card's bucket in a gloo group) the seconds of
# the two copies and of the hops and additions on the host
RING_STATS = {"calls": 0, "bytes": 0, "copy_s": 0.0, "ring_s": 0.0,
              "ag_calls": 0, "ag_bytes": 0, "ag_copy_s": 0.0,
              "ag_ring_s": 0.0, "rs_calls": 0, "rs_bytes": 0,
              "rs_copy_s": 0.0, "rs_ring_s": 0.0, "tp_calls": 0,
              "tp_bytes": 0, "tp_copy_s": 0.0, "tp_ring_s": 0.0,
              "sp_calls": 0, "sp_bytes": 0, "sp_copy_s": 0.0,
              "sp_ring_s": 0.0}

_MESH_RING_GROUPS: dict = {}

# pinned host buffers of the host path, free for reuse, by (group, shape,
# dtype); a buffer in use is out of the list, so two threads never share
# one
_HOST_BUFFERS: dict = {}
_HOST_LOCK = threading.Lock()


def reset_ring_stats() -> None:
    for key in RING_STATS:
        RING_STATS[key] = 0.0 if key.endswith("_s") else 0


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


def _neighbours(group):
    """(n, this rank's index in ``group``, the next rank, the previous
    rank), global ranks for the hops."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    ranks = dist.get_process_group_ranks(group)
    return n, r, ranks[(r + 1) % n], ranks[(r - 1) % n]


def _ring(bucket, group):
    """The sum of ``bucket`` (1-D fp32, on the group's device) across
    ``group`` by the reference's schedule."""
    n, r, nxt, prv = _neighbours(group)
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


def _gather(shard, group, dim: int):
    """The reference's ``ring_all_gather``: rank r starts with global
    slice r of ``dim``; at hop t it receives rank r - t's slice from its
    previous neighbour and writes it at its global offset."""
    n, r, nxt, prv = _neighbours(group)
    size = shard.shape[dim]
    shape = list(shard.shape)
    shape[dim] = n * size
    full = shard.new_empty(shape)
    full.narrow(dim, r * size, size).copy_(shard)
    cur = shard.contiguous()
    for t in range(1, n):
        recv = torch.empty_like(cur)
        _exchange(cur, recv, nxt, prv, group)
        cur = recv
        full.narrow(dim, ((r - t) % n) * size, size).copy_(cur)
    return full


def _reduce_scatter(full, group, dim: int):
    """The reference's ``ring_reduce_scatter``: the all-reduce's
    travelling partial sum in ``full``'s dtype (after n - 1 hops rank r
    holds the sum of slice r + 1), then one hop forward, so rank r owns
    slice r."""
    n, r, nxt, prv = _neighbours(group)
    size = full.shape[dim] // n

    def chunk(i):
        return full.narrow(dim, (i % n) * size, size)

    total = chunk(r).contiguous()
    recv = torch.empty_like(total)
    for s in range(n - 1):
        _exchange(total, recv, nxt, prv, group)
        total = recv + chunk(r - 1 - s)
    out = torch.empty_like(total)
    _exchange(total, out, nxt, prv, group)
    return out


def _on_host(group, bucket) -> bool:
    return bucket.is_cuda and dist.get_backend(group) != "nccl"


def _via_host(tensor, group, fn, prefix: str, stream=None):
    """``fn(tensor)`` where the backend can run it: a card's tensor in a
    non-NCCL group through one pinned host copy and back, its copy and
    ring seconds counted under ``prefix`` in :data:`RING_STATS`.
    ``stream``: the side stream the copies run on (the current one when
    None)."""
    if not _on_host(group, tensor):
        return fn(tensor)
    stream = stream or torch.cuda.current_stream(tensor.device)
    t0 = time.perf_counter()
    key = (group, tuple(tensor.shape), tensor.dtype)
    with _HOST_LOCK:
        free = _HOST_BUFFERS.get(key)
        host = free.pop() if free else None
    if host is None:
        host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    try:
        with torch.cuda.stream(stream):
            host.copy_(tensor, non_blocking=True)
        stream.synchronize()
        t1 = time.perf_counter()
        done = fn(host)
        t2 = time.perf_counter()
        with torch.cuda.stream(stream):
            out = done.to(tensor.device, non_blocking=True)
        stream.synchronize()
    finally:
        with _HOST_LOCK:
            _HOST_BUFFERS.setdefault(key, []).append(host)
    t3 = time.perf_counter()
    RING_STATS[prefix + "copy_s"] += (t1 - t0) + (t3 - t2)
    RING_STATS[prefix + "ring_s"] += t2 - t1
    return out


def _ring_bucket(bucket, group, stream=None, prefix: str = ""):
    """:func:`_ring` where the backend can run it (:func:`_via_host`)."""
    RING_STATS[prefix + "calls"] += 1
    RING_STATS[prefix + "bytes"] += bucket.numel() * 4
    return _via_host(bucket, group, lambda t: _ring(t, group), prefix,
                     stream)


def ring_all_gather(shard, group=None, dim: int = 0, stream=None):
    """The whole leaf from every rank's ``shard`` (rank r holds global
    slice r of ``dim``), in n - 1 single-neighbour hops; the same bits on
    every rank. A group of one returns ``shard``."""
    group = group or dist.group.WORLD
    n = dist.get_world_size(group)
    if n == 1:
        return shard
    RING_STATS["ag_calls"] += 1
    RING_STATS["ag_bytes"] += n * shard.numel() * shard.element_size()
    return _via_host(shard, group, lambda t: _gather(t, group, dim), "ag_",
                     stream)


def ring_reduce_scatter(full, group=None, dim: int = 0, stream=None):
    """Sum ``full`` over ``group`` and keep this rank's slice r of
    ``dim`` (whose extent the group's size divides), summed in the
    reference's order and in ``full``'s dtype. A group of one returns
    ``full``."""
    group = group or dist.group.WORLD
    if dist.get_world_size(group) == 1:
        return full
    RING_STATS["rs_calls"] += 1
    RING_STATS["rs_bytes"] += full.numel() * full.element_size()
    return _via_host(full, group, lambda t: _reduce_scatter(t, group, dim),
                     "rs_", stream)


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


def mesh_ring_group(mesh, axes: tuple):
    """A process group of the ranks that share this rank's coordinates on
    every axis of ``mesh`` (a ``DeviceMesh``) but ``axes``, kept for the
    ring alone. Collective over the world the first time for a mesh and
    ``axes``: every rank makes every such group, at the same point of its
    program, and keeps its own."""
    names = list(mesh.mesh_dim_names)
    idx = [names.index(a) for a in axes]
    ranks = mesh.mesh
    rest = [i for i in range(ranks.ndim) if i not in idx]
    size = 1
    for i in idx:
        size *= ranks.shape[i]
    rows = tuple(tuple(int(r) for r in row) for row in
                 ranks.permute(*rest, *idx).reshape(-1, size).tolist())
    key = (rows, dist.get_backend())
    if key not in _MESH_RING_GROUPS:
        mine, _ = dist.new_subgroups_by_enumeration(
            [list(row) for row in rows], backend=key[1])
        _MESH_RING_GROUPS[key] = mine
    return _MESH_RING_GROUPS[key]


class _Pending:
    """One reduction in flight: ``run(stream) -> [tensor, ...]`` over
    ``inputs`` (tensors of the group's ranks' backward); :meth:`result`
    returns its outputs, ready for the current stream."""

    def __init__(self, run, inputs, group) -> None:
        self._out = None
        self._error = None
        self._thread = None
        self._done = None
        cuda = inputs[0].is_cuda
        side = None
        if cuda:
            dev = inputs[0].device
            side = torch.cuda.Stream(device=dev)
            # the backward that produced the inputs comes first
            side.wait_stream(torch.cuda.current_stream(dev))
            for t in inputs:
                t.record_stream(side)
        if cuda and not _on_host(group, inputs[0]):
            # NCCL: hops and additions queued on the side stream; the host
            # goes on to the next backward at once
            with torch.cuda.stream(side):
                self._out = run(None)
                self._done = torch.cuda.Event()
                self._done.record(side)
            return

        def work():
            try:
                # every kernel of the reduction on the side stream, which
                # waits for the backward that produced the inputs
                with (torch.cuda.stream(side) if side is not None
                      else contextlib.nullcontext()):
                    self._out = run(side)
            except BaseException as e:  # noqa: BLE001 - re-raised in result()
                self._error = e

        self._thread = threading.Thread(target=work, name="m2kt-ring",
                                        daemon=True)
        self._thread.start()

    def result(self) -> list:
        if self._thread is not None:
            self._thread.join()
            if self._error is not None:
                raise self._error
        for out in self._out:
            if out.is_cuda:
                consumer = torch.cuda.current_stream(out.device)
                if self._done is not None:
                    consumer.wait_event(self._done)
                # made on the side stream, read on this one
                out.record_stream(consumer)
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
            (reduced,) = pending.result()
            acc = reduced if acc is None else acc + reduced
        pending = _Pending(
            lambda stream, bucket=bucket: [_ring_bucket(bucket, group,
                                                        stream)],
            [bucket], group)
    (reduced,) = pending.result()
    acc = reduced if acc is None else acc + reduced
    k = len(losses)
    set_reduced_grads(params, acc, meta, k * n)
    loss = torch.stack(losses).sum() / k
    return group_mean(loss, group)


def group_mean(value, group):
    """The mean of a scalar tensor over ``group``, through the ring (so
    every rank reads the same bits); ``value`` itself for no group."""
    if group is None:
        return value
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


def is_pure_fsdp(mesh) -> bool:
    """True when every device sits on the ``fsdp`` axis (the planner's
    ZeRO layout: parameters sharded leaf by leaf, the batch over fsdp),
    the precondition for :func:`prefetched_fsdp_accum_grads`."""
    try:
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    except (AttributeError, TypeError):
        return False
    fsdp = shape.get("fsdp", 1)
    return fsdp > 1 and all(v == 1 for k, v in shape.items() if k != "fsdp")


def fsdp_prefetch_mode() -> str:
    """``M2KT_FSDP_PREFETCH`` -> 'auto' | 'on' | 'off', the reference's
    spellings: auto and on take the prefetched schedule whenever
    :func:`is_pure_fsdp` holds; off takes the sequential one there too."""
    raw = os.environ.get("M2KT_FSDP_PREFETCH", "auto").strip().lower()
    if raw in ("on", "1", "true"):
        return "on"
    if raw in ("off", "0", "false"):
        return "off"
    return "auto"


def fsdp_prefetched(mesh) -> bool:
    """Whether a step on ``mesh`` takes :func:`prefetched_fsdp_accum_grads`
    (a pure fsdp mesh, ``M2KT_FSDP_PREFETCH`` not off) rather than
    :func:`sequential_fsdp_accum_grads`."""
    return is_pure_fsdp(mesh) and fsdp_prefetch_mode() != "off"


def fsdp_transient_bytes(layout, prefetched: bool, grad_accum: int,
                         compute_dtype=torch.float32) -> dict:
    """What a rank holds beyond its shards while a step of the fsdp
    schedule runs, which the memory plan (the reference's: shards,
    gradients, moments, activations) does not count, for fp32 masters
    of ``layout`` (a :class:`~move2kube_tpu_torch.parallel.sharding.
    ShardLayout`): the sharded leaves gathered; their copy in
    ``compute_dtype`` with the replicated leaves' (none under fp32); and
    the sharded leaves' full gradients: one tree (prefetched, one
    microbatch), two (prefetched, more: one waits for its reduction while
    the next backward runs), the largest leaf's (sequential)."""
    import math

    # each leaf at its size on this rank before the fsdp cut (the
    # tensor-local leaf the gather yields)
    sizes = {n: math.prod(spec.shape) // math.prod(
        c.extent for c in layout.cuts[n] if c.axis != "fsdp")
        for n, spec in layout.specs.items()}
    sharded = [sizes[n] for n, d in layout.dims.items() if d is not None]
    gathered = 4 * sum(sharded)
    cast = (0 if compute_dtype == torch.float32 else
            sum(sizes.values()) * torch.finfo(compute_dtype).bits // 8)
    full = (4 * sum(sharded) * (2 if grad_accum > 1 else 1) if prefetched
            else 4 * max(sharded, default=0))
    return {"schedule": "prefetched" if prefetched else "sequential",
            "gathered_params_bytes": gathered, "cast_params_bytes": cast,
            "full_grads_bytes": full,
            "total_bytes": gathered + cast + full}


def _fsdp_leaf_dims(model, n: int, axis_name: str = "fsdp") -> dict:
    """Each parameter's dimension sharded over ``axis_name`` at extent
    ``n`` (port dimensions, by the port's parameter name), None for a
    replicated leaf or one whose dimension ``n`` does not divide (it
    rides the replicated bucket): the reference's table, from the specs
    of :func:`~move2kube_tpu_torch.parallel.sharding.param_specs`.
    ``model``: the model at its global shapes (the meta device will
    do)."""
    from move2kube_tpu_torch.parallel.sharding import param_specs

    return {name: spec.dim_of(axis_name)
            for name, spec in param_specs(model, {axis_name: n}).items()}


def _fsdp_reduce(grads, dims, group, stream):
    """One microbatch's reduction: the replicated leaves' gradients in one
    bucketed all-reduce, each sharded leaf's full gradient reduce-scattered
    to this rank's slice; in ``grads``' order. Each full gradient is let go
    (its entry of ``grads`` set to None) as soon as it is reduced, so the
    caller's list holds no more of them than are still to reduce."""
    rep = [i for i, d in enumerate(dims) if d is None]
    out = [None] * len(grads)
    if rep:
        bucket, meta = _flatten_bucket([grads[i] for i in rep])
        for i in rep:
            grads[i] = None
        for i, g in zip(rep, _unflatten_bucket(
                _ring_bucket(bucket, group, stream), meta)):
            out[i] = g
    for i, d in enumerate(dims):
        if d is not None:
            out[i] = ring_reduce_scatter(grads[i], group, d, stream)
            grads[i] = None
    return out


def _take_grads(full) -> list:
    """The gradients the backward left on ``full`` (zeros for a leaf
    without one, as the reference's tree holds it), cleared from the
    leaves: the caller owns them now."""
    grads = [t.grad if t.grad is not None else torch.zeros_like(t)
             for t in full]
    for t in full:
        t.grad = None
    return grads


def _gather_leaves(params, dims, group) -> list:
    """The parameters at their global shapes for the forward: each
    sharded leaf all-gathered into a leaf tensor of its own that takes a
    gradient, each replicated one as it is."""
    return [p if d is None else
            ring_all_gather(p.detach(), group, d).requires_grad_(True)
            for p, d in zip(params, dims)]


class _GatherLeaf(torch.autograd.Function):
    """A sharded leaf at its global shape for the forward
    (:func:`ring_all_gather` of the shard); the backward reduce-scatters
    the leaf's full gradient as soon as the backward has summed it, so the
    shard's ``.grad`` takes this rank's slice and the full gradient is
    freed at once (no tree of full gradients ever exists)."""

    @staticmethod
    def forward(ctx, shard, group, dim):
        ctx.group, ctx.dim = group, dim
        return ring_all_gather(shard, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return ring_reduce_scatter(grad, ctx.group, ctx.dim), None, None


def _set_shard_grads(params, acc, divisor: int) -> None:
    for p, a in zip(params, acc):
        p.grad = (a / divisor).to(p.dtype)


def prefetched_fsdp_accum_grads(params, dims, loss_fn, batches, group):
    """The ZeRO mesh's counterpart of :func:`overlapped_accum_grads`.

    ``params``: the model's parameters, each sharded one holding this
    rank's slice of dimension ``dims[i]`` (None: replicated);
    ``loss_fn(full, microbatch) -> scalar`` runs the forward on ``full``,
    the parameters at their global shapes. The sharded leaves are
    all-gathered once a step, an independent ring a leaf; microbatch k's
    pending reduction (:func:`_fsdp_reduce`) runs while microbatch k+1's
    backward does. The gathered leaves take the backward's gradients,
    which go to the pending reduction at once and are freed when it
    ends. The gradients land in the parameters' ``.grad`` as shards,
    averaged over ``len(batches) x n``; the loss comes back as the
    group's mean."""
    params, dims = list(params), list(dims)
    n = dist.get_world_size(group)
    full = _gather_leaves(params, dims, group)
    acc, pending, losses = None, None, []
    for mb in batches:
        for p in params:
            p.grad = None
        loss = loss_fn(full, mb)
        loss.backward()
        losses.append(loss.detach())
        grads = _take_grads(full)
        if pending is not None:
            reduced = pending.result()
            acc = reduced if acc is None else [
                a + r for a, r in zip(acc, reduced)]
        pending = _Pending(
            lambda stream, grads=grads: _fsdp_reduce(grads, dims, group,
                                                     stream),
            grads, group)
        del grads
    reduced = pending.result()
    acc = reduced if acc is None else [a + r for a, r in zip(acc, reduced)]
    del full, pending, reduced
    k = len(losses)
    _set_shard_grads(params, acc, k * n)
    return group_mean(torch.stack(losses).sum() / k, group)


def sequential_fsdp_accum_grads(params, dims, loss_fn, batches, fsdp_group,
                                data_group=None, batch_group=None):
    """The reference's sequential accumulation on an fsdp mesh (and on any
    mesh with a tensor or expert axis, whose model-parallel step the
    reference runs the same way), where
    GSPMD's scan re-gathers the parameters for every microbatch: each
    microbatch gathers the sharded leaves over ``fsdp_group``, runs its
    forward and backward, in which each sharded gradient is
    reduce-scattered over ``fsdp_group`` as soon as it is whole
    (:class:`_GatherLeaf`), and all-reduces the shards over
    ``data_group`` (a data x fsdp mesh); the replicated leaves' gradients
    are all-reduced over ``batch_group``, every rank of the batch (default
    ``fsdp_group``; None, or a group of one: the batch is this rank's).
    Gradients and loss as :func:`prefetched_fsdp_accum_grads` gives
    them, averaged over the microbatches and the batch group."""
    params, dims = list(params), list(dims)
    batch_group = batch_group or fsdp_group
    n = dist.get_world_size(batch_group) if batch_group is not None else 1
    data_n = dist.get_world_size(data_group) if data_group is not None else 1
    acc, losses = None, []
    for mb in batches:
        for p in params:
            p.grad = None
        loss = loss_fn([p if d is None else
                        _GatherLeaf.apply(p, fsdp_group, d)
                        for p, d in zip(params, dims)], mb)
        # each sharded leaf's gradient is reduce-scattered over fsdp
        # inside the backward (_GatherLeaf)
        loss.backward()
        losses.append(loss.detach())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        for p in params:
            p.grad = None
        sharded = [g for g, d in zip(grads, dims) if d is not None]
        rep = [g for g, d in zip(grads, dims) if d is None]
        del grads
        if sharded and data_n > 1:
            bucket, meta = _flatten_bucket(sharded)
            sharded = _unflatten_bucket(_ring_bucket(bucket, data_group),
                                        meta)
        if rep and n > 1:
            bucket, meta = _flatten_bucket(rep)
            rep = _unflatten_bucket(_ring_bucket(bucket, batch_group), meta)
        sharded, rep = iter(sharded), iter(rep)
        reduced = [next(rep) if d is None else next(sharded) for d in dims]
        acc = reduced if acc is None else [a + r for a, r in zip(acc,
                                                                 reduced)]
    k = len(losses)
    _set_shard_grads(params, acc, k * n)
    return group_mean(torch.stack(losses).sum() / k, batch_group)


def broadcast_model(model, group) -> None:
    """Every parameter and buffer of ``model`` from the group's first rank
    (a card's tensors through the host in a gloo group)."""
    broadcast_tensors([*model.parameters(), *model.buffers()], group)


def broadcast_tensors(tensors, group) -> None:
    """Each of ``tensors`` from the group's first rank, in place."""
    src = dist.get_process_group_ranks(group)[0]
    host = dist.get_backend(group) != "nccl"
    with torch.no_grad():
        for t in tensors:
            buf = t.detach().cpu() if host and t.is_cuda else t.detach()
            dist.broadcast(buf, src, group=group)
            if buf is not t:
                t.copy_(buf)


# ---------------------------------------------- tensor and expert parallel

def all_reduce_tensor(x, group):
    """``x`` summed over ``group`` by the ring (fp32 sums, the same bits
    on every rank), in ``x``'s dtype; counted under ``RING_STATS``' ``tp_``
    keys."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    flat = x.detach().reshape(-1).float()
    out = _ring_bucket(flat, group, prefix="tp_")
    return out.view(x.shape).to(x.dtype)


class _ColumnEntry(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_tensor(grad, ctx.group), None


class _RowExit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_tensor(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_tensor(x, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_tensor(grad, ctx.group), None


class _GatherSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.size = x.shape[dim]
        RING_STATS["tp_calls"] += 1
        RING_STATS["tp_bytes"] += (dist.get_world_size(group) * x.numel()
                                   * x.element_size())
        return _via_host(x.contiguous(), group,
                         lambda t: _gather(t, group, dim), "tp_")

    @staticmethod
    def backward(ctx, grad):
        r = dist.get_rank(ctx.group)
        return grad.narrow(ctx.dim, r * ctx.size, ctx.size), None, None


def column_entry(x, group):
    """Megatron's f: ``x`` as it is into a region where each rank of
    ``group`` computes its own part; the backward sums the ranks'
    gradients of ``x``. A group of one (or None) is the identity."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _ColumnEntry.apply(x, group)


def row_exit(x, group):
    """Megatron's g: the sum over ``group`` of each rank's partial
    product ``x``; the backward hands each rank the gradient as it is."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _RowExit.apply(x, group)


def sum_over(x, group):
    """The sum of ``x`` over ``group``, which every rank then uses alike;
    the backward sums the ranks' gradients back to each input."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _SumOver.apply(x, group)


def gather_split(x, group, dim: int):
    """The whole activation from each rank's contiguous slice ``x`` of
    ``dim`` (rank r's slice r); the backward keeps this rank's slice of
    the gradient."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _GatherSplit.apply(x, group, dim)


# ------------------------------------------------- sequence parallelism

def seq_hop(tensors, group):
    """Each of ``tensors`` to the next rank of ``group``'s ring, the
    previous rank's in return, in one exchange of their bytes (one
    buffer, so tensors of several dtypes travel together). Every rank of
    the group calls it at the same point of its program."""
    _, _, nxt, prv = _neighbours(group)
    # the widest elements first, so each tensor's bytes start aligned
    order = sorted(range(len(tensors)),
                   key=lambda i: -tensors[i].element_size())
    flat = torch.cat([tensors[i].contiguous().view(-1).view(torch.uint8)
                      for i in order])
    RING_STATS["sp_calls"] += 1
    RING_STATS["sp_bytes"] += flat.numel()

    def run(buf):
        recv = torch.empty_like(buf)
        _exchange(buf, recv, nxt, prv, group)
        return recv

    got = _via_host(flat, group, run, "sp_")
    out, offset = [None] * len(tensors), 0
    for i in order:
        t = tensors[i]
        size = t.numel() * t.element_size()
        out[i] = got[offset:offset + size].view(t.dtype).view(t.shape)
        offset += size
    return out


def gather_seq(x, group):
    """Every seq rank's tokens of ``x`` ``[b, S, ...]`` in rank order
    along dimension 1 (the ring all-gather); its backward sums each
    rank's gradient over the group and keeps this rank's slice (the ring
    reduce-scatter), since every rank reads every rank's tokens. A group
    of one (or None) is the identity."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _GatherLeaf.apply(x.contiguous(), group, 1)


def _all_to_all(x, group, split_dim: int, concat_dim: int):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    ranks = dist.get_process_group_ranks(group)
    RING_STATS["sp_calls"] += 1
    RING_STATS["sp_bytes"] += x.numel() * x.element_size() * (n - 1) // n

    def run(t):
        chunks = [c.contiguous() for c in t.chunk(n, split_dim)]
        got = [None] * n
        got[r] = chunks[r]
        # at distance d rank r sends its chunk d ranks on and takes the
        # chunk of the rank d back: every pair meets in one exchange
        for d in range(1, n):
            to, frm = (r + d) % n, (r - d) % n
            recv = torch.empty_like(chunks[to])
            _exchange(chunks[to], recv, ranks[to], ranks[frm], group)
            got[frm] = recv
        return torch.cat(got, concat_dim)

    return _via_host(x.contiguous(), group, run, "sp_")


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all(grad, ctx.group, concat_dim, split_dim), None,
                None, None)


def all_to_all(x, group, split_dim: int, concat_dim: int):
    """The reference's tiled ``all_to_all``: ``x`` cut into n equal chunks
    along ``split_dim``, chunk j sent to rank j of ``group``, and the
    chunks received put together along ``concat_dim`` in rank order
    (``[b, s/n, h, d] -> [b, s, h/n, d]`` with split 2 and concat 1). Its
    backward is the exchange the other way. A group of one (or None) is
    the identity."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_dim, concat_dim)


# ------------------------------------------------ collective decode matmul

def has_model_axis(mesh) -> bool:
    """True when ``mesh`` (a ``DeviceMesh``) splits parameters across a
    ``model`` axis: the precondition for the collective-overlapped decode
    matmul. The port's :func:`~move2kube_tpu_torch.parallel.mesh.
    make_mesh` never names one, as the reference's does not."""
    try:
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    except (AttributeError, TypeError):
        return False
    return shape.get("model", 1) > 1


def _hop(send, group):
    """``send`` to the next rank of ``group``, the previous rank's in
    return (a card's tensor through the host in a gloo group)."""
    _, _, nxt, prv = _neighbours(group)
    host = _on_host(group, send)
    buf = send.cpu() if host else send.contiguous()
    recv = torch.empty_like(buf)
    _exchange(buf, recv, nxt, prv, group)
    return recv.to(send.device) if host else recv


def _overlapped_matmul_shard(x, w, group):
    """The shard-local body: ``x`` ``[batch, in/n]`` (this rank's columns)
    against ``w`` ``[in/n, out]`` (its rows). The output columns are cut
    into n chunks (padded to a multiple of n); the reduce-scatter's
    travelling partial sum takes each hop's chunk product as it arrives,
    so after n - 1 hops rank r owns finished chunk r + 1; n - 1 more hops
    all-gather the ``[batch, out]`` row, the same on every rank."""
    n = dist.get_world_size(group)
    if n == 1:
        return x @ w
    r = dist.get_rank(group)
    out = w.shape[1]
    pad = (-out) % n
    if pad:
        w = torch.nn.functional.pad(w, (0, pad))
    cols = w.reshape(w.shape[0], n, -1)

    def part(idx):
        return x.float() @ cols[:, idx % n].float()

    total = part(r)
    for s in range(n - 1):
        total = _hop(total, group) + part(r - 1 - s)
    chunks = total.new_zeros((n,) + tuple(total.shape))
    chunks[(r + 1) % n] = total
    for s in range(n - 1):
        total = _hop(total, group)
        chunks[(r - s) % n] = total
    y = chunks.permute(1, 0, 2).reshape(x.shape[0], -1)
    if pad:
        y = y[:, :out]
    return y.to(x.dtype)


def collective_decode_matmul(group, x, w):
    """``x @ w`` with ``w``'s contraction dimension split over ``group``:
    ``x`` ``[batch, in]`` replicated, ``w`` this rank's rows ``[in/n,
    out]`` (rank r's slice r). Returns the whole product on every rank;
    the sum over the group rides the overlapped ring of
    :func:`_overlapped_matmul_shard`."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    rows = w.shape[0]
    if x.shape[1] != rows * n:
        raise ValueError(f"x has {x.shape[1]} columns; w's {rows} rows "
                         f"x {n} ranks")
    return _overlapped_matmul_shard(x[:, r * rows:(r + 1) * rows], w, group)
