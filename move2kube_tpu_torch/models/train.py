"""Single-device training steps: the port of
``move2kube_tpu/models/train.py``.

:func:`make_lm_train_step` keeps the JAX step's semantics on one card:
fp32 master weights, the loss on the policy's compute-dtype view of them
(``torch.func.functional_call`` on :meth:`PrecisionPolicy.cast_params`, so
the gradients land in fp32 on the masters), the lm-head folded into the
chunked cross-entropy whenever the vocab spans more than one chunk, loss
scaling before the backward and unscaling of gradients and loss after,
gradient accumulation over ``[k, batch, seq]`` microbatches, and per-block
rematerialisation. An MoE ``Llama``'s load-balancing loss joins the LM
loss with weight ``moe_aux_weight`` (the model leaves it in
``Llama.moe_aux``; the step reads and clears it). GPT-2 trains through
its tied head (:func:`~move2kube_tpu_torch.ops.crossentropy.
lm_head_weight`). The optimizer is ``torch.optim.Adam``/``AdamW`` inside
an :class:`Optimizer` that carries what the JAX trainer chains around
optax's: the learning-rate schedule, the precision policy's
:class:`~move2kube_tpu_torch.models.precision.FiniteGuard` and the
grad-norm record.

The family steps (:func:`make_classifier_train_step`,
:func:`make_bert_train_step`, :func:`make_diffusion_train_step`) run the
model in its own compute type over fp32 parameters, as the JAX steps do;
ResNet's BatchNorm statistics are the model's buffers, updated in place
by its training-mode forward (:attr:`TrainState.batch_stats` lists
them).

Telemetry: :func:`instrument_optimizer` records each update's global
grad norm and the tensor-health summaries of the gradients and the
parameters (:mod:`move2kube_tpu_torch.obs.numerics`), and
:class:`StepTelemetry` turns step times, those records and the cost model
(:mod:`move2kube_tpu_torch.obs.costmodel`) into the reference's
``m2kt_train_*`` gauges.

Data parallelism: each step factory takes a ``mesh`` (a ``DeviceMesh``
from :func:`~move2kube_tpu_torch.parallel.mesh.make_mesh`). On a pure
data mesh of more than one rank the batch a rank is handed is its own
rows of the global batch; the parameters start identical on every rank (a
broadcast from the data group's first rank at the first step); the
gradients are reduced by the port's ring (:mod:`move2kube_tpu_torch.
parallel.overlap`) in place of GSPMD's implicit psum, with no DDP and no
``dist.all_reduce``: one reduction path in the reference's order, which
leaves every rank with the same bits. With ``grad_accum > 1`` each
microbatch's reduction overlaps the next one's backward
(:func:`~move2kube_tpu_torch.parallel.overlap.overlapped_accum_grads`,
the reference's path on such a mesh); with one microbatch the single
reduction goes through the same ring. The loss comes back as the group's
mean, and the loss-scale guard, the grad norm and the health recorder
read the reduced gradients, so no rank skips an update alone. BatchNorm
statistics are taken over the global batch (:class:`~move2kube_tpu_torch.
models.layers.BatchNorm`).

FSDP (ZeRO-3): on a mesh with an fsdp axis the model holds this rank's
shards (:func:`create_sharded_state`, or :func:`~move2kube_tpu_torch.
parallel.sharding.shard_params` before the optimizer's first step), so
the optimizer's moments are shards too. The step gathers the sharded
leaves into tensors of their own for the forward (``functional_call`` on
the gathered dict, so the precision cast and the head-folded loss see
whole fp32 tensors) and reduce-scatters their gradients into the shards'
``.grad``, the full gradients freed as their reduction ends: on a pure
fsdp mesh through :func:`~move2kube_tpu_torch.parallel.overlap.
prefetched_fsdp_accum_grads` (one gather a step, each microbatch's
reduction overlapping the next backward) for every ``grad_accum``,
unless ``M2KT_FSDP_PREFETCH=off``; on a data x fsdp mesh, and under
``off``, through the sequential schedule, which gathers for every
microbatch and all-reduces the shards over the data axis. Replicated
leaves are all-reduced over the whole batch group; the family steps run
their loss on the gathered parameters, and a conv family, whose leaves
all stay whole, takes the data path over the batch group. No
``torch.distributed.fsdp``, no DDP, no ``all_gather_into_tensor`` or
``reduce_scatter_tensor``: the rings' point-to-point hops are the one
gather and reduction path.

Tensor and expert parallelism: on a mesh with a tensor or expert axis the
model holds its parts over every axis (:func:`create_sharded_state`), the
step gives its modules a :class:`~move2kube_tpu_torch.parallel.sharding.
ModelParallel`, and the Llama, GPT-2 and MoE forwards split their heads,
columns, vocab rows and experts (their docstrings), issuing the
collectives GSPMD inserts in the reference. The step runs the sequential
schedule, as the reference's model-parallel step does; the gradient
reduction and reduce-scatter stay over the batch group (data x fsdp) and
the fsdp group, and the gradients of the whole leaves a tensor rank uses
a slice of are summed over the tensor group. Each leaf starts from the
first rank of the ranks that hold the same copy of it. The optimizer's
grad norm, guard and health summaries count each part once. An MoE
routes the global batch's tokens where the reference's step sees the
global batch (``models/moe.py``).

Sequence parallelism (the LM step): on a mesh with a seq axis the ranks
of a seq group hold the same rows (the loader's batch layout), and each
runs its shard of their tokens, positions ``[r S, (r+1) S)``
(:func:`seq_shard`); the model's ``ring`` or ``ulysses`` attention runs
over the group (``models/llama.py``). Each rank's loss is the sum over
its targets over the global count ``b (s - 1)``, times the seq extent
(:func:`seq_loss_weight`), so the batch x seq group's mean of the losses
and of the gradients, which the rings take, is the reference's global
mean: every leaf's gradient summed over the seq group and averaged over
the batch. An MoE's aux loss, the same global value on every rank, is
not weighted. A mesh with a seq axis takes the sequential schedule (the
data path without overlap, or the sequential fsdp schedule, whose
reduce-scatter is then all-reduced over data x seq), as the reference's
``is_pure_fsdp`` says; an MoE routes over the batch x seq group. The
BERT, ResNet and UNet steps refuse a seq axis, naming 9d (the reference
leaves them to GSPMD). A mesh with a pipe axis above 1 raises
``NotImplementedError`` naming its ROADMAP slice (9e).
``scan_steps``
(k optimizer steps in one compiled call) has no counterpart: the caller
runs the step k times. Each step updates the state in place and returns
it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import torch
from torch import nn

from move2kube_tpu_torch.obs import numerics as numericslib
from move2kube_tpu_torch.ops.crossentropy import (
    DEFAULT_CHUNK,
    fused_cross_entropy,
    linear_lm_loss,
    lm_head_weight,
    reference_cross_entropy,
)

# the JAX package's cross_entropy_loss is the same function as its
# reference_cross_entropy: full fp32 log-softmax and a gather
cross_entropy_loss = reference_cross_entropy


def lm_loss(logits, input_ids, chunk: int = DEFAULT_CHUNK,
            targets=None) -> torch.Tensor:
    """Next-token-prediction loss on logits ``[b, s, vocab]``: the chunked
    CE when the vocab spans more than one ``chunk`` (the JAX ladder's
    ``auto``), the reference otherwise. ``targets`` ``[b, t]``, when
    given, label the first t positions in place of the shifted
    ``input_ids`` (:func:`seq_shard`)."""
    if targets is None:
        logits, labels = logits[:, :-1], input_ids[:, 1:]
    else:
        logits, labels = logits[:, :targets.shape[1]], targets
    if logits.shape[-1] > chunk:
        return fused_cross_entropy(logits, labels, chunk)
    return cross_entropy_loss(logits, labels)


def seq_loss_weight(n_targets: int, s: int, sp: int) -> float:
    """What a seq rank's mean over its ``n_targets`` targets is multiplied
    by: its share of the global mean over the ``s - 1`` targets of a row,
    times the seq extent ``sp``, so that the batch x seq group's mean of
    the ranks' losses and gradients is the sum over the seq ranks and the
    mean over the batch."""
    return n_targets * sp / (s - 1)


def seq_shard(ids, sp: int, r: int):
    """Seq rank r of ``sp``'s share of rows ``ids`` ``[b, s]`` (every rank
    of a seq group holds the rows whole): ``(inputs, targets, weight)``,
    the inputs ``ids[:, r S:(r+1) S]`` (S = s / sp), their targets
    ``ids[:, r S + 1:(r+1) S + 1]`` (the last rank's one fewer: no token
    follows the row) and :func:`seq_loss_weight`. The reference's loss is
    the mean over all ``b (s - 1)`` targets, never a mean of the shards'
    means."""
    b, s = ids.shape
    if s % sp or s // sp < 2:
        raise ValueError(f"a seq axis of {sp} cuts rows of {s} tokens into "
                         "equal shards of at least 2")
    size = s // sp
    inputs = ids[:, r * size:(r + 1) * size]
    targets = ids[:, r * size + 1:(r + 1) * size + 1]
    return inputs, targets, seq_loss_weight(targets.shape[1], s, sp)


def global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: the 2-norm of all the tensors together, in
    fp32."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then cosine down to
    ``end_value`` at ``decay_steps`` (which counts the warmup). Returns a
    function of the update count."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed "
                         f"warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cos_steps)
        decay = 0.5 * (1 + math.cos(math.pi * t / cos_steps))
        return peak_value * ((1 - alpha) * decay + alpha)

    return schedule


class Optimizer:
    """A ``torch.optim`` optimizer and what the JAX trainer chains around
    optax's:

    - ``schedule``: the learning rate as a function of the number of
      updates applied so far (optax's schedule count, which a skipped
      update does not advance);
    - ``guard``: set by ``PrecisionPolicy.wrap_optimizer`` under loss
      scaling; a rejected update leaves the parameters, the inner state
      and the count as they were;
    - the records (:func:`instrument_optimizer`): the global norm of the
      gradients as handed to :meth:`step` (unscaled) and the tensor-health
      summaries of those gradients and of the parameters before the
      update (``health``, a :class:`~move2kube_tpu_torch.obs.numerics.
      TensorHealthState` on the parameters' device), both taken before
      the guard, so a skipped update is recorded too. Nothing is read
      back to the host.
    - ``sharding``: over parts (set by the step on a mesh that cuts
      leaves over fsdp, tensor or expert), the norm is the square root of
      the group's sum of squares, each part and each whole leaf counted
      once; the health summaries are reduced across the group (sums
      summed, maxima maxed, counts summed), so every rank records the
      whole tree's numbers; and the guard's verdict is the group's (any
      rank's non-finite gradient rejects the update on every rank).

    The health groups need the parameters' names: :meth:`bind` takes them
    from the model (a :class:`TrainState` binds its own).
    """

    def __init__(self, inner: torch.optim.Optimizer) -> None:
        self.inner = inner
        self.schedule = None  # set by default_optimizer
        self.count = 0
        self.guard = None
        self.record_grad_norm = False
        self.grad_norm: torch.Tensor | None = None
        # tensor-health recorder (instrument_optimizer): the state exists
        # whether recording is on or off, so its shape never depends on
        # M2KT_NUMERICS; health_on is that knob, read when instrumented
        self.record_health = False
        self.health_on = False
        self.health: numericslib.TensorHealthState | None = None
        self.health_names: list[str] | None = None
        self._groups: dict[int, int] = {}
        self._held = False
        # set by a step on an fsdp mesh: which parameters are shards and
        # the group they are shards over, so the norm, the guard and the
        # health summaries read the whole tree
        self.sharding: _ShardedTree | None = None

    def params(self) -> list:
        return [p for g in self.inner.param_groups for p in g["params"]]

    def bind(self, model) -> None:
        """Name this optimizer's health groups after ``model``'s parameters
        (:func:`~move2kube_tpu_torch.obs.numerics.group_index`); an
        instrumented optimizer gets its zeroed state here."""
        names, leaf_groups = numericslib.group_index(model)
        self.health_names = names
        self._groups = {id(p): g for (_, p), g in
                        zip(model.named_parameters(), leaf_groups)}
        if self.record_health:
            self._zero_health()

    def _zero_health(self) -> None:
        params = self.params()
        dev = params[0].device if params else None
        self.health = numericslib.zero_state(len(self.health_names), dev)

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    @contextlib.contextmanager
    def held(self):
        """While held, :meth:`step` applies no update and records nothing:
        the parameters, the inner state, the count, the guard and the
        records stay as they were (the cost model runs one step this way
        to count it)."""
        self._held = True
        try:
            yield self
        finally:
            self._held = False

    def _record_health(self, params) -> None:
        """The gradients' and the parameters' group summaries (one group
        while no model is bound); a parameter without a gradient counts
        as the zero gradient the reference's tree holds for it."""
        if self.health_names is None:
            groups, n = [0] * len(params), 1
        else:
            groups = [self._groups.get(id(p), 0) for p in params]
            n = len(self.health_names)
        grads = [p.grad if p.grad is not None
                 else p.new_zeros(()).expand_as(p) for p in params]
        shards = gather = owners = None
        if self.sharding is not None:
            shards = [self.sharding.kind(p) for p in params]
            gather, owners = self.sharding.gather, self.sharding.owners
        self.health = numericslib.TensorHealthState(
            *numericslib.summarize_tree(grads, groups, n, shards, gather,
                                        owners),
            *numericslib.summarize_tree(params, groups, n, shards, gather,
                                        owners))

    def step(self) -> bool:
        """Apply the update held in the parameters' ``.grad``; returns
        False when the guard rejected it."""
        if self._held:
            return True
        with_grad = [p for p in self.params() if p.grad is not None]
        grads = [p.grad for p in with_grad]
        sharded = self.sharding
        if self.record_grad_norm:
            self.grad_norm = (global_norm(grads) if sharded is None
                              else sharded.global_norm(with_grad))
        if self.record_health and self.health_on:
            self._record_health(self.params())
        if self.guard is not None and not self.guard.admit(
                grads, None if sharded is None else sharded.any_rank):
            return False
        if self.schedule is not None:
            lr = self.schedule(self.count)
            for group in self.inner.param_groups:
                group["lr"] = lr
        self.inner.step()
        self.count += 1
        return True


def adam(params, learning_rate: float) -> Optimizer:
    """``optax.adam(learning_rate)``: b1 0.9, b2 0.999, eps 1e-8 added
    outside the square root."""
    return Optimizer(torch.optim.Adam(params, lr=learning_rate,
                                      betas=(0.9, 0.999), eps=1e-8))


def adamw(params, learning_rate: float,
          weight_decay: float = 1e-4) -> Optimizer:
    """``optax.adamw(learning_rate, weight_decay=...)``: Adam plus decoupled
    weight decay, ``p -= lr * (adam_update + weight_decay * p)`` on every
    parameter (optax's default mask is none). ``torch.optim.AdamW`` scales
    ``p`` by ``1 - lr * weight_decay`` before its Adam step, the same
    update; tests hold the two together."""
    return Optimizer(torch.optim.AdamW(params, lr=learning_rate,
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay))


def default_optimizer(params, lr: float = 1e-3, weight_decay: float = 0.0,
                      warmup_steps: int = 100, total_steps: int = 10000,
                      precision=None) -> Optimizer:
    """Warmup-cosine Adam(W), as the JAX ``default_optimizer``. With a
    ``PrecisionPolicy`` that scales the loss, non-finite gradients skip the
    update instead of poisoning the fp32 master weights."""
    schedule = warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps, max(total_steps, warmup_steps + 1))
    opt = (adamw(params, schedule(0), weight_decay) if weight_decay
           else adam(params, schedule(0)))
    opt.schedule = schedule
    if precision is not None:
        precision.wrap_optimizer(opt)
    return opt


def instrument_optimizer(opt: Optimizer) -> Optimizer:
    """Record the global norm of each update's gradients (the JAX
    ``grad_norm_recorder``; read it with :func:`grad_norm_from_state`) and
    their and the parameters' tensor-health summaries (the JAX
    ``health_recorder``; :func:`~move2kube_tpu_torch.obs.numerics.
    health_from_state`), both in front of any guard, as the JAX function
    chains them outside ``apply_if_finite``. The health state has the same
    shape whether ``M2KT_NUMERICS`` (read here) is on or off; the
    :class:`TrainState` that takes the optimizer names its groups."""
    opt.record_grad_norm = True
    return numericslib.health_recorder(opt)


def grad_norm_from_state(state) -> float | None:
    """Latest global grad norm recorded by an instrumented optimizer
    (``state`` is a :class:`TrainState` or its optimizer); None when the
    optimizer is not instrumented or has not stepped."""
    opt = getattr(state, "optimizer", state)
    norm = getattr(opt, "grad_norm", None)
    return float(norm) if norm is not None else None


@dataclasses.dataclass
class TrainState:
    """What a step updates: the model holding the fp32 master weights, its
    optimizer, and the number of steps taken (skipped updates included, as
    the JAX ``TrainState.step`` counts them)."""
    model: nn.Module
    optimizer: Optimizer
    step: int = 0

    def __post_init__(self) -> None:
        bind = getattr(self.optimizer, "bind", None)
        if bind is not None:
            bind(self.model)

    @property
    def batch_stats(self) -> dict | None:
        """The model's BatchNorm running statistics (its buffers, by
        name; the JAX ``TrainState.batch_stats``), None when it has
        none."""
        stats = dict(self.model.named_buffers())
        return stats or None


def create_sharded_state(cfg, mesh, optimizer_fn, seed: int = 0,
                         device=None, dtype: torch.dtype = torch.float32,
                         params: dict | None = None,
                         rules=None) -> TrainState:
    """A :class:`TrainState` whose parameters are this rank's parts on
    ``mesh`` (its fsdp shards, ZeRO-3, and its tensor and expert cuts):
    the reference's ``create_sharded_state``.

    A Llama or GPT-2 (``cfg``'s type) is built on the meta device, and
    each leaf is then materialised on ``device`` (the card by default)
    one at a time, in ``dtype`` (fp32 masters by default), and only this
    rank's slice kept (:func:`~move2kube_tpu_torch.parallel.sharding.
    shard_params`' layout), so no rank ever holds the whole tree. Every
    rank draws a leaf's full values from one generator seeded with
    ``seed``, in :func:`~move2kube_tpu_torch.models.convert.init_llama`'s
    order: the values do not depend on the world, and the shards put
    together are ``init_llama(cfg, seed)``'s tree. ``params`` (a full
    tree by the port's names, as ``params_from_jax`` gives it) takes the
    place of the draws. A BERT, ResNet or UNet is built whole
    (``init_family``, or ``params``) and then sharded.

    ``optimizer_fn(parameters) -> Optimizer`` is built over the shards,
    so the optimizer's moments are shards too."""
    from move2kube_tpu_torch._device import resolve_device
    from move2kube_tpu_torch.models import convert
    from move2kube_tpu_torch.parallel.sharding import (
        mesh_layout,
        shard_params,
    )

    dev = resolve_device(device)
    lm = type(cfg) in convert.LM_EMBEDS
    if not lm:
        if params is None:
            model = convert.init_family(cfg, seed, device=dev)
        else:
            model = convert.meta_model(cfg).to_empty(device=dev)
            model.load_state_dict(params)
        shard_params(model, mesh, rules)
        return TrainState(model, optimizer_fn(model.parameters()))
    from move2kube_tpu_torch.models.gpt2 import GPT2
    from move2kube_tpu_torch.models.llama import Llama, LlamaConfig

    cfg = dataclasses.replace(cfg, dtype=dtype)
    model = (Llama if isinstance(cfg, LlamaConfig) else GPT2)(
        cfg, device="meta")
    layout = mesh_layout(model, mesh, rules)
    gen = None
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    embeds = convert.LM_EMBEDS[type(cfg)]
    for name, p in list(model.named_parameters()):
        if params is None:
            full = torch.empty(p.shape, dtype=dtype, device=dev)
            convert.draw_lm_leaf(model, name, full, gen, embeds)
        else:
            full = params[name].to(device=dev, dtype=dtype)
        shard = layout.take(name, full)
        shard = shard.clone() if shard is not full else full
        del full
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner), leaf, nn.Parameter(shard))
    model.fsdp_layout = layout
    return TrainState(model, optimizer_fn(model.parameters()))


class _ShardedTree:
    """How the optimizer's records read a tree of parts: each parameter's
    kind (the mesh axes it is cut over, an empty set for a whole leaf),
    the ring group of every rank that holds a distinct part (the mesh's
    axes above 1 but data) and each of its ranks' coordinates. A part
    counts once, on the ranks whose coordinate is 0 on every axis the
    leaf is not cut over; every reduction goes through the ring's
    all-gather, so every rank reads the same bits."""

    def __init__(self, kinds: dict, group, coords: list, device) -> None:
        self.kinds = kinds
        self.group = group
        self.coords = coords
        self.device = device

    def is_shard(self, p) -> bool:
        return bool(self.kinds.get(id(p)))

    def kind(self, p):
        return self.kinds.get(id(p)) or False

    def gather(self, t):
        """``t`` of every rank of the group, stacked on a new first
        dimension in rank order."""
        from move2kube_tpu_torch.parallel import overlap

        return overlap.ring_all_gather(t.unsqueeze(0), self.group, 0)

    def owners(self, kinds) -> torch.Tensor:
        """``[ranks, kinds]``: 1 where a rank's part of a kind counts."""
        rows = [[float(all(c.get(a, 0) == 0 for a in c
                           if not (kind and a in kind)))
                 for kind in kinds] for c in self.coords]
        return torch.tensor(rows, device=self.device)

    def global_norm(self, params) -> torch.Tensor:
        """``optax.global_norm`` of the whole tree's gradients."""
        kinds = list(dict.fromkeys(self.kind(p) for p in params))
        sq = [[] for _ in kinds]
        for p in params:
            sq[kinds.index(self.kind(p))].append(
                torch.linalg.vector_norm(p.grad.float()) ** 2)
        local = torch.stack([torch.stack(v).sum() for v in sq])
        every = self.gather(local)
        return torch.sqrt((every * self.owners(kinds)).sum())

    def any_rank(self, flag: bool) -> bool:
        """True when ``flag`` holds on any rank of the group (a MAX)."""
        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        return bool(self.gather(t).amax() > 0)


class _MeshPlan:
    """What a step runs on a mesh of more than one rank.

    - ``batch``: the ring group of every rank of the batch (data x fsdp
      x seq; None when the batch is one rank's); the data path (9a)
      reduces over it, and so do a sharded model's whole leaves.
    - ``layout``: the model's :class:`~move2kube_tpu_torch.parallel.
      sharding.ShardLayout` when it holds parts, else None.
    - ``fsdp``, ``data``, ``tensor``: the ring groups of this rank's
      fsdp, data x seq and tensor axes (None at extent 1).
    - ``sequential``: a seq mesh's model without parts takes the
      sequential schedule (no overlapped reduction) too.
    - ``prefetch``: the pure-fsdp schedule
      (:func:`~move2kube_tpu_torch.parallel.overlap.
      prefetched_fsdp_accum_grads`) rather than the sequential one.
    - ``partial``: the whole leaves a tensor rank uses a slice of, whose
      gradients are summed over the tensor group."""

    def __init__(self, batch, layout=None, fsdp=None, data=None,
                 prefetch=False, tensor=None, partial=(),
                 sequential=False) -> None:
        self.batch, self.layout = batch, layout
        self.fsdp, self.data, self.prefetch = fsdp, data, prefetch
        self.tensor, self.partial = tensor, set(partial)
        self.sequential = sequential


class _MeshContext:
    """A step's mesh context, made at the first step: the ring groups of
    the batch and of each axis above 1, each model met broadcast once
    (each leaf from the first rank of the group of ranks that hold the
    same copy of it: the axes it is not cut over), its BatchNorm layers
    given the batch group, its modules given a :class:`~move2kube_tpu_
    torch.parallel.sharding.ModelParallel` on a tensor or expert mesh,
    and a sharded model's optimizer told which of its parameters are
    parts of which axes. None without a mesh or on a mesh of one."""

    def __init__(self, mesh, grad_accum: int = 1) -> None:
        self.mesh = mesh
        self.grad_accum = grad_accum
        self._groups: dict = {}
        self._synced: set[int] = set()

    def group(self, axes: tuple):
        """The ring group of this rank's ``axes`` (those above 1; None
        when none is)."""
        from move2kube_tpu_torch.parallel import overlap
        from move2kube_tpu_torch.parallel.mesh import mesh_config_of

        cfg = mesh_config_of(self.mesh)
        axes = tuple(a for a in axes if getattr(cfg, a) > 1)
        if not axes:
            return None
        if axes not in self._groups:
            self._groups[axes] = overlap.mesh_ring_group(self.mesh, axes)
        return self._groups[axes]

    def plan(self, state) -> _MeshPlan | None:
        if self.mesh is None:
            return None
        from move2kube_tpu_torch.models import convert
        from move2kube_tpu_torch.parallel import overlap
        from move2kube_tpu_torch.parallel.mesh import (
            check_ported_mesh,
            mesh_config_of,
        )
        from move2kube_tpu_torch.parallel.sharding import layout_of

        cfg = mesh_config_of(self.mesh)
        if cfg.total() == 1:
            return None
        check_ported_mesh(cfg)  # raises, naming an unported axis's slice
        model = state.model
        layout = layout_of(model)  # None too for a conv family's
        cut = self._cut_axes(model, layout, cfg)
        if cut & {"tensor", "expert"} and type(
                getattr(model, "cfg", None)) not in convert.LM_EMBEDS:
            raise NotImplementedError(
                "the rules split this model over tensor or expert; its "
                "forward does not: they split the Llama and GPT-2 families")
        if layout is None and cut:
            raise ValueError(
                "a mesh that cuts the model's leaves (fsdp, tensor, expert) "
                "trains a sharded model: build the state with "
                "create_sharded_state (or shard_params before the "
                "optimizer's first step)")
        batch = self.group(("data", "fsdp", "seq"))
        fsdp, data = self.group(("fsdp",)), self.group(("data", "seq"))
        tensor = self.group(("tensor",))
        if id(model) not in self._synced:
            self._sync(model, layout, cfg)
            self._synced.add(id(model))
        prefetch = layout is not None and overlap.fsdp_prefetched(self.mesh)
        self._attach(model, cfg, batch, tensor, prefetch)
        if layout is None:
            return _MeshPlan(batch, sequential=cfg.seq > 1)
        state.optimizer.sharding = self._sharded_tree(model, layout, cfg)
        # the whole leaves a tensor rank uses only its slice of: each
        # block names its own (``tensor_partial``)
        names = dict(model.named_parameters())
        partial = [f"{m_name}.{leaf}" for m_name, m in model.named_modules()
                   for leaf in getattr(m, "tensor_partial", ())
                   if tensor is not None and f"{m_name}.{leaf}" in names]
        return _MeshPlan(batch, layout, fsdp, data, prefetch, tensor,
                         partial)

    @staticmethod
    def _cut_axes(model, layout, cfg) -> set:
        """The axes the rules cut the model's leaves over on this mesh."""
        from move2kube_tpu_torch.parallel.mesh import MeshConfig
        from move2kube_tpu_torch.parallel.sharding import param_specs

        if layout is not None:
            return set().union(*(layout.axes_of(n) for n in layout.cuts))
        if max(cfg.fsdp, cfg.tensor, cfg.expert) == 1:
            return set()
        out = set()
        for spec in param_specs(model, dict(zip(MeshConfig.AXES,
                                                cfg.dims()))).values():
            for entry in spec.axes:
                out.update(entry if isinstance(entry, tuple) else (entry,))
        return out & {"fsdp", "tensor", "expert"}

    def _attach(self, model, cfg, batch, tensor, prefetch) -> None:
        """The model's :class:`ModelParallel`: its tensor, expert and seq
        groups, and the MoE route group: the batch x seq group where the
        reference's step routes the global batch (its GSPMD step, its
        sequential scan), none on its per-device ``shard_map`` paths (pure
        data with accumulation, the prefetched fsdp step with it)."""
        from move2kube_tpu_torch.parallel.sharding import (
            ModelParallel,
            attach_model_parallel,
        )

        if not hasattr(model, "mp"):
            return
        per_device = self.grad_accum > 1 and (
            prefetch or (cfg.data > 1 and cfg.total() == cfg.data))
        mp = getattr(model, "mp", None)
        if mp is None:
            mesh = self.mesh
            mp = ModelParallel(
                tensor=tensor, t=cfg.tensor,
                t_rank=mesh.get_local_rank("tensor") if cfg.tensor > 1 else 0,
                expert=self.group(("expert",)), ep=cfg.expert,
                ep_rank=mesh.get_local_rank("expert") if cfg.expert > 1
                else 0, te=self.group(("tensor", "expert")),
                seq=self.group(("seq",)), sp=cfg.seq,
                sp_rank=mesh.get_local_rank("seq") if cfg.seq > 1 else 0)
            attach_model_parallel(model, mp)
        mp.route = None if per_device else batch

    def _sharded_tree(self, model, layout, cfg) -> _ShardedTree:
        from move2kube_tpu_torch.parallel.mesh import MeshConfig

        axes = tuple(a for a in MeshConfig.AXES
                     if a != "data" and getattr(cfg, a) > 1)
        group = self.group(axes)
        coords = []
        for flat in range(self.mesh.mesh.numel() // max(1, cfg.data)):
            c, rest = {}, flat
            for a in reversed(axes):
                c[a] = rest % getattr(cfg, a)
                rest //= getattr(cfg, a)
            coords.append(c)
        kinds = {id(p): layout.axes_of(n) for n, p in
                 model.named_parameters()}
        return _ShardedTree(kinds, group, coords,
                            next(model.parameters()).device)

    def _sync(self, model, layout, cfg) -> None:
        from move2kube_tpu_torch.parallel import overlap
        from move2kube_tpu_torch.parallel.mesh import MeshConfig

        axes = tuple(a for a in MeshConfig.AXES if getattr(cfg, a) > 1)
        by_group: dict = {}
        for n, p in model.named_parameters():
            cut = layout.axes_of(n) if layout is not None else frozenset()
            copies = tuple(a for a in axes if a not in cut)
            by_group.setdefault(copies, []).append(p)
        by_group.setdefault(axes, []).extend(model.buffers())
        for copies, tensors in by_group.items():
            group = self.group(copies)
            if group is not None and tensors:
                overlap.broadcast_tensors(tensors, group)
        # BatchNorm's statistics run on the main thread while a pending
        # ring reduction may run on the batch's ring group: they take the
        # mesh's own group
        mesh = self.mesh
        stats = (mesh.get_group("data") if cfg.fsdp == 1 else
                 mesh.get_group("fsdp") if cfg.data == 1 else None)
        if stats is None:
            import torch.distributed as dist

            stats = dist.group.WORLD
        for m in model.modules():
            if hasattr(m, "stats_group"):
                m.stats_group = stats


class _Applied:
    """``model`` called on ``params`` (``torch.func.functional_call``),
    its other attributes the model's own: what a family's loss function
    sees in place of a sharded model."""

    def __init__(self, model, params: dict) -> None:
        self._model, self._params = model, params

    def __call__(self, *args, **kwargs):
        return torch.func.functional_call(self._model, self._params, args,
                                          kwargs)

    def __getattr__(self, name):
        return getattr(self._model, name)


def _mesh_loss(plan, model, loss_of, batch, grad_accum: int):
    """Backward and reduce one update's gradients on a mesh
    (``loss_of(params, microbatch) -> loss``, ``params`` a dict of the
    parameters at their global shapes; ``batch`` holds ``grad_accum``
    stacked microbatches when above 1); returns the group's mean loss.
    A data-parallel model takes 9a's ring over the batch group; a
    sharded one (or any on a seq mesh) the fsdp schedule of ``plan``."""
    from move2kube_tpu_torch.parallel import overlap

    named = list(model.named_parameters())
    params = [p for _, p in named]
    if plan.layout is None and not plan.sequential:
        whole = dict(named)
        if grad_accum <= 1:
            loss = loss_of(whole, batch)
            loss.backward()
            if plan.batch is not None:
                overlap.reduce_grads(params, plan.batch)
            return overlap.group_mean(loss.detach(), plan.batch)
        if plan.batch is None:  # the batch is this rank's (expert copies)
            return _accumulate(model, (loss_of(whole, mb) for mb in batch),
                               grad_accum)
        return overlap.overlapped_accum_grads(
            params, lambda mb: loss_of(whole, mb), batch, plan.batch)
    names = [n for n, _ in named]
    dims = [plan.layout.dims[n] if plan.layout is not None else None
            for n in names]
    micro = [batch] if grad_accum <= 1 else batch

    def loss_fn(full, mb):
        return loss_of(dict(zip(names, full)), mb)

    if plan.prefetch:
        return overlap.prefetched_fsdp_accum_grads(params, dims, loss_fn,
                                                   micro, plan.fsdp)
    loss = overlap.sequential_fsdp_accum_grads(
        params, dims, loss_fn, micro, plan.fsdp, plan.data, plan.batch)
    if plan.partial:
        # the gradient rule: a whole leaf each tensor rank used a slice of
        part = [p for n, p in named if n in plan.partial]
        for p, g in zip(part, overlap.ring_all_reduce(
                [p.grad for p in part], plan.tensor)):
            p.grad = g
    return loss


def _accumulate(model, micro_losses, grad_accum: int) -> torch.Tensor:
    """Backward each microbatch's loss (``micro_losses``: a generator of
    ``grad_accum`` losses) into the fp32 ``.grad``, average the
    gradients, return the mean loss."""
    losses = []
    for loss in micro_losses:
        loss.backward()  # sums into the fp32 .grad
        losses.append(loss.detach())
    for p in model.parameters():
        if p.grad is not None:
            p.grad.div_(grad_accum)
    return torch.stack(losses).mean()


def make_train_step(loss_fn, grad_accum: int = 1, mesh=None):
    """A step around ``loss_fn(model, batch) -> loss`` (``batch`` a dict
    of tensors, moved to the model's device): zero the grads, backward
    (over ``grad_accum`` microbatches stacked on each tensor's leading
    axis when > 1), reduce across the batch group on a ``mesh`` (a
    sharded model's loss function is handed the model on its gathered
    parameters), update. The families' steps below and minitrain's are
    this one. The ranks of a seq axis run the same rows as copies."""
    ctx = _MeshContext(mesh, grad_accum)

    def step(state: TrainState, batch: dict):
        model, opt = state.model, state.optimizer
        dev = next(model.parameters()).device
        batch = {k: v.to(dev) for k, v in batch.items()}
        opt.zero_grad()
        plan = ctx.plan(state)
        if grad_accum > 1:
            lead = {v.shape[0] for v in batch.values()}
            if lead != {grad_accum}:
                raise ValueError(f"grad_accum={grad_accum} takes batch "
                                 f"tensors [{grad_accum}, ...]; got leading "
                                 f"extents {sorted(lead)}")
        if plan is not None:
            micro = (batch if grad_accum <= 1 else
                     [{k: v[i] for k, v in batch.items()}
                      for i in range(grad_accum)])
            loss = _mesh_loss(
                plan, model,
                lambda params, b: loss_fn(
                    model if plan.layout is None else _Applied(model, params),
                    b),
                micro, grad_accum)
        elif grad_accum <= 1:
            loss = loss_fn(model, batch)
            loss.backward()
            loss = loss.detach()
        else:
            micro = ({k: v[i] for k, v in batch.items()}
                     for i in range(grad_accum))
            loss = _accumulate(model, (loss_fn(model, b) for b in micro),
                               grad_accum)
        opt.step()
        state.step += 1
        return state, loss

    return step


def _refuse_seq(mesh, family: str) -> None:
    """A family step that does not shard its inputs over a seq axis
    (BERT, ResNet, the UNet) refuses a mesh with one."""
    if mesh is None:
        return
    from move2kube_tpu_torch.parallel.mesh import mesh_config_of

    seq = mesh_config_of(mesh).seq
    if seq > 1:
        raise NotImplementedError(
            f"seq={seq}: the {family} step does not shard its inputs over "
            "a seq axis (ROADMAP Queue 1 item 9d runs the Llama and GPT-2 "
            "LM steps on one; BERT, ResNet and the UNet on it are open)")


def make_classifier_train_step(has_batch_stats: bool = False,
                               grad_accum: int = 1, mesh=None):
    """Train step for image/sequence classifiers (ResNet); ``step(state,
    {"input": x, "label": y}) -> (state, loss)``, cross-entropy of the
    logits in fp32.

    ``has_batch_stats``: the model carries BatchNorm statistics (ResNet);
    the step runs it in training mode, which normalises with each batch's
    statistics and updates the running ones in place. A model with
    BatchNorm buffers needs it, as the JAX step needs the collection.
    ``grad_accum=k`` takes ``[k, batch, ...]`` tensors and folds the k
    microbatches into one update; the statistics go through the
    microbatches in order, so the final ones reflect all k, as the JAX
    step threads them through its scan. On a data ``mesh`` the statistics
    are the global batch's."""

    def loss_fn(model, batch):
        if has_batch_stats:
            model.train()
        elif next(model.buffers(), None) is not None:
            raise ValueError("the model carries BatchNorm statistics; "
                             "pass has_batch_stats=True")
        return cross_entropy_loss(model(batch["input"]), batch["label"])

    _refuse_seq(mesh, "classifier")
    return make_train_step(loss_fn, grad_accum, mesh)


def make_bert_train_step(mesh=None):
    """Fine-tune step for ``BertEncoder``; ``step(state, {"input_ids",
    "attention_mask" (optional), "label"}) -> (state, loss)``."""

    def loss_fn(model, batch):
        logits = model(batch["input_ids"], batch.get("attention_mask"))
        return cross_entropy_loss(logits, batch["label"])

    _refuse_seq(mesh, "BERT")
    return make_train_step(loss_fn, mesh=mesh)


def make_diffusion_train_step(num_diffusion_steps: int = 1000, mesh=None):
    """DDPM denoising step for the ``UNet``: the batch carries clean
    ``image``s, pre-drawn gaussian ``noise`` and integer timesteps ``t``;
    the step forms ``x_t`` from the linear-beta schedule
    (``ddpm_alpha_bars``, made once on the model's device) and regresses
    the predicted noise with the mean squared error in fp32."""
    from move2kube_tpu_torch.models.unet import ddpm_alpha_bars

    schedules: dict = {}

    def loss_fn(model, batch):
        x0, noise, t = batch["image"], batch["noise"], batch["t"]
        dev = x0.device
        if dev not in schedules:
            schedules[dev] = ddpm_alpha_bars(num_diffusion_steps, device=dev)
        ab = schedules[dev][t.long()][:, None, None, None]
        noise32 = noise.float()
        x_t = torch.sqrt(ab) * x0.float() + torch.sqrt(1.0 - ab) * noise32
        pred = model(x_t, t)
        return torch.mean((pred - noise32) ** 2)

    _refuse_seq(mesh, "diffusion")
    return make_train_step(loss_fn, mesh=mesh)


def make_lm_train_step(remat: bool = True, grad_accum: int = 1,
                       precision=None, chunk: int = DEFAULT_CHUNK,
                       moe_aux_weight: float = 0.01, mesh=None):
    """Next-token-prediction step for ``Llama`` (MoE included) and
    ``GPT2``; ``step(state, {"input_ids": ids}) -> (state, loss)``.

    - ``remat`` recomputes each block's activations in the backward
      (``torch.utils.checkpoint`` per block; the JAX step checkpoints the
      whole forward: the same numbers, other memory).
    - ``grad_accum=k`` takes ``input_ids`` of shape ``[k, batch, seq]`` and
      averages the gradients and losses of the ``k`` microbatches before
      one update.
    - ``precision`` (a ``PrecisionPolicy``) casts the fp32 masters to the
      compute dtype inside the loss and applies/undoes its loss scale; the
      gradients and the loss come back unscaled fp32.
    - ``chunk``: the vocab chunk of the cross-entropy. When the vocab is
      wider than ``chunk`` the model returns its pre-head hidden states and
      the lm-head product is folded into the chunked loss (the ``[b, s,
      vocab]`` logits never exist); otherwise the logits path runs. The
      head is ``Llama``'s ``lm_head`` or GPT-2's tied ``wte``.
    - ``moe_aux_weight``: the weight of an MoE model's load-balancing
      loss (``Llama.moe_aux``, its blocks' sum) in the loss, on both
      paths; dense models have none.
    - ``mesh``: a pure data mesh reduces the gradients across its ranks
      (the module's docstring); each rank's ``input_ids`` are its rows.
      On a seq axis they are the rows whole, and each rank runs its
      shard of their tokens (:func:`seq_shard`).

    The batch runs where the model's parameters lie."""
    ctx = _MeshContext(mesh, grad_accum)

    def _loss(model, ids, params=None):
        if params is None:
            params = dict(model.named_parameters())
        if precision is not None:
            # on the parameters at their global shapes: a sharded model's
            # gathered fp32 masters are cast here, after the gather
            params = precision.cast_params(params)
        head_w = lm_head_weight(params)
        mp = getattr(model, "mp", None)
        targets = None
        if mp is not None and mp.sp > 1:
            ids, targets, weight = seq_shard(ids, mp.sp, mp.sp_rank)
        # this tensor rank's head rows: the vocab-parallel loss
        split = (mp is not None and mp.t > 1
                 and head_w.shape[0] != model.cfg.vocab_size)
        if split or head_w.shape[0] > chunk:
            hidden = torch.func.functional_call(
                model, params, (ids,), {"return_hidden": True,
                                        "remat": remat})
            loss = linear_lm_loss(hidden, head_w, ids, chunk,
                                  mp.tensor if split else None,
                                  mp.t_rank if split else 0, targets)
        else:
            logits = torch.func.functional_call(model, params, (ids,),
                                                {"remat": remat})
            loss = lm_loss(logits, ids, chunk, targets)
        if targets is not None:
            loss = loss * weight
        aux = getattr(model, "moe_aux", None)
        if aux is not None:
            model.moe_aux = None
            loss = loss + moe_aux_weight * aux
        if precision is not None:
            loss = precision.scale_loss(loss)
        return loss

    def step(state: TrainState, batch: dict):
        model, opt = state.model, state.optimizer
        ids = batch["input_ids"].to(next(model.parameters()).device)
        opt.zero_grad()
        if grad_accum > 1 and (ids.ndim != 3 or ids.shape[0] != grad_accum):
            raise ValueError(
                f"grad_accum={grad_accum} takes input_ids [k, batch, "
                f"seq] with k = {grad_accum}; got {tuple(ids.shape)}")
        plan = ctx.plan(state)
        if plan is not None:
            loss = _mesh_loss(plan, model,
                              lambda params, x: _loss(model, x, params), ids,
                              grad_accum)
        elif grad_accum <= 1:
            loss = _loss(model, ids)
            loss.backward()
            loss = loss.detach()
        else:
            loss = _accumulate(model, (_loss(model, micro)
                                       for micro in ids), grad_accum)
        if precision is not None:
            precision.unscale([p.grad for p in model.parameters()
                               if p.grad is not None])
            loss = precision.unscale(loss)
        opt.step()
        state.step += 1
        return state, loss

    return step


class StepTelemetry:
    """Per-step training telemetry into an obs registry: the reference's
    ``StepTelemetry`` (``move2kube_tpu/models/train.py``), same families,
    labels and help text.

    The loop calls :meth:`record_step` with host-measured wall time; it
    folds it into a step-time histogram, throughput/loss/grad-norm gauges,
    the MFU gauge once :meth:`record_cost_model` has run, and (every
    ``mem_every`` steps) the device-memory gauge. A ``state`` passed at a
    sync point adds the grad norm, the tensor-health gauges and the
    non-finite forensics (``<flight>.numerics``, the watchdog's edge
    trigger). The reference's budget is at most 3 % of step time. The
    port's, with the optimizer's health recorder, is over it: 547.6
    against 501.6 ms a step, 9.17 %, on the training slice of
    ``chip_smoke.py``'s ``obs_train_phase`` (Llama-8B widths, 8 layers,
    batch 4 x 2048, bf16 policy; NVIDIA H100 80GB HBM3, 700.00 W), 41.4
    ms of it the recorder's five passes over 2.0 B gradients and 2.0 B
    parameters (ROADMAP.md Queue 2)."""

    def __init__(self, registry=None, items_per_step: int = 0,
                 unit: str = "tokens", mem_every: int = 10, tracer=None):
        from move2kube_tpu_torch.obs import tracing
        from move2kube_tpu_torch.obs.metrics import default_registry
        reg = registry if registry is not None else default_registry()
        self.registry = reg
        # per-step spans into the trace ring, recorded from the step's own
        # clock readings. None -> the process tracer when M2KT_TRACE is
        # on; False -> off
        if tracer is None:
            tracer = tracing.get() if tracing.enabled() else None
        self.tracer = tracer or None
        self.items_per_step = items_per_step
        self.mem_every = max(1, mem_every)
        self._step_hist = reg.histogram(
            "m2kt_train_step_seconds", "Train step wall time",
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1.0, 2.5, 5.0, 10.0, 30.0))
        self._steps = reg.counter(
            "m2kt_train_steps_total", "Optimizer steps completed")
        self._throughput = reg.gauge(
            f"m2kt_train_{unit}_per_second",
            f"Training throughput ({unit}/s, most recent step)")
        self._loss = reg.gauge("m2kt_train_loss", "Most recent step loss")
        self._grad_norm = reg.gauge(
            "m2kt_train_grad_norm", "Global gradient norm (last update)")
        self._step_gauge = reg.gauge(
            "m2kt_train_step", "Current step number")
        # the reference's family and help text, so its dashboards read
        # the port's; here the value is torch.cuda.memory_allocated()
        self._device_bytes = reg.gauge(
            "m2kt_train_device_live_bytes",
            "Bytes held by live jax arrays on this host's devices")
        # the port compiles nothing, so its loops record no compile event
        # and these stay at 0
        self._compiles = reg.counter(
            "m2kt_train_compile_events_total",
            "Compile events observed by the training loop")
        self._compile_seconds = reg.counter(
            "m2kt_train_compile_seconds_total",
            "Wall seconds spent in observed compile events")
        # tensor-health gauges, groups x {grad, param}, bounded by the
        # max_series overflow contract the tenant families use
        self._numerics_on = numericslib.enabled()
        cap = 2 * numericslib.max_groups()
        self._tensor_rms = reg.gauge(
            "m2kt_train_tensor_rms",
            "Per-layer-group rms over finite entries",
            labels=("group", "kind"), max_series=cap + 1)
        self._tensor_max_abs = reg.gauge(
            "m2kt_train_tensor_max_abs",
            "Per-layer-group max |x| (Inf shows as Inf)",
            labels=("group", "kind"), max_series=cap + 1)
        self._tensor_nonfinite = reg.gauge(
            "m2kt_train_tensor_nonfinite",
            "Per-layer-group non-finite entry count (last recorded step)",
            labels=("group", "kind"), max_series=cap + 1)
        self._nonfinite_steps = reg.counter(
            "m2kt_train_nonfinite_steps_total",
            "Recorded steps carrying a non-finite gradient, parameter, "
            "or loss")
        self._skipped_steps = reg.counter(
            "m2kt_train_skipped_steps_total",
            "Updates apply_if_finite skipped over non-finite (scaled) "
            "gradients")
        self._loss_scale_gauge = reg.gauge(
            "m2kt_train_loss_scale",
            "Active loss scale (0 = no scaling)")
        self._group_names: list[str] | None = None
        self._skipped_seen = 0
        self._last_bad_group: str | None = None
        # filled by record_cost_model; record_step then keeps the MFU
        # gauge live from measured wall times
        self._cost_report = None
        self._chip_spec = None
        # optional anomaly watchdog (obs/bridge.DiagWatchdog), assigned
        # by the loop: sync-point step times feed its regression baseline
        # and a non-finite step edge-triggers a capture
        self.watchdog = None

    def record_cost_model(self, step_fn, *args,
                          accelerator: str = "") -> None:
        """Count one step of ``step_fn(*args)`` with the cost model
        (:func:`~move2kube_tpu_torch.obs.costmodel.analyze_step_fn`: it
        runs the step with the optimizer held, so the state comes out as
        it went in) and export the train cost gauges; later
        :meth:`record_step` calls derive the MFU from it. Call once after
        the first step. Best-effort: a failure leaves the gauges absent,
        never raises."""
        from move2kube_tpu_torch.obs import costmodel
        try:
            report = costmodel.analyze_step_fn(step_fn, *args)
        except Exception:  # noqa: BLE001 - accounting must never kill a run
            report = None
        if report is None:
            return
        self._cost_report = report
        self._chip_spec, _ = costmodel.chip_spec(accelerator)
        costmodel.export_train_gauges(
            report, self.registry, accelerator=accelerator)

    def record_compile(self, seconds: float) -> None:
        self._compiles.inc()
        self._compile_seconds.inc(max(0.0, seconds))
        if self.tracer is not None:
            now = time.perf_counter()
            self.tracer.record("train.compile", now - max(0.0, seconds), now)

    def record_step(self, step: int, seconds: float, loss=None,
                    state=None, items: int | None = None) -> None:
        if self.tracer is not None:
            now = time.perf_counter()
            attrs = {"step": step}
            if loss is not None:
                try:
                    attrs["loss"] = float(loss)
                except (TypeError, ValueError):
                    pass
            self.tracer.record("train.step", now - max(0.0, seconds), now,
                               attrs=attrs)
        self._step_hist.observe(seconds)
        self._steps.inc()
        self._step_gauge.set(step)
        n = self.items_per_step if items is None else items
        if n and seconds > 0:
            self._throughput.set(n / seconds)
        if loss is not None:
            try:
                self._loss.set(float(loss))
            except (TypeError, ValueError):
                pass
        if state is not None:
            norm = grad_norm_from_state(state)
            if norm is not None:
                self._grad_norm.set(norm)
            if self._numerics_on:
                try:
                    self._record_numerics(step, state, loss)
                except Exception:  # noqa: BLE001 - never kill a run
                    pass
            if self.watchdog is not None:
                # sync points only: unsynced steps record dispatch time,
                # which would poison the regression baseline
                try:
                    self.watchdog.observe_step(seconds)
                except Exception:  # noqa: BLE001 - never kill a run
                    pass
        if (self._cost_report is not None and self._chip_spec is not None
                and seconds > 0):
            mfu = self._cost_report.mfu(seconds, self._chip_spec)
            if mfu is not None:
                self.registry.gauge(
                    "m2kt_train_mfu",
                    "Achieved model-FLOP utilization per chip "
                    "(0 = unknown)").set(mfu)
        if step % self.mem_every == 0:
            self.record_device_memory()

    def record_precision(self, policy) -> None:
        """Export the precision policy's loss scale; call once at loop
        start. The skipped-step counter then tracks what the guard does
        with it."""
        try:
            self._loss_scale_gauge.set(float(policy.loss_scale))
        except (AttributeError, TypeError, ValueError):
            pass

    def _record_numerics(self, step: int, state, loss) -> None:
        """Tensor-health read-back at a sync point: six small vectors
        cross to the host, the gauges update per group, and a non-finite
        step dumps the ``<flight>.numerics`` sidecar naming the first bad
        layer group."""
        from move2kube_tpu_torch.models import precision as precisionlib
        health = numericslib.health_from_state(state)
        if health is None:
            return
        if self._group_names is None:
            opt = getattr(state, "optimizer", state)
            self._group_names = (getattr(opt, "health_names", None)
                                 or numericslib.group_index(state.model)[0])
        doc = numericslib.summary(self._group_names, health)
        for group, fields in doc.items():
            for kind in ("grad", "param"):
                self._tensor_rms.labels(group, kind).set(
                    fields[f"{kind}_rms"])
                self._tensor_max_abs.labels(group, kind).set(
                    fields[f"{kind}_max_abs"])
                self._tensor_nonfinite.labels(group, kind).set(
                    fields[f"{kind}_nonfinite"])
        skipped = precisionlib.skipped_updates(state)
        if skipped is not None and skipped > self._skipped_seen:
            self._skipped_steps.inc(skipped - self._skipped_seen)
            self._skipped_seen = skipped
        loss_bad = False
        if loss is not None:
            try:
                loss_bad = not math.isfinite(float(loss))
            except (TypeError, ValueError):
                loss_bad = False
        bad = numericslib.first_bad_group(doc)
        if bad is None and not loss_bad:
            self._last_bad_group = None
            return
        self._nonfinite_steps.inc()
        self._last_bad_group = bad or "loss"
        if self.watchdog is not None:
            try:
                self.watchdog.note_nonfinite()
            except Exception:  # noqa: BLE001 - never kill a run
                pass
        if self.tracer is not None:
            now = time.perf_counter()
            self.tracer.record("train.numerics.nonfinite", now, now,
                               attrs={"step": step,
                                      "group": self._last_bad_group})
        numericslib.write_sidecar({
            "step": step,
            "first_bad_group": self._last_bad_group,
            "loss_nonfinite": loss_bad,
            "skipped_updates": skipped or 0,
            "groups": doc,
        })

    def record_device_memory(self) -> None:
        """``torch.cuda.memory_allocated()`` on the card; without one the
        gauge reads 0."""
        on_card = torch.cuda.is_available() and torch.cuda.is_initialized()
        self._device_bytes.set(torch.cuda.memory_allocated() if on_card
                               else 0)

    def timed_step(self, step: int, step_fn, state, batch, sync: bool = False):
        """Run one step under timing. ``sync`` waits for the device (true
        step time, used at logging boundaries) and passes the loss and the
        state to :meth:`record_step`; unsynced steps measure the host's
        dispatch time."""
        t0 = time.perf_counter()
        new_state, loss = step_fn(state, batch)
        if sync and loss.is_cuda:
            torch.cuda.synchronize(loss.device)
        self.record_step(step, time.perf_counter() - t0,
                         loss=float(loss) if sync else None,
                         state=new_state if sync else None)
        return new_state, loss
