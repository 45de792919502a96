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

Not ported here: the mesh paths (overlapped accumulation, FSDP prefetch;
ROADMAP.md Queue 1 item 9), the tensor-health recorder and
``StepTelemetry`` (Queue 1 item 7). ``scan_steps`` (k optimizer steps in
one compiled call) has no counterpart on one card: the caller runs the
step k times. Each step updates the state in place and returns it.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

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


def lm_loss(logits, input_ids, chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Next-token-prediction loss on logits ``[b, s, vocab]``: the chunked
    CE when the vocab spans more than one ``chunk`` (the JAX ladder's
    ``auto``), the reference otherwise."""
    logits, labels = logits[:, :-1], input_ids[:, 1:]
    if logits.shape[-1] > chunk:
        return fused_cross_entropy(logits, labels, chunk)
    return cross_entropy_loss(logits, labels)


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
    - the grad-norm record (:func:`instrument_optimizer`): the global norm
      of the gradients as handed to :meth:`step` (unscaled), taken before
      the guard, so a skipped update is recorded too.
    """

    def __init__(self, inner: torch.optim.Optimizer) -> None:
        self.inner = inner
        self.schedule = None  # set by default_optimizer
        self.count = 0
        self.guard = None
        self.record_grad_norm = False
        self.grad_norm: torch.Tensor | None = None

    def params(self) -> list:
        return [p for g in self.inner.param_groups for p in g["params"]]

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def step(self) -> bool:
        """Apply the update held in the parameters' ``.grad``; returns
        False when the guard rejected it."""
        grads = [p.grad for p in self.params() if p.grad is not None]
        if self.record_grad_norm:
            self.grad_norm = global_norm(grads)
        if self.guard is not None and not self.guard.admit(grads):
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
    ``grad_norm_recorder``, chained in front of any ``apply_if_finite``);
    read it with :func:`grad_norm_from_state`. The JAX function also
    chains the tensor-health recorder, which is not ported yet (ROADMAP.md
    Queue 1 item 7)."""
    opt.record_grad_norm = True
    return opt


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

    @property
    def batch_stats(self) -> dict | None:
        """The model's BatchNorm running statistics (its buffers, by
        name; the JAX ``TrainState.batch_stats``), None when it has
        none."""
        stats = dict(self.model.named_buffers())
        return stats or None


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


def _family_step(loss_fn, grad_accum: int = 1):
    """A step around ``loss_fn(model, batch) -> loss`` (batch tensors on
    the model's device): zero the grads, backward (over ``grad_accum``
    microbatches stacked on each tensor's leading axis when > 1),
    update."""

    def step(state: TrainState, batch: dict):
        model, opt = state.model, state.optimizer
        dev = next(model.parameters()).device
        batch = {k: v.to(dev) for k, v in batch.items()}
        opt.zero_grad()
        if grad_accum <= 1:
            loss = loss_fn(model, batch)
            loss.backward()
            loss = loss.detach()
        else:
            lead = {v.shape[0] for v in batch.values()}
            if lead != {grad_accum}:
                raise ValueError(f"grad_accum={grad_accum} takes batch "
                                 f"tensors [{grad_accum}, ...]; got leading "
                                 f"extents {sorted(lead)}")
            micro = ({k: v[i] for k, v in batch.items()}
                     for i in range(grad_accum))
            loss = _accumulate(model, (loss_fn(model, b) for b in micro),
                               grad_accum)
        opt.step()
        state.step += 1
        return state, loss

    return step


def make_classifier_train_step(has_batch_stats: bool = False,
                               grad_accum: int = 1):
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
    step threads them through its scan."""

    def loss_fn(model, batch):
        if has_batch_stats:
            model.train()
        elif next(model.buffers(), None) is not None:
            raise ValueError("the model carries BatchNorm statistics; "
                             "pass has_batch_stats=True")
        return cross_entropy_loss(model(batch["input"]), batch["label"])

    return _family_step(loss_fn, grad_accum)


def make_bert_train_step():
    """Fine-tune step for ``BertEncoder``; ``step(state, {"input_ids",
    "attention_mask" (optional), "label"}) -> (state, loss)``."""

    def loss_fn(model, batch):
        logits = model(batch["input_ids"], batch.get("attention_mask"))
        return cross_entropy_loss(logits, batch["label"])

    return _family_step(loss_fn)


def make_diffusion_train_step(num_diffusion_steps: int = 1000):
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

    return _family_step(loss_fn)


def make_lm_train_step(remat: bool = True, grad_accum: int = 1,
                       precision=None, chunk: int = DEFAULT_CHUNK,
                       moe_aux_weight: float = 0.01):
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

    The batch runs where the model's parameters lie."""

    def _loss(model, ids):
        params = dict(model.named_parameters())
        if precision is not None:
            params = precision.cast_params(params)
        head_w = lm_head_weight(params)
        if head_w.shape[0] > chunk:
            hidden = torch.func.functional_call(
                model, params, (ids,), {"return_hidden": True,
                                        "remat": remat})
            loss = linear_lm_loss(hidden, head_w, ids, chunk)
        else:
            logits = torch.func.functional_call(model, params, (ids,),
                                                {"remat": remat})
            loss = lm_loss(logits, ids, chunk)
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
        if grad_accum <= 1:
            loss = _loss(model, ids)
            loss.backward()
            loss = loss.detach()
        else:
            if ids.ndim != 3 or ids.shape[0] != grad_accum:
                raise ValueError(
                    f"grad_accum={grad_accum} takes input_ids [k, batch, "
                    f"seq] with k = {grad_accum}; got {tuple(ids.shape)}")
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
