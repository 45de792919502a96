"""Mixed-precision policy: bf16 compute, fp32 master weights. The port of
``move2kube_tpu/models/precision.py``.

Parameters and optimizer state live in fp32 (the master weights); the
loss runs on a compute-dtype view of them (:meth:`PrecisionPolicy.
cast_params`), so matmuls run in bf16 while the gradients land in fp32 on
the masters. bf16 shares fp32's exponent range and needs no loss scaling;
the ``bf16-scaled`` policy multiplies the loss by a constant and divides it
back out of the gradients, with :class:`FiniteGuard` (optax's
``apply_if_finite``) skipping an update whose gradients went non-finite.

Resolved from ``M2KT_PRECISION`` with ``M2KT_LOSS_SCALE`` as a numeric
override (:func:`from_env`), as the JAX trainer does.
"""

from __future__ import annotations

import dataclasses
import os

import torch

PRECISION_OPTIONS = ("bf16", "fp32", "bf16-scaled")


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    name: str = "bf16"
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32  # master weights + optimizer
    loss_scale: float = 0.0  # 0 = off (bf16 needs none)

    def cast_params(self, params: dict) -> dict:
        """Compute-dtype view of the fp32 master weights (a dict of
        name -> tensor; identity for fp32 policies). Every floating tensor
        is cast, norm scales and the lm-head included, as the JAX policy
        casts every float leaf; others pass through. The cast is
        differentiable: gradients flow back to the masters in fp32."""
        if self.compute_dtype == torch.float32:
            return params
        return {k: v.to(self.compute_dtype) if v.is_floating_point() else v
                for k, v in params.items()}

    def scale_loss(self, loss):
        return loss * self.loss_scale if self.loss_scale else loss

    def unscale(self, x):
        """Undo :meth:`scale_loss` on a loss (returns a new tensor) or, in
        place, on a list of gradient tensors (returns the list)."""
        if not self.loss_scale:
            return x
        inv = 1.0 / self.loss_scale
        if isinstance(x, torch.Tensor):
            return x * inv
        for g in x:
            g.mul_(inv)
        return x

    def wrap_optimizer(self, opt):
        """Skip (not crash on) non-finite updates when loss scaling is
        active: ``opt`` gets a :class:`FiniteGuard` with optax's
        ``apply_if_finite(max_consecutive_errors=10)`` semantics. Returns
        ``opt``."""
        if self.loss_scale:
            opt.guard = FiniteGuard(max_consecutive_errors=10)
        return opt

    def apply_to_model_config(self, cfg):
        """Return ``cfg`` with its ``dtype`` field set to the compute dtype
        (what a model built for inference in this policy holds); configs
        without a dtype field pass through. Training keeps fp32 masters
        (``dtype=torch.float32``) and casts them inside the loss."""
        if not dataclasses.is_dataclass(cfg) or "dtype" not in {
                f.name for f in dataclasses.fields(cfg)}:
            return cfg
        return dataclasses.replace(cfg, dtype=self.compute_dtype)


_POLICIES = {
    "bf16": PrecisionPolicy(),
    "fp32": PrecisionPolicy(name="fp32", compute_dtype=torch.float32),
    "bf16-scaled": PrecisionPolicy(name="bf16-scaled", loss_scale=1024.0),
}


def policy(name: str) -> PrecisionPolicy:
    try:
        return _POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown precision policy {name!r}; options: "
            f"{', '.join(PRECISION_OPTIONS)}") from None


def from_env(default: str = "bf16", env=None) -> PrecisionPolicy:
    """``M2KT_PRECISION`` names the policy; ``M2KT_LOSS_SCALE`` (float)
    overrides its loss scale. Unknown names fall back to ``default``
    rather than killing a training job over an env typo."""
    env = os.environ if env is None else env
    name = env.get("M2KT_PRECISION", "") or default
    try:
        pol = policy(name)
    except ValueError:
        pol = policy(default)
    raw_scale = env.get("M2KT_LOSS_SCALE", "")
    if raw_scale:
        try:
            pol = dataclasses.replace(pol, loss_scale=float(raw_scale))
        except ValueError:
            pass
    return pol


class FiniteGuard:
    """``optax.apply_if_finite(inner, max_consecutive_errors)`` for a torch
    optimizer: an update whose gradients hold a NaN or Inf is rejected, and
    the parameters and the inner optimizer's state (its step count
    included) stay as they were. After more than ``max_consecutive_errors``
    non-finite updates in a row the update is applied anyway: optax gives
    up, it does not raise."""

    def __init__(self, max_consecutive_errors: int) -> None:
        self.max_consecutive_errors = max_consecutive_errors
        self.notfinite_count = 0   # consecutive, reset by a finite update
        self.total_notfinite = 0
        self.last_finite = True

    def admit(self, grads, any_rank=None) -> bool:
        """Count this update's gradients; True when it is to be applied.
        Reads one flag back from the device. ``any_rank(flag) -> bool``:
        the group's verdict on a rank's flag, for gradients that are
        shards (every rank then skips or applies the update alike)."""
        finite = bool(torch.stack(
            [torch.isfinite(g).all() for g in grads]).all()) if grads else True
        if any_rank is not None:
            finite = not any_rank(not finite)
        self.last_finite = finite
        if finite:
            self.notfinite_count = 0
        else:
            self.notfinite_count += 1
            self.total_notfinite += 1
        return finite or self.notfinite_count > self.max_consecutive_errors


def _guard(state):
    opt = getattr(state, "optimizer", state)
    return getattr(opt, "guard", None)


def skipped_updates(state) -> int | None:
    """Cumulative updates the guard swallowed because the (scaled)
    gradients went non-finite; None when no guard is active. ``state`` is
    a ``TrainState`` or its optimizer."""
    guard = _guard(state)
    return guard.total_notfinite if guard is not None else None


def notfinite_streak(state) -> int | None:
    """Consecutive non-finite updates so far (reset by a finite one); past
    ``max_consecutive_errors`` the guard applies them anyway, so a climbing
    streak is the early warning. None when no guard is active."""
    guard = _guard(state)
    return guard.notfinite_count if guard is not None else None
