"""Tensor-health plane: per-layer-group numerics telemetry and non-finite
forensics, the port's own copy of ``move2kube_tpu/obs/numerics.py``.

- :func:`summarize_tree` computes per-layer-group summaries of a model's
  tensors (rms over the finite entries, max |x| with any non-finite entry
  counted as +Inf, the non-finite count) with plain torch reductions on
  the tensors' device; only ``O(groups)`` scalars ever cross to the host,
  at sync points (:func:`summary`).
- The port's ``Optimizer`` (``models/train.py``) records the gradients'
  and the parameters' summaries into a :class:`TensorHealthState` each
  update once instrumented (the reference's ``health_recorder``, an optax
  transform); ``StepTelemetry`` reads them back into the
  ``m2kt_train_tensor_*`` gauges.
- On a NaN/Inf step, :func:`first_bad_group` names the first bad layer
  group in tree order and :func:`write_sidecar` dumps the
  ``<flight>.numerics`` JSON the supervisor folds into
  ``m2kt-flight.json``.

Groups are the flax tree's top-level names (``embed``, ``layer_0``, ...,
``lm_head`` for Llama; ``h_0``, ... for GPT-2), taken from the table
``models/convert.py`` maps the JAX package's trees with, and ordered as
``jax.tree_util`` flattens that tree: by sorted name, so ``layer_10``
comes before ``layer_2``. torch is imported only inside the functions
that need it.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, NamedTuple

_OFF = ("0", "false", "off", "no")

# gauge fields exported per layer group, in TensorHealthState order
HEALTH_FIELDS = ("grad_rms", "grad_max_abs", "grad_nonfinite",
                 "param_rms", "param_max_abs", "param_nonfinite")


def enabled(env=None) -> bool:
    """``M2KT_NUMERICS`` gates the tensor-health plane (default on)."""
    env = os.environ if env is None else env
    return str(env.get("M2KT_NUMERICS", "1")).strip().lower() not in _OFF


def max_groups(env=None) -> int:
    """Label-cardinality cap for the per-group gauges
    (``M2KT_NUMERICS_MAX_GROUPS``, default 16); groups beyond it collapse
    into the registry's shared overflow series."""
    env = os.environ if env is None else env
    try:
        return max(1, int(env.get("M2KT_NUMERICS_MAX_GROUPS", "") or 16))
    except ValueError:
        return 16


def audit_rate(env=None) -> float:
    """Serving quant-drift audit rate (``M2KT_QUANT_AUDIT_RATE``):
    fraction of cold admissions re-run through the fp reference path.
    0 (the default) disables the auditor and keeps no fp weight copy."""
    env = os.environ if env is None else env
    try:
        rate = float(env.get("M2KT_QUANT_AUDIT_RATE", "") or 0.0)
    except ValueError:
        return 0.0
    return min(1.0, max(0.0, rate))


class TensorHealthState(NamedTuple):
    """What the health recorder writes each update: per-group vectors
    (shape ``[num_groups]``, on the parameters' device) in
    :func:`group_index` order; rms and max |x| fp32, counts int32."""

    grad_rms: Any
    grad_max_abs: Any
    grad_nonfinite: Any
    param_rms: Any
    param_max_abs: Any
    param_nonfinite: Any


def _named_leaves(tree) -> list:
    """``[(name, tensor)]`` of an ``nn.Module``'s parameters or of a
    mapping of names to tensors, in its own order."""
    named = getattr(tree, "named_parameters", None)
    if callable(named):
        return list(named())
    return list(tree.items())


def group_index(tree, cfg=None) -> tuple[list[str], list[int]]:
    """Static grouping of a model's parameters (``tree``: an ``nn.Module``,
    or a mapping of the port's parameter names to tensors) by the flax
    tree's top-level name of each (``models/convert.py`` ``flax_group``
    under ``cfg``, by default the module's own ``cfg``; without a config
    a name's first component). Returns ``(group names, per-leaf group
    index)``: the names in the reference's tree-flatten order (sorted),
    the indices in ``tree``'s own leaf order."""
    from move2kube_tpu_torch.models.convert import flax_group

    cfg = cfg if cfg is not None else getattr(tree, "cfg", None)
    groups = [flax_group(cfg, name) if cfg is not None
              else name.partition(".")[0]
              for name, _ in _named_leaves(tree)]
    names = sorted(set(groups))
    index = {g: i for i, g in enumerate(names)}
    return names, [index[g] for g in groups]


def summarize_tree(tree, leaf_groups=None, num_groups=None):
    """Per-group ``(rms, max_abs, nonfinite)`` of a tree's floating
    tensors (``tree`` as :func:`group_index` takes it, or a list of
    tensors with ``leaf_groups`` given), each a ``[num_groups]`` tensor on
    the tensors' device. ``rms`` is over the *finite* entries (divided by
    the group's whole size, as the reference divides); ``max_abs`` is +Inf
    where any entry is non-finite; integer leaves are skipped. Each leaf
    is reduced on its own and the partial sums folded per group, so no
    group is ever concatenated into one copy. Nothing reads back to the
    host."""
    import torch

    if leaf_groups is None or num_groups is None:
        names, leaf_groups = group_index(tree)
        num_groups = len(names)
    leaves = (list(tree) if isinstance(tree, (list, tuple))
              else [t for _, t in _named_leaves(tree)])
    n = max(1, int(num_groups))
    parts: list[list] = [[] for _ in range(n)]
    device = None
    for g, leaf in zip(leaf_groups, leaves):
        if leaf is None or not torch.is_floating_point(leaf):
            continue
        x = leaf.detach()
        device = x.device
        if not x.numel():
            continue
        # x * 0 is NaN exactly where x is not finite; its non-zeros are
        # counted by float reductions, several times faster on the card
        # than isfinite (four kernels) and the sum of a bool mask
        bad = _count_nonzero(torch.mul(x, 0).reshape(-1))
        # in fp32, as the reference reduces; a dot product, which sums
        # more exactly than vector_norm (7e-6 relative off float64 on a
        # 256 x 384 leaf, against 2e-8)
        safe = torch.nan_to_num(x, nan=0.0, posinf=0.0,
                                neginf=0.0).to(torch.float32).reshape(-1)
        sumsq = torch.dot(safe, safe)
        # any non-finite entry makes the group's max +Inf below
        top = torch.linalg.vector_norm(x, ord=float("inf")).float()
        parts[g].append((sumsq, top, bad, x.numel()))
    device = device if device is not None else torch.device("cpu")
    zero = torch.zeros((), dtype=torch.float32, device=device)
    rms, max_abs, nonfinite = [], [], []
    for group in parts:
        if not group:
            rms.append(zero)
            max_abs.append(zero)
            nonfinite.append(zero.to(torch.int32))
            continue
        sumsq, top, bad, size = zip(*group)
        count = torch.cat(list(bad)).sum().to(torch.int32)
        rms.append(torch.sqrt(torch.stack(list(sumsq)).sum() / sum(size)))
        max_abs.append(torch.where(count > 0, float("inf"),
                                   torch.stack(list(top)).amax()))
        nonfinite.append(count)
    return torch.stack(rms), torch.stack(max_abs), torch.stack(nonfinite)


# rows of a count: a float32 sum of ones is exact up to 2**24
_COUNT_ROW = 1 << 24


def _count_nonzero(flat):
    """The number of non-zero entries of a flat tensor (NaN counts), as a
    float64 vector whose sum is exact: ``vector_norm(ord=0)`` over rows
    of at most 2**24 entries."""
    import torch

    n = flat.numel()
    rows = n // _COUNT_ROW
    parts = []
    if rows:
        parts.append(torch.linalg.vector_norm(
            flat[:rows * _COUNT_ROW].view(rows, _COUNT_ROW), ord=0, dim=1))
    if n > rows * _COUNT_ROW:
        parts.append(torch.linalg.vector_norm(
            flat[rows * _COUNT_ROW:], ord=0).reshape(1))
    return torch.cat(parts).to(torch.float64)


def zero_state(num_groups: int, device=None) -> TensorHealthState:
    """A :class:`TensorHealthState` of zeros, ``[num_groups]`` each: what
    an instrumented optimizer holds before its first update, and keeps
    while recording is off."""
    import torch

    n = max(1, int(num_groups))
    return TensorHealthState(*(
        torch.zeros((n,), dtype=dt, device=device) for dt in (
            torch.float32, torch.float32, torch.int32,
            torch.float32, torch.float32, torch.int32)))


def health_recorder(opt):
    """Make the port's ``Optimizer`` (``models/train.py``) record the
    gradients' and the parameters' group summaries into its ``health``
    state each update, before any guard (the reference's optax
    ``health_recorder``, which ``instrument_optimizer`` chains outside
    ``apply_if_finite``). ``M2KT_NUMERICS`` off, the state keeps its
    shape and stays zero. Returns ``opt``."""
    opt.record_health = True
    opt.health_on = enabled()
    if opt.health_names is not None:
        opt._zero_health()
    return opt


def health_from_state(state) -> TensorHealthState | None:
    """Latest :class:`TensorHealthState` an instrumented optimizer
    recorded; ``state`` is a ``TrainState``, an ``Optimizer`` or the state
    itself. None when the optimizer was not instrumented."""
    if isinstance(state, TensorHealthState):
        return state
    opt = getattr(state, "optimizer", state)
    health = getattr(opt, "health", None)
    return health if isinstance(health, TensorHealthState) else None


def summary(names: list[str], state: TensorHealthState) -> dict:
    """Host-side ``{group: {field: float}}`` view of a health state: the
    plane's only device-to-host transfer, six ``[num_groups]`` vectors."""
    cols = [v.detach().cpu().tolist() for v in state]
    out: dict[str, dict[str, float]] = {}
    for i, name in enumerate(names):
        if i >= len(cols[0]):
            break
        out[name] = {field: float(col[i])
                     for field, col in zip(HEALTH_FIELDS, cols)}
    return out


def first_bad_group(summary_doc: dict) -> str | None:
    """First layer group (tree order) with a non-finite gradient or
    parameter entry, or None when the step is clean."""
    for name, fields in summary_doc.items():
        if fields["grad_nonfinite"] + fields["param_nonfinite"]:
            return name
    return None


def sidecar_path() -> str:
    """``<flight>.numerics``: rides next to the crash flight recorder so
    the supervisor can fold it into ``m2kt-flight.json``."""
    from move2kube_tpu_torch.obs import tracing

    return tracing.flight_path() + ".numerics"


def write_sidecar(doc: dict, path: str | None = None) -> str | None:
    """Atomically dump the forensics document. Best-effort: telemetry
    must never kill a training run over a full disk."""
    path = path or sidecar_path()
    try:
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(path) or ".", suffix=".numerics.tmp")
        with os.fdopen(fd, "w") as fh:
            json.dump(doc, fh, indent=2, default=str)
        os.replace(tmp, path)
        return path
    except OSError:
        return None


def read_sidecar(path: str | None = None) -> dict | None:
    path = path or sidecar_path()
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None
