"""Per-card memory budget of a training run: the port of
``move2kube_tpu/parallel/memory.py``.

Answers "does this run fit?" from shapes alone: the parameter, gradient
and optimizer bytes come from the model built on ``torch.device("meta")``
(:func:`~move2kube_tpu_torch.models.convert.meta_model`, in place of
``jax.eval_shape``) and the reference's sharding heuristic applied to each
parameter under its flax name and shape
(:func:`~move2kube_tpu_torch.models.convert.flax_params`,
:func:`~move2kube_tpu_torch.parallel.sharding.infer_param_axes`); the
activations from the remat model of the LM step (per-layer checkpoint
boundaries plus the fp32 logits block).

``HBM_BYTES`` keeps the reference's TPU rows, and adds the H100's from
the port's cost model (:data:`~move2kube_tpu_torch.obs.costmodel.
CHIP_SPECS`), so the card's capacity is one number in one place.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

from move2kube_tpu_torch.obs.costmodel import CHIP_SPECS, DEFAULT_CHIP
from move2kube_tpu_torch.obs.costmodel import (
    normalize_accelerator as _normalize_card,
)
from move2kube_tpu_torch.parallel.sharding import (
    ShardingRules,
    infer_param_axes,
)

logger = logging.getLogger(__name__)

HBM_BYTES = {
    "tpu-v5-lite-podslice": 16e9,
    "tpu-v5p-slice": 95e9,
    "tpu-v4-podslice": 32e9,
    "tpu-v6e-slice": 32e9,
    DEFAULT_CHIP: CHIP_SPECS[DEFAULT_CHIP].hbm_bytes,
}

# the reference's TPU aliases (its obs/costmodel.py), matched on the
# lowercased string with separators stripped
_TPU_ALIASES = {
    "v4": "tpu-v4-podslice",
    "tpuv4": "tpu-v4-podslice",
    "v5e": "tpu-v5-lite-podslice",
    "v5lite": "tpu-v5-lite-podslice",
    "v5litepod": "tpu-v5-lite-podslice",
    "tpuv5e": "tpu-v5-lite-podslice",
    "tpuv5lite": "tpu-v5-lite-podslice",
    "tpuv5litedevice": "tpu-v5-lite-podslice",
    "v5p": "tpu-v5p-slice",
    "tpuv5p": "tpu-v5p-slice",
    "v6e": "tpu-v6e-slice",
    "tpuv6e": "tpu-v6e-slice",
    "trillium": "tpu-v6e-slice",
}


def _normalize_tpu(accelerator: str) -> str | None:
    raw = str(accelerator or "").strip().lower()
    if not raw:
        return None
    if raw in HBM_BYTES:
        return raw
    squashed = "".join(c for c in raw if c.isalnum())
    base = squashed.rstrip("0123456789")
    for key in (squashed, base):
        if key in _TPU_ALIASES:
            return _TPU_ALIASES[key]
    for key, canon in _TPU_ALIASES.items():
        if key in squashed and len(key) >= 3:
            return canon
    return None


def hbm_budget_bytes(accelerator: str) -> float:
    """Device memory for an accelerator string: an H100 name (the card's
    ``torch.cuda.get_device_name``, a GKE label) or any alias the
    reference accepts ("v5e", "v5litepod-8", "TPU v5p"); an unknown
    string budgets like the smallest row, with a logged warning."""
    if accelerator in HBM_BYTES:
        return HBM_BYTES[accelerator]
    canon = _normalize_card(accelerator) or _normalize_tpu(accelerator)
    if canon in HBM_BYTES:
        return HBM_BYTES[canon]
    fallback = min(HBM_BYTES.values())
    logger.warning(
        "unknown accelerator %r: assuming conservative %d GB HBM budget",
        accelerator, int(fallback / 1e9))
    return fallback


@dataclass
class MemoryPlan:
    """Byte budget per card; ``total`` is the sum the fit check gates
    on."""

    params: int = 0
    grads: int = 0
    opt_state: int = 0
    activations: int = 0
    # largest single leaves: (flax path, bytes/card)
    breakdown: list = field(default_factory=list)

    @property
    def total(self) -> int:
        return self.params + self.grads + self.opt_state + self.activations

    def fits(self, accelerator: str, headroom: float = 0.9) -> bool:
        """True when ``total`` fits ``headroom`` of the device memory."""
        return self.total <= hbm_budget_bytes(accelerator) * headroom


def _sharded_bytes(shape, itemsize: int, spec, extents: dict) -> int:
    """Bytes per card of one leaf of ``shape`` under ``spec``: a dim whose
    size its mesh extent does not divide stays whole (replicated)."""
    shape = list(shape)
    for dim, entry in enumerate(spec):
        names = (entry,) if isinstance(entry, str) else (entry or ())
        extent = 1
        for nm in names:
            extent *= extents.get(nm, 1)
        if extent > 1 and shape[dim] % extent == 0:
            shape[dim] //= extent
    n = 1
    for d in shape:
        n *= d
    return n * itemsize


def train_memory_plan(
    model,
    mesh_extents: dict,
    *,
    rules: ShardingRules | None = None,
    optimizer_slots: int = 2,  # adam/adamw: m + v
    seq_len: int | None = None,
    batch_per_chip: int = 1,
    d_model: int | None = None,
    num_layers: int | None = None,
    vocab_size: int | None = None,
    activation_dtype_bytes: int = 2,  # bf16 activations
    top_n: int = 5,
) -> MemoryPlan:
    """Shape-level per-card memory plan of a remat LM train step.

    ``model`` is a port model (``cfg`` attached), on any device; build it
    on the meta device (:func:`~move2kube_tpu_torch.models.convert.
    meta_model`) to plan a size the host could not hold. Each parameter
    counts at its own dtype (fp32 masters in training), sharded by the
    reference's rules under its flax name; grads mirror params, and each
    of ``optimizer_slots`` moments is one more copy. With ``seq_len``,
    ``d_model`` and ``num_layers`` the activations are the per-layer
    boundaries (``num_layers * batch * seq * d_model`` at
    ``activation_dtype_bytes``) plus, with ``vocab_size``, twice the fp32
    logits block (the logits and their cotangent). On a seq axis a rank
    holds ``s / seq`` tokens of its rows: pass that as ``seq_len`` (the
    emitted trainer does)."""
    from move2kube_tpu_torch.models.convert import flax_params

    rules = rules or ShardingRules.default()
    named = flax_params(model)
    itemsize = {n: p.element_size() for n, p in model.named_parameters()}
    shapes = {path: shape for path, shape in named.values()}
    axes = infer_param_axes(shapes)
    plan = MemoryPlan()
    leaves: list[tuple[str, int]] = []
    # flax's tree order: dict keys sorted at every level
    for name, (path, shape) in sorted(named.items(),
                                      key=lambda kv: kv[1][0].split("/")):
        nbytes = _sharded_bytes(shape, itemsize[name], rules.spec(axes[path]),
                                mesh_extents)
        leaves.append((path, nbytes))
        plan.params += nbytes
    plan.grads = plan.params
    plan.opt_state = optimizer_slots * plan.params

    if seq_len and d_model and num_layers:
        boundary = (num_layers * batch_per_chip * seq_len * d_model
                    * activation_dtype_bytes)
        transient = 0
        if vocab_size:
            transient = 2 * 4 * batch_per_chip * seq_len * vocab_size
        plan.activations = boundary + transient

    plan.breakdown = sorted(leaves, key=lambda t: -t[1])[:top_n]
    return plan
