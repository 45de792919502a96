"""Logical-axis sharding rules: the part of ``move2kube_tpu/parallel/
sharding.py`` that the memory plan reads.

:class:`ShardingRules` maps logical axis names (``embed``, ``mlp``,
``heads``, ``vocab``, ...) to mesh axes, and :func:`infer_param_axes` gives
each parameter its logical axes from its flax path and flax shape (the
port's names and shapes go through
:func:`~move2kube_tpu_torch.models.convert.flax_params` first, so a
``Linear`` weight is sharded along flax's ``kernel`` dims). Placing the
shards (``shard_params``) and the activation constraints come with FSDP
and tensor parallelism (ROADMAP Queue 1 items 9b and 9c); under pure data
parallelism every parameter is replicated.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class ShardingRules:
    """logical axis -> mesh axis (or None = replicated)."""

    rules: dict = field(default_factory=dict)

    @classmethod
    def default(cls) -> "ShardingRules":
        """The reference's FSDP + TP layout: batch over (data, fsdp),
        embed over fsdp, mlp/heads/vocab over tensor, length over seq."""
        return cls(rules={
            "batch": ("data", "fsdp"),
            "length": "seq",
            "embed": "fsdp",
            "mlp": "tensor",
            "heads": "tensor",
            "kv": None,
            "vocab": "tensor",
            "norm": None,
            "conv_kernel": None,
            "experts": "expert",
            "stage": "pipe",
        })

    def spec(self, logical_axes) -> tuple:
        """The mesh axis (or axes, or None) of each logical axis."""
        return tuple(self.rules.get(a) if a else None for a in logical_axes)


def infer_param_axes(shapes: dict, tp_layers: tuple = ()) -> dict:
    """Logical axes of each parameter, as the reference's heuristic gives
    them: ``shapes`` maps a flax path (``"layer_0/qkv/kernel"``) to its
    flax shape; the result maps it to a tuple of logical names (None =
    replicated). A tree whose 4-D (conv) kernels hold at least half the
    parameters is replicated whole."""
    conv_params = sum(math.prod(s) for s in shapes.values() if len(s) == 4)
    total_params = sum(math.prod(s or (1,)) for s in shapes.values()) or 1
    conv_family = conv_params * 2 >= total_params and conv_params > 0

    def axes_for(path: str, shape) -> tuple:
        nd = len(shape)
        if conv_family:
            return (None,) * nd
        joined = path.lower()
        if nd <= 1:
            return (None,) * nd
        if "embedding" in joined:
            return ("vocab", None) if nd == 2 else (None,) * nd
        if nd == 2:
            if any(t in joined for t in tp_layers) or any(
                t in joined for t in ("gate", "up_proj", "wi", "query",
                                      "key", "value", "qkv", "lm_head",
                                      "c_attn", "c_fc")):
                return ("embed", "mlp")
            if any(t in joined for t in ("down_proj", "wo", "out_proj",
                                         "attn_out", "mlp_out")):
                return ("mlp", "embed")
            return (None, "embed")
        if nd == 3:
            if "moe" in joined or "expert" in joined:
                if any(t in joined for t in ("w_out", "wo", "down")):
                    return ("experts", "mlp", "embed")
                return ("experts", "embed", "mlp")
            return ("embed", "heads", None)
        return (None,) * nd

    return {path: axes_for(path, shape) for path, shape in shapes.items()}
