"""Logical-axis sharding rules and the placement of parameter shards:
the port of ``move2kube_tpu/parallel/sharding.py``.

:class:`ShardingRules` maps logical axis names (``embed``, ``mlp``,
``heads``, ``vocab``, ...) to mesh axes, and :func:`infer_param_axes` gives
each parameter its logical axes from its flax path and flax shape (the
port's names and shapes go through
:func:`~move2kube_tpu_torch.models.convert.flax_params` first, so a
``Linear`` weight is sharded along flax's ``kernel`` dims).

:func:`param_specs` turns those axes into a :class:`ParamSpec` a
parameter: the mesh axis of each *port* dimension (a ``Linear`` weight
``[out, in]`` is flax's ``kernel [in, out]`` transposed, so
``("embed", "mlp")`` shards the port's dimension 1 over fsdp, and
``("mlp", "embed")`` and ``(None, "embed")`` its dimension 0), with a
dimension whose extent does not divide its size replicated, as the
reference's ``_sharding_for`` prunes an uneven leaf. Embeddings are
``("vocab", None)``: they shard over ``tensor`` only and stay whole under
pure FSDP. :func:`shard_params` keeps on each rank its contiguous slice r
of each sharded dimension, the ``NamedSharding`` layout in which fsdp
rank r holds global slice r, and leaves a :class:`ShardLayout` on the
model (:func:`layout_of`) for the step, the optimizer and the checkpoint.
Only the fsdp axis places shards here; the activation constraints
(``with_logical_constraint``, ``maybe_shard``) come with tensor
parallelism (ROADMAP Queue 1 item 9c).
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


@dataclass(frozen=True)
class ParamSpec:
    """One parameter's placement: its flax ``path``, its global port
    ``shape`` and ``axes``, the mesh axis (a name, a tuple of names or
    None) of each port dimension after pruning."""

    path: str
    shape: tuple
    axes: tuple

    def dim_of(self, axis: str) -> int | None:
        """The port dimension sharded over mesh axis ``axis``, or None."""
        for dim, entry in enumerate(self.axes):
            names = entry if isinstance(entry, tuple) else (entry,)
            if axis in names:
                return dim
        return None


def logical_sharding(extents: dict, rules: ShardingRules, logical_axes,
                     shape) -> tuple:
    """The mesh axis of each dimension of a leaf of ``shape`` with
    ``logical_axes`` on a mesh of ``extents`` (axis -> size): an entry
    survives only where its extent is above 1 and divides the
    dimension."""
    pruned = []
    for dim, entry in enumerate(rules.spec(logical_axes)):
        names = (entry,) if isinstance(entry, str) else (entry or ())
        extent = 1
        for nm in names:
            extent *= extents.get(nm, 1)
        pruned.append(entry if extent > 1 and shape[dim] % extent == 0
                      else None)
    return tuple(pruned)


def param_specs(model, extents: dict, rules: ShardingRules | None = None,
                tp_layers: tuple = ()) -> dict:
    """``{port name: ParamSpec}`` for ``model`` (a port model at its
    global shapes, on any device, the meta device included) on a mesh of
    ``extents``, in ``named_parameters`` order."""
    from move2kube_tpu_torch.models.convert import flax_layout

    rules = rules or ShardingRules.default()
    layout = flax_layout(model)
    axes = infer_param_axes({path: shape for path, shape, _ in
                             layout.values()}, tp_layers)
    specs = {}
    for name, (path, shape, order) in layout.items():
        flax_axes = logical_sharding(extents, rules, axes[path], shape)
        port_axes = [None] * len(shape)
        for i, entry in enumerate(flax_axes):
            port_axes[order[i]] = entry
        port_shape = [0] * len(shape)
        for i, size in enumerate(shape):
            port_shape[order[i]] = size
        specs[name] = ParamSpec(path, tuple(port_shape), tuple(port_axes))
    return specs


def param_shardings(model, mesh, rules: ShardingRules | None = None) -> dict:
    """``{port name: ParamSpec}`` of ``model`` on a ``DeviceMesh`` made by
    :func:`~move2kube_tpu_torch.parallel.mesh.make_mesh`."""
    from move2kube_tpu_torch.parallel.mesh import MeshConfig, mesh_config_of

    cfg = mesh_config_of(mesh)
    return param_specs(model, dict(zip(MeshConfig.AXES, cfg.dims())), rules)


@dataclass
class ShardLayout:
    """Where a sharded model's parameters lie: ``specs`` (global shapes)
    and this rank's coordinate ``rank`` on the fsdp axis of extent
    ``n``. ``dims`` maps each parameter to its sharded port dimension
    (None: replicated on every rank)."""

    specs: dict
    n: int
    rank: int
    data_rank: int = 0
    dims: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.dims:
            self.dims = {name: spec.dim_of("fsdp")
                         for name, spec in self.specs.items()}

    def sharded(self) -> list:
        return [name for name, dim in self.dims.items() if dim is not None]

    def take(self, name: str, full):
        """This rank's slice of parameter ``name``'s global tensor
        ``full`` (``full`` itself for a replicated leaf)."""
        dim = self.dims.get(name)
        if dim is None:
            return full
        size = full.shape[dim] // self.n
        return full.narrow(dim, self.rank * size, size)

    def describe(self) -> dict:
        """The layout as ``meta.json`` keeps it: each leaf's global shape,
        its sharded dimension and the extent."""
        return {name: {"shape": list(spec.shape), "dim": self.dims[name],
                       "extent": self.n if self.dims[name] is not None
                       else 1}
                for name, spec in self.specs.items()}


def layout_of(model) -> ShardLayout | None:
    """The :class:`ShardLayout` :func:`shard_params` left on ``model``, or
    None for a model whose parameters are whole (a layout that shards no
    leaf counts as none)."""
    layout = getattr(model, "fsdp_layout", None)
    return layout if layout is not None and layout.sharded() else None


def mesh_layout(model, mesh, rules: ShardingRules | None = None
                ) -> ShardLayout:
    """The layout ``model`` (at its global shapes) takes on ``mesh``:
    specs over the mesh's extents, this rank's coordinates on its fsdp
    and data axes."""
    from move2kube_tpu_torch.parallel.mesh import mesh_config_of

    cfg = mesh_config_of(mesh)
    rank = mesh.get_local_rank("fsdp") if cfg.fsdp > 1 else 0
    data_rank = mesh.get_local_rank("data") if cfg.data > 1 else 0
    return ShardLayout(param_shardings(model, mesh, rules), cfg.fsdp, rank,
                       data_rank)


def shard_params(model, mesh, rules: ShardingRules | None = None
                 ) -> ShardLayout:
    """Keep on this rank only its slice of each parameter of ``model``
    sharded over ``mesh``'s fsdp axis (in place: each ``Parameter`` keeps
    its identity and takes the slice as its data), leave the layout on
    the model and return it. Call before the optimizer's first step: its
    moments take the shards' shapes. A mesh whose fsdp extent is 1
    shards nothing."""
    if getattr(model, "fsdp_layout", None) is not None:
        raise ValueError("the model is sharded already")
    layout = mesh_layout(model, mesh, rules)
    for name, p in model.named_parameters():
        if layout.dims[name] is not None:
            p.data = layout.take(name, p.data).clone()
    model.fsdp_layout = layout
    return layout
