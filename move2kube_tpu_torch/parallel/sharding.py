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

Two-axis layouts (tensor and expert parallelism). A leaf may be cut over
several mesh axes, one port dimension each (Llama's ``qkv`` ``[out,
in]``: ``out`` over tensor, ``in`` over fsdp; an MoE ``w_in`` ``[E, d,
m]``: experts over expert, ``d`` over fsdp, ``m`` over tensor); a
:class:`Cut` says which. A tensor rank holds *its heads* of a fused
projection rather than a contiguous block of rows: the ``qkv`` rows of
query heads ``[r H/t, (r+1) H/t)`` and of KV heads ``[r KV/t, (r+1)
KV/t)``, the same cut of ``gate_up``'s gate half and of its up half, and
of ``c_attn``'s three thirds; every rank still holds as many bytes as the
reference's contiguous cut, so the memory plan holds. The layout
(:meth:`ShardLayout.describe`, the checkpoint) keeps the global (flax)
order. A ``tensor`` extent that does not divide the query and KV head
counts or the MLP width is refused by name. :class:`ModelParallel` is
what a model's forward reads on such a mesh (its groups and
coordinates); :func:`with_logical_constraint` and :func:`maybe_shard`
are the points where an activation takes its named layout.
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


# the default rules, by which the models name their activations' layouts
RULES = ShardingRules.default()


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


@dataclass(frozen=True)
class Cut:
    """One mesh axis's cut of a leaf: port dimension ``dim`` over
    ``axis`` at ``extent``. The dimension is a row of ``blocks`` (a fused
    projection's parts, in global order; one block for a plain leaf),
    and coordinate r holds slice r of each block, in block order."""

    axis: str
    dim: int
    extent: int
    blocks: tuple

    def segments(self, coord: int) -> list:
        """``(start, length)`` along ``dim`` of each block's slice."""
        out, off = [], 0
        for size in self.blocks:
            part = size // self.extent
            out.append((off + coord * part, part))
            off += size
        return out

    def to_json(self) -> list:
        return [self.axis, self.dim, self.extent, list(self.blocks)]

    @classmethod
    def from_json(cls, doc) -> "Cut":
        axis, dim, extent, blocks = doc
        return cls(axis, int(dim), int(extent), tuple(int(b) for b in blocks))


def take_cuts(full, cuts, coords: dict):
    """The part of ``full`` that coordinates ``coords`` (axis -> index)
    hold under ``cuts``: a view where each cut is one block."""
    import torch

    for cut in cuts:
        segs = cut.segments(coords.get(cut.axis, 0))
        full = (full.narrow(cut.dim, *segs[0]) if len(segs) == 1 else
                torch.cat([full.narrow(cut.dim, s, n) for s, n in segs],
                          cut.dim))
    return full


def place_cuts(full, part, cuts, coords: dict) -> None:
    """Write ``part`` (what ``coords`` hold under ``cuts``) into its place
    in ``full``, in place: the inverse of :func:`take_cuts`."""
    if not cuts:
        full.copy_(part)
        return
    cut, rest = cuts[0], cuts[1:]
    off = 0
    for start, size in cut.segments(coords.get(cut.axis, 0)):
        place_cuts(full.narrow(cut.dim, start, size),
                   part.narrow(cut.dim, off, size), rest, coords)
        off += size


# the port leaves whose tensor cut is a fused projection's: the blocks
# along their dimension 0, from the model's config
def _fused_blocks(name: str, cfg) -> tuple | None:
    if name.endswith("qkv.weight"):
        hd = cfg.d_model // cfg.num_heads
        return (cfg.num_heads * hd, cfg.num_kv_heads * hd,
                cfg.num_kv_heads * hd)
    if name.endswith("gate_up.weight"):
        return (cfg.mlp_dim, cfg.mlp_dim)
    if name.endswith("c_attn.weight"):
        return (cfg.d_model,) * 3
    return None


def check_model_parallel(cfg, extents: dict) -> None:
    """Refuse, by name, a ``tensor`` extent that does not divide a
    Llama's or GPT-2's head counts or MLP width, and an ``expert`` extent
    that does not divide the MoE's experts."""
    t = extents.get("tensor", 1)
    if t > 1 and cfg is not None and hasattr(cfg, "num_heads"):
        counts = {"num_heads": cfg.num_heads,
                  "num_kv_heads": getattr(cfg, "num_kv_heads",
                                          cfg.num_heads),
                  "mlp_dim": getattr(cfg, "mlp_dim", 4 * cfg.d_model)}
        for what, count in counts.items():
            if count % t:
                raise ValueError(f"tensor={t} does not divide {what}="
                                 f"{count}")
    ep = extents.get("expert", 1)
    experts = getattr(cfg, "moe_experts", 0)
    if ep > 1 and experts and experts % ep:
        raise ValueError(f"expert={ep} does not divide moe_experts="
                         f"{experts}")


def leaf_cuts(specs: dict, extents: dict, cfg=None) -> dict:
    """``{name: (Cut, ...)}``: each mesh axis above 1 a leaf's spec names,
    the fsdp cut last (it cuts the tensor-local leaf, as ZeRO-3's gather
    over fsdp yields it)."""
    out = {}
    for name, spec in specs.items():
        cuts = []
        for dim, entry in enumerate(spec.axes):
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                if axis is None or extents.get(axis, 1) <= 1:
                    continue
                blocks = (spec.shape[dim],)
                if axis == "tensor" and dim == 0 and cfg is not None:
                    blocks = _fused_blocks(name, cfg) or blocks
                cuts.append(Cut(axis, dim, extents[axis], blocks))
        cuts.sort(key=lambda c: c.axis == "fsdp")
        out[name] = tuple(cuts)
    return out


# the axes whose ranks hold copies of the same parts: the rules cut no
# parameter over data or seq (seq cuts activations only)
COPY_AXES = ("data", "seq")


@dataclass
class ShardLayout:
    """Where a sharded model's parameters lie: ``specs`` (global shapes),
    ``cuts`` (each leaf's :class:`Cut` a mesh axis), this rank's
    ``coords`` on the mesh's axes above 1 and their ``extents``. ``n``,
    ``rank`` and ``dims`` are the fsdp axis's extent, this rank's
    coordinate on it and each leaf's dimension cut over it (None: whole
    over fsdp), which ZeRO-3's gather and reduce-scatter read."""

    specs: dict
    cuts: dict
    coords: dict = field(default_factory=dict)
    extents: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.dims = {name: next((c.dim for c in cuts if c.axis == "fsdp"),
                                None)
                     for name, cuts in self.cuts.items()}

    @property
    def n(self) -> int:
        return self.extents.get("fsdp", 1)

    @property
    def rank(self) -> int:
        return self.coords.get("fsdp", 0)

    @property
    def first_copy(self) -> bool:
        """Whether this rank is the first of the ranks that hold copies of
        its parts (coordinate 0 on the data and seq axes): the one that
        writes them."""
        return all(self.coords.get(a, 0) == 0 for a in COPY_AXES)

    def part_axes(self) -> list:
        """``[(axis, extent), ...]``: the axes above 1 whose ranks hold
        distinct parts (every one but data and seq), outer to inner."""
        from move2kube_tpu_torch.parallel.mesh import MeshConfig

        return [(a, self.extents[a]) for a in MeshConfig.AXES
                if a not in COPY_AXES and self.extents.get(a, 1) > 1]

    def part_index(self) -> int:
        """This rank's index among the ranks of distinct parts (row-major
        over :meth:`part_axes`): the checkpoint's shard file number."""
        index = 0
        for axis, extent in self.part_axes():
            index = index * extent + self.coords.get(axis, 0)
        return index

    def sharded(self) -> list:
        """The leaves cut over any axis."""
        return [name for name, cuts in self.cuts.items() if cuts]

    def axes_of(self, name: str) -> frozenset:
        """The mesh axes leaf ``name`` is cut over."""
        return frozenset(c.axis for c in self.cuts.get(name, ()))

    def take(self, name: str, full):
        """This rank's part of parameter ``name``'s global tensor ``full``
        (``full`` itself for a whole leaf)."""
        return take_cuts(full, self.cuts.get(name, ()), self.coords)

    def describe(self) -> dict:
        """The layout as ``meta.json`` keeps it: each leaf's global shape,
        its fsdp dimension and extent, and, for a leaf cut over another
        axis too, its cuts in global order (a leaf cut over fsdp alone is
        described as before tensor and expert parallelism)."""
        out = {}
        for name, spec in self.specs.items():
            dim = self.dims[name]
            out[name] = {"shape": list(spec.shape), "dim": dim,
                         "extent": self.n if dim is not None else 1}
            if any(c.axis != "fsdp" for c in self.cuts[name]):
                out[name]["cuts"] = [c.to_json() for c in self.cuts[name]]
        return out


def layout_of(model) -> ShardLayout | None:
    """The :class:`ShardLayout` :func:`shard_params` left on ``model``, or
    None for a model whose parameters are whole (a layout that cuts no
    leaf counts as none)."""
    layout = getattr(model, "fsdp_layout", None)
    return layout if layout is not None and layout.sharded() else None


def mesh_layout(model, mesh, rules: ShardingRules | None = None
                ) -> ShardLayout:
    """The layout ``model`` (at its global shapes) takes on ``mesh``:
    specs over the mesh's extents, this rank's coordinate on each axis
    above 1. Raises where the tensor or expert extent does not divide
    the model (:func:`check_model_parallel`)."""
    from move2kube_tpu_torch.parallel.mesh import MeshConfig, mesh_config_of

    cfg = mesh_config_of(mesh)
    extents = dict(zip(MeshConfig.AXES, cfg.dims()))
    model_cfg = getattr(model, "cfg", None)
    check_model_parallel(model_cfg, extents)
    coords = {a: mesh.get_local_rank(a) for a, e in extents.items() if e > 1}
    specs = param_shardings(model, mesh, rules)
    return ShardLayout(specs, leaf_cuts(specs, extents, model_cfg), coords,
                       {a: e for a, e in extents.items() if e > 1})


def shard_params(model, mesh, rules: ShardingRules | None = None
                 ) -> ShardLayout:
    """Keep on this rank only its part of each parameter of ``model`` cut
    over ``mesh``'s axes (in place: each ``Parameter`` keeps its identity
    and takes its part as its data), leave the layout on the model and
    return it. Call before the optimizer's first step: its moments take
    the parts' shapes. A mesh that cuts no leaf changes nothing."""
    if getattr(model, "fsdp_layout", None) is not None:
        raise ValueError("the model is sharded already")
    layout = mesh_layout(model, mesh, rules)
    for name, p in model.named_parameters():
        if layout.cuts[name]:
            p.data = layout.take(name, p.data).clone()
    model.fsdp_layout = layout
    return layout


@dataclass
class ModelParallel:
    """What a Llama's, GPT-2's or MoE's forward reads on a mesh (set on
    the model's modules by :func:`attach_model_parallel`): the ring
    groups of this rank's ``tensor`` axis, its ``expert`` axis and both
    together (``te``), and of its ``seq`` axis (whose ranks hold
    consecutive tokens of the same rows, rank ``sp_rank`` of ``sp`` the
    positions ``[sp_rank S, (sp_rank + 1) S)``), the extents and
    coordinates, and ``route``: the group over which an MoE layer routes
    its tokens (the batch x seq group on the reference's GSPMD and
    sequential paths; None: this call's tokens, as its per-device paths
    route)."""

    tensor: object = None
    t: int = 1
    t_rank: int = 0
    expert: object = None
    ep: int = 1
    ep_rank: int = 0
    te: object = None
    route: object = None
    seq: object = None
    sp: int = 1
    sp_rank: int = 0


def attach_model_parallel(model, mp: ModelParallel | None) -> None:
    """Point every module of ``model`` that reads a :class:`ModelParallel`
    (an ``mp`` attribute) at ``mp``."""
    for m in model.modules():
        if hasattr(m, "mp"):
            m.mp = mp


def with_logical_constraint(x, mp, rules: ShardingRules, logical_axes,
                            global_shape):
    """An activation by logical names (the reference's
    ``with_logical_constraint``): :func:`maybe_shard` of the rules'
    spec."""
    return maybe_shard(x, rules.spec(tuple(logical_axes)), mp, global_shape)


def maybe_shard(x, spec, mp, global_shape):
    """The point where activation ``x`` (this rank's part) takes the
    layout ``spec`` names (a mesh axis, a tuple of them or None a
    dimension). Off a mesh (``mp`` None) it is the identity, as the
    reference's off an abstract mesh. On one, the port's forward has
    already made each dimension named over ``tensor`` or ``expert`` this
    rank's cut (from its part of the weight), so nothing moves: the
    shape is held to ``global_shape`` over the extents, and a mismatch
    raises. Batch axes are the caller's rows and are not checked."""
    if mp is None:
        return x
    extents = {"tensor": mp.t, "expert": mp.ep}
    for dim, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        div = 1
        for nm in names:
            div *= extents.get(nm, 1)
        if div > 1 and x.shape[dim] * div != global_shape[dim]:
            raise ValueError(f"activation dim {dim}: {x.shape[dim]} x "
                             f"{div} != {global_shape[dim]} ({spec})")
    return x


def gather_full(layout: ShardLayout, name: str, part, mesh):
    """Leaf ``name``'s global tensor from every rank's ``part`` (this
    rank's), all-gathered over each axis it is cut over, the fsdp cut
    first: the same bits on every rank (``part`` itself under no
    ``layout``). Collective over ``mesh``."""
    if layout is None:
        return part
    import torch

    from move2kube_tpu_torch.parallel.overlap import (
        mesh_ring_group,
        ring_all_gather,
    )

    for cut in reversed(layout.cuts.get(name, ())):
        every = ring_all_gather(part.unsqueeze(0).contiguous(),
                                mesh_ring_group(mesh, (cut.axis,)), 0)
        shape = list(part.shape)
        shape[cut.dim] = sum(cut.blocks)
        full = torch.empty(shape, dtype=part.dtype, device=part.device)
        for coord in range(cut.extent):
            place_cuts(full, every[coord], (cut,), {cut.axis: coord})
        part = full
    return part
