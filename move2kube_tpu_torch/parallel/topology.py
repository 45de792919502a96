"""Parallelism planner: the port of ``move2kube_tpu/parallel/topology.py``.

A topology string (``2x4``, ``4x4x4``) plus the desired parallelism
degrees become a :class:`MeshPlan`: the logical extents (from
:func:`~move2kube_tpu_torch.parallel.mesh.infer_mesh_config`, with the
data x fsdp pool re-split by the per-card memory model so replicated
optimizer state fits, :func:`_memory_min_fsdp`), the ``dcn_dp`` outer data
factor across slices, and where the extents came from (``source``).

What does not carry over: the ICI permutation (the reference's
``_assign_layout``/``_build_perm``), which lays each logical axis onto
contiguous torus dims with the heaviest-traffic axis on wraparound rings.
The cards of an NVLink node are connected all to all, so there is no
torus to lay axes onto; across nodes the fabric is switched. The port's
plan keeps the identity device order and an empty layout, and its plan
line says ``layout=[]`` where the reference names the dims. Everything
else (extents, ``dcn_dp``, ``source``) is the reference's.

Multislice (``M2KT_NUM_SLICES`` > 1): each slice is planned alone and the
data extent is multiplied by ``dcn_dp``; ``data`` is the outermost mesh
axis, so each slice's ranks stay contiguous.

No process group and no device: the planner is pure arithmetic.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from move2kube_tpu_torch.parallel.memory import HBM_BYTES
from move2kube_tpu_torch.parallel.mesh import MeshConfig, infer_mesh_config

_DEFAULT_HBM = 16e9  # unknown slice types budget like v5e, as the reference


def parse_topology(topology: str) -> tuple[int, ...]:
    """``"4x4x4"`` -> ``(4, 4, 4)``; raises ValueError when malformed."""
    dims = []
    for dim_str in str(topology).split("x"):
        dim = int(dim_str)
        if dim <= 0:
            raise ValueError(f"non-positive topology dim {dim} in {topology!r}")
        dims.append(dim)
    return tuple(dims)


@dataclass(frozen=True)
class Topology:
    """A slice's grid: dim sizes and the slice type its budget reads."""

    dims: tuple[int, ...]
    slice_type: str = ""

    @property
    def chips(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    def hbm_bytes(self) -> float:
        return HBM_BYTES.get(self.slice_type, _DEFAULT_HBM)


@dataclass
class MeshPlan:
    """A logical mesh and the device order realizing it (the identity in
    the port; ``layout`` stays empty, see the module docstring)."""

    config: MeshConfig
    topology: Topology | None = None
    perm: tuple[int, ...] = ()
    layout: dict[str, tuple[int, ...]] = field(default_factory=dict)
    source: str = "planner"
    # DCN data-parallel factor: the number of slices the data axis spans
    dcn_dp: int = 1

    def device_order(self, devices) -> list:
        """The devices in plan order (the identity)."""
        devices = list(devices)
        if not self.perm or len(self.perm) != len(devices):
            return devices
        return [devices[i] for i in self.perm]

    def describe(self) -> str:
        dims = "x".join(str(d) for d in self.config.dims())
        topo = ("x".join(str(d) for d in self.topology.dims)
                if self.topology else "-")
        lay = ",".join(
            f"{a}@{'+'.join(str(d) for d in ds)}"
            for a, ds in sorted(self.layout.items()))
        slices = f" dcn_dp={self.dcn_dp}" if self.dcn_dp > 1 else ""
        return (f"mesh={dims} topology={topo} layout=[{lay}]{slices} "
                f"source={self.source}")


def _memory_min_fsdp(
    resident: int, tensor: int, param_bytes: int, hbm: float, headroom: float,
    optimizer_slots: int,
) -> int:
    """Smallest fsdp divisor of ``resident`` (= dp*fsdp cards) so fp32
    master params + grads + optimizer slots fit ``headroom`` of HBM.
    Params are already split over the tensor axis; fsdp shards the rest."""
    state_bytes = param_bytes * (2 + optimizer_slots)  # params + grads + slots
    budget = hbm * headroom
    for fsdp in sorted(d for d in range(1, resident + 1) if resident % d == 0):
        if state_bytes / (fsdp * tensor) <= budget:
            return fsdp
    return resident


def plan_parallelism(
    n_devices: int,
    *,
    topology: str = "",
    slice_type: str = "",
    zero_stage: int = 0,
    tensor_parallel: int = 1,
    seq_parallel: int = 1,
    pipeline_parallel: int = 1,
    expert_parallel: int = 1,
    param_bytes: int | None = None,
    optimizer_slots: int = 2,
    headroom: float = 0.9,
    num_slices: int = 1,
) -> MeshPlan:
    """The plan: extents from :func:`infer_mesh_config` (inner axes first,
    non-dividing degrees dropped); with ``param_bytes`` known and ZeRO
    off, the data pool re-split data x fsdp with the smallest fsdp whose
    fp32 master state fits ``headroom`` x HBM. ``num_slices`` > 1 plans
    one slice of ``n_devices // num_slices`` devices and multiplies the
    data extent by ``dcn_dp``; a count that does not divide falls back to
    one slice. A topology whose chips are not the slice's device count
    is modelled as a chain (``source=fallback-chain``)."""
    n_devices = max(1, n_devices)
    num_slices = max(1, num_slices)
    if num_slices > 1 and n_devices % num_slices:
        num_slices = 1
    per_slice = n_devices // num_slices
    config = infer_mesh_config(
        per_slice,
        zero_stage=zero_stage,
        tensor_parallel=tensor_parallel,
        seq_parallel=seq_parallel,
        pipeline_parallel=pipeline_parallel,
        expert_parallel=expert_parallel,
    )

    topo: Topology | None = None
    source = "planner"
    if topology:
        try:
            dims = parse_topology(topology)
        except ValueError:
            dims = ()
        if dims and Topology(dims).chips == per_slice:
            topo = Topology(dims=dims, slice_type=slice_type)
        else:
            source = "fallback-chain"
    if topo is None:
        topo = Topology(dims=(per_slice,), slice_type=slice_type)

    if param_bytes and zero_stage < 2 and config.data > 1:
        # per-slice re-split: each slice holds a full replica pool
        resident = config.data * config.fsdp
        fsdp = _memory_min_fsdp(
            resident, config.tensor, param_bytes, topo.hbm_bytes(), headroom,
            optimizer_slots,
        )
        fsdp = max(fsdp, config.fsdp)
        config = MeshConfig(
            data=resident // fsdp, fsdp=fsdp, pipe=config.pipe,
            tensor=config.tensor, seq=config.seq, expert=config.expert,
        )

    if n_devices == 1:
        return MeshPlan(config=config, topology=topo, perm=(0,), layout={},
                        source="single-chip")
    if num_slices > 1:
        config = MeshConfig(
            data=config.data * num_slices, fsdp=config.fsdp,
            pipe=config.pipe, tensor=config.tensor, seq=config.seq,
            expert=config.expert,
        )
    return MeshPlan(config=config, topology=topo,
                    perm=tuple(range(n_devices)), layout={}, source=source,
                    dcn_dp=num_slices)


def _env_mesh_config(env) -> MeshConfig | None:
    """Explicit ``M2KT_MESH_*`` overrides win over the planner (missing
    axes default to 1)."""
    keys = {axis: f"M2KT_MESH_{axis.upper()}" for axis in MeshConfig.AXES}
    if not any(k in env for k in keys.values()):
        return None
    try:
        return MeshConfig(**{axis: int(env.get(key, "1"))
                             for axis, key in keys.items()})
    except ValueError:
        return None


def resolve_mesh_plan(
    n_devices: int,
    *,
    default_topology: str = "",
    default_slice_type: str = "",
    zero_stage: int = 0,
    tensor_parallel: int = 1,
    seq_parallel: int = 1,
    pipeline_parallel: int = 1,
    expert_parallel: int = 1,
    param_bytes: int | None = None,
    num_slices: int | None = None,
    env=None,
) -> MeshPlan:
    """What the emitted trainer calls at startup: the plan from
    ``M2KT_TPU_TOPOLOGY``/``M2KT_TPU_ACCELERATOR`` (else the baked
    defaults), with ``M2KT_MESH_*`` as an override taken when its product
    is ``n_devices``. ``num_slices=None`` reads ``M2KT_NUM_SLICES``, which
    the elastic supervisor shrinks after a slice loss."""
    env = os.environ if env is None else env
    if num_slices is None:
        try:
            num_slices = int(env.get("M2KT_NUM_SLICES", "1") or 1)
        except ValueError:
            num_slices = 1
    explicit = _env_mesh_config(env)
    if explicit is not None and explicit.total() == n_devices:
        return MeshPlan(config=explicit, topology=None,
                        perm=tuple(range(n_devices)), layout={},
                        source="env-mesh")
    return plan_parallelism(
        n_devices,
        topology=env.get("M2KT_TPU_TOPOLOGY", "") or default_topology,
        slice_type=env.get("M2KT_TPU_ACCELERATOR", "") or default_slice_type,
        zero_stage=zero_stage,
        tensor_parallel=tensor_parallel,
        seq_parallel=seq_parallel,
        pipeline_parallel=pipeline_parallel,
        expert_parallel=expert_parallel,
        param_bytes=param_bytes,
        num_slices=num_slices,
    )
