"""Multi-GPU execution of the port: the counterpart of ``move2kube_tpu/
parallel/``.

- :mod:`.mesh`: ``MeshConfig`` and its six axes, the process layout a pod
  maps onto (one rank a card), ``initialize_distributed`` and the
  ``DeviceMesh``;
- :mod:`.topology`: the parallelism planner (``resolve_mesh_plan``);
- :mod:`.sharding`: the logical-axis rules the memory plan reads, the
  placement of parameter parts over the fsdp, tensor and expert axes, and
  the activation constraints;
- :mod:`.memory`: the per-card memory plan;
- :mod:`.overlap`: the bucketed ring all-reduce, the FSDP all-gather and
  reduce-scatter rings, the accumulations that overlap them with the
  next microbatch's backward, the collectives of a model split over
  tensor and expert ranks, and the collective decode matmul.

Data parallelism, FSDP (ZeRO-3), tensor and expert parallelism run here;
sequence and pipeline parallelism are ROADMAP Queue 1 items 9d-9e.
"""

from move2kube_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshConfig,
    ProcessLayout,
    infer_mesh_config,
    initialize_distributed,
    make_mesh,
    process_layout,
)
