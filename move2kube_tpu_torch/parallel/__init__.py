"""Multi-GPU execution of the port: the counterpart of ``move2kube_tpu/
parallel/``.

- :mod:`.mesh`: ``MeshConfig`` and its six axes, the process layout a pod
  maps onto (one rank a card), ``initialize_distributed`` and the
  ``DeviceMesh``;
- :mod:`.topology`: the parallelism planner (``resolve_mesh_plan``);
- :mod:`.sharding`: the logical-axis rules the memory plan reads, and the
  placement of parameter shards;
- :mod:`.memory`: the per-card memory plan;
- :mod:`.overlap`: the bucketed ring all-reduce, the FSDP all-gather and
  reduce-scatter rings, and the accumulations that overlap them with the
  next microbatch's backward.

Data parallelism and FSDP (ZeRO-3) run here; tensor, sequence, expert and
pipeline parallelism are ROADMAP Queue 1 items 9c-9e.
"""

from move2kube_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshConfig,
    ProcessLayout,
    infer_mesh_config,
    initialize_distributed,
    make_mesh,
    process_layout,
)
