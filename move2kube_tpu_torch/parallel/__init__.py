"""Multi-GPU execution of the port: the counterpart of ``move2kube_tpu/
parallel/``.

- :mod:`.mesh`: ``MeshConfig`` and its six axes, the process layout a pod
  maps onto (one rank a card), ``initialize_distributed`` and the
  ``DeviceMesh``;
- :mod:`.topology`: the parallelism planner (``resolve_mesh_plan``);
- :mod:`.sharding`: the logical-axis rules the memory plan reads;
- :mod:`.memory`: the per-card memory plan;
- :mod:`.overlap`: the bucketed ring all-reduce and the accumulation that
  overlaps it with the next microbatch's backward.

Data parallelism runs here; FSDP, tensor, sequence, expert and pipeline
parallelism are ROADMAP Queue 1 items 9b-9e.
"""

from move2kube_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshConfig,
    ProcessLayout,
    infer_mesh_config,
    initialize_distributed,
    make_mesh,
    process_layout,
)
