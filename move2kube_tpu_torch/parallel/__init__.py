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
  tensor and expert ranks, the seq group's K/V hop and all-to-all, and
  the collective decode matmul;
- :mod:`.ring_attention` and :mod:`.ulysses`: exact causal attention
  over a seq group, on the port's flash kernels.

Data parallelism, FSDP (ZeRO-3), tensor, expert and sequence parallelism
run here; pipeline parallelism is ROADMAP Queue 1 item 9e.
"""

from move2kube_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshConfig,
    ProcessLayout,
    infer_mesh_config,
    initialize_distributed,
    make_mesh,
    process_layout,
)
from move2kube_tpu_torch.parallel.ring_attention import (  # noqa: F401
    ring_attention,
)
from move2kube_tpu_torch.parallel.ulysses import (  # noqa: F401
    ulysses_attention,
)
